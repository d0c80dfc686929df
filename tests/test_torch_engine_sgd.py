"""The SGD walk over a chunk's merge batches (repro_torch.kernels.engine's
glm_sgd_chunk) and the engine's affine-update match on the CPU: the plain
version against repro's Pallas gradient (interpret mode) batch by batch with
the same update, the port's Engine against repro's Engine on the same hDFG,
and match_sgd_update on the repository's algorithms and on DSL updates that
are not affine. The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py and tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.algorithms as jalgos
from repro.core import dsl as jdsl
from repro.core import engine as jengine
from repro.core import translator as jtranslator
from repro.db.heap import write_table
from repro.kernels.engine.engine import glm_grad_pallas
import repro_torch.algorithms as talgos
from repro_torch.algorithms import linear_regression, logistic_regression, lrmf, svm
from repro_torch.core import dsl as tdsl
from repro_torch.core.engine import (
    init_models,
    make_engine,
    match_sgd_update,
    models_from_numpy,
)
from repro_torch.core.translator import trace
from repro_torch.db.heap import HeapFile
from repro_torch.kernels.engine import kernel, ops, ref

CPU = "cpu"


def _chunk(n, d, act, seed):
    """n rows of a chunk whose masked rows hold 99.0 garbage."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
    if act == "logistic":
        y = (y > 0).astype(np.float32)
    elif act == "linear":
        y = rng.normal(0, 1, n).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    x[mask == 0] = 99.0
    w = rng.normal(0, 0.3, d).astype(np.float32)
    return x, y, mask, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("act", ref.ACTS)
@pytest.mark.parametrize("n,d,coef", [(5 * 32 + 19, 12, 32), (3 * 24 + 7, 5, 24)])
def test_sgd_chunk_ref_matches_pallas_batch_loop(act, n, d, coef):
    """glm_sgd_chunk_ref == a loop over repro's Pallas gradient (interpret
    mode) with the same update, ragged tail and masked garbage included."""
    x, y, mask, w0 = _chunk(n, d, act, seed=n + d)
    a, b = np.float32(1.0 - 0.1 * 1e-3), np.float32(0.1 / coef)
    w = w0.copy()
    norms = []
    for s in range(0, n, coef):
        xb, yb, mb = x[s:s + coef], y[s:s + coef], mask[s:s + coef]
        pad = coef - xb.shape[0]  # the tail batch, padded as dead rows
        xp = np.pad(xb, ((0, pad), (0, 0)))
        yp, mp = np.pad(yb, (0, pad)), np.pad(mb, (0, pad))
        g = np.asarray(glm_grad_pallas(jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(w),
                                       jnp.asarray(mp), act, block_rows=coef,
                                       interpret=True))
        got = ref.glm_grad_ref(*_t(xb, yb, w, mb), act)
        np.testing.assert_allclose(got.numpy(), g, rtol=2e-5, atol=2e-4)
        norms.append(np.sqrt(np.sum(np.square(g, dtype=np.float32))))
        w = a * w - b * g
    got_w, got_n = ref.glm_sgd_chunk_ref(*_t(x, y, mask, w0), coef, act, float(a), float(b))
    assert got_n.shape == (-(-n // coef),)
    np.testing.assert_allclose(got_w.numpy(), w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_n.numpy(), np.array(norms), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", ref.ACTS)
def test_sgd_chunk_equals_batches_one_by_one(act):
    """The chunk walk is the per-batch gradient and update, batch after
    batch: the same bits as calling them one at a time."""
    x, y, mask, w0 = _chunk(4 * 16 + 3, 7, act, seed=3)
    xt, yt, mt, w = _t(x, y, mask, w0)
    got_w, got_n = ops.glm_sgd_chunk(xt, yt, mt, w, 16, act, 0.5, 0.25)
    norms = []
    for s in range(0, x.shape[0], 16):
        g = ops.glm_grad(xt[s:s + 16], yt[s:s + 16], w, mt[s:s + 16], act)
        norms.append(g.square().sum().sqrt())
        w = w * 0.5 - g * 0.25
    assert torch.equal(got_w, w) and torch.equal(got_n, torch.stack(norms))


def test_sgd_chunk_edges():
    x, y, mask, w = _t(*_chunk(10, 3, "linear", seed=4))
    # one batch wider than the chunk; a batch per row
    got_w, got_n = ops.glm_sgd_chunk(x, y, mask, w, 64, "linear", 1.0, 0.1)
    want = w - 0.1 * ref.glm_grad_ref(x, y, w, mask, "linear")
    torch.testing.assert_close(got_w, want, rtol=1e-6, atol=1e-7)
    assert got_n.shape == (1,)
    assert ops.glm_sgd_chunk(x, y, mask, w, 1, "linear", 1.0, 0.1)[1].shape == (10,)
    # an empty chunk leaves w as it was and has no batches
    got_w, got_n = ops.glm_sgd_chunk(x[:0], y[:0], mask[:0], w, 4, "linear", 1.0, 0.1)
    assert torch.equal(got_w, w) and got_n.shape == (0,)


def test_sgd_chunk_cpu_path_is_plain(monkeypatch):
    x, y, mask, w = _t(*_chunk(16, 4, "svm", seed=5))
    calls = []
    monkeypatch.setattr(ref, "glm_sgd_chunk_ref", lambda *a: calls.append("ref"))
    monkeypatch.setattr(kernel, "glm_sgd_chunk", lambda *a: calls.append("kernel"))
    ops.glm_sgd_chunk(x, y, mask, w, 8, "svm", 1.0, 0.1)
    ops.glm_sgd_chunk(*(t.to("meta") for t in (x, y, mask, w)), 8, "svm", 1.0, 0.1)
    assert calls == ["ref", "kernel"]


def test_sgd_chunk_kernel_rejects_bad_input():
    x, y, mask, w = _t(*_chunk(16, 4, "svm", seed=6))
    launches = kernel.glm_sgd_chunk.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.glm_sgd_chunk(x, y, mask, w, 8, "svm", 1.0, 0.1)
    meta = [t.to("meta") for t in (x, y, mask, w)]
    with pytest.raises(ValueError, match="activation"):
        kernel.glm_sgd_chunk(*meta, 8, "tanh", 1.0, 0.1)
    with pytest.raises(ValueError, match="coef"):
        kernel.glm_sgd_chunk(*meta, 0, "svm", 1.0, 0.1)
    with pytest.raises(ValueError, match="coef"):
        kernel.glm_sgd_chunk(*meta, 8.0, "svm", 1.0, 0.1)
    assert kernel.glm_sgd_chunk.launches == launches


# ------------------------------ match_sgd_update ------------------------------
@pytest.mark.parametrize("name,kw,want", [
    ("linear", dict(lr=0.05, merge_coef=8), (1.0, 0.05 / 8)),
    ("logistic", dict(lr=0.1, merge_coef=7), (1.0, 0.1 / 7)),
    ("svm", dict(lr=0.05, merge_coef=24), (1.0 - 0.05 * 1e-4, 0.05 / 24)),
    ("svm", dict(lr=0.2, lam=1e-2, merge_coef=256), (1.0 - 0.2 * 1e-2, 0.2 / 256)),
])
def test_match_sgd_update_on_the_glms(name, kw, want):
    g, part = trace(lambda: talgos.ALGORITHMS[name](6, **kw))
    eng = make_engine(g, part, device=CPU)
    assert eng.chunk_kernel
    np.testing.assert_allclose(eng.fused_update, want, rtol=1e-6)
    assert match_sgd_update(g, part, eng.metas) == eng.fused_update


def test_match_sgd_update_reads_the_engines_metas():
    g, part = trace(lambda: svm(6, lr=0.05, lam=1e-4, merge_coef=16))
    eng = make_engine(g, part, metas=[0.3, 2e-2], device=CPU)
    np.testing.assert_allclose(eng.fused_update, (1.0 - 0.3 * 2e-2, 0.3 / 16), rtol=1e-6)
    g, part = trace(lambda: logistic_regression(6, lr=0.1, merge_coef=16))
    eng = make_engine(g, part, metas=[0.4], device=CPU)
    np.testing.assert_allclose(eng.fused_update, (1.0, 0.4 / 16), rtol=1e-6)


def _squared_step(dsl, n_features, lr=0.05, merge_coef=8):
    """Linear regression whose update squares the averaged gradient."""
    mo, inp, out = dsl.model([n_features]), dsl.input([n_features]), dsl.output()
    mu = dsl.meta(lr)
    algo = dsl.algo(mo, inp, out)
    grad = algo.merge((dsl.sigma(mo * inp, 1) - out) * inp, merge_coef, "+")
    step = grad / merge_coef
    algo.setModel(mo - mu * step * step)
    algo.setEpochs(2)
    return algo


def _decayed_model(dsl, n_features, lr=0.05, merge_coef=8):
    """Linear regression whose update squares the model."""
    mo, inp, out = dsl.model([n_features]), dsl.input([n_features]), dsl.output()
    mu = dsl.meta(lr)
    algo = dsl.algo(mo, inp, out)
    grad = algo.merge((dsl.sigma(mo * inp, 1) - out) * inp, merge_coef, "+")
    algo.setModel(mo - mu * (grad / merge_coef) - mu * mo * mo)
    algo.setEpochs(2)
    return algo


@pytest.mark.parametrize("build", [_squared_step, _decayed_model])
def test_update_that_is_not_affine_loops_over_batches(build):
    """The GLM template matches, the update does not: no (a, b), and the
    engine's loop over batches still agrees with repro's."""
    d, coef = 6, 8
    g, part = trace(lambda: build(tdsl, d, merge_coef=coef))
    gj, pj = jtranslator.trace(lambda: build(jdsl, d, merge_coef=coef))
    assert match_sgd_update(g, part, [0.05]) is None
    teng = make_engine(g, part, device=CPU)
    assert teng.glm_template == "linear" and teng.fused_update is None
    assert not teng.chunk_kernel
    rng = np.random.default_rng(8)
    X = rng.normal(0, 1, (4, coef, d)).astype(np.float32)
    Y = rng.normal(0, 1, (4, coef)).astype(np.float32)
    M = np.ones((4, coef), np.float32)
    jeng = jengine.make_engine(gj, pj)
    jmodels = jengine.init_models(gj, np.random.default_rng(6), scale=0.1)
    tmodels = models_from_numpy([np.asarray(m) for m in jmodels], CPU)
    jm, jg = jeng.run_epoch(jmodels, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(M))
    tm, tg = teng.run_epoch(tmodels, *_t(X, Y, M))
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_lrmf_has_no_affine_update():
    g, part = trace(lambda: lrmf(12, rank=3))
    assert match_sgd_update(g, part, make_engine(g, part, device=CPU).metas) is None
    assert make_engine(g, part, device=CPU).fused_update is None


# ------------------------------ against repro's Engine ------------------------
@pytest.mark.parametrize("name,coef,kw", [
    ("linear", 24, dict(lr=0.1)), ("logistic", 32, dict(lr=0.3)),
    ("svm", 24, dict(lr=0.1, lam=1e-2)), ("svm", 64, dict(lr=0.05)),
])
def test_run_epoch_chunk_matches_repro(name, coef, kw):
    """The port's one-launch epoch against repro's scan over batches, with
    dead rows of garbage."""
    rng = np.random.default_rng(29)
    d, nb = 10, 5
    X = rng.normal(0, 1, (nb * coef, d)).astype(np.float32)
    if name == "logistic":
        y = (rng.uniform(size=nb * coef) > 0.5).astype(np.float32)
    else:
        y = np.sign(rng.normal(0, 1, nb * coef)).astype(np.float32)
    mask = (rng.uniform(size=nb * coef) > 0.1).astype(np.float32)
    X[mask == 0] = 99.0
    gj, pj = jtranslator.trace(lambda: jalgos.ALGORITHMS[name](d, merge_coef=coef, **kw))
    g, part = trace(lambda: talgos.ALGORITHMS[name](d, merge_coef=coef, **kw))
    jeng = jengine.make_engine(gj, pj)
    teng = make_engine(g, part, device=CPU)
    assert teng.chunk_kernel and teng.glm_template == jeng.glm_template
    jmodels = jengine.init_models(gj, np.random.default_rng(6), scale=0.1)
    tmodels = models_from_numpy([np.asarray(m) for m in jmodels], CPU)
    xs, ys, ms = X.reshape(nb, coef, d), y.reshape(nb, coef), mask.reshape(nb, coef)
    jm, jg = jeng.run_epoch(jmodels, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ms))
    tm, tg = teng.run_epoch(tmodels, *_t(xs, ys, ms))
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_run_chunk_ragged_tail_matches_repro(tmp_path):
    """A chunk whose tuples do not fill the last merge batch: the port hands
    the flat stream to the walk, repro pads; the same models and norms."""
    rng = np.random.default_rng(31)
    X = rng.normal(0, 1, (1000, 9)).astype(np.float32)
    z = X @ rng.normal(0, 1, 9).astype(np.float32)
    heap = write_table(str(tmp_path / "lr.heap"), X, (z > 0).astype(np.float32),
                       page_bytes=4096)
    pages = heap.read_pages(np.arange(heap.n_pages))
    gj, pj = jtranslator.trace(lambda: jalgos.logistic_regression(9, lr=0.2, merge_coef=48))
    g, part = trace(lambda: logistic_regression(9, lr=0.2, merge_coef=48))
    jeng = jengine.make_engine(gj, pj)
    teng = make_engine(g, part, device=CPU)
    th = HeapFile(heap.path)
    assert (th.n_pages * th.layout.tuples_per_page) % 48 != 0
    jmodels = jengine.init_models(gj, np.random.default_rng(0), scale=0.01)
    tmodels = models_from_numpy([np.asarray(m) for m in jmodels], CPU)
    jm, jg = jeng.run_chunk(jmodels, pages, heap.layout)
    tm, tg = teng.run_chunk(tmodels, pages, th.layout)
    assert tg.shape == jg.shape
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_run_chunk_takes_the_walk_once(monkeypatch, tmp_path):
    """run_chunk and run_epoch call glm_sgd_chunk once per chunk and never
    the per-batch gradient."""
    rng = np.random.default_rng(37)
    X = rng.normal(0, 1, (700, 5)).astype(np.float32)
    heap = write_table(str(tmp_path / "l.heap"), X, X.sum(1), page_bytes=4096)
    g, part = trace(lambda: linear_regression(5, lr=0.1, merge_coef=32))
    eng = make_engine(g, part, device=CPU)
    calls = []
    real = ops.glm_sgd_chunk
    monkeypatch.setattr(ops, "glm_sgd_chunk", lambda *a: calls.append(a[4]) or real(*a))
    monkeypatch.setattr(ops, "glm_grad", lambda *a, **k: calls.append("grad"))
    models = init_models(g, device=CPU)
    th = HeapFile(heap.path)
    eng.run_chunk(models, th.read_pages(np.arange(th.n_pages)), th.layout)
    eng.run_epoch(models, *_t(X[:640].reshape(20, 32, 5), X[:640].sum(1).reshape(20, 32),
                              np.ones((20, 32), np.float32)))
    assert calls == [32, 32]
