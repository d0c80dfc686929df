"""Port execution engine (repro_torch.core.engine) on the CPU: the ports of
tests/test_engine.py's single-device tests, plus run_epoch and run_chunk
held against repro's Engine on the same batch, and run_chunk against
decode-then-run_epoch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.algorithms as jalgos
from repro.core import engine as jengine
from repro.core import translator as jtranslator
from repro.db.heap import write_table
import repro_torch.algorithms as talgos
from repro_torch.algorithms import linear_regression, logistic_regression, lrmf, svm
from repro_torch.core.engine import (
    batches_from_stream,
    init_models,
    make_engine,
    match_glm_template,
    models_from_numpy,
)
from repro_torch.core.translator import trace
from repro_torch.db.heap import HeapFile
from repro_torch.kernels.strider import ops as strider_ops

CPU = "cpu"


def _batchify(X, y, coef):
    n = X.shape[0] // coef * coef
    return (
        torch.from_numpy(X[:n]).reshape(-1, coef, X.shape[1]),
        torch.from_numpy(y[:n]).reshape(-1, coef),
        torch.ones((n // coef, coef), dtype=torch.float32),
    )


def test_glm_template_matching():
    cases = {
        "linear": lambda: linear_regression(6),
        "logistic": lambda: logistic_regression(6),
        "svm": lambda: svm(6),
    }
    for want, fn in cases.items():
        g, part = trace(fn)
        assert match_glm_template(g, part) == want
    g, part = trace(lambda: lrmf(12, rank=3))
    assert match_glm_template(g, part) is None


@pytest.mark.parametrize("use_fused", [False, True])
def test_linear_regression_recovers_truth(use_fused):
    rng = np.random.default_rng(0)
    w_true = rng.normal(0, 1, 12)
    X = rng.normal(0, 1, (2048, 12)).astype(np.float32)
    y = (X @ w_true).astype(np.float32)
    g, part = trace(lambda: linear_regression(12, lr=0.3, merge_coef=64))
    eng = make_engine(g, part, use_fused_kernel=use_fused, device=CPU)
    assert eng.use_fused_kernel == use_fused
    models = init_models(g, device=CPU)
    Xb, Yb, Mb = _batchify(X, y, 64)
    for _ in range(40):
        models, gnorms = eng.run_epoch(models, Xb, Yb, Mb)
    np.testing.assert_allclose(models[0].numpy(), w_true, atol=1e-2)
    assert float(gnorms[-1]) < 1.0


def test_threaded_equals_sequential_batched():
    """Merged '+' over a batch == explicit per-tuple accumulation."""
    rng = np.random.default_rng(3)
    X = rng.normal(0, 1, (128, 8)).astype(np.float32)
    y = rng.normal(0, 1, 128).astype(np.float32)
    g, part = trace(lambda: linear_regression(8, lr=0.1, merge_coef=16))
    eng = make_engine(g, part, use_fused_kernel=False, device=CPU)
    models = init_models(g, device=CPU)
    Xb, Yb, Mb = _batchify(X, y, 16)
    got, _ = eng.run_epoch(models, Xb, Yb, Mb)
    want = eng.sequential_epoch(models, Xb, Yb)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)


def test_fused_kernel_matches_general_path():
    rng = np.random.default_rng(5)
    X = rng.normal(0, 1, (256, 20)).astype(np.float32)
    y = np.sign(rng.normal(0, 1, 256)).astype(np.float32)
    for algo, labels in (
        (lambda: svm(20, lr=0.05, merge_coef=32), y),
        (lambda: logistic_regression(20, lr=0.05, merge_coef=32), np.clip(y, 0, 1)),
    ):
        g, part = trace(algo)
        models = init_models(g, np.random.default_rng(1), scale=0.1, device=CPU)
        Xb, Yb, Mb = _batchify(X, labels, 32)
        fused = make_engine(g, part, use_fused_kernel=True, device=CPU)
        plain = make_engine(g, part, use_fused_kernel=False, device=CPU)
        assert fused.use_fused_kernel
        m1, g1 = fused.run_epoch(models, Xb, Yb, Mb)
        m2, g2 = plain.run_epoch(models, Xb, Yb, Mb)
        np.testing.assert_allclose(m1[0].numpy(), m2[0].numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_fused", [False, True])
def test_masked_tuples_do_not_contribute(use_fused):
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1, (32, 5)).astype(np.float32)
    y = rng.normal(0, 1, 32).astype(np.float32)
    g, part = trace(lambda: linear_regression(5, lr=0.1, merge_coef=32))
    eng = make_engine(g, part, use_fused_kernel=use_fused, device=CPU)
    models = init_models(g, device=CPU)
    # mask second half; equivalent to running only the first half padded
    mask = np.ones(32, np.float32)
    mask[16:] = 0
    X2 = X.copy()
    X2[16:] = 99.0  # garbage that must be ignored
    got, _ = eng.run_epoch(
        models, torch.from_numpy(X2)[None], torch.from_numpy(y)[None],
        torch.from_numpy(mask)[None],
    )
    Xz, yz = X.copy(), y.copy()
    Xz[16:] = 0
    yz[16:] = 0
    want, _ = eng.run_epoch(
        models, torch.from_numpy(Xz)[None], torch.from_numpy(yz)[None],
        torch.ones((1, 32), dtype=torch.float32),
    )
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)


def test_logistic_learns_separator():
    rng = np.random.default_rng(11)
    w_true = rng.normal(0, 2, 10)
    X = rng.normal(0, 1, (4096, 10)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    g, part = trace(lambda: logistic_regression(10, lr=0.5, merge_coef=128))
    eng = make_engine(g, part, device=CPU)
    models = init_models(g, device=CPU)
    Xb, Yb, Mb = _batchify(X, y, 128)
    for _ in range(30):
        models, _ = eng.run_epoch(models, Xb, Yb, Mb)
    pred = (X @ models[0].numpy() > 0).astype(np.float32)
    assert (pred == y).mean() > 0.97


def test_svm_learns_separator():
    rng = np.random.default_rng(13)
    w_true = rng.normal(0, 2, 8)
    X = rng.normal(0, 1, (4096, 8)).astype(np.float32)
    y = np.sign(X @ w_true).astype(np.float32)
    g, part = trace(lambda: svm(8, lr=0.1, merge_coef=128))
    eng = make_engine(g, part, device=CPU)
    models = init_models(g, device=CPU)
    Xb, Yb, Mb = _batchify(X, y, 128)
    for _ in range(30):
        models, _ = eng.run_epoch(models, Xb, Yb, Mb)
    pred = np.sign(X @ models[0].numpy())
    assert (pred == y).mean() > 0.97


def test_lrmf_reduces_reconstruction_error():
    """The non-template path: pre_fn mapped over threads with torch.func.vmap."""
    rng = np.random.default_rng(17)
    n_items, rank, n_users = 40, 4, 256
    U = rng.normal(0, 1, (n_users, rank))
    V = rng.normal(0, 1, (n_items, rank))
    R = (U @ V.T).astype(np.float32)  # dense low-rank ratings
    g, part = trace(lambda: lrmf(n_items, rank=rank, lr=2e-3, merge_coef=16))
    eng = make_engine(g, part, device=CPU)
    assert eng.glm_template is None and not eng.use_fused_kernel
    models = init_models(g, np.random.default_rng(2), scale=0.1, device=CPU)

    Xb = torch.from_numpy(R).reshape(-1, 16, n_items, 1)
    Yb = torch.zeros((Xb.shape[0], 16))
    Mb = torch.ones((Xb.shape[0], 16))

    def recon_err(M):
        M = M.numpy()
        return float(np.linalg.norm(R - (R @ M) @ M.T) / np.linalg.norm(R))

    e0 = recon_err(models[0])
    for _ in range(60):
        models, _ = eng.run_epoch(models, Xb, Yb, Mb)
    e1 = recon_err(models[0])
    assert e1 < 0.55 * e0


def test_convergence_terminator():
    rng = np.random.default_rng(19)
    w_true = rng.normal(0, 1, 6)
    X = rng.normal(0, 1, (512, 6)).astype(np.float32)
    y = (X @ w_true).astype(np.float32)
    g, part = trace(
        lambda: linear_regression(6, lr=0.3, merge_coef=64, conv_factor=0.05,
                                  epochs=500)
    )
    eng = make_engine(g, part, device=CPU)
    models = init_models(g, device=CPU)
    Xb, Yb, Mb = _batchify(X, y, 64)
    for epoch in range(500):
        models, _ = eng.run_epoch(models, Xb, Yb, Mb)
        _, merged = eng.batch_step(models, Xb[0], Yb[0], Mb[0])
        if eng.converged(models, merged):
            break
    assert epoch < 400  # converged well before the cap
    np.testing.assert_allclose(models[0].numpy(), w_true, atol=0.05)


# ------------------------- against repro's Engine ---------------------------
@pytest.mark.parametrize("name,coef", [("linear", 32), ("logistic", 32), ("svm", 32),
                                       ("lrmf", 8)])
def test_run_epoch_matches_repro(name, coef):
    rng = np.random.default_rng(23)
    d = 12
    X = rng.normal(0, 1, (6 * coef, d)).astype(np.float32)
    if name == "logistic":
        y = (rng.uniform(size=6 * coef) > 0.5).astype(np.float32)
    else:
        y = np.sign(rng.normal(0, 1, 6 * coef)).astype(np.float32)
    mask = (rng.uniform(size=6 * coef) > 0.1).astype(np.float32)
    kw = dict(rank=3, lr=1e-2) if name == "lrmf" else dict(lr=0.1)
    gj, pj = jtranslator.trace(lambda: jalgos.ALGORITHMS[name](d, merge_coef=coef, **kw))
    g, part = trace(lambda: talgos.ALGORITHMS[name](d, merge_coef=coef, **kw))
    jeng = jengine.make_engine(gj, pj)
    teng = make_engine(g, part, device=CPU)
    assert teng.glm_template == jeng.glm_template
    jmodels = jengine.init_models(gj, np.random.default_rng(6), scale=0.1)
    tmodels = models_from_numpy([np.asarray(m) for m in jmodels], CPU)
    xs = X.reshape(6, coef, d)
    if name == "lrmf":
        xs = xs[..., None]
    ys, ms = y.reshape(6, coef), mask.reshape(6, coef)
    jm, jg = jeng.run_epoch(jmodels, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ms))
    tm, tg = teng.run_epoch(tmodels, torch.from_numpy(xs), torch.from_numpy(ys),
                            torch.from_numpy(ms))
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def linreg_heap(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_engine")
    rng = np.random.default_rng(5)
    w_true = rng.normal(0, 1, 16).astype(np.float32)
    X = rng.normal(0, 1, (3000, 16)).astype(np.float32)
    return write_table(str(tmp / "lin.heap"), X, X @ w_true, page_bytes=8192)


def test_run_chunk_matches_decode_then_epoch(linreg_heap):
    """run_chunk == separate decode + reshape + run_epoch."""
    heap = HeapFile(linreg_heap.path)
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64))
    eng = make_engine(g, part, device=CPU)
    models = init_models(g, np.random.default_rng(0), scale=0.01, device=CPU)
    pages = heap.read_pages(np.arange(heap.n_pages))
    feats, labels, mask = strider_ops.decode_pages(strider_ops.pages_tensor(pages),
                                                   heap.layout)
    t = feats.shape[0] * feats.shape[1]
    X, Y, M = batches_from_stream(
        feats.reshape(t, heap.layout.n_features), labels.reshape(t),
        mask.reshape(t), eng.merge_coef,
    )
    want, wantg = eng.run_epoch(models, X, Y, M)
    got, gotg = eng.run_chunk(models, pages, heap.layout)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gotg.numpy(), wantg.numpy(), rtol=1e-4, atol=1e-5)


def test_run_chunk_matches_repro(linreg_heap):
    """The port's chunk executor against repro's fused chunk program on the
    same heap pages and starting model."""
    heap = HeapFile(linreg_heap.path)
    pages = heap.read_pages(np.arange(heap.n_pages))
    gj, pj = jtranslator.trace(lambda: jalgos.linear_regression(16, lr=0.3, merge_coef=64))
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64))
    jeng = jengine.make_engine(gj, pj)
    teng = make_engine(g, part, device=CPU)
    jmodels = jengine.init_models(gj, np.random.default_rng(0), scale=0.01)
    tmodels = models_from_numpy([np.asarray(m) for m in jmodels], CPU)
    jm, jg = jeng.run_chunk(jmodels, pages, linreg_heap.layout)
    tm, tg = teng.run_chunk(tmodels, pages, heap.layout)
    np.testing.assert_allclose(tm[0].numpy(), np.asarray(jm[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_batches_from_stream_pads_to_whole_batches():
    feats = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    X, Y, M = batches_from_stream(feats, torch.ones(10), torch.ones(10), 4)
    assert X.shape == (3, 4, 3) and Y.shape == M.shape == (3, 4)
    assert M.reshape(-1)[10:].sum() == 0 and torch.equal(X.reshape(-1, 3)[:10], feats)


def test_make_engine_device_and_mesh_policy(monkeypatch):
    g, part = trace(lambda: linear_regression(4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(g, part)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_models(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models_from_numpy([np.zeros(4, np.float32)])
    with pytest.raises(NotImplementedError, match="distribution"):
        make_engine(g, part, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="distribution"):
        make_engine(g, part, shard_model=True, device=CPU)
    assert make_engine(g, part, device=CPU).device == torch.device("cpu")
