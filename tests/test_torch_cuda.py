"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, and the TRAIN and PREDICT paths on the card
against the same runs on the CPU. Marked ``cuda``; every test skips where no card is
present. This file imports no JAX, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import linear_regression, logistic_regression
from repro_torch.core import solver, striders
from repro_torch.core.translator import trace
from repro_torch.db.catalog import Catalog
from repro_torch.db.executor import QueryExecutor
from repro_torch.db.query import execute, register_udf_from_trace
from repro_torch.db.heap import HeapFile, write_table, write_token_table
from repro_torch.db.page import PageLayout, build_pages, parse_page
from repro_torch.kernels.engine import kernel as glm_kernel
from repro_torch.kernels.engine import ref as glm_ref
from repro_torch.kernels.strider import kernel as strider_kernel
from repro_torch.kernels.strider import ops as strider_ops
from repro_torch.kernels.strider import ref as strider_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("page_kb", [8, 32, 128])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [1, 3, 54, 520])
def test_strider_kernel_bit_exact(card, d, quant, page_kb):
    layout = PageLayout(n_features=d, page_bytes=page_kb * 1024, quantized=quant)
    t = layout.tuples_per_page
    n = 2 * t + t // 2 + 1
    rng = np.random.default_rng(d + page_kb)
    feats = rng.normal(0, 2, (n, d)).astype(np.float32)
    labels = rng.normal(0, 2, n).astype(np.float32)
    pages = strider_ops.pages_tensor(build_pages(feats, labels, layout))
    launches = strider_kernel.strider_decode.launches
    got = strider_ops.decode_pages(pages.to(card), layout)
    assert strider_kernel.strider_decode.launches == launches + 1
    for g, p, h in zip(got, strider_ref.decode_pages_ref(pages.to(card), layout),
                       strider_ref.decode_pages_ref(pages, layout)):
        assert g.device.type == "cuda"
        assert _same_bits(g, p) and _same_bits(g.cpu(), h)


def test_strider_kernel_keeps_denormal_tokens(card, tmp_path):
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(str(tmp_path / "tok.heap"), seqs, page_bytes=8192)
    pages = strider_ops.pages_tensor(heap.read_all()).to(card)
    feats = strider_kernel.strider_decode(pages, heap.layout)[0].view(torch.int32).cpu()
    for i, s in enumerate(seqs):
        assert feats[0, i, : len(s)].tolist() == s


@pytest.mark.parametrize("act", glm_ref.ACTS)
@pytest.mark.parametrize("n,d", [(256, 54), (217, 31), (70_656, 54), (33, 1000)])
def test_glm_kernel_matches_plain(card, act, n, d):
    rng = np.random.default_rng(n + d)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
    w = rng.normal(0, 0.5, d).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    x[mask == 0] = 1e6  # dead rows must not contribute
    x, y, w, mask = (torch.from_numpy(a).to(card) for a in (x, y, w, mask))
    got = glm_kernel.glm_grad(x, y, w, mask, act)
    torch.testing.assert_close(got, glm_ref.glm_grad_ref(x, y, w, mask, act),
                               rtol=2e-5, atol=2e-4)
    assert torch.equal(got, glm_kernel.glm_grad(x, y, w, mask, act))  # deterministic


@pytest.mark.parametrize("algo,labels", [("linear", "real"), ("logistic", "01")])
def test_train_on_card_matches_cpu(card, tmp_path, algo, labels):
    rng = np.random.default_rng(4)
    X = rng.normal(0, 1, (3000, 16)).astype(np.float32)
    z = X @ rng.normal(0, 1, 16).astype(np.float32)
    y = z if labels == "real" else (z > 0).astype(np.float32)
    heap = write_table(str(tmp_path / "t.heap"), X, y, page_bytes=8192)
    fn = linear_regression if algo == "linear" else logistic_regression
    g, part = trace(lambda: fn(16, lr=0.1, merge_coef=64, epochs=3))
    glm = glm_kernel.glm_grad.launches
    strider = strider_kernel.strider_decode.launches
    a = solver.train(g, part, heap, mode="dana", seed=1)
    assert glm_kernel.glm_grad.launches - glm == 3 * -(-heap.n_pages * heap.layout
                                                       .tuples_per_page // 64)
    assert strider_kernel.strider_decode.launches - strider == 3
    b = solver.train(g, part, heap, mode="dana", seed=1, device="cpu")
    assert a.device_syncs == b.device_syncs == 3
    np.testing.assert_allclose(a.models[0], b.models[0], rtol=1e-4, atol=1e-5)


# plans over a d-column layout: one column, scattered runs, all, label only
def _plans(layout):
    d = layout.n_features
    cols = {"one": [d // 2], "scattered": sorted({0, d // 3, d // 3 + 1, d - 1} & set(range(d))),
            "all": range(d), "label_only": []}
    for name, c in cols.items():
        for label in (False, True):
            if c or label:
                yield f"{name}-label{int(label)}", striders.projection_plan(layout, c, label)


@pytest.mark.parametrize("page_kb", [8, 32, 128])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [1, 54, 520])
def test_projected_kernel_bit_exact(card, d, quant, page_kb):
    layout = PageLayout(n_features=d, page_bytes=page_kb * 1024, quantized=quant)
    t = layout.tuples_per_page
    n = 2 * t + t // 2 + 1
    rng = np.random.default_rng(d + page_kb + 7)
    feats = rng.normal(0, 2, (n, d)).astype(np.float32)
    labels = rng.normal(0, 2, n).astype(np.float32)
    pages = strider_ops.pages_tensor(build_pages(feats, labels, layout))
    dev = pages.to(card)
    for what, plan in _plans(layout):
        launches = strider_kernel.strider_decode_projected.launches
        got = strider_ops.decode_pages_projected(dev, layout, plan)
        assert strider_kernel.strider_decode_projected.launches == launches + 1, what
        assert got[0].shape == (pages.shape[0], t, plan.n_columns), what
        for g, p, h in zip(got, strider_ref.decode_pages_projected_ref(dev, layout, plan),
                           strider_ref.decode_pages_projected_ref(pages, layout, plan)):
            assert _same_bits(g, p) and _same_bits(g.cpu(), h), what


def test_projected_kernel_keeps_denormal_tokens(card, tmp_path):
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(str(tmp_path / "tok.heap"), seqs, page_bytes=8192)
    pages = strider_ops.pages_tensor(heap.read_all()).to(card)
    plan = striders.full_plan(heap.layout)
    got = strider_kernel.strider_decode_projected(pages, heap.layout, plan)
    want = strider_kernel.strider_decode(pages, heap.layout)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    for i, s in enumerate(seqs):
        assert got[0][0, i, : len(s)].view(torch.int32).tolist() == s


@pytest.mark.parametrize("act", glm_ref.ACTS)
@pytest.mark.parametrize("n,d", [(70_656, 54), (217, 31), (1, 1)])
def test_predict_kernel_matches_plain(card, act, n, d):
    rng = np.random.default_rng(n + d + 1)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    # |x.w| stays below ~4, where atol=2e-6 is about 8 f32 ulps
    w = rng.normal(0, 0.1, d).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    if n > 1:
        mask[0] = 1.0
        x[mask == 0] = 1e6
        x[np.flatnonzero(mask == 0)[::2]] = np.inf  # dead rows must come back 0
    x, w, mask = (torch.from_numpy(a).to(card) for a in (x, w, mask))
    launches = glm_kernel.glm_predict.launches
    got = glm_kernel.glm_predict(x, w, mask, act)
    assert glm_kernel.glm_predict.launches == launches + 1
    plain = glm_ref.glm_predict_ref(x, w, mask, act)
    assert torch.isfinite(got).all() and not got[mask == 0].any()
    torch.testing.assert_close(got, plain, rtol=0, atol=2e-6)
    if act == "svm":
        assert torch.equal(got, plain)
    assert torch.equal(got, glm_kernel.glm_predict(x, w, mask, act))  # deterministic


PREDICT_SQL = ("SELECT c0, c1 FROM dana.predict('udf', 'score_t') "
               "WHERE c2 > 0.0 OR c3 <= -0.5;")
AGG_SQL = ("SELECT COUNT(*), AVG(prediction), SUM(label) FROM "
           "dana.predict('udf', 'score_t') WHERE NOT c1 > 0.5;")


def _kept_columns(res):
    """The projected columns of a PREDICT's kept rows, read back from its
    result pages."""
    return np.concatenate([parse_page(p, res.result_layout)[0] for p in res.result_pages])


def _score_catalog(root, family="logistic", d=6, n=1500):
    rng = np.random.default_rng(5)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    z = X @ rng.normal(0, 1, d).astype(np.float32)
    y = (z > 0).astype(np.float32) if family == "logistic" else z
    Xs = rng.normal(0, 1, (n, d + 3)).astype(np.float32)
    htr = write_table(str(root / "train.heap"), X, y, page_bytes=8192)
    hs = write_table(str(root / "score.heap"), Xs, rng.normal(0, 1, n).astype(np.float32),
                     page_bytes=8192)
    cat = Catalog(str(root / "cat"))
    cat.register_table("train_t", htr.path, {"n_features": d})
    cat.register_table("score_t", hs.path, {"n_features": d + 3})
    fn = logistic_regression if family == "logistic" else linear_regression
    for udf in ("udf", "udf_bg"):
        register_udf_from_trace(cat, udf, lambda: fn(d, lr=0.1, merge_coef=32, epochs=3),
                                layout=htr.layout)
    execute("SELECT * FROM dana.udf('train_t');", cat, device="cpu", seed=0)
    return cat


@pytest.mark.parametrize("family", ["linear", "logistic"])
def test_predict_on_card_matches_cpu(card, tmp_path, family):
    cat = _score_catalog(tmp_path, family)
    b3 = strider_kernel.strider_decode_projected.launches
    b4 = glm_kernel.glm_predict.launches
    gpu = execute(PREDICT_SQL, cat, chunk_pages=2)
    n_chunks = -(-HeapFile(cat.table("score_t")["heap"]).n_pages // 2)
    assert strider_kernel.strider_decode_projected.launches - b3 == n_chunks
    assert glm_kernel.glm_predict.launches - b4 == n_chunks
    cpu = execute(PREDICT_SQL, cat, chunk_pages=2, device="cpu")
    assert gpu.device_syncs == cpu.device_syncs == 1 and gpu.n_rows == cpu.n_rows
    np.testing.assert_array_equal(_kept_columns(gpu), _kept_columns(cpu))
    np.testing.assert_allclose(gpu.predictions, cpu.predictions, rtol=0, atol=2e-6)
    ga = execute(AGG_SQL, cat, chunk_pages=2).aggregates
    ca = execute(AGG_SQL, cat, chunk_pages=2, device="cpu").aggregates
    assert ga["count(*)"] == ca["count(*)"]
    for k in ("avg(prediction)", "sum(label)"):
        np.testing.assert_allclose(ga[k], ca[k], rtol=1e-4)


def test_executor_on_card_interleaved_matches_serial(card, tmp_path):
    cat = _score_catalog(tmp_path)

    def run(**kw):
        ex = QueryExecutor(cat, chunk_pages=1, **kw)
        hs = [ex.submit("SELECT * FROM dana.udf_bg('train_t');", priority=2,
                        max_epochs=2, seed=0),
              ex.submit(PREDICT_SQL, priority=0), ex.submit(AGG_SQL, priority=0)]
        ex.drain()
        return [h.result for h in hs]

    serial = run(max_running=1, policy="fifo")
    inter = run(max_running=2, policy="priority")
    np.testing.assert_array_equal(serial[0].coefficients[0], inter[0].coefficients[0])
    np.testing.assert_array_equal(serial[1].predictions, inter[1].predictions)
    np.testing.assert_array_equal(serial[1].result_pages, inter[1].result_pages)
    assert serial[2].aggregates == inter[2].aggregates
    assert all(r.device_syncs == 1 for r in serial[1:] + inter[1:])
