"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same CUDA tensors, the TRAIN and PREDICT paths on the card
against the same runs on the CPU, and the server's kernel path against its
gather path on the card. Marked ``cuda``; every test skips where no card is
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
from repro_torch.kernels.paged_attn import kernel as pa_kernel
from repro_torch.kernels.paged_attn import ref as pa_ref
from repro_torch.kernels.wkv import kernel as wkv_kernel
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv import ref as wkv_ref
from test_torch_paged_attn_cases import CASES as PA_CASES
from test_torch_paged_attn_cases import LATENT_CASES as PA_LATENT_CASES
from test_torch_paged_attn_cases import make as pa_case
from test_torch_predict_plan import CASES as PREDICT_CASES
from test_torch_predict_plan import make as predict_case
from test_torch_wkv_cases import CASES as WKV_CASES
from test_torch_wkv_cases import FULL as WKV_FULL
from test_torch_wkv_cases import GENERAL as WKV_GENERAL
from test_torch_wkv_cases import make as wkv_case

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


@pytest.mark.parametrize("act", glm_ref.ACTS)
@pytest.mark.parametrize("d,coef", [(1, 1), (5, 7), (54, 256), (129, 64), (2000, 7),
                                    (9001, 3)])
def test_glm_sgd_chunk_matches_plain(card, act, d, coef):
    n = 4 * coef + coef // 2 + 1  # a ragged last batch
    rng = np.random.default_rng(d + coef)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
    if act == "logistic":
        y = (y > 0).astype(np.float32)
    w = rng.normal(0, 0.3, d).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    x[mask == 0] = 99.0  # dead rows must not contribute
    a, b = 1.0 - 1e-3, 0.5 / (coef * d)
    x, y, mask, w = (torch.from_numpy(v).to(card) for v in (x, y, mask, w))
    launches = glm_kernel.glm_sgd_chunk.launches
    got = glm_kernel.glm_sgd_chunk(x, y, mask, w, coef, act, a, b)
    assert glm_kernel.glm_sgd_chunk.launches == launches + 1
    want = glm_ref.glm_sgd_chunk_ref(x, y, mask, w, coef, act, a, b)
    assert got[1].shape == (-(-n // coef),)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-4)
    again = glm_kernel.glm_sgd_chunk(x, y, mask, w, coef, act, a, b)
    assert all(_same_bits(g, h) for g, h in zip(got, again))  # deterministic


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
    walks = glm_kernel.glm_sgd_chunk.launches
    strider = strider_kernel.strider_decode.launches
    a = solver.train(g, part, heap, mode="dana", seed=1)
    chunks = -(-heap.n_pages // solver.MAX_RESIDENT_PAGES)
    assert glm_kernel.glm_sgd_chunk.launches - walks == 3 * chunks  # one per chunk
    assert glm_kernel.glm_grad.launches == glm
    assert strider_kernel.strider_decode.launches - strider == 3 * chunks
    b = solver.train(g, part, heap, mode="dana", seed=1, device="cpu")
    assert a.device_syncs == b.device_syncs == 3
    np.testing.assert_allclose(a.models[0], b.models[0], rtol=1e-4, atol=1e-5)


def test_sharded_epochs_on_two_gloo_ranks_of_one_card(card, tmp_path):
    """Two gloo ranks on cuda:0 (tests/test_torch_dist_util.py's engine
    case): the data mesh (2 x 1) launches B2's glm_grad a merge batch and
    never the vmap thread path, the model mesh (1 x 2) holds w Shard(0),
    LRMF takes the gspmd path, the solver trains on the model mesh; only
    all_reduce and broadcast are issued (gloo on CUDA runs nothing else),
    and each result is held against the unsharded card run."""
    import test_torch_dist_util as dist_util
    from repro_torch.algorithms import lrmf
    from repro_torch.core.engine import init_models, make_engine

    inp = dist_util.toy_inputs()
    write_table(str(tmp_path / "t.heap"), inp["Xt"], inp["yt"], page_bytes=8192)
    started = dist_util.start("engine", 2, str(tmp_path), device="cuda")
    try:
        g, part = trace(lambda: logistic_regression(16, lr=0.3, merge_coef=64))
        eng = make_engine(g, part)
        Xb = torch.from_numpy(inp["X"]).reshape(-1, 64, 16).cuda()
        Yb = torch.from_numpy(inp["y"]).reshape(-1, 64).cuda()
        want, wantg = eng.run_epoch(init_models(g), Xb, Yb, torch.ones_like(Yb))
        gm, pm = trace(lambda: lrmf(24, rank=4, lr=1e-2, merge_coef=8))
        Rb = torch.from_numpy(inp["R"]).reshape(-1, 8, 24).cuda()
        m0 = init_models(gm, np.random.default_rng(1), scale=0.05)
        wantm, _ = make_engine(gm, pm).run_epoch(m0, Rb, torch.zeros(Rb.shape[:2], device="cuda"),
                                                 torch.ones(Rb.shape[:2], device="cuda"))
        gt, pt = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64, epochs=4))
        base = solver.train(gt, pt, HeapFile(str(tmp_path / "t.heap")), mode="dana", seed=2)
    finally:
        ranks = dist_util.collect(started)
    for rank, r in enumerate(ranks):
        data, model = r["data"], r["model"]
        assert data["path"] == ("shard_map", ("data",), None)
        assert data["calls"] == data["launches"] == 16  # B2 a batch on each rank
        assert data["collectives"] == {"all_reduce": 16, "broadcast": 0}
        np.testing.assert_allclose(data["w"], want[0].cpu().numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(data["gnorms"], wantg.cpu().numpy(), rtol=1e-3, atol=1e-4)
        assert model["mesh"] == {"data": 1, "model": 2}
        assert model["path"] == ("shard_map", (), "model")
        assert model["placements"] == ["R", "S(0)"]
        np.testing.assert_allclose(model["local"], model["w"][8 * rank:8 * rank + 8])
        np.testing.assert_allclose(model["w"], want[0].cpu().numpy(), rtol=1e-4, atol=1e-5)
        assert r["lrmf"]["path"] == ("gspmd", (), None)
        assert r["lrmf"]["placements"] == ["R", "S(0)"]
        np.testing.assert_allclose(r["lrmf"]["M"], wantm[0].cpu().numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert r["train"]["device_syncs"] == r["train"]["epochs_run"] == 4
        np.testing.assert_allclose(r["train"]["w"], base.models[0], rtol=1e-4, atol=1e-5)
        assert r["forbidden"] == []
    for key in (("data", "w"), ("model", "w"), ("lrmf", "M"), ("train", "w")):
        assert np.array_equal(ranks[0][key[0]][key[1]], ranks[1][key[0]][key[1]]), key


def test_lm_train_on_two_gloo_ranks_of_one_card(card, tmp_path):
    """Reduced rwkv6-3b (f32 activations) on two gloo ranks of cuda:0
    (tests/test_torch_dist_util.py's lm_card case), on (2 x 1) and (1 x 2),
    through ``train_loop.run(param_specs=)``: the async checkpointer on the
    mesh, then a resume placed with the mesh's shardings. B6 and B6-bwd
    launched on each rank, the losses and gradient norms at the bounds of
    the single-card train-loop test, the weights at F32_GRAD of the
    unsharded card run, the weights placed on the model axis, the same bits
    on both ranks, and only all_reduce and broadcast."""
    import test_torch_dist_util as dist_util
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.models.params import leaves, tree_map

    cfg = get_reduced_config("rwkv6-3b")
    p, _ = model_zoo.init_params(cfg, 0, "cpu", dtype=torch.float32)
    weights = tree_map(lambda t: t.numpy(), p)
    torch.save(weights, str(tmp_path / "lm_card_weights.pt"))
    started = dist_util.start("lm_card", 2, str(tmp_path), device="cuda")
    try:
        want = dist_util.lm_card_run(cfg, weights, card, str(tmp_path / "ck_unsharded"))
    finally:
        ranks = dist_util.collect(started)
    steps, layers = dist_util.LM_CARD_STEPS, cfg.n_layers
    # no remat: one forward and one backward launch a layer a step
    assert want["launches"] == {"wkv": layers * steps, "wkv_bwd": layers * steps}
    for r in ranks:
        for name in ("data", "model"):
            got = r[name]
            assert got["launches"] == want["launches"], name
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
            np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-3)
            for key, v in got["params"].items():
                np.testing.assert_allclose(v, want["params"][key], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} {key}")
            assert set(got["collectives"]) == {"all_reduce", "broadcast"}
        assert r["forbidden"] == []
    assert ranks[0]["data"]["collectives"]["all_reduce"] > 0  # the data mesh sums
    assert ranks[0]["model"]["placements"]["embed/table"] == ["R", "S(0)"]  # vocab on model
    for name in ("data", "model"):
        for key, v in ranks[0][name]["params"].items():
            assert np.array_equal(v, ranks[1][name]["params"][key]), (name, key)
    assert len(list(leaves(p))) == len(ranks[0]["data"]["params"])


def test_sharded_server_on_two_gloo_ranks_of_one_card(card, tmp_path):
    """Reduced internlm2-20b served by two gloo ranks of cuda:0
    (tests/test_torch_dist_util.py's serve_card case): on (1 x 2) the kernel
    path with the pool replicated and the KV heads split, B5 launched on
    each rank at half the heads once a layer a fused step; on (2 x 1) dense
    caches through the gather path with the slots over data. Each gives
    the unsharded card server's tokens on every rank, with no disagreement
    with rank 0 and only all_reduce and broadcast."""
    import test_torch_dist_util as dist_util
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.models.params import params_from_numpy, tree_map
    from repro_torch.serve.serving import BatchedServer, Request

    cfg = get_reduced_config("internlm2-20b")
    p, _ = model_zoo.init_params(cfg, 2, "cpu", dtype=torch.float32)
    weights = {"internlm2-20b": tree_map(lambda t: t.numpy(), p)}
    torch.save(weights, str(tmp_path / "serve_weights.pt"))
    started = dist_util.start("serve_card", 2, str(tmp_path), device="cuda")
    try:
        tp = params_from_numpy(cfg, weights["internlm2-20b"], device=card)
        want = {}
        for name, kw in (("kernel", dist_util.KERNEL), ("dense", {})):
            srv = BatchedServer(cfg, tp, batch_slots=dist_util.SERVE_SLOTS,
                                max_seq=dist_util.SERVE_MAX_SEQ, device=card, **kw)
            want[name] = dist_util.run_arrivals(srv, dist_util.SERVE_STREAM, Request)
    finally:
        ranks = dist_util.collect(started)
    for r in ranks:
        kern, dense = r["kernel"], r["dense"]
        assert kern["path"] == ("gspmd", (), "model") and kern["attn_impl"] == "kernel"
        assert kern["layout"][0]["k"][0] == ["R", "S(3)"]
        assert kern["layout"][0]["k"][1][3] == cfg.n_kv_heads // 2
        assert kern["launches"] == cfg.n_layers * kern["steps"]
        assert dense["path"] == ("gspmd", ("data",), None)
        assert dense["layout"][0]["k"][0] == ["S(1)", "R"]
        for name in ("kernel", "dense"):
            assert r[name]["outs"] == want[name], name
            assert r[name]["disagreements"] == 0 and r[name]["finished"] == 5
            assert set(r[name]["collectives"]) == {"all_reduce", "broadcast"}
        assert r["forbidden"] == []


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
@pytest.mark.parametrize("name,n,d,kind", PREDICT_CASES, ids=[c[0] for c in PREDICT_CASES])
def test_predict_kernel_matches_plain(card, act, name, n, d, kind):
    buf, w, mask = predict_case(n, d, kind)
    buf, w, mask = (torch.from_numpy(a).to(card) for a in (buf, w, mask))
    x = buf[1:] if kind == "misaligned" else buf
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (kind == "misaligned")
    launches = glm_kernel.glm_predict.launches
    got = glm_kernel.glm_predict(x, w, mask, act)
    assert glm_kernel.glm_predict.launches == launches + 1
    plain = glm_ref.glm_predict_ref(x, w, mask, act)
    assert torch.isfinite(got).all() and not got[mask == 0].any()
    torch.testing.assert_close(got, plain, rtol=0, atol=2e-6)
    if act == "svm":
        assert torch.equal(got, plain)
    assert torch.equal(got, glm_kernel.glm_predict(x, w, mask, act))  # deterministic
    # the chunk program's bool keep mask: the same bits as its f32 form
    assert _same_bits(glm_kernel.glm_predict(x, w, mask > 0, act), got)


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


def _paged_attn_on_card(card, case, with_runs=False):
    q, k, v, table, pos, kw, bf16, runs = case
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.from_numpy(a).to(card, dt) for a in (q, k, v))
    table, pos = torch.from_numpy(table).to(card), torch.from_numpy(pos).to(card)
    runs = torch.from_numpy(runs).to(card) if with_runs else None
    launches = pa_kernel.paged_attention.launches
    got = pa_kernel.paged_attention(q, k, v, table, pos, runs=runs, **kw)
    assert pa_kernel.paged_attention.launches == launches + 1
    torch.testing.assert_close(got, pa_ref.paged_attn_ref(q, k, v, table, pos, **kw),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(got, pa_kernel.paged_attention(q, k, v, table, pos, runs=runs, **kw))


@pytest.mark.parametrize("name", sorted(PA_CASES))
def test_paged_attn_kernel_matches_plain(card, name):
    _paged_attn_on_card(card, PA_CASES[name]())


@pytest.mark.parametrize("name", sorted(PA_CASES))
def test_paged_attn_kernel_with_runs_matches_plain(card, name):
    """Each case's runs given to the kernel (one row each where the case has
    none): the same function, at the same tolerance, the same bits twice."""
    _paged_attn_on_card(card, PA_CASES[name](), with_runs=True)


@pytest.mark.parametrize("g,dk,dv", [(40, 288, 256), (128, 576, 512)])
def test_paged_attn_kernel_mla_shapes(card, g, dk, dv):
    """The absorbed-MLA call shapes: one kv head, G = n_heads, Dk = kv_lora +
    rope, Dv = kv_lora, bf16 pools of 16-row blocks."""
    _paged_attn_on_card(card, pa_case(t=7, kvh=1, g=g, dk=dk, dv=dv, nb_slot=8, bs=16,
                                      num_blocks=64, seed=g, bf16=True,
                                      scale=1 / np.sqrt(dk)))
    assert pa_kernel.paged_attention.body == "tiled"


@pytest.mark.parametrize("split_rows", [None, 32, 64, 128], ids=["host", "s32", "s64", "s128"])
@pytest.mark.parametrize("with_runs", [False, True], ids=["no_runs", "runs"])
@pytest.mark.parametrize("name", sorted(PA_LATENT_CASES))
def test_paged_latent_kernel_matches_plain(card, name, with_runs, split_rows):
    """The latent entry (the absorbed-MLA call over the pools c and kr) on
    its body against its plain version, with and without the case's runs, at
    the host's context split and at each one the kernel takes: minicpm3-4b's
    (H 40, Dc 256, Dr 32) and deepseek-v3's (H 128, Dc 512, Dr 64) shapes
    among the cases; the same bits on a second call."""
    q, c, kr, table, pos, kw, _, runs = PA_LATENT_CASES[name]()
    q, c, kr = (torch.from_numpy(a).to(card, torch.bfloat16) for a in (q, c, kr))
    table, pos = torch.from_numpy(table).to(card), torch.from_numpy(pos).to(card)
    runs = torch.from_numpy(runs).to(card) if with_runs else None
    launches = pa_kernel.paged_latent_attention.launches
    got = pa_kernel.paged_latent_attention(q, c, kr, table, pos, runs=runs,
                                           split_rows=split_rows, **kw)
    assert pa_kernel.paged_latent_attention.launches == launches + 1
    assert pa_kernel.paged_latent_attention.body == "latent"
    torch.testing.assert_close(got, pa_ref.paged_latent_attn_ref(q, c, kr, table, pos, **kw),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(got, pa_kernel.paged_latent_attention(q, c, kr, table, pos, runs=runs,
                                                             split_rows=split_rows, **kw))


def test_server_kernel_path_matches_gather_on_card(card):
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer, Request

    cfg = get_reduced_config("mistral-nemo-12b")
    params, _ = model_zoo.init_params(cfg, seed=2, device=card)
    stream = [([5, 6, 7, 8], 9), ([1, 2], 3), ([9, 3, 9, 4], 5), ([2, 7], 4)]

    def serve(impl):
        srv = BatchedServer(cfg, params, batch_slots=2, max_seq=24, kv="paged",
                            block_size=4, step_mode="tokens", prefill_chunk=4,
                            attn_impl=impl, device=card)
        for i, (p, n) in enumerate(stream):
            srv.submit(Request(i, list(p), n))
        return [r.out for r in srv.run()]

    launches = pa_kernel.paged_attention.launches
    assert serve("kernel") == serve("gather")
    assert pa_kernel.paged_attention.launches > launches


def test_paged_attn_kernel_on_hymbas_wrapped_ring(card):
    """One of hymba-1.5b's sliding-window calls as its server makes them: 16
    slots, one row each (chunked stepping), KVH 5, G 5, D 64, bf16 pools of
    16-row blocks, a ring of 1,024 rows (64 blocks a slot) that every slot
    has passed (positions 1,024-1,087), with and without runs."""
    pos = np.array([1024, 1025, 1030, 1039, 1040, 1041, 1047, 1050, 1055, 1060, 1064, 1070,
                    1075, 1080, 1086, 1087])
    case = pa_case(t=16, kvh=5, g=5, dk=64, dv=64, bs=16, nb_slot=64, num_blocks=16 * 64 + 8,
                   ring_width=1024, seed=41, bf16=True, scale=64 ** -0.5, pos=pos)
    _paged_attn_on_card(card, case)
    _paged_attn_on_card(card, case, with_runs=True)
    assert pa_kernel.paged_attention.body == "split"


def test_paged_attn_kernel_at_internvl2s_call(card):
    """internvl2-26b's call as its server makes it: KVH 8, G 6, D 128, bf16
    pools of 16-row blocks, 1,088 rows a slot; one slot's prefill chunk of
    16 rows (one run) beside 8 decode rows at positions 0-1,087, with and
    without runs."""
    nb_slot, rng = 68, np.random.default_rng(43)
    tables = rng.permutation(9 * nb_slot).reshape(9, nb_slot)
    table = np.concatenate([np.repeat(tables[:1], 16, 0), tables[1:]])
    pos = np.concatenate([np.arange(500, 516), [0, 15, 16, 255, 700, 1000, 1040, 1087]])
    runs = [(0, 16)] + [(16 + i, 1) for i in range(8)]
    case = pa_case(t=24, kvh=8, g=6, dk=128, dv=128, bs=16, nb_slot=nb_slot,
                   num_blocks=9 * nb_slot + 8, seed=43, bf16=True, scale=128 ** -0.5,
                   pos=pos, table=table, runs=runs)
    _paged_attn_on_card(card, case)
    _paged_attn_on_card(card, case, with_runs=True)
    assert pa_kernel.paged_attention.body == "split"


def test_encdec_prefill_equals_decode_on_card(card):
    """Reduced seamless-m4t-medium on the card (bf16 weights from seed 4):
    prefill's last logits against as many decode steps over the source's
    precomputed cross K/V, at the reference's tolerance (3e-2, an equal
    argmax), as ``test_torch_encdec_decode.py`` holds them on the CPU."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import encdec, model_zoo

    cfg = get_reduced_config("seamless-m4t-medium")
    params, _ = model_zoo.init_params(cfg, seed=4, device=card)
    rng = np.random.default_rng(9)
    seq = 24
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, seq)).astype(np.int32))
    frames = torch.from_numpy(rng.normal(0, 1, (2, seq, cfg.d_model)).astype(np.float32))
    tokens, frames = tokens.to(card), frames.to(card)
    with torch.no_grad():
        want = model_zoo.prefill_fn(cfg)(params, {"tokens": tokens, "frames": frames}).float()
        cache = model_zoo.make_cache(cfg, 2, seq, card)
        enc_out = encdec.encode(params, frames, cfg, remat="none")
        cache["xk"][:], cache["xv"][:] = encdec.precompute_cross_kv(params, enc_out, cfg)
        step = model_zoo.decode_fn(cfg)
        for t in range(seq):
            logits, cache = step(params, tokens[:, t], cache, t)
    got = logits.float()
    assert got.device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_server_hybrid_kernel_path_matches_gather_on_card(card):
    """Reduced hymba with one global layer (the other a sliding-window layer
    of window 16, on the ring pool): the kernel path's tokens equal the
    gather path's on a stream whose positions pass the window; B5 runs
    every layer of every sub-step."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer, Request

    cfg = get_reduced_config("hymba-1.5b", n_global_layers=1)
    params, _ = model_zoo.init_params(cfg, seed=2, device=card)
    stream = [([5, 6, 7, 8], 9), ([1, 2], 3), ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 12), ([2, 7], 4)]

    def serve(impl):
        srv = BatchedServer(cfg, params, batch_slots=2, max_seq=24, kv="paged",
                            block_size=4, step_mode="tokens", prefill_chunk=4,
                            attn_impl=impl, device=card)
        assert srv.step_mode == "chunked" and srv._paged.ring_width == 16
        for i, (p, n) in enumerate(stream):
            srv.submit(Request(i, list(p), n))
        return [r.out for r in srv.run()], srv.metrics.steps

    launches = pa_kernel.paged_attention.launches
    (kernel, steps), (gather, _) = serve("kernel"), serve("gather")
    assert kernel == gather
    assert pa_kernel.paged_attention.launches - launches == steps * 4 * cfg.n_layers


def _paged_teacher_forced(cfg, params, seq, impl, card, bs=4):
    """Logits (f32, true vocab) of ``seq`` teacher-forced one token a call
    through one slot's paged decode on ``impl``'s read path, on the device
    ``card`` (the CPU's ``kernel`` path is the plain version)."""
    from repro_torch.models import model_zoo

    nb = -(-len(seq) // bs)
    cache = model_zoo.make_paged_cache(cfg, nb, bs, card)
    ctx = {"table": torch.arange(nb, dtype=torch.int32, device=card)[None], "block_size": bs,
           "write_ok": torch.ones(1, dtype=torch.bool, device=card), "max_seq": len(seq),
           "impl": impl}
    decode = model_zoo.decode_fn(cfg)
    out = []
    for pos, tok in enumerate(seq):
        logits, _ = decode(params, torch.tensor([tok], dtype=torch.int32, device=card), cache,
                           torch.tensor([pos], dtype=torch.int32, device=card), paged=ctx)
        out.append(logits[0, :cfg.vocab_size].float())
    return torch.stack(out)


def _assert_near_tie(cfg, params, prompt, got, want, card):
    """``got`` (the kernel path's tokens) equals ``want`` (the gather
    path's) except at a near-tie, as ``assert_greedy_matches`` defines one,
    with the two read paths of the port in place of the two packages: at
    the first divergence the gather path's top-2 margin is below the largest
    spread of the two paths' logit difference along the common history,
    which stays within DEVIATION_LIMIT."""
    from test_torch_serve_util import DEVIATION_LIMIT

    assert len(got) == len(want)
    if got == want:
        return
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = list(prompt) + list(want[:k])
    kl = _paged_teacher_forced(cfg, params, seq, "kernel", card)
    gl = _paged_teacher_forced(cfg, params, seq, "gather", card)
    top = torch.topk(gl[-1], 2).values
    margin = float(top[0] - top[1])
    delta = kl - gl
    deviation = float((delta.amax(1) - delta.amin(1)).max())
    assert deviation <= DEVIATION_LIMIT, ("logits deviate", k, deviation)
    assert margin < deviation, (k, margin, deviation, got, want)
    print(f"near-tie at token {k}: gather margin {margin:.4g} < deviation {deviation:.4g}")


def test_server_mla_kernel_path_matches_gather_on_card(card):
    """Reduced minicpm3-4b at its full latent widths (kv_lora 256, rope 32):
    the absorbed decode hands B5's latent entry the cache's c and kr pools
    (Dk 288, Dv 256), which take the latent body, one kernel a call (a table
    of 24 rows is one context split, so no merge), and never the generic
    entry."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer, Request

    cfg = get_reduced_config("minicpm3-4b", kv_lora_rank=256, qk_rope_head_dim=32)
    params, _ = model_zoo.init_params(cfg, seed=2, device=card)
    stream = [([5, 6, 7, 8], 9), ([1, 2], 3), ([9, 3, 9, 4], 5), ([2, 7], 4)]

    def serve(impl):
        srv = BatchedServer(cfg, params, batch_slots=2, max_seq=24, kv="paged",
                            block_size=4, step_mode="tokens", prefill_chunk=4,
                            attn_impl=impl, device=card)
        for i, (p, n) in enumerate(stream):
            srv.submit(Request(i, list(p), n))
        return [r.out for r in srv.run()]

    launches = pa_kernel.paged_latent_attention.launches
    generic = pa_kernel.paged_attention.launches
    kernel = serve("kernel")
    assert pa_kernel.paged_latent_attention.launches > launches
    assert pa_kernel.paged_attention.launches == generic
    assert pa_kernel.paged_latent_attention.body == "latent"
    assert pa_kernel.paged_latent_attention.kernels == 1
    for (prompt, _), got, want in zip(stream, kernel, serve("gather")):
        _assert_near_tie(cfg, params, prompt, got, want, card)


def test_lm_predict_on_card_matches_generate_greedy(card, tmp_path):
    """LM PREDICT over a token table on the card, one chunk a page: B3 runs
    once a chunk, and the kept prompts' tokens equal generate_greedy's on
    the same card (the default slot count equals the kept prompts' count
    here, so both run the same batch shapes)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.db.query import register_lm_udf
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import generate_greedy

    cfg = get_reduced_config("mistral-nemo-12b")
    params, _ = model_zoo.init_params(cfg, seed=3, device=card)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(8, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(3, 12, 24)]
    for i in range(0, 24, 4):
        prompts[i][0] = 7
    path = str(tmp_path / "p.heap")
    heap = write_token_table(path, prompts, page_bytes=512)
    cat = Catalog(str(tmp_path / "cat"))
    cat.register_table("p", path, {"kind": "tokens"})
    register_lm_udf(cat, "lm", cfg, params)
    launches = strider_kernel.strider_decode_projected.launches
    res = execute("SELECT * FROM dana.predict('lm', 'p') "
                  "WHERE c0 = 7 AND label >= 8 OR label >= 11;",
                  cat, chunk_pages=1, max_new_tokens=5, device=card)
    assert heap.n_pages > 1
    assert strider_kernel.strider_decode_projected.launches == launches + heap.n_pages
    kept = [p for p in prompts if p[0] == 7 and len(p) >= 8 or len(p) >= 11]
    assert 0 < len(kept) <= 8 and res.n_rows == len(kept)
    assert res.rows_filtered == len(prompts) - len(kept)
    assert res.predictions == generate_greedy(cfg, params, kept, 5, device=card)


# ------------------------------- WKV6 (B6, B6-bwd) ----------------------------
WKV_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 outputs: the kernel's and the plain version's f32 results round to bf16
# one step apart at most (a step is 2^-7 of the value)
WKV_BF16_TOL = dict(rtol=8e-3, atol=2e-4)
WKV_NAMES = sorted(WKV_CASES) + ["full"]


def _wkv_on(card, name, dtype=torch.float32, seed=7):
    """A case's inputs on the card, r/k/v in ``dtype``, and cotangents for
    y and the final state."""
    *arrs, chunk = wkv_case(WKV_FULL if name == "full" else name)
    r, k, v, lw, u, s0 = (torch.from_numpy(a).to(card) for a in arrs)
    r, k, v = (x.to(dtype) for x in (r, k, v))
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.normal(0, 1, (*r.shape[:3], v.shape[-1])).astype(np.float32))
    ds = torch.from_numpy(rng.normal(0, 1, s0.shape).astype(np.float32))
    return (r, k, v, lw, u, s0), chunk, dy.to(card, dtype), ds.to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", WKV_NAMES)
def test_wkv_kernel_matches_plain(card, name, dtype):
    ins, chunk, _, _ = _wkv_on(card, name, dtype)
    launches = wkv_kernel.wkv_forward.launches
    y, s, states = wkv_kernel.wkv_forward(*ins, chunk, save_states=True)
    assert wkv_kernel.wkv_forward.launches == launches + 1
    y_ref, s_ref = wkv_ref.wkv_chunked_ref(*ins, chunk)
    assert y.dtype == dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(),
                               **(WKV_TOL if dtype == torch.float32 else WKV_BF16_TOL))
    torch.testing.assert_close(s, s_ref, **WKV_TOL)
    # the saved chunk states: the first is the initial state bit for bit,
    # every one is the plain version's
    r, k, v, lw, u, s0 = ins
    b, _, h, kd = r.shape
    assert torch.equal(states[:, 0], s0.reshape(b * h, kd, -1))
    states_ref, _ = wkv_ref.wkv_chunk_states_ref(k, v, lw, s0, chunk)
    torch.testing.assert_close(states, states_ref, **WKV_TOL)
    y2, s2, _ = wkv_kernel.wkv_forward(*ins, chunk)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", WKV_NAMES)
def test_wkv_kernel_without_saved_states_gives_the_same_bits(card, name, dtype):
    """The output pass reads the chunk states either way: without
    save_states they are scratch, and y and the final state keep their bits."""
    ins, chunk, _, _ = _wkv_on(card, name, dtype)
    y, s, states = wkv_kernel.wkv_forward(*ins, chunk, save_states=True)
    y2, s2, none = wkv_kernel.wkv_forward(*ins, chunk, save_states=False)
    assert none is None and states is not None
    assert _same_bits(y.float(), y2.float()) and _same_bits(s, s2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(WKV_GENERAL) + ["misaligned"])
def test_wkv_kernel_general_paths(card, name, dtype):
    """Shapes off the training shape's grid, and inputs one element off their
    16-byte alignment (the same values), through the general paths of the
    forward and the backward."""
    case = "chunk8" if name == "misaligned" else WKV_GENERAL[name]
    *arrs, chunk = wkv_case(case)
    rng = np.random.default_rng(7)
    arrs += [rng.normal(0, 1, (*arrs[0].shape[:3], arrs[2].shape[-1])).astype(np.float32),
             rng.normal(0, 1, arrs[5].shape).astype(np.float32)]
    ins = []
    for i, a in enumerate(arrs):  # r, k, v, lw, u, s0, dy, ds
        x = torch.from_numpy(a).to(card)
        x = x.to(dtype) if i < 3 or i == 6 else x
        if name == "misaligned":
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
            x = buf[1:].view(x.shape).copy_(x)
        ins.append(x)
    ins, dy, ds = ins[:6], ins[6], ins[7]
    y, s, states = wkv_kernel.wkv_forward(*ins, chunk, save_states=True)
    y_ref, s_ref = wkv_ref.wkv_chunked_ref(*ins, chunk)
    states_ref, _ = wkv_ref.wkv_chunk_states_ref(*ins[1:4], ins[5], chunk)
    torch.testing.assert_close(y.float(), y_ref.float(),
                               **(WKV_TOL if dtype == torch.float32 else WKV_BF16_TOL))
    torch.testing.assert_close(s, s_ref, **WKV_TOL)
    torch.testing.assert_close(states, states_ref, **WKV_TOL)
    assert all(torch.equal(a, b) for a, b in
               zip((y, s, states), wkv_kernel.wkv_forward(*ins, chunk, save_states=True)))
    if name == "misaligned":  # the chunk states as the forward left them, off alignment
        buf = torch.empty(states.numel() + 1, dtype=states.dtype, device=card)
        states = buf[1:].view(states.shape).copy_(states)
    got = wkv_kernel.wkv_backward(*ins, states, s, dy, ds, chunk, save_dstates=True)
    want = wkv_ref.wkv_bwd_ref(*ins, chunk, dy, ds)
    want_dstates, _ = wkv_ref.wkv_chunk_dstates_ref(ins[0], ins[3], dy, ds, chunk)
    for name_, g, w in zip(("dr", "dk", "dv", "dlw", "du", "ds0", "dstates"), got,
                           (*want, want_dstates)):
        tol = WKV_BF16_TOL if g.dtype == torch.bfloat16 else WKV_TOL
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=lambda m: f"{name_}: {m}")
    again = wkv_kernel.wkv_backward(*ins, states, s, dy, ds, chunk, save_dstates=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", WKV_NAMES)
def test_wkv_bwd_kernel_matches_plain(card, name, dtype):
    ins, chunk, dy, ds = _wkv_on(card, name, dtype)
    _, s, states = wkv_kernel.wkv_forward(*ins, chunk, save_states=True)
    launches = wkv_kernel.wkv_backward.launches
    got = wkv_kernel.wkv_backward(*ins, states, s, dy, ds, chunk, save_dstates=True)
    assert wkv_kernel.wkv_backward.launches == launches + 1
    want = wkv_ref.wkv_bwd_ref(*ins, chunk, dy, ds)
    for name_, g, w, x in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got, want, ins):
        assert g.dtype == x.dtype, name_
        tol = WKV_BF16_TOL if g.dtype == torch.bfloat16 else WKV_TOL
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=lambda m: f"{name_}: {m}")
    # the state-gradient pass's output: the gradient of the state after each
    # chunk, the last one the state cotangent bit for bit
    dstates = got[6]
    want_dstates, _ = wkv_ref.wkv_chunk_dstates_ref(ins[0], ins[3], dy, ds, chunk)
    torch.testing.assert_close(dstates, want_dstates, **WKV_TOL)
    assert torch.equal(dstates[:, -1], ds.reshape(dstates[:, -1].shape))
    again = wkv_kernel.wkv_backward(*ins, states, s, dy, ds, chunk)
    assert len(again) == 6
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # a missing state cotangent is a zero one
    none = wkv_kernel.wkv_backward(*ins, states, s, dy, None, chunk)
    zero = wkv_kernel.wkv_backward(*ins, states, s, dy, torch.zeros_like(ds), chunk)
    assert all(torch.equal(a, b) for a, b in zip(none, zero))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv_backward_info_at_training_shape(card, dtype):
    """B6-bwd's three kernels as the runtime reports them: the gradient pass
    holds at least three CTAs an SM at the training shape."""
    info = wkv_kernel.wkv_backward_info(64, 64, 32, dtype)
    assert set(info) == {"dstate_pass", "grad_pass", "du_reduce"}
    assert info["grad_pass"]["ctas_per_sm"] >= 3
    assert info["grad_pass"]["threads"] == 128 and info["dstate_pass"]["threads"] == 128
    assert all(v["registers"] > 0 and v["ctas_per_sm"] >= 1 for v in info.values())


def test_wkv_ops_differentiates_through_both_kernels(card):
    ins, chunk, dy, ds = _wkv_on(card, "chunk8")
    leaves = [x.clone().requires_grad_(True) for x in ins]
    fwd, bwd = wkv_kernel.wkv_forward.launches, wkv_kernel.wkv_backward.launches
    y, s = wkv_ops.wkv(*leaves, chunk)
    torch.autograd.backward([y, s], [dy, ds])
    assert (wkv_kernel.wkv_forward.launches, wkv_kernel.wkv_backward.launches) == \
        (fwd + 1, bwd + 1)
    want = wkv_ref.wkv_bwd_ref(*ins, chunk, dy, ds)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, **WKV_TOL)


def test_paged_attn_kernel_at_olmoes_call(card):
    """olmoe-1b-7b's call as its server makes it: 16 slots, one row each
    (chunked stepping), KVH 16, G 1, D 128, bf16 pools of 16-row blocks,
    contexts from one row to 1,088 (68 blocks a slot), with and without
    runs, on the split body."""
    pos = np.array([0, 1, 15, 16, 17, 100, 255, 256, 500, 777, 1000, 1023, 1040, 1050, 1086,
                    1087])
    case = pa_case(t=16, kvh=16, g=1, dk=128, dv=128, bs=16, nb_slot=68,
                   num_blocks=16 * 68 + 8, seed=43, bf16=True, scale=128 ** -0.5, pos=pos)
    _paged_attn_on_card(card, case)
    _paged_attn_on_card(card, case, with_runs=True)
    assert pa_kernel.paged_attention.body == "split"


def test_moe_backward_gives_the_same_bits_twice(card):
    """The MoE block's forward and backward on the card at olmoe's expert
    count and top-k (64 experts, top 8, capacity binding at the default
    factor), bf16: a second run gives the same bits in the output and in
    every gradient (the dispatch/combine pair gathers, no float atomics),
    and the gradients are the CPU run's within bf16 rounding."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), d_model=512, moe_d_ff=256)
    gen = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(512, 64, generator=gen) * 0.005,
         "wi": torch.randn(64, 512, 256, generator=gen) / 512 ** 0.5,
         "wg": torch.randn(64, 512, 256, generator=gen) / 512 ** 0.5,
         "wo": torch.randn(64, 256, 512, generator=gen) / 256 ** 0.5}
    x = torch.randn(4, 256, 512, generator=gen)
    dy = torch.randn(4, 256, 512, generator=gen)

    def run(device):
        leaves = {k: v.to(device, torch.bfloat16).requires_grad_() for k, v in p.items()}
        xx = x.to(device, torch.bfloat16).requires_grad_()
        routed = []
        out = moe.apply_moe(leaves, xx, cfg, routing_out=routed)
        out.backward(dy.to(device, torch.bfloat16))
        assert not routed[0].choice_ok.all()  # capacity binds
        return [out.detach(), xx.grad] + [leaves[k].grad for k in sorted(leaves)]

    first, second = run(card), run(card)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, b in zip(first, run("cpu")):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).norm() / b.norm()) < 2e-2


def test_server_deepseek_v3_on_card_matches_cpu(card):
    """Reduced deepseek-v3 (MLA at its latent widths, kv_lora 512 and rope
    64, beside a shared expert and routed experts) served on the card
    through B5's latent entry gives the CPU run's tokens (the same weights,
    the plain version of the entry), except at a near-tie. Capacity factor
    16, so a row's tokens depend on its own history only and the near-tie
    is measured teacher-forced; the deviation limit is DEVIATION_LIMIT
    doubled, as the reference doubles its parity tolerance for
    deepseek-v3."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer, Request
    from test_torch_serve_util import DEVIATION_LIMIT

    cfg = dataclasses.replace(
        get_reduced_config("deepseek-v3-671b", kv_lora_rank=512, qk_rope_head_dim=64),
        capacity_factor=16.0)
    cpu_params, _ = model_zoo.init_params(cfg, seed=2, device="cpu")
    params = {"cpu": cpu_params,
              "card": _tree_to(cpu_params, card)}
    stream = [([5, 6, 7, 8], 9), ([1, 2], 3), ([9, 3, 9, 4], 5), ([2, 7], 4)]

    def serve(where):
        srv = BatchedServer(cfg, params[where], batch_slots=2, max_seq=24, kv="paged",
                            block_size=4, step_mode="tokens", prefill_chunk=4,
                            attn_impl="kernel", device=card if where == "card" else "cpu")
        for i, (p, n) in enumerate(stream):
            srv.submit(Request(i, list(p), n))
        return [r.out for r in srv.run()]

    launches = pa_kernel.paged_latent_attention.launches
    got = serve("card")
    assert pa_kernel.paged_latent_attention.launches > launches
    assert pa_kernel.paged_latent_attention.body == "latent"
    for (prompt, _), g, w in zip(stream, got, serve("cpu")):
        assert len(g) == len(w)
        if g == w:
            continue
        k = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        seq = list(prompt) + list(w[:k])
        tl = _paged_teacher_forced(cfg, params["card"], seq, "kernel", card)
        cl = _paged_teacher_forced(cfg, params["cpu"], seq, "kernel", "cpu").to(card)
        top = torch.topk(cl[-1], 2).values
        margin, delta = float(top[0] - top[1]), tl - cl
        deviation = float((delta.amax(1) - delta.amin(1)).max())
        assert deviation <= 2 * DEVIATION_LIMIT, ("logits deviate", k, deviation)
        assert margin < deviation, (k, margin, deviation, g, w)
        print(f"near-tie at token {k}: CPU margin {margin:.4g} < deviation {deviation:.4g}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def test_roofline_prediction_of_a_train_step_on_card(card):
    """The dry-run's prediction of a small rwkv6 train step (meta tensors,
    one-rank mesh) against the same step on the card through B6 and
    B6-bwd: the predicted argument bytes are the card's bytes of weights,
    moments and inputs exactly, and the step is no shorter than the compute
    term at the H100's bf16 peak."""
    import time

    from repro_torch.configs import get_reduced_config
    from repro_torch.dist import meshes
    from repro_torch.launch import dryrun
    from repro_torch.models import model_zoo
    from repro_torch.roofline.analysis import H100
    from repro_torch.train.optimizer import OptConfig, adamw_init, make_train_step

    cfg = get_reduced_config("rwkv6-3b")
    shape = model_zoo.ShapeSpec("tiny", 256, 2, "train")
    pred = dryrun._lower_and_measure(cfg, shape, meshes.AbstractMesh((1, 1), ("data", "model")))
    params, _ = model_zoo.init_params(cfg, seed=0, device=card, dtype=torch.float32)
    opt = adamw_init(params, OptConfig())
    batch = model_zoo.demo_batch(cfg, shape.global_batch, shape.seq_len, device=card)
    storages = {}
    for t in torch.utils._pytree.tree_leaves((params, opt, batch)):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    assert pred["memory"]["argument_bytes"] == sum(storages.values())
    step = make_train_step(model_zoo.loss_fn(cfg, remat="full", wkv_impl="kernel"), OptConfig())
    wkv_kernel.wkv_forward.launches = wkv_kernel.wkv_backward.launches = 0
    step(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert seconds >= pred["cost"]["flops"] / H100.peak_flops
    assert torch.isfinite(metrics["loss"])
    assert wkv_kernel.wkv_forward.launches == 2 * 2 * cfg.n_layers
    assert wkv_kernel.wkv_backward.launches == 2 * cfg.n_layers
