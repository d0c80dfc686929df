"""Port scoring path (repro_torch.kernels.{strider,engine} scoring functions
and repro_torch.db.scoring) against repro on the same numpy inputs: the
projected decode bit for bit (against repro's plain version and its Pallas
kernel in interpret mode), GLM scoring within the reference's atol=2e-6, and
whole PREDICT statements through ``execute`` in both packages, with the
JAX-trained model carried into the port's catalog. The CUDA kernels are held
against the same plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.algorithms as jalgos
from repro.core import striders as jstriders
from repro.db.catalog import Catalog as JCatalog
from repro.db.heap import write_table as jwrite_table
from repro.db.page import PageLayout as JPageLayout
from repro.db.query import execute as jexecute
from repro.db.query import register_udf_from_trace as jregister
from repro.kernels.engine import ref as jeref
from repro.kernels.strider import ref as jsref
from repro.kernels.strider.strider import strider_decode as pallas_decode
from repro_torch import algorithms
from repro_torch.core import striders
from repro_torch.db import scoring
from repro_torch.db.catalog import Catalog
from repro_torch.db.heap import HeapFile
from repro_torch.db.page import PageLayout, build_pages, parse_page
from repro_torch.db.query import execute, parse, register_udf_from_trace, set_udf_model
from repro_torch.kernels.engine import kernel as ekernel
from repro_torch.kernels.engine import ops as eops
from repro_torch.kernels.engine import ref as eref
from repro_torch.kernels.strider import kernel as skernel
from repro_torch.kernels.strider import ops as sops
from repro_torch.kernels.strider import ref as sref

CPU = "cpu"
PAGE_BYTES = 8192
D = 6  # model columns; the scoring table has D + 4
FAMILIES = {"linear": "linear_regression", "logistic": "logistic_regression",
            "svm": "svm", "lrmf": "lrmf"}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


# ------------------------------ projected decode -----------------------------
PLAN_COLS = {"one": [4], "scattered": [0, 3, 4, 9], "all": list(range(11)), "none": []}


@pytest.mark.parametrize("cols,label", [(c, lab) for c in PLAN_COLS for lab in (True, False)
                                         if PLAN_COLS[c] or lab])
@pytest.mark.parametrize("quant", [False, True])
def test_projected_decode_bit_exact_vs_repro(quant, cols, label):
    lo = PageLayout(n_features=11, page_bytes=1024, quantized=quant)
    jlo = JPageLayout(n_features=11, page_bytes=1024, quantized=quant)
    rng = np.random.default_rng(7 + quant)
    n = 2 * lo.tuples_per_page + 5  # a partial last page
    pages = build_pages(rng.normal(0, 2, (n, 11)).astype(np.float32),
                        rng.normal(0, 2, n).astype(np.float32), lo)
    plan = striders.projection_plan(lo, PLAN_COLS[cols], label)
    jplan = jstriders.projection_plan(jlo, PLAN_COLS[cols], label)
    got = sops.decode_pages_projected(sops.pages_tensor(pages), lo, plan)
    assert got[0].shape == (pages.shape[0], lo.tuples_per_page, plan.n_columns)
    wants = [jsref.decode_pages_projected_ref(jnp.asarray(pages), jlo, jplan)]
    if plan.n_columns:
        wants.append(pallas_decode(jnp.asarray(pages), jlo, interpret=True, plan=jplan))
    else:  # the Pallas kernel concatenates the plan's runs: it needs one
        with pytest.raises(ValueError, match="concatenate"):
            pallas_decode(jnp.asarray(pages), jlo, interpret=True, plan=jplan)
    for want in wants:
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_plan_sources_name_each_columns_word_or_byte():
    for quant in (False, True):
        lo = PageLayout(n_features=11, page_bytes=1024, quantized=quant)
        plan = striders.projection_plan(lo, [9, 0, 4, 3], include_label=False)
        assert skernel.plan_sources(plan) == [0, 3, 4, 9]  # word (f32) or byte (int8)
    lo = PageLayout(n_features=11, page_bytes=1024)
    assert skernel.plan_sources(striders.projection_plan(lo, [], True)) == []


def test_projected_cuda_path_never_falls_back(monkeypatch):
    lo = PageLayout(n_features=5, page_bytes=1024)
    plan = striders.projection_plan(lo, [1, 2], include_label=True)
    pt = sops.pages_tensor(build_pages(np.ones((9, 5), np.float32), np.ones(9, np.float32), lo))
    calls = []
    monkeypatch.setattr(sref, "decode_pages_projected_ref", lambda *a: calls.append("ref"))
    monkeypatch.setattr(skernel, "strider_decode_projected", lambda *a: calls.append("kernel"))
    sops.decode_pages_projected(pt, lo, plan)
    sops.decode_pages_projected(pt.to("meta"), lo, plan)
    assert calls == ["ref", "kernel"]


def test_projected_kernel_wrapper_rejects_non_cuda_input():
    lo = PageLayout(n_features=5, page_bytes=1024)
    plan = striders.projection_plan(lo, [1], include_label=False)
    pt = sops.pages_tensor(build_pages(np.ones((9, 5), np.float32), np.ones(9, np.float32), lo))
    launches = skernel.strider_decode_projected.launches
    with pytest.raises(ValueError, match="CUDA"):
        skernel.strider_decode_projected(pt, lo, plan)
    assert skernel.strider_decode_projected.launches == launches


# --------------------------------- GLM scoring -------------------------------
@pytest.mark.parametrize("n,d", [(50, 7), (217, 31), (1, 1), (0, 4)])
@pytest.mark.parametrize("act", eref.ACTS)
def test_glm_predict_matches_repro(act, n, d):
    rng = np.random.default_rng(21 + n)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    w = rng.normal(0, 0.5, d).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.float32)
    x[mask == 0] = np.inf  # dead rows must come back 0, not NaN
    got = eops.glm_predict(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(mask), act=act).numpy()
    want = np.asarray(jeref.glm_predict_ref(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(mask), act))
    assert got.shape == (n,) and np.isfinite(got).all() and not got[mask == 0].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    if act == "svm":  # sign decisions are exactly equal across packages
        np.testing.assert_array_equal(got, want)
    z = rng.normal(0, 3, 64).astype(np.float32)
    np.testing.assert_allclose(eref.glm_act(torch.from_numpy(z), act).numpy(),
                               np.asarray(jeref.glm_act(jnp.asarray(z), act)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("act", eref.ACTS)
def test_glm_predict_takes_a_bool_mask(act):
    """The chunk program hands its keep mask over as bool: the same
    predictions, bit for bit, as its f32 form, and repro's within atol=2e-6."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (300, 54)).astype(np.float32)
    w = rng.normal(0, 0.1, 54).astype(np.float32)
    keep = rng.random(300) > 0.3
    x[~keep] = np.inf
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = eops.glm_predict(xt, wt, torch.from_numpy(keep), act=act).numpy()
    f32 = eops.glm_predict(xt, wt, torch.from_numpy(keep.astype(np.float32)), act=act).numpy()
    assert _bits(got).tobytes() == _bits(f32).tobytes()
    want = np.asarray(jeref.glm_predict_ref(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(keep.astype(np.float32)), act))
    assert np.isfinite(got).all() and not got[~keep].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_glm_predict_cuda_path_never_falls_back(monkeypatch):
    x, w, m = torch.ones(4, 3), torch.ones(3), torch.ones(4)
    calls = []
    monkeypatch.setattr(eref, "glm_predict_ref", lambda *a: calls.append("ref"))
    monkeypatch.setattr(ekernel, "glm_predict", lambda *a: calls.append("kernel"))
    eops.glm_predict(x, w, m, act="logistic")
    eops.glm_predict(*(t.to("meta") for t in (x, w, m)), act="logistic")
    assert calls == ["ref", "kernel"]


def test_glm_predict_kernel_wrapper_rejects_bad_input():
    x, w, m = torch.ones(4, 3), torch.ones(3), torch.ones(4)
    launches = ekernel.glm_predict.launches
    with pytest.raises(ValueError, match="CUDA"):
        ekernel.glm_predict(x, w, m, "linear")
    with pytest.raises(ValueError, match="activation"):
        eops.glm_predict(x, w, m, act="tanh")
    assert ekernel.glm_predict.launches == launches


# ---------------------------- whole PREDICT statements -----------------------
def _both_catalogs(root, family, n=400, seed=11):
    """The same tables in a repro and a port catalog, the UDF trained by repro
    and its coefficients carried into the port's artifact."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, D)).astype(np.float32)
    z = X @ rng.normal(0, 1, D).astype(np.float32)
    y = {"logistic": (z > 0).astype(np.float32),
         "svm": np.where(z > 0, 1.0, -1.0).astype(np.float32)}.get(family, z)
    Xs = rng.normal(0, 1, (n, D + 4)).astype(np.float32)
    Xs[::7, 1] = np.float32(0.1)  # a literal f32 cannot hold exactly
    ys = np.round(rng.normal(0, 1, n)).astype(np.float32)
    htr = jwrite_table(str(root / "train.heap"), X, y, page_bytes=PAGE_BYTES)
    hs = jwrite_table(str(root / "score.heap"), Xs, ys, page_bytes=PAGE_BYTES)
    name = FAMILIES[family]
    kw = dict(rank=3, lr=1e-3, merge_coef=16) if family == "lrmf" else dict(
        lr=0.1, merge_coef=32)
    cats = []
    for cat_cls, register, algos in ((JCatalog, jregister, jalgos),
                                     (Catalog, register_udf_from_trace, algorithms)):
        cat = cat_cls(str(root / f"cat_{cat_cls.__module__.split('.')[0]}"))
        cat.register_table("train_t", htr.path, {"n_features": D})
        cat.register_table("score_t", hs.path, {"n_features": D + 4})
        fn = getattr(algos, name)
        register(cat, "udf", lambda fn=fn: fn(D, epochs=5, **kw), layout=htr.layout)
        cats.append(cat)
    jcat, cat = cats
    jexecute("SELECT * FROM dana.udf('train_t');", jcat, seed=0)
    set_udf_model(cat, "udf", jcat.udf("udf")["model"])
    return jcat, cat, Xs, ys


def _rows(res):
    """(projected columns, predictions) of a PREDICT's kept rows, read back
    from its result pages."""
    if not len(res.result_pages):
        return np.zeros((0, res.result_layout.n_features), np.float32), np.zeros(0, np.float32)
    parsed = [parse_page(p, res.result_layout) for p in res.result_pages]
    return (np.concatenate([f for f, _, _ in parsed]),
            np.concatenate([p for _, p, _ in parsed]))


def assert_same_result(got, want, pred_tol):
    assert got.verb == want.verb == "PREDICT"
    assert (got.schema, got.n_rows, got.rows_scanned, got.rows_filtered) == (
        want.schema, want.n_rows, want.rows_scanned, want.rows_filtered)
    assert got.device_syncs == want.device_syncs == 1
    for field in ("columns_decoded", "n_columns_total", "include_label", "bytes_per_tuple",
                  "bytes_per_tuple_full", "bytes_decoded", "bytes_full_decode",
                  "strider_cycles", "strider_cycles_full"):
        assert getattr(got.pushdown, field) == getattr(want.pushdown, field), field
    if want.aggregates is not None:
        assert got.aggregates.keys() == want.aggregates.keys()
        for k, v in want.aggregates.items():
            if k.startswith("count"):
                assert got.aggregates[k] == v
            elif math.isnan(v):
                assert math.isnan(got.aggregates[k])
            else:
                np.testing.assert_allclose(got.aggregates[k], v, rtol=1e-4, err_msg=k)
        return
    feats, preds = _rows(got)
    jfeats, jpreds = _rows(want)
    np.testing.assert_array_equal(feats, jfeats)  # the same rows and columns
    np.testing.assert_allclose(preds, jpreds, **pred_tol)
    np.testing.assert_allclose(got.predictions, np.asarray(want.predictions), **pred_tol)


GLM_TOL = dict(rtol=0, atol=2e-6)
STATEMENTS = {
    "project_where": "SELECT c0, c8 FROM dana.predict('udf', 'score_t') WHERE c1 > 0.0;",
    "select_star": "SELECT * FROM dana.predict('udf', 'score_t');",
    "tree_label": ("SELECT c2, label FROM dana.predict('udf', 'score_t') "
                   "WHERE (c1 > 0.0 AND c0 <= 1.0) OR NOT label == 0;"),
    "or_drops_label": ("SELECT c0, c1 FROM dana.predict('udf', 'score_t') "
                       "WHERE c2 > 0.0 OR c3 <= -0.5;"),
    "aggregates": ("SELECT COUNT(*), AVG(prediction), SUM(label), SUM(c9) FROM "
                   "dana.predict('udf', 'score_t') WHERE NOT c1 > 0.5;"),
    "aggregates_no_prediction": ("SELECT COUNT(*), SUM(c3), AVG(label) FROM "
                                 "dana.predict('udf', 'score_t') WHERE c2 > 0.0;"),
    "empty_filter_rows": "SELECT c0 FROM dana.predict('udf', 'score_t') WHERE c1 > 100.0;",
    "empty_filter_aggregates": ("SELECT COUNT(*), AVG(prediction) FROM "
                                "dana.predict('udf', 'score_t') WHERE c1 > 100.0;"),
    "literal_gt": "SELECT c1 FROM dana.predict('udf', 'score_t') WHERE c1 > 0.1;",
    "literal_eq": "SELECT c1 FROM dana.predict('udf', 'score_t') WHERE c1 == 0.1;",
}


@pytest.fixture(scope="module")
def logistic_catalogs(tmp_path_factory):
    return _both_catalogs(tmp_path_factory.mktemp("torch_scoring"), "logistic")


@pytest.mark.parametrize("chunk_pages", [1, None])
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_matches_repro(logistic_catalogs, name, chunk_pages):
    jcat, cat, _, _ = logistic_catalogs
    sql = STATEMENTS[name]
    got = execute(sql, cat, chunk_pages=chunk_pages, device=CPU)
    want = jexecute(sql, jcat, chunk_pages=chunk_pages)
    assert_same_result(got, want, GLM_TOL)


def test_literal_compares_in_f32(logistic_catalogs):
    """``c1 > 0.1`` drops the rows holding float32(0.1): the literal is cast to
    f32, as JAX's weak typing casts it, not widened to f64."""
    _, cat, Xs, _ = logistic_catalogs
    tenth = Xs[:, 1] == np.float32(0.1)
    assert tenth.sum() > 50 and float(np.float32(0.1)) > 0.1  # f64 would keep them
    gt = execute(STATEMENTS["literal_gt"], cat, device=CPU)
    eq = execute(STATEMENTS["literal_eq"], cat, device=CPU)
    assert gt.n_rows == int((Xs[:, 1] > np.float32(0.1)).sum())
    assert eq.n_rows == int(tenth.sum())
    assert (_rows(eq)[0][:, 0] == np.float32(0.1)).all()


def test_insert_chains_the_same_table(logistic_catalogs):
    jcat, cat, _, _ = logistic_catalogs
    sql = ("INSERT OR REPLACE INTO scored SELECT c0 FROM dana.predict('udf', 'score_t') "
           "WHERE c2 > 0.0;")
    got = execute(sql, cat, device=CPU)
    want = jexecute(sql, jcat)
    assert_same_result(got, want, GLM_TOL)
    heap = HeapFile(cat.table("scored")["heap"])
    jheap = HeapFile(jcat.table("scored")["heap"])
    assert heap.n_tuples == jheap.n_tuples == got.n_rows
    feats, labels = [], []
    for page in heap.read_all():
        f, l, _ = parse_page(page, heap.layout)
        feats.append(f)
        labels.append(l)
    np.testing.assert_array_equal(np.concatenate(labels), got.predictions)
    np.testing.assert_array_equal(np.concatenate(feats)[:, 0], _rows(got)[0][:, 0])
    with pytest.raises(ValueError, match="already exists"):
        execute(sql.replace(" OR REPLACE", ""), cat, device=CPU)


@pytest.mark.parametrize("family", ["linear", "svm", "lrmf"])
def test_families_match_repro(tmp_path, family):
    jcat, cat, _, _ = _both_catalogs(tmp_path, family)
    tol = dict(rtol=1e-6, atol=2e-6) if family == "lrmf" else GLM_TOL
    for name in ("project_where", "aggregates"):
        sql = STATEMENTS[name]
        assert_same_result(execute(sql, cat, chunk_pages=1, device=CPU),
                           jexecute(sql, jcat, chunk_pages=1), tol)


def test_one_join_per_scan(logistic_catalogs, monkeypatch):
    _, cat, _, _ = logistic_catalogs
    calls = []
    real = scoring._device_join
    monkeypatch.setattr(scoring, "_device_join",
                        lambda outs, agg: calls.append(len(outs)) or real(outs, agg))
    n_pages = HeapFile(cat.table("score_t")["heap"]).n_pages
    for name in ("project_where", "aggregates"):
        res = execute(STATEMENTS[name], cat, chunk_pages=1, device=CPU)
        assert res.device_syncs == 1
    assert calls == [n_pages, n_pages]  # one join, after every chunk


def test_sql_train_equals_solver_train(logistic_catalogs, tmp_path):
    """A TRAIN statement through the port's SQL layer gives solver.train's
    coefficients byte for byte, and writes them back into the artifact."""
    from repro_torch.core import solver

    _, cat, _, _ = logistic_catalogs
    art = cat.udf("udf")
    heap = HeapFile(cat.table("train_t")["heap"])
    want = solver.train(art["hdfg"], art["partition"], heap, max_epochs=3, seed=2, device=CPU)
    got = execute("SELECT * FROM dana.udf('train_t');", cat, max_epochs=3, seed=2, device=CPU)
    assert got.verb == "TRAIN" and got.device_syncs == want.device_syncs == 3
    np.testing.assert_array_equal(got.coefficients[0], want.models[0])
    np.testing.assert_array_equal(cat.udf("udf")["model"][0], want.models[0])


def test_predict_rejections(logistic_catalogs, monkeypatch):
    _, cat, _, _ = logistic_catalogs
    cat.register_udf("lm", {"kind": "lm", "cfg": None, "params": None})
    with pytest.raises(ValueError, match="register_lm_udf"):
        execute("SELECT * FROM dana.predict('lm', 'score_t');", cat, device=CPU)
    register_udf_from_trace(cat, "bare", lambda: algorithms.linear_regression(D))
    set_udf_model(cat, "bare", [np.zeros(D, np.float32)])
    with pytest.raises(ValueError, match="without a page layout"):
        execute("SELECT c0 FROM dana.predict('bare', 'score_t');", cat, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        execute("SELECT c0 FROM dana.predict('udf', 'score_t') WHERE c10 > 0;", cat,
                device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute(STATEMENTS["project_where"], cat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scoring.PredictScan(parse(STATEMENTS["project_where"]), cat)
