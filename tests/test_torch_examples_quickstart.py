"""``repro_torch.launch.quickstart`` (the port of ``examples/quickstart.py``)
against ``repro``'s same flow, written out here: the same tables from numpy
seed 0, the same UDF and the same four statements on the CPU. The
coefficients within 1e-4; the predictions, the scan's counts, the
pushdown's columns and bytes, the aggregate count and the inserted rows'
c0 equal, and the predictions (in the scan and in the inserted rows) within
``test_torch_scoring.GLM_TOL``: the two packages' SGD sums in other orders,
so the coefficients differ in their last bits; the design point and the
strider program's length equal."""
import argparse
import os

import numpy as np
import pytest

from repro_torch.db.page import parse_page
from repro_torch.launch import quickstart
from test_torch_scoring import GLM_TOL


def _repro_flow(tmp):
    """``examples/quickstart.py``'s statements through ``repro``."""
    from repro.algorithms import linear_regression
    from repro.db import connect
    from repro.db.heap import HeapFile, write_table
    from repro.db.query import register_udf_from_trace

    rng = np.random.default_rng(quickstart.SEED)
    w_true = rng.normal(0, 1, 10).astype(np.float32)
    X = rng.normal(0, 1, (20_000, 10)).astype(np.float32)
    heap = write_table(os.path.join(tmp, "training_data.heap"), X, X @ w_true)
    sess = connect(os.path.join(tmp, "catalog"), page_bytes=heap.layout.page_bytes)
    sess.catalog.register_table("training_data_table", heap.path, {"n_features": 10})
    artifact = register_udf_from_trace(
        sess.catalog, "linearR",
        lambda: linear_regression(10, lr=0.2, merge_coef=64, conv_factor=0.01, epochs=200),
        layout=heap.layout)
    dp = artifact["design_point"]
    out = {"design_point": (dp.n_threads, dp.acs_per_thread, dp.total_aus, dp.n_striders,
                            dp.bram_used),
           "program_len": len(artifact["strider_program"])}
    res = sess.sql("SELECT * FROM dana.linearR('training_data_table');")
    out["coefficients"] = np.asarray(res.coefficients[0])
    out["err"] = float(np.max(np.abs(out["coefficients"] - w_true)))
    Xs = rng.normal(0, 1, (5_000, 30)).astype(np.float32)
    write_table(os.path.join(tmp, "scoring.heap"), Xs, np.zeros(5_000, np.float32))
    sess.catalog.register_table("scoring_table", os.path.join(tmp, "scoring.heap"),
                                {"n_features": 30})
    res = sess.sql(quickstart.PREDICT_SQL)
    pd = res.pushdown
    out.update(predictions=np.asarray(res.predictions), n_rows=res.n_rows,
               rows_scanned=res.rows_scanned, rows_filtered=res.rows_filtered,
               columns_decoded=list(pd.columns_decoded), bytes_decoded=pd.bytes_decoded,
               bytes_full_decode=pd.bytes_full_decode)
    out["aggregates"] = dict(sess.sql(quickstart.AGGREGATE_SQL).aggregates)
    out["inserted_rows"] = sess.sql(quickstart.INSERT_SQL).n_rows
    scored = HeapFile(sess.catalog.table("scored")["heap"])
    out["inserted_pages"], out["inserted_layout"] = scored.read_all(), scored.layout
    sess.close()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    want = _repro_flow(str(tmp_path_factory.mktemp("repro")))
    args = quickstart.build_parser().parse_args(
        ["--device", "cpu", "--workdir", str(tmp_path_factory.mktemp("port"))])
    return quickstart.flow(args), want


def test_coefficients_within_1e_4_of_repro(both):
    got, want = both
    np.testing.assert_allclose(got["coefficients"], want["coefficients"], rtol=0, atol=1e-4)
    assert got["err"] < 0.05 and want["err"] < 0.05


def _inserted(pages, layout):
    feats, labels = zip(*(parse_page(page, layout)[:2] for page in pages))
    return np.concatenate(feats), np.concatenate(labels)


def test_scans_equal_repros(both):
    """The scan's counts, the pushdown's columns and bytes, the aggregate
    count and the inserted rows equal; the predictions at GLM_TOL."""
    got, want = both
    np.testing.assert_allclose(got["predictions"], want["predictions"], **GLM_TOL)
    for key in ("n_rows", "rows_scanned", "rows_filtered", "columns_decoded", "bytes_decoded",
                "bytes_full_decode", "inserted_rows"):
        assert got[key] == want[key], key
    assert got["aggregates"]["count(*)"] == want["aggregates"]["count(*)"]
    np.testing.assert_allclose(got["aggregates"]["avg(prediction)"],
                               want["aggregates"]["avg(prediction)"], rtol=1e-6)
    assert got["inserted_pages"].shape == want["inserted_pages"].shape
    (gf, gl), (wf, wl) = (_inserted(x["inserted_pages"], x["inserted_layout"])
                          for x in (got, want))
    assert gf.shape == wf.shape == (got["inserted_rows"], 1)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_allclose(gl, wl, **GLM_TOL)


def test_design_point_and_program_equal_repros(both):
    got, want = both
    assert got["design_point"] == want["design_point"]
    assert got["program_len"] == want["program_len"]


def test_flow_prints_the_examples_lines_and_one_join_a_statement(both):
    got, _ = both
    assert got["lines"][-1] == "OK"
    assert got["lines"][0] == "table: 20000 tuples in 37 x 32KB pages"
    assert got["syncs"] == {"train": got["epochs_run"], "predict": 1, "aggregate": 1,
                            "insert": 1}
    assert got["decode_bytes_ratio"] > 2.0


def test_flow_takes_no_weights():
    args = argparse.Namespace(device="cpu", workdir=None)
    with pytest.raises(ValueError, match="params must be None"):
        quickstart.flow(args, params={"w": 0})
