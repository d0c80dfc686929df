"""The port's concurrent executor and Database/Session front door
(repro_torch.db.executor, repro_torch.db.session) on the CPU: serial and
interleaved schedules give byte-identical results, one join per scan,
deadlines, failed-query isolation, LM rejection, and the same schedule (step
counts, units, finish order) as repro's executor on the same trace."""
import numpy as np
import pytest
import torch

import repro.algorithms as jalgos
from repro.db.bufferpool import BufferPool as JBufferPool
from repro.db.catalog import Catalog as JCatalog
from repro.db.executor import QueryExecutor as JQueryExecutor
from repro.db.heap import HeapFile as JHeapFile
from repro.db.query import execute as jexecute
from repro.db.query import register_udf_from_trace as jregister
from repro_torch.algorithms import linear_regression
from repro_torch.db import Database, connect, scoring
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.catalog import Catalog
from repro_torch.db.executor import DEFAULT_CHUNK_PAGES, FAILED, TERMINAL, QueryExecutor
from repro_torch.db.heap import HeapFile, write_table
from repro_torch.db.query import execute, register_udf_from_trace, set_udf_model
from repro_torch.serve.scheduler import CANCELLED_DEADLINE, FINISHED, REJECTED

CPU = "cpu"
PAGE_BYTES = 8192
D = 6
PREDICT_SQL = ("SELECT c0 FROM dana.predict('udf', 'score_t') "
               "WHERE c1 > 0.0 AND (c2 <= 0.5 OR NOT c3 < 0.0);")
AGG_SQL = ("SELECT COUNT(*), AVG(prediction) FROM "
           "dana.predict('udf', 'score_t') WHERE c1 > 0.0;")
TRAIN_BG_SQL = "SELECT * FROM dana.udf_bg('train_t');"


def _tables(root, n=500, seed=31):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 1, D).astype(np.float32)
    Xtr = rng.normal(0, 1, (n, D)).astype(np.float32)
    Xs = rng.normal(0, 1, (n, D + 4)).astype(np.float32)
    htr = write_table(str(root / "train.heap"), Xtr, Xtr @ w_true, page_bytes=PAGE_BYTES)
    hs = write_table(str(root / "score.heap"), Xs, rng.normal(0, 1, n).astype(np.float32),
                     page_bytes=PAGE_BYTES)
    return htr, hs, Xs


def _register(cat, register, fn, htr, hs):
    cat.register_table("train_t", htr.path, {"n_features": D})
    cat.register_table("score_t", hs.path, {"n_features": D + 4})
    for udf in ("udf", "udf_bg"):
        register(cat, udf, lambda: fn(D, lr=0.1, merge_coef=32, epochs=8), layout=htr.layout)


@pytest.fixture
def catalog(tmp_path):
    """A port catalog with ``udf`` trained (the PREDICT target) and
    ``udf_bg`` for background TRAINs, over a train and a wider score table."""
    htr, hs, Xs = _tables(tmp_path)
    cat = Catalog(str(tmp_path / "cat"))
    _register(cat, register_udf_from_trace, linear_regression, htr, hs)
    execute("SELECT * FROM dana.udf('train_t');", cat, pool=BufferPool(page_bytes=PAGE_BYTES),
            max_epochs=5, seed=0, device=CPU)
    return cat, Xs


def _executor(cat, **kw):
    kw.setdefault("chunk_pages", 1)
    return QueryExecutor(cat, BufferPool(page_bytes=PAGE_BYTES), device=CPU, **kw)


def _submit_trace(ex, epochs=6):
    return (ex.submit(TRAIN_BG_SQL, priority=2, max_epochs=epochs, seed=0),
            ex.submit(PREDICT_SQL, priority=0),
            ex.submit(AGG_SQL, priority=0))


def test_schedule_matches_repro(tmp_path, catalog):
    """The same trace through both executors: the same steps, units, finish
    order and per-priority rollup, and the same answers within f32 order."""
    cat, _ = catalog
    jcat = JCatalog(str(tmp_path / "jcat"))
    _register(jcat, jregister, jalgos.linear_regression,
              *(JHeapFile(cat.table(t)["heap"]) for t in ("train_t", "score_t")))
    jexecute("SELECT * FROM dana.udf('train_t');", jcat,
             pool=JBufferPool(page_bytes=PAGE_BYTES), max_epochs=5, seed=0)
    set_udf_model(cat, "udf", jcat.udf("udf")["model"])

    ex = _executor(cat, max_running=2, policy="priority")
    jex = JQueryExecutor(jcat, JBufferPool(page_bytes=PAGE_BYTES), max_running=2,
                         policy="priority", chunk_pages=1)
    reqs, jreqs = _submit_trace(ex), _submit_trace(jex)
    m, jm = ex.drain(), jex.drain()
    assert m.as_dict() == jm.as_dict()
    for r, jr in zip(reqs, jreqs):
        assert (r.status, r.units, r.admit_step, r.first_unit_step, r.finish_step) == (
            jr.status, jr.units, jr.admit_step, jr.first_unit_step, jr.finish_step)
    np.testing.assert_allclose(reqs[0].result.coefficients[0],
                               np.asarray(jreqs[0].result.coefficients[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(reqs[1].result.predictions,
                               np.asarray(jreqs[1].result.predictions), rtol=0, atol=2e-6)
    assert reqs[2].result.aggregates["count(*)"] == jreqs[2].result.aggregates["count(*)"]


def test_interleaved_trace_completes_with_metrics(catalog):
    cat, _ = catalog
    ex = _executor(cat, max_running=2, policy="priority")
    train, pred, agg = _submit_trace(ex)
    m = ex.drain()
    assert all(r.status == FINISHED for r in (train, pred, agg))
    assert m.submitted == m.admitted == m.finished == 3
    assert m.failed == m.rejected == m.cancelled_deadline == 0
    assert m.train_units == 6 and m.predict_units > 0
    assert 0 < m.occupancy_pct <= 100.0
    assert pred.finish_step < train.finish_step and agg.finish_step < train.finish_step
    assert pred.first_unit_step >= pred.admit_step >= pred.submit_step


def test_serial_vs_interleaved_results_byte_identical(catalog):
    cat, _ = catalog
    runs = {}
    for name, kw in (("interleaved", dict(max_running=2, policy="priority")),
                     ("serial", dict(max_running=1, policy="fifo"))):
        ex = _executor(cat, **kw)
        reqs = _submit_trace(ex)
        ex.drain()
        runs[name] = reqs
    (ti, pi, ai), (ts, ps, as_) = runs["interleaved"], runs["serial"]
    np.testing.assert_array_equal(pi.result.predictions, ps.result.predictions)
    np.testing.assert_array_equal(pi.result.result_pages, ps.result.result_pages)
    assert ai.result.aggregates == as_.result.aggregates
    np.testing.assert_array_equal(ti.result.coefficients[0], ts.result.coefficients[0])
    assert ts.finish_step < ps.finish_step and ts.finish_step < as_.finish_step


def test_executor_train_matches_execute_train(catalog, tmp_path):
    cat, _ = catalog
    direct = execute(TRAIN_BG_SQL, cat, pool=BufferPool(page_bytes=PAGE_BYTES),
                     max_epochs=6, seed=0, device=CPU)
    ex = _executor(Catalog(cat.root), max_running=2)
    req = ex.submit(TRAIN_BG_SQL, priority=0, max_epochs=6, seed=0)
    ex.drain()
    assert req.status == FINISHED and req.units == 6
    np.testing.assert_array_equal(req.result.coefficients[0], direct.coefficients[0])


def test_one_join_per_scan(catalog, monkeypatch):
    cat, Xs = catalog
    joins = []
    real = scoring._device_join
    monkeypatch.setattr(scoring, "_device_join",
                        lambda outs, agg: joins.append(len(outs)) or real(outs, agg))
    ex = _executor(cat, max_running=2)
    pred, agg = ex.submit(PREDICT_SQL), ex.submit(AGG_SQL)
    ex.drain()
    n_pages = HeapFile(cat.table("score_t")["heap"]).n_pages
    assert joins == [n_pages, n_pages] and pred.units == agg.units == n_pages
    assert pred.result.device_syncs == agg.result.device_syncs == 1
    assert agg.result.aggregates["count(*)"] == int((Xs[:, 1] > 0.0).sum())
    assert agg.result.aggregates == execute(AGG_SQL, cat, chunk_pages=1, device=CPU).aggregates


def test_deadline_cancels_queued_and_running(catalog):
    cat, Xs = catalog
    now = [0.0]
    ex = _executor(cat, max_running=1, policy="fifo", clock=lambda: now[0])
    run = ex.submit(TRAIN_BG_SQL, priority=0, max_epochs=4, seed=0)
    late = ex.submit(PREDICT_SQL, priority=0, deadline_s=5.0)
    ex.step()  # admits the TRAIN; the PREDICT waits
    now[0] = 10.0
    ex.drain()
    assert (run.status, late.status, late.result) == (FINISHED, CANCELLED_DEADLINE, None)
    assert ex.metrics.cancelled_deadline == 1

    now[0] = 0.0
    ex2 = _executor(cat, max_running=2, clock=lambda: now[0])
    doomed = ex2.submit(PREDICT_SQL, priority=0, deadline_s=1.0)
    ok = ex2.submit(AGG_SQL, priority=2)
    ex2.step()
    now[0] = 2.0
    ex2.drain()
    assert doomed.status == CANCELLED_DEADLINE and ok.status == FINISHED
    assert ok.result.aggregates["count(*)"] == int((Xs[:, 1] > 0.0).sum())


def test_lm_and_unknown_udfs_rejected_at_submit(catalog):
    cat, _ = catalog
    cat.register_udf("lm", {"kind": "lm", "cfg": None, "params": None})
    ex = _executor(cat)
    with pytest.raises(ValueError, match="language model"):
        ex.submit("SELECT c0 FROM dana.predict('lm', 'score_t');")
    with pytest.raises(KeyError):
        ex.submit("SELECT c0 FROM dana.predict('nope', 'score_t');")
    assert ex.metrics.rejected == 2 and all(r.status == REJECTED for r in ex.queries)
    assert ex.drain().units == 0


def test_failed_query_is_terminal_and_isolated(catalog):
    cat, _ = catalog
    ex = _executor(cat, max_running=2)
    bad = ex.submit("SELECT c0 FROM dana.predict('udf', 'train_t') WHERE c9 > 0.0;")
    good = ex.submit(AGG_SQL)
    ex.drain()
    assert bad.status == FAILED and bad.status in TERMINAL and isinstance(bad.error, Exception)
    assert good.status == FINISHED
    assert ex.metrics.failed == 1 and ex.metrics.finished == 1


def test_default_chunk_pages_used_when_unset(catalog):
    cat, _ = catalog
    ex = QueryExecutor(cat, BufferPool(page_bytes=PAGE_BYTES), max_running=1, device=CPU)
    req = ex.submit(PREDICT_SQL)
    ex.drain()
    n_pages = HeapFile(cat.table("score_t")["heap"]).n_pages
    assert req.units == -(-n_pages // DEFAULT_CHUNK_PAGES)


# ------------------------------ Database / Session ---------------------------
def test_session_sql_submit_and_close(catalog):
    cat, Xs = catalog
    sess = connect(cat, page_bytes=PAGE_BYTES, device=CPU)
    assert sess.udfs() == ["udf", "udf_bg"] and "score_t" in sess.tables()
    sync = sess.sql(PREDICT_SQL, chunk_pages=1)
    h_train = sess.submit(TRAIN_BG_SQL, priority=2, max_epochs=2, seed=0)
    h_pred = sess.submit(PREDICT_SQL, priority=0, chunk_pages=1)
    assert not h_pred.done()
    res = h_pred.result()
    np.testing.assert_array_equal(res.predictions, sync.predictions)
    assert h_train.result().train.epochs_run == 2 and h_train.status == FINISHED
    into = sess.sql(PREDICT_SQL, into="scored")
    assert sess.catalog.has_table("scored") and into.n_rows == res.n_rows
    sess.sql("SELECT c0 FROM dana.predict('udf', 'score_t');")  # pool now holds pages
    assert sess.pool.resident > 0
    sess.close()
    assert sess.pool.resident == 0
    with pytest.raises(RuntimeError, match="closed"):
        sess.sql(PREDICT_SQL)
    sess.close()  # idempotent


def test_query_handle_raises_the_query_error(catalog):
    cat, _ = catalog
    with Database(cat, device=CPU).connect() as sess:
        h = sess.submit("SELECT c0 FROM dana.predict('udf', 'train_t') WHERE c9 > 0.0;")
        with pytest.raises(ValueError, match="out of range"):
            h.result()
        assert h.status == FAILED


def test_entry_points_raise_without_a_card(catalog, monkeypatch):
    cat, _ = catalog
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: connect(cat), lambda: Database(cat), lambda: QueryExecutor(cat),
                 lambda: execute(PREDICT_SQL, cat)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---------------------------------- launcher ---------------------------------
def test_score_launcher_matches_repro(tmp_path, monkeypatch):
    from repro.launch import score as jscore
    from repro_torch.launch import score

    argv = ["--rows", "600", "--epochs", "2", "--where", "c1 > 0.0 AND c2 <= 0.5",
            "--project", "c0,c1", "--chunk-pages", "1"]
    got = score.main(argv + ["--device", "cpu", "--workdir", str(tmp_path / "port")])
    want = jscore.main(argv + ["--workdir", str(tmp_path / "repro")])
    assert (got.n_rows, got.rows_scanned, got.schema) == (want.n_rows, want.rows_scanned,
                                                          want.schema)
    assert got.pushdown.bytes_decoded == want.pushdown.bytes_decoded
    np.testing.assert_allclose(got.predictions, np.asarray(want.predictions),
                               rtol=1e-4, atol=1e-4)  # each package trained its own model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score.main(argv + ["--workdir", str(tmp_path / "card")])
