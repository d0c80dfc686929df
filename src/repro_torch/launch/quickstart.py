"""Quickstart: the paper's §4.3 flow, end to end, train then score
(counterpart of ``examples/quickstart.py``, which it is held against).

1. Define linear regression in DAnA's Python-embedded DSL (update rule,
   merge function, convergence).
2. Load a training table into the RDBMS substrate (slotted pages, heap file).
3. Register the compiled accelerator artifact (hDFG + Strider program +
   design point) in the catalog.
4. Connect a ``Session`` and train with the SQL query
   ``SELECT * FROM dana.linearR('table')``.
5. Score a wider table with ``SELECT ... FROM dana.predict('linearR', 't')
   WHERE ...``: the projection and the filter push down into the strider
   program, so the columns the query does not need are never decoded.
6. Reduce on the device with ``SELECT COUNT(*), AVG(prediction) ...`` and
   chain the scored rows back into the catalog with ``INSERT INTO``.

On the card TRAIN decodes its pages through B1 and walks each chunk's merge
batches through B2's ``glm_sgd_chunk`` (the update is affine); each of the
three scans runs B3 and B4 once a chunk. TRAIN makes one join an epoch,
each scan one.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

``--device`` defaults to ``cuda``; without a card it raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

# the example's sizes and seed
SEED = 0
N_FEATURES = 10
TRAIN_ROWS = 20_000
SCORE_ROWS = 5_000
SCORE_COLUMNS = 30
UDF = dict(lr=0.2, merge_coef=64, conv_factor=0.01, epochs=200)
PREDICT_SQL = ("SELECT c0 FROM dana.predict('linearR', 'scoring_table') "
               "WHERE c1 > 0 AND (c2 <= 1.5 OR NOT c3 < 0);")
AGGREGATE_SQL = ("SELECT COUNT(*), AVG(prediction) FROM "
                 "dana.predict('linearR', 'scoring_table') WHERE c1 > 0;")
INSERT_SQL = ("INSERT INTO scored SELECT c0 FROM "
              "dana.predict('linearR', 'scoring_table') WHERE c1 > 0;")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default=None,
                    help="the tables and the catalog (default: a temporary directory)")
    return ap


def flow(args, params=None) -> dict:
    """The example's statements on ``args.device``; prints its lines and
    returns what it printed and checked. The flow trains its own model, so
    ``params`` (the launchers' common signature) must be None."""
    if params is not None:
        raise ValueError("the quickstart trains its own coefficients: params must be None")
    if args.workdir is None:
        with tempfile.TemporaryDirectory(prefix="dana_quickstart_") as tmp:
            return _flow(args, tmp)
    os.makedirs(args.workdir, exist_ok=True)
    return _flow(args, args.workdir)


def _flow(args, tmp) -> dict:
    from repro_torch.algorithms import linear_regression
    from repro_torch.db import connect
    from repro_torch.db.heap import HeapFile, write_table
    from repro_torch.db.query import register_udf_from_trace

    out = {"lines": []}

    def say(line):
        out["lines"].append(line)
        print(line, flush=True)

    # --- make a training table: y = w.x with 10 features -------------------
    rng = np.random.default_rng(SEED)
    w_true = rng.normal(0, 1, N_FEATURES).astype(np.float32)
    X = rng.normal(0, 1, (TRAIN_ROWS, N_FEATURES)).astype(np.float32)
    y = X @ w_true
    heap = write_table(os.path.join(tmp, "training_data.heap"), X, y)
    say(f"table: {heap.n_tuples} tuples in {heap.n_pages} x 32KB pages")

    # --- one Session over one catalog + shared buffer pool ------------------
    sess = connect(os.path.join(tmp, "catalog"), page_bytes=heap.layout.page_bytes,
                   device=args.device)
    try:
        sess.catalog.register_table("training_data_table", heap.path,
                                    {"n_features": N_FEATURES})

        # --- register the UDF: DSL -> hDFG -> strider program -> design point
        artifact = register_udf_from_trace(
            sess.catalog, "linearR", lambda: linear_regression(N_FEATURES, **UDF),
            layout=heap.layout)
        dp = artifact["design_point"]
        say(f"hardware generator chose {dp.n_threads} threads x "
            f"{dp.acs_per_thread} ACs ({dp.total_aus} AUs), "
            f"{dp.n_striders} striders, {dp.bram_used/2**20:.1f} MB BRAM")
        say(f"strider program: {len(artifact['strider_program'])} instructions "
            f"(22-bit ISA)")
        out["design_point"] = (dp.n_threads, dp.acs_per_thread, dp.total_aus,
                               dp.n_striders, dp.bram_used)
        out["program_len"] = len(artifact["strider_program"])

        # --- TRAIN: one SQL query; the trained model lands in the catalog ---
        res = sess.sql("SELECT * FROM dana.linearR('training_data_table');")
        tr = res.train
        w = res.coefficients[0]
        err = float(np.max(np.abs(w - w_true)))
        say(f"converged={tr.converged} after {tr.epochs_run} epochs; "
            f"max |w - w*| = {err:.4f}")
        say(f"timings: io={tr.io_s:.3f}s "
            f"(exposed={res.exposed_io_s:.3f}s overlapped={res.overlapped_io_s:.3f}s) "
            f"compute={res.compute_s:.3f}s total={res.total_s:.3f}s "
            f"[pipelined: decode fused into compute, "
            f"{res.device_syncs} device syncs]")
        assert err < 0.05, err
        out.update(coefficients=np.asarray(w), err=err, epochs_run=tr.epochs_run,
                   syncs={"train": res.device_syncs})

        # --- PREDICT: score a wider table through the same strider path -----
        # the scoring table carries 20 extra columns the model never reads;
        # the projection pushdown means they are never decoded off the page
        Xs = rng.normal(0, 1, (SCORE_ROWS, SCORE_COLUMNS)).astype(np.float32)
        write_table(os.path.join(tmp, "scoring.heap"), Xs, np.zeros(SCORE_ROWS, np.float32))
        sess.catalog.register_table("scoring_table", os.path.join(tmp, "scoring.heap"),
                                    {"n_features": SCORE_COLUMNS})
        res = sess.sql(PREDICT_SQL)
        pd = res.pushdown
        say(f"scored {res.n_rows}/{res.rows_scanned} rows "
            f"({res.rows_filtered} filtered), schema {res.schema}")
        say(f"pushdown: decoded {len(pd.columns_decoded)}/{pd.n_columns_total} "
            f"columns — {pd.bytes_decoded}/{pd.bytes_full_decode} bytes "
            f"({pd.decode_bytes_ratio:.2f}x fewer), "
            f"{res.device_syncs} device sync")
        kept = (Xs[:, 1] > 0) & ((Xs[:, 2] <= 1.5) | ~(Xs[:, 3] < 0))
        np.testing.assert_allclose(res.predictions, Xs[kept, :N_FEATURES] @ w, atol=1e-4)
        assert pd.decode_bytes_ratio > 2.0, pd.decode_bytes_ratio
        out.update(predictions=np.asarray(res.predictions), n_rows=res.n_rows,
                   rows_scanned=res.rows_scanned, rows_filtered=res.rows_filtered,
                   columns_decoded=list(pd.columns_decoded),
                   bytes_decoded=pd.bytes_decoded, bytes_full_decode=pd.bytes_full_decode,
                   decode_bytes_ratio=pd.decode_bytes_ratio)
        out["syncs"]["predict"] = res.device_syncs

        # --- AGGREGATE: reduce on device, no result pages materialized ------
        agg = sess.sql(AGGREGATE_SQL)
        say(f"aggregates (device-reduced, {agg.device_syncs} sync): {agg.aggregates}")
        assert agg.aggregates["count(*)"] == int((Xs[:, 1] > 0).sum()), agg.aggregates
        out["aggregates"] = dict(agg.aggregates)
        out["syncs"]["aggregate"] = agg.device_syncs

        # --- INSERT ... SELECT: chain scored rows into a new catalog table --
        ins = sess.sql(INSERT_SQL)
        say(f"chained {ins.n_rows} rows into table 'scored' "
            f"(schema {list(ins.schema)}); tables: {sess.tables()}")
        out["inserted_rows"] = ins.n_rows
        scored = HeapFile(sess.catalog.table("scored")["heap"])
        out["inserted_pages"], out["inserted_layout"] = scored.read_all(), scored.layout
        out["syncs"]["insert"] = ins.device_syncs
        # the port's own check: one join an epoch, and one a scan
        assert out["syncs"] == {"train": tr.epochs_run, "predict": 1, "aggregate": 1,
                                "insert": 1}, out["syncs"]
    finally:
        sess.close()
    say("OK")
    return out


def main(argv=None) -> dict:
    """The command line: ``flow`` on the parsed flags; returns its dict."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.engine import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here
    return flow(args)


if __name__ == "__main__":
    main()
