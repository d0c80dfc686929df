"""Shared CLI flag vocabulary for the port's launchers (counterpart of
``repro.launch.common``, which it is held against): the helpers
``launch/score.py`` uses. The mesh, kv and serving-only flags wait for the
port's serving and distribution slices (ROADMAP A17, A19, A21).

  scheduler flags  ``--scheduler priority|fifo`` + ``--deadline-ttft`` /
                   ``--deadline``
  bench output     ``--bench-out PATH`` writing a JSON rollup

``repro``'s ``--scheduler`` also offers ``wdrr``, which weighs a request by
its prompt; a SQL statement has none, so the query executor cannot run it.

Every helper takes the ``argparse.ArgumentParser`` (or a group) and only
*adds* arguments — launchers keep their workload-specific flags alongside.
"""
from __future__ import annotations

import argparse
import json


def add_scheduler_flags(ap: argparse.ArgumentParser) -> None:
    """--scheduler / --deadline-ttft / --deadline: the query executor's
    admission policy and per-statement deadlines."""
    ap.add_argument("--scheduler", choices=["priority", "fifo"], default="priority",
                    help="fifo = submission order (the serial ablation)")
    ap.add_argument("--deadline-ttft", type=float, default=None,
                    help="per-request time-to-first-output budget in "
                         "seconds (miss = cancel)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request end-to-end budget in seconds")


def add_bench_out_flag(ap: argparse.ArgumentParser) -> None:
    """--bench-out: where to write the run's JSON metrics rollup."""
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="write the run's metrics rollup as JSON to PATH")


def write_bench_out(args, payload: dict) -> None:
    """Write the rollup if --bench-out was given (no-op otherwise)."""
    path = getattr(args, "bench_out", None)
    if path:
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[bench] wrote {path}")
