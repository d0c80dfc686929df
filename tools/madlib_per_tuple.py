#!/usr/bin/env python3
"""The MADlib analogue's seconds a tuple on the host's CPU:
``repro.core.solver.madlib_train`` (its per-tuple step jitted) and
``repro_torch.core.solver.madlib_train`` (its per-tuple step eager torch
ops), each over the same heap, ``dana_vs_madlib``'s (remote_sensing_lr at
scale 0.01, the harness's logistic regression, one epoch), in alternating
turns (repro, port, port, repro, ...) after a first run of each (repro's jit
compiles there, the port's first torch ops warm up; the example times that
first run). ``--packages repro_torch`` runs the port alone (no JAX: on the
card's host), and ``--src`` takes the port from another tree's ``src``.
Prints one JSON line: each package's first run, its seconds an epoch and a
tuple (median of the turns), torch's threads, the CPU's model name. These
are times of the host's CPU, not of any accelerator.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python3 tools/madlib_per_tuple.py [--turns 3]
    python3 tools/madlib_per_tuple.py --packages repro_torch [--src OTHER/src]
"""
import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD, SCALE = "remote_sensing_lr", 0.01  # dana_vs_madlib's


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("model name"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _port(heap_path):
    from repro_torch.algorithms import logistic_regression
    from repro_torch.core import solver
    from repro_torch.core.translator import trace
    from repro_torch.db.heap import HeapFile

    g, part = trace(lambda: logistic_regression(54, lr=0.1, merge_coef=256, epochs=1))
    return lambda: solver.madlib_train(g, part, HeapFile(heap_path), max_epochs=1)


def _repro(heap_path):
    from repro.algorithms import logistic_regression
    from repro.core import solver
    from repro.core.translator import trace
    from repro.db.heap import HeapFile

    g, part = trace(lambda: logistic_regression(54, lr=0.1, merge_coef=256, epochs=1))
    return lambda: solver.madlib_train(g, part, HeapFile(heap_path), max_epochs=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=3, help="timed runs of each package")
    ap.add_argument("--threads", type=int, default=None, help="torch's intra-op threads")
    ap.add_argument("--packages", default="repro,repro_torch")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"), help="the tree's src")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.data.synthetic import WORKLOADS, generate
    from repro_torch.db.heap import write_table

    if args.threads:
        torch.set_num_threads(args.threads)
    names = args.packages.split(",")
    w = WORKLOADS[WORKLOAD]
    with tempfile.TemporaryDirectory(prefix="madlib_per_tuple_") as tmp:
        feats, labels = generate(w, scale=SCALE, seed=0)
        heap = write_table(os.path.join(tmp, "t.heap"), feats, labels, page_bytes=w.page_bytes)
        makers = {"repro": _repro, "repro_torch": _port}
        runs = {name: makers[name](heap.path) for name in names}
        first = {}
        for name, run in runs.items():
            t0 = time.perf_counter()
            run()
            first[name] = time.perf_counter() - t0
        seconds = {name: [] for name in runs}
        for turn in range(args.turns):
            for name in (names if turn % 2 == 0 else names[::-1]):
                t0 = time.perf_counter()
                runs[name]()
                seconds[name].append(time.perf_counter() - t0)
        n = heap.n_tuples
    med = {name: statistics.median(s) for name, s in seconds.items()}
    out = {"workload": WORKLOAD, "scale": SCALE, "n_tuples": n, "src": args.src,
           "first_epoch_s": first, "epoch_s": seconds, "median_epoch_s": med,
           "us_per_tuple": {name: 1e6 * s / n for name, s in med.items()},
           "torch_threads": torch.get_num_threads(), "cpu": _cpu_model(),
           "cores": os.cpu_count(), "loadavg": os.getloadavg()}
    if len(med) == 2:
        out["port_over_repro"] = med["repro_torch"] / med["repro"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
