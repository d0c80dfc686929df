"""Shared benchmark harness: build scaled Table 3 workloads as heap files,
wire each to its DSL algorithm, and time the three execution modes
(counterpart of ``benchmarks/workloads.py``, which it is held against; the
port imports nothing of ``repro`` or ``benchmarks``).

Scaling: the paper's datasets are up to 38 GB; each benchmark uses a
--scale fraction (default sized for seconds-level runs) with identical
geometry (feature width, page layout). The FPGA cycle model runs at FULL
size (it's analytic), so Table 5's modeled column uses the real tuple
counts.

Where the port differs: ``time_mode(..., device=None)`` times the device
modes on the card and raises ``RuntimeError`` without one (``madlib`` is
the CPU baseline by definition and ignores the device); the engine cache
and the warm-up key carry the device; ``build_heap`` takes the directory
that holds its files (``BENCH_DIR`` when None).
"""
from __future__ import annotations

import os
import time

from repro_torch.algorithms import linear_regression, logistic_regression, lrmf, svm
from repro_torch.core import hwgen, solver
from repro_torch.core.engine import make_engine, resolve_device
from repro_torch.core.translator import trace
from repro_torch.data.synthetic import WORKLOADS, Workload, generate
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.heap import HeapFile, write_table

BENCH_DIR = os.environ.get("REPRO_BENCH_DIR", "artifacts/bench_data")

# benchmark-friendly knobs per algorithm
ALGO = {
    "linear": lambda d: linear_regression(d, lr=0.05, merge_coef=256, epochs=1),
    "logistic": lambda d: logistic_regression(d, lr=0.1, merge_coef=256, epochs=1),
    "svm": lambda d: svm(d, lr=0.05, merge_coef=256, epochs=1),
    "lrmf": lambda d: lrmf(d, rank=10, lr=1e-3, merge_coef=8, epochs=1),
}

# MADlib's tuple-at-a-time python loop needs smaller tuple counts to finish
MADLIB_CAP = 2_000


def build_heap(w: Workload, scale: float, seed: int = 0, directory: str | None = None):
    """The workload's heap at ``scale``, written once into ``directory``
    (``BENCH_DIR`` when None) and opened from there after."""
    directory = BENCH_DIR if directory is None else directory
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{w.name}_{scale:g}.heap")
    if not os.path.exists(path):
        feats, labels = generate(w, scale=scale, seed=seed)
        write_table(path, feats, labels, page_bytes=w.page_bytes)
    return HeapFile(path)


def traced(w: Workload):
    return trace(lambda: ALGO[w.algorithm](w.n_features))


_CACHE: dict = {}


def time_mode(w: Workload, heap, mode: str, epochs: int = 1, warm: bool = True,
              pipelined: bool = True, device=None):
    """Returns (seconds, TrainResult). Warm cache preloads the buffer pool.

    Device modes reuse one engine per (workload, tuples, device) and run it
    once untimed before timing: accelerator synthesis (here the kernels'
    build at first use and CUDA's start) is an offline, catalog-time cost in
    DAnA's design (the FPGA is programmed before the query runs), so
    measured runtimes are steady-state query executions. The timed window
    ends with the models on the host (``TrainResult.models`` is numpy).
    ``pipelined=False`` selects the synchronous executor for benches that
    read per-phase timings (io/decode/compute add only there). ``madlib``
    runs on the CPU whatever ``device`` says."""
    if mode != "madlib":
        device = resolve_device(device)  # no card: raise before any work
    pool = BufferPool(pool_bytes=max(heap.n_pages, 1) * heap.layout.page_bytes,
                      page_bytes=heap.layout.page_bytes)

    def fill():
        if warm:
            pool.warm(heap)
        else:
            pool.clear()

    if mode == "madlib":
        g, part = traced(w)
        fill()
        t0 = time.perf_counter()
        res = solver.madlib_train(g, part, heap, max_epochs=epochs)
        return time.perf_counter() - t0, res
    key = (w.name, heap.n_tuples, device)
    if key not in _CACHE:
        g, part = traced(w)
        _CACHE[key] = (g, part, make_engine(g, part, device=device))
    g, part, engine = _CACHE[key]
    fill()
    wkey = (w.name, mode, heap.n_tuples, pipelined, device)
    if wkey not in _CACHE:
        solver.train(g, part, heap, pool=pool, mode=mode, engine=engine,
                     max_epochs=1, pipelined=pipelined)
        _CACHE[wkey] = True
        fill()
    t0 = time.perf_counter()
    res = solver.train(g, part, heap, pool=pool, mode=mode, engine=engine,
                       max_epochs=epochs, pipelined=pipelined)
    return time.perf_counter() - t0, res


def fpga_model(w: Workload, epochs: int = 1, bandwidth_scale: float = 1.0,
               n_threads: int | None = None, warm: bool = True):
    """Paper-fidelity analytic runtime at FULL dataset size (150 MHz VU9P)."""
    from repro_torch.db.page import PageLayout

    g, part = traced(w)
    layout = PageLayout(n_features=w.n_features, page_bytes=w.page_bytes)
    if n_threads is None:
        point = hwgen.explore(g, part, layout, n_tuples=w.n_tuples)
    else:
        coef = g.node(g.merge_id).attrs["coef"] if g.merge_id else 1
        point = hwgen._estimate(
            g, part, layout, w.n_tuples, hwgen.FPGASpec(), n_threads,
            max(hwgen._max_aus(hwgen.FPGASpec()) // max(n_threads, 1) // 8, 1),
            coef, sum(4 * g.node(m).size for m in g.model_ids),
        )
    if point is None:  # design point does not fit the FPGA (BRAM/AU budget)
        return None, None
    rt = hwgen.modeled_runtime_s(point, layout, w.n_tuples, epochs,
                                 bandwidth_scale=bandwidth_scale, warm_cache=warm)
    return point, rt


def bench_workloads(scale_public=0.01, scale_sn=0.004, scale_se=0.001):
    """The workload list each benchmark iterates, with per-tier scales."""
    out = []
    for name, w in WORKLOADS.items():
        if not w.synthetic:
            s = scale_public
        elif name.startswith("sn_"):
            s = scale_sn
        else:
            s = scale_se
        out.append((w, s))
    return out
