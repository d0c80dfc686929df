"""MADlib+PostgreSQL analogue baseline (counterpart of
``repro.baselines.madlib``, which it is held against).

Semantics of the in-RDBMS software path the paper benchmarks against:
  * pages are parsed tuple-at-a-time on the host (CPU data transformation),
  * the update rule executes per mini-batch on the host,
  * no device, no page-granular decode, no thread-level merge hardware.

It runs on the CPU by definition, whatever card the machine has: it is the
software baseline the accelerated path is compared against. It evaluates the
hDFG's PyTorch functions eagerly on CPU tensors, one tuple at a time, so the
learned models are directly comparable with the accelerated path.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.engine import default_metas, init_models, models_from_numpy
from repro_torch.core.torch_backend import compile_hdfg
from repro_torch.db.heap import HeapFile
from repro_torch.db.page import parse_page


def run(
    g,
    part,
    heap: HeapFile,
    max_epochs: int | None = None,
    models=None,
    seed: int = 0,
    batch: int | None = None,
):
    from repro_torch.core.solver import TrainResult

    t_start = time.perf_counter()
    pre_fn, post_fn, conv_fn, merge_spec = compile_hdfg(g, part)
    metas = default_metas(g)
    coef = batch or (merge_spec[1] if merge_spec else 1)
    models = (
        models_from_numpy(models, "cpu") if models is not None
        else init_models(g, np.random.default_rng(seed), scale=0.01, device="cpu")
    )
    epochs = max_epochs or g.epochs or 100

    # an explicit per-tuple inner loop for the update rule, like a row-wise
    # UDF aggregate; a vectorised batch would hide the tuple-at-a-time cost
    decode_s = compute_s = 0.0
    grad_norms: list[float] = []
    converged = False
    epochs_run = 0

    for epoch in range(epochs):
        last_merged = None
        for pid in range(heap.n_pages):
            t0 = time.perf_counter()
            page = heap.read_page(pid)
            feats, labels, _ = parse_page(page, heap.layout)
            feats, labels = torch.from_numpy(feats), torch.from_numpy(labels)
            t1 = time.perf_counter()
            decode_s += t1 - t0
            # per-batch aggregate over tuple-at-a-time transition states
            for s in range(0, feats.shape[0], coef):
                xb = feats[s : s + coef]
                yb = labels[s : s + coef]
                acc = None
                for i in range(xb.shape[0]):
                    v = pre_fn(models, xb[i], yb[i], metas)
                    acc = v if acc is None else acc + v
                models = post_fn(models, acc, metas)
                last_merged = acc
            compute_s += time.perf_counter() - t1
        grad_norms.append(float(torch.sqrt(torch.sum(torch.square(last_merged)))))
        epochs_run = epoch + 1
        if g.convergence_id is not None:
            if bool(conv_fn(models, last_merged, metas)):
                converged = True
                break

    return TrainResult(
        models=[m.numpy() for m in models],
        epochs_run=epochs_run,
        converged=converged,
        grad_norms=grad_norms,
        decode_s=decode_s,
        compute_s=compute_s,
        io_s=0.0,
        total_s=time.perf_counter() - t_start,
    )
