"""Synthetic datasets: the paper's Table 3 workload suite.

The GLM generators reproduce the published dataset geometries (model topology,
tuple counts) at full size and at a --scale for CPU-runnable benchmarks.
Shaded rows (S/N, S/E) are the paper's synthetic nominal/extensive sets.

Copy of ``repro.data.synthetic`` (``Workload``, ``WORKLOADS``, ``generate``), which
it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    algorithm: str  # linear | logistic | svm | lrmf
    n_features: int  # model topology (n_items for lrmf)
    n_tuples: int
    synthetic: bool
    rank: int = 0
    page_bytes: int = 32 * 1024


# paper Table 3 (model topology, #tuples); page counts follow from the layout
WORKLOADS = {
    "remote_sensing_lr": Workload("remote_sensing_lr", "logistic", 54, 581_102, False),
    "remote_sensing_svm": Workload("remote_sensing_svm", "svm", 54, 581_102, False),
    "wlan": Workload("wlan", "logistic", 520, 19_937, False),
    "netflix": Workload("netflix", "lrmf", 3952, 6_040, False, rank=10,
                        page_bytes=32 * 1024),
    "patient": Workload("patient", "linear", 384, 53_500, False),
    "blog_feedback": Workload("blog_feedback", "linear", 280, 52_397, False),
    "sn_logistic": Workload("sn_logistic", "logistic", 2_000, 387_944, True),
    "sn_svm": Workload("sn_svm", "svm", 1_740, 678_392, True),
    "sn_lrmf": Workload("sn_lrmf", "lrmf", 19_880, 19_880, True, rank=10,
                        page_bytes=128 * 1024),
    "sn_linear": Workload("sn_linear", "linear", 8_000, 130_503, True),
    "se_logistic": Workload("se_logistic", "logistic", 6_033, 1_044_024, True),
    "se_svm": Workload("se_svm", "svm", 7_129, 1_356_784, True),
    "se_lrmf": Workload("se_lrmf", "lrmf", 28_002, 45_064, True, rank=10,
                        page_bytes=128 * 1024),
    "se_linear": Workload("se_linear", "linear", 8_000, 1_000_000, True),
}
# NOTE (DESIGN.md §2): LRMF tuples are wider than 32 KB (the paper spans pages
# with continuation pointers); we use larger pages to keep tuples page-local.


def generate(w: Workload, scale: float = 1.0, seed: int = 0):
    """Returns (features (N,D) f32, labels (N,) f32) with learnable signal."""
    rng = np.random.default_rng(seed)
    n = max(int(w.n_tuples * scale), 64)
    d = w.n_features
    if w.algorithm == "lrmf":
        n = max(int(w.n_tuples * scale), 32)
        u = rng.normal(0, 1, (n, w.rank)).astype(np.float32)
        v = rng.normal(0, 1, (d, w.rank)).astype(np.float32)
        feats = (u @ v.T + 0.05 * rng.normal(0, 1, (n, d))).astype(np.float32)
        return feats, np.zeros(n, np.float32)
    w_true = rng.normal(0, 1, d).astype(np.float32)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    z = x @ w_true / np.sqrt(d)
    if w.algorithm == "linear":
        y = z + 0.01 * rng.normal(0, 1, n)
    elif w.algorithm == "logistic":
        y = (z + 0.1 * rng.normal(0, 1, n) > 0).astype(np.float32)
    elif w.algorithm == "svm":
        y = np.sign(z + 0.1 * rng.normal(0, 1, n)).astype(np.float32)
    else:
        raise ValueError(w.algorithm)
    return x, y.astype(np.float32)

