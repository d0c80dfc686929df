"""Hardware generator (paper §6.1): restricted design-space exploration.

Given the hDFG, FPGA resource constraints, and the page layout, pick the
(threads x ACs-per-thread) design point with the best estimated throughput,
trading single-thread latency against merge parallelism — exactly the paper's
'smallest and best-performing design point'. The static cycle estimator is
viable for the same reason the paper gives: the hDFG is fixed, there is no
hardware-managed cache, and the schedule is static.

The same model produces the paper-fidelity runtime estimates used by the
benchmark suite (150 MHz clock, AXI/PCIe bandwidth bound for page transfer).

Copy of ``repro.core.hwgen``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hdfg import HDFG
from repro_torch.core.scheduler import AUS_PER_AC, Schedule, merge_tree_cycles, schedule
from repro_torch.core.striders import strider_cycles_per_page
from repro_torch.core.translator import Partition
from repro_torch.db.page import PageLayout


@dataclasses.dataclass(frozen=True)
class FPGASpec:
    """Xilinx Virtex UltraScale+ VU9P (paper Table 4)."""

    name: str = "VU9P"
    luts: int = 1_182_000
    flip_flops: int = 2_364_000
    freq_hz: float = 150e6
    bram_bytes: int = 44 * 1024 * 1024
    dsp_slices: int = 6840
    dsps_per_au: int = 5  # fused mul-add + nonlinear approximation
    max_compute_units: int = 1024  # paper §7.2
    io_bandwidth: float = 16e9  # PCIe gen3 x16 page streaming


@dataclasses.dataclass
class DesignPoint:
    n_threads: int
    acs_per_thread: int
    n_striders: int
    pre_schedule: Schedule
    post_schedule: Schedule
    conv_schedule: Schedule
    cycles_per_batch: int
    est_epoch_cycles: int
    bram_used: int

    @property
    def total_aus(self) -> int:
        return self.n_threads * self.acs_per_thread * AUS_PER_AC


def _max_aus(spec: FPGASpec) -> int:
    return min(spec.dsp_slices // spec.dsps_per_au, spec.max_compute_units)


def explore(
    g: HDFG,
    part: Partition,
    layout: PageLayout,
    n_tuples: int,
    spec: FPGASpec = FPGASpec(),
    merge_coef: int | None = None,
) -> DesignPoint:
    """Enumerate design points and return the best (paper's <5-min DSE)."""
    coef = merge_coef or (
        g.node(g.merge_id).attrs["coef"] if g.merge_id is not None else 1
    )
    max_aus = _max_aus(spec)

    # BRAM split (paper §6.1): model + extracted data per thread; the rest is
    # page buffers (one strider per resident page).
    model_bytes = sum(4 * g.node(m).size for m in g.model_ids)

    best: DesignPoint | None = None
    t = 1
    while t <= max(coef, 1):
        if t * AUS_PER_AC > max_aus:  # one AC per thread minimum (paper §7.2)
            break
        acs = max((max_aus // max(t, 1)) // AUS_PER_AC, 1)
        point = _estimate(g, part, layout, n_tuples, spec, t, acs, coef, model_bytes)
        if point is not None and (
            best is None
            or point.est_epoch_cycles < best.est_epoch_cycles
            or (
                point.est_epoch_cycles == best.est_epoch_cycles
                and point.total_aus < best.total_aus
            )
        ):
            best = point
        t *= 2
    assert best is not None
    return best


def _estimate(
    g: HDFG,
    part: Partition,
    layout: PageLayout,
    n_tuples: int,
    spec: FPGASpec,
    n_threads: int,
    acs_per_thread: int,
    coef: int,
    model_bytes: int,
) -> DesignPoint | None:
    pre = schedule(g, part.pre_merge, acs_per_thread)
    post = schedule(g, part.post_merge, acs_per_thread)
    conv = schedule(g, part.convergence, acs_per_thread)

    merge_size = g.node(g.merge_id).size if g.merge_id is not None else 0
    tree = merge_tree_cycles(merge_size, n_threads, acs_per_thread)

    # one batch = merge_coef tuples; each thread serially runs coef/t instances
    serial = math.ceil(coef / n_threads)
    cycles_per_batch = serial * pre.total_cycles + tree + post.total_cycles
    batches = math.ceil(n_tuples / max(coef, 1))
    exec_cycles = batches * cycles_per_batch + conv.total_cycles

    # access engine: striders unpack pages concurrently with execution
    per_thread_bytes = model_bytes + 4 * (layout.n_features + 1)
    pool = spec.bram_bytes - n_threads * per_thread_bytes
    if pool <= 0:
        return None
    n_striders = max(1, min(pool // layout.page_bytes, 64))
    n_pages = layout.n_pages(n_tuples)
    access_cycles = math.ceil(
        n_pages * strider_cycles_per_page(layout) / n_striders
    )

    # striders and the execution engine are interleaved (paper §5.1.1): the
    # epoch takes whichever engine is the bottleneck
    epoch_cycles = max(exec_cycles, access_cycles)
    bram_used = n_threads * per_thread_bytes + n_striders * layout.page_bytes
    return DesignPoint(
        n_threads=n_threads,
        acs_per_thread=acs_per_thread,
        n_striders=n_striders,
        pre_schedule=pre,
        post_schedule=post,
        conv_schedule=conv,
        cycles_per_batch=cycles_per_batch,
        est_epoch_cycles=epoch_cycles,
        bram_used=bram_used,
    )


def modeled_runtime_s(
    point: DesignPoint,
    layout: PageLayout,
    n_tuples: int,
    epochs: int,
    spec: FPGASpec = FPGASpec(),
    bandwidth_scale: float = 1.0,
    warm_cache: bool = True,
) -> dict:
    """Paper-fidelity end-to-end model: compute vs. page-transfer bound.

    Used by the Fig 12 (thread sweep), Fig 14 (bandwidth sweep) and Fig 16
    (TABLA = single-thread) reproductions.
    """
    n_pages = layout.n_pages(n_tuples)
    compute_s = epochs * point.est_epoch_cycles / spec.freq_hz
    io_bw = spec.io_bandwidth * bandwidth_scale
    transfer_s = epochs * n_pages * layout.page_bytes / io_bw
    disk_s = 0.0
    if not warm_cache:
        disk_s = n_pages * layout.page_bytes / 500e6  # one cold read of the heap
    total = max(compute_s, transfer_s) + disk_s
    return {
        "compute_s": compute_s,
        "transfer_s": transfer_s,
        "disk_s": disk_s,
        "total_s": total,
        "bound": "compute" if compute_s >= transfer_s else "bandwidth",
    }
