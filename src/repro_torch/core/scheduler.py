"""Static scheduler: hDFG sub-nodes -> AC/AU placement + cycle counts (paper §6.2).

The execution engine is a bank of threads, each `n_acs` Analytic Clusters of
8 Analytic Units running in selective-SIMD mode. The scheduler walks the hDFG
in topological order and, for every node, computes its placement (how many
lanes), its issue schedule (iterations of the collective AC instruction), and
its latency. Elementwise/non-linear nodes spread across all lanes (no intra-
node dependencies, paper §6.2); group operations map to reduction trees and
are placed to minimize inter-AC bus hops.

Per-node micro-instructions are emitted in the compressed collective form the
paper describes (one AC-level instruction + lane enable + iteration count),
which is also what keeps the instruction footprint small.

Copy of ``repro.core.scheduler``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hdfg import ELEMENTWISE, GROUP, NONLINEAR, HDFG

AUS_PER_AC = 8

# ALU issue latencies (cycles). Non-linear ops use the pipelined multi-cycle
# units the AU's ALU is synthesized with.
OP_LATENCY = {
    "add": 1, "sub": 1, "mul": 1, "gt": 1, "lt": 1, "neg": 1, "abs": 1,
    "sign": 1, "div": 4, "sqrt": 8, "sigmoid": 8, "gaussian": 10, "exp": 8,
    "log": 8, "relu": 1,
}
INTER_AC_HOP = 2  # shared line-topology bus penalty (cycles per tree level)


@dataclasses.dataclass
class NodeSched:
    nid: int
    op: str
    start: int
    end: int
    lanes: int
    iterations: int
    acs: int
    microcode: int  # packed collective instruction word


@dataclasses.dataclass
class Schedule:
    records: list[NodeSched]
    total_cycles: int
    lanes: int

    @property
    def instruction_count(self) -> int:
        return len(self.records)


# Execution-engine collective instruction encoding (paper §5.2 /appendix B):
#  [31:26] opcode  [25:16] iteration count  [15:8] lane mask mode  [7:0] dst slot
_EE_OPC = {
    op: i
    for i, op in enumerate(
        sorted(ELEMENTWISE | NONLINEAR | {"sigma", "pi", "norm", "merge"})
    )
}


def _pack(op: str, iters: int, lanes: int, dst: int) -> int:
    return (
        (_EE_OPC[op] << 26)
        | (min(iters, 1023) << 16)
        | ((lanes % 256) << 8)
        | (dst % 256)
    )


def schedule(g: HDFG, node_ids: list[int], n_acs: int) -> Schedule:
    """List-schedule the given nodes on one thread with ``n_acs`` ACs."""
    lanes = max(1, n_acs * AUS_PER_AC)
    ready_at: dict[int, int] = {}
    records: list[NodeSched] = []
    clock = 0

    for nid in node_ids:
        n = g.node(nid)
        if n.op in ("leaf", "const", "merge"):
            ready_at[nid] = 0
            continue
        start = max([ready_at.get(i, 0) for i in n.inputs] or [0])
        start = max(start, clock)

        if n.op in ELEMENTWISE or n.op in NONLINEAR:
            iters = math.ceil(max(n.size, 1) / lanes)
            lat = OP_LATENCY[n.op]
            end = start + iters + lat - 1  # pipelined issue
        elif n.op in GROUP:
            k = max(n.attrs.get("reduced_size", 1), 1)
            outs = max(n.size, 1)
            base = "mul" if n.op == "pi" else "add"
            # element ops first (squares for norm), then log-tree reduction
            pre = math.ceil(outs * k / lanes) if n.op == "norm" else 0
            levels = math.ceil(math.log2(k)) if k > 1 else 0
            tree = 0
            width = outs * k
            for _ in range(levels):
                width = math.ceil(width / 2)
                tree += math.ceil(width / lanes) * OP_LATENCY[base]
                if width > AUS_PER_AC:  # crosses AC boundary -> bus hop
                    tree += INTER_AC_HOP
            post = OP_LATENCY["sqrt"] if n.op == "norm" else 0
            iters = max(pre + tree + post, 1)
            end = start + iters
        else:  # pragma: no cover - unknown op guarded by backend already
            raise NotImplementedError(n.op)

        used_lanes = min(max(n.size, 1), lanes)
        records.append(
            NodeSched(
                nid=nid,
                op=n.op,
                start=start,
                end=end,
                lanes=used_lanes,
                iterations=end - start,
                acs=math.ceil(used_lanes / AUS_PER_AC),
                microcode=_pack(n.op, end - start, used_lanes, nid),
            )
        )
        ready_at[nid] = end
        clock = start  # independent nodes may overlap; issue port advances
    total = max((r.end for r in records), default=0)
    return Schedule(records=records, total_cycles=total, lanes=lanes)


def merge_tree_cycles(merge_size: int, n_threads: int, n_acs: int) -> int:
    """Cycles for the computationally-enabled tree bus combining thread results."""
    if n_threads <= 1:
        return 0
    lanes = max(1, n_acs * AUS_PER_AC)
    levels = math.ceil(math.log2(n_threads))
    per_level = math.ceil(max(merge_size, 1) / lanes) + INTER_AC_HOP
    return levels * per_level
