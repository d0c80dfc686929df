"""Hierarchical DataFlow Graph (hDFG) — DAnA's compiler IR.

Each node is a multi-dimensional operation; ``subnode_count`` is its
decomposition into atomic scalar operations (what the AC/AU scheduler places).
Edges are implied by ``inputs``. The graph is produced by the translator from
a traced DSL program and is what the backend (JAX codegen), the scheduler, and
the hardware generator all consume.

Copy of ``repro.core.hdfg``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

ELEMENTWISE = {"add", "sub", "mul", "div", "gt", "lt", "neg"}
NONLINEAR = {"sigmoid", "gaussian", "sqrt", "exp", "log", "relu", "sign", "abs"}
GROUP = {"sigma", "pi", "norm"}
SPECIAL = {"const", "merge"}


@dataclasses.dataclass
class Node:
    nid: int
    op: str
    inputs: tuple[int, ...]
    shape: tuple[int, ...]
    kind: str = "inter"  # model | input | output | meta | inter | const
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str | None = None

    @property
    def size(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1

    def subnode_count(self) -> int:
        """Atomic scalar ops this node decomposes into."""
        if self.op in ELEMENTWISE or self.op in NONLINEAR:
            return self.size
        if self.op == "sigma" or self.op == "pi":
            reduced = self.attrs.get("reduced_size", 1)
            return self.size * max(reduced - 1, 1)
        if self.op == "norm":
            # squares + tree of adds + sqrt
            n = self.attrs.get("reduced_size", 1)
            return 2 * n
        if self.op == "merge":
            return self.size  # per merge step, one combine op per element
        return 0  # leaves / consts

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        ins = ",".join(map(str, self.inputs))
        return f"%{self.nid}={self.op}({ins}):{self.shape}"


@dataclasses.dataclass
class HDFG:
    """Partitioned hDFG: leaves + ops, with the merge boundary made explicit."""

    nodes: list[Node]
    model_ids: list[int]
    input_ids: list[int]
    output_ids: list[int]
    meta_ids: list[int]
    merge_id: int | None  # the merge node, if any
    new_model_ids: list[int]  # setModel targets (parallel to model_ids)
    convergence_id: int | None
    epochs: int | None

    def node(self, nid: int) -> Node:
        return self.nodes[nid]

    def topo_order(self) -> list[Node]:
        return self.nodes  # construction order is topological by tracing

    def consumers(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {n.nid: [] for n in self.nodes}
        for n in self.nodes:
            for i in n.inputs:
                out[i].append(n.nid)
        return out

    def ancestors(self, roots: list[int], stop: set[int] = frozenset()) -> set[int]:
        seen: set[int] = set()
        stack = list(roots)
        while stack:
            nid = stack.pop()
            if nid in seen or nid in stop:
                continue
            seen.add(nid)
            stack.extend(self.nodes[nid].inputs)
        return seen

    # -- statistics used by hwgen ---------------------------------------------
    def total_subnodes(self, ids: set[int] | None = None) -> int:
        return sum(
            n.subnode_count() for n in self.nodes if ids is None or n.nid in ids
        )

    def op_histogram(self) -> dict[str, int]:
        hist: dict[str, int] = {}
        for n in self.nodes:
            if n.op not in ("leaf", "const"):
                hist[n.op] = hist.get(n.op, 0) + 1
        return hist

    def required_alu_ops(self) -> set[str]:
        """The ops an AU's ALU must be synthesized with (hardware generator)."""
        ops = set()
        for n in self.nodes:
            if n.op in ELEMENTWISE or n.op in NONLINEAR:
                ops.add(n.op)
            elif n.op == "sigma":
                ops.add("add")
            elif n.op == "pi":
                ops.add("mul")
            elif n.op == "norm":
                ops.update({"mul", "add", "sqrt"})
            elif n.op == "merge":
                ops.add({"+": "add", "*": "mul", "max": "max"}[n.attrs["op"]])
        return ops
