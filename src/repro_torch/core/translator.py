"""Translator: traced DSL program -> validated, partitioned hDFG (paper §4.4).

Responsibilities (mirroring the paper): maintain the function boundary between
the parallelizable update rule and the merge function, keep the convergence
check separate (it runs once per epoch), and expose parallelism metadata for
the backend/scheduler.

Copy of ``repro.core.translator``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import dsl
from repro_torch.core.hdfg import HDFG


@dataclasses.dataclass
class Partition:
    """Node-id sets for the three phases of one training step."""

    pre_merge: list[int]  # per-tuple update-rule portion (parallel threads)
    post_merge: list[int]  # merge -> new model (once per batch)
    convergence: list[int]  # once per epoch


def translate(builder=None) -> tuple[HDFG, Partition]:
    b = builder or dsl.current_builder()
    if not b.new_model_ids:
        raise ValueError("UDF must call algo.setModel(...)")
    if b.convergence_id is None and b.epochs is None:
        raise ValueError("UDF must set a terminator (setConvergence or setEpochs)")
    if len(b.new_model_ids) != len(b.model_ids):
        raise ValueError(
            f"setModel got {len(b.new_model_ids)} vars for {len(b.model_ids)} models"
        )
    for mid, nid in zip(b.model_ids, b.new_model_ids):
        if b.nodes[mid].shape != b.nodes[nid].shape:
            raise ValueError(
                f"updated model shape {b.nodes[nid].shape} != declared "
                f"{b.nodes[mid].shape}"
            )

    g = HDFG(
        nodes=b.nodes,
        model_ids=b.model_ids,
        input_ids=b.input_ids,
        output_ids=b.output_ids,
        meta_ids=b.meta_ids,
        merge_id=b.merge_id,
        new_model_ids=b.new_model_ids,
        convergence_id=b.convergence_id,
        epochs=b.epochs,
    )

    leaves = set(g.model_ids) | set(g.input_ids) | set(g.output_ids) | set(g.meta_ids)

    if g.merge_id is not None:
        merge_node = g.node(g.merge_id)
        pre = g.ancestors(list(merge_node.inputs)) - leaves
        post_roots = list(g.new_model_ids)
        post = g.ancestors(post_roots, stop=pre | {g.merge_id}) - leaves
        post |= {g.merge_id}
        # Validation: nothing after the merge may read per-tuple data directly —
        # that would break thread-level parallelism (paper's function boundary).
        for nid in post - {g.merge_id}:
            node = g.node(nid)
            for i in node.inputs:
                if i in g.input_ids or i in g.output_ids:
                    raise ValueError(
                        f"node {node} reads per-tuple data after the merge point"
                    )
    else:
        # No merge: the whole update rule is sequential (merge coefficient 1).
        pre = g.ancestors(list(g.new_model_ids)) - leaves
        post = set()

    conv = (
        g.ancestors([g.convergence_id], stop=pre | post) - leaves
        if g.convergence_id is not None
        else set()
    )

    order = [n.nid for n in g.topo_order()]
    part = Partition(
        pre_merge=[i for i in order if i in pre],
        post_merge=[i for i in order if i in post],
        convergence=[i for i in order if i in conv and i not in pre and i not in post],
    )
    return g, part


def trace(fn, *args, **kwargs) -> tuple[HDFG, Partition]:
    """Trace a UDF-defining function in a fresh builder and translate it."""
    dsl.reset()
    fn(*args, **kwargs)
    return translate()
