"""hDFG -> executable PyTorch functions (counterpart of
``repro.core.jax_backend``, which it is held against).

The backend emits three functions from the partitioned graph:

  pre_fn(models, x, y, metas)        -> merge-input value(s), per tuple
  post_fn(models, merged, metas)     -> updated models
  conv_fn(models, merged, metas)     -> bool convergence flag (0-d tensor)

``pre_fn`` is one accelerator *thread*; the engine maps it over the merge
coefficient with ``torch.func.vmap`` and folds the results with the merge
operator (the tree bus). Constants and metas stay Python floats, so they ride
into each operation as scalar arguments: no host-to-device copy, and an f32
tensor combined with one stays f32, as JAX's weakly typed scalars do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hdfg import HDFG
from repro_torch.core.translator import Partition


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.float32)


_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "gt": lambda a, b: torch.gt(_as_tensor(a), b).to(torch.float32),
    "lt": lambda a, b: torch.lt(_as_tensor(a), b).to(torch.float32),
}
_UNOPS = {
    "neg": lambda x: -x,
    "sigmoid": lambda x: torch.sigmoid(_as_tensor(x)),
    "gaussian": lambda x: torch.exp(-torch.square(_as_tensor(x))),
    "sqrt": lambda x: torch.sqrt(_as_tensor(x)),
    "exp": lambda x: torch.exp(_as_tensor(x)),
    "log": lambda x: torch.log(_as_tensor(x)),
    "relu": lambda x: torch.relu(_as_tensor(x)),
    "sign": lambda x: torch.sign(_as_tensor(x)),
    "abs": lambda x: torch.abs(_as_tensor(x)),
}
MERGE_OPS = {
    "+": lambda v, mask, dim: torch.sum(v * mask, dim=dim),
    "*": lambda v, mask, dim: torch.prod(torch.where(mask > 0, v, 1.0), dim=dim),
    "max": lambda v, mask, dim: torch.amax(
        torch.where(mask > 0, v, -torch.inf), dim=dim
    ),
}


def _outer_broadcast(a, b, out_shape):
    """Realize the DSL's outer-replication semantics (see dsl._broadcast).
    Python-float operands are scalars and broadcast as they are."""
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        return a, b
    if a.shape == b.shape:
        return a, b
    if a.dim() != b.dim():
        # right-aligned replication of the lower-rank operand, computed from
        # the operands so post_fn stays shape-polymorphic (broadcast_tensors,
        # not broadcast_shapes: that one's Python reference costs ~45 us a
        # call, and its first call imports sympy, seconds)
        return torch.broadcast_tensors(a, b)
    # equal rank, outer replication: a -> prefix_a x 1s x suffix, b -> 1s x prefix_b x suffix
    k = 0
    while k < a.dim() and a.shape[a.dim() - 1 - k] == b.shape[b.dim() - 1 - k]:
        k += 1
    if len(out_shape) > a.dim():
        pa, pb = a.dim() - k, b.dim() - k
        a = a.reshape(a.shape[:pa] + (1,) * pb + a.shape[pa:])
        b = b.reshape((1,) * pa + b.shape)
    return a.broadcast_to(out_shape), b.broadcast_to(out_shape)


def _eval_nodes(g: HDFG, node_ids, env):
    for nid in node_ids:
        n = g.node(nid)
        if n.op in _BINOPS:
            a, b = env[n.inputs[0]], env[n.inputs[1]]
            if not isinstance(b, torch.Tensor):
                # two scalars combine in f32, as jnp.asarray would have them
                a = _as_tensor(a)
            a, b = _outer_broadcast(a, b, n.shape)
            env[nid] = _BINOPS[n.op](a, b)
        elif n.op in _UNOPS:
            env[nid] = _UNOPS[n.op](env[n.inputs[0]])
        elif n.op in ("sigma", "pi", "norm"):
            x = _as_tensor(env[n.inputs[0]])
            axis = n.attrs.get("axis")
            if n.op == "norm":
                x = torch.square(x)
            if n.op == "pi":
                red = torch.prod(x) if axis is None else torch.prod(x, dim=axis - 1)
            else:
                red = torch.sum(x) if axis is None else torch.sum(x, dim=axis - 1)
            env[nid] = torch.sqrt(red) if n.op == "norm" else red
        elif n.op == "const":
            # the f32 constant, as jnp.float32(value) holds it
            env[nid] = float(np.float32(n.attrs["value"]))
        elif n.op == "merge":
            pass  # handled by the engine between pre_fn and post_fn
        elif n.op == "leaf":
            if nid not in env:
                raise ValueError(f"unbound leaf {n}")
        else:
            raise NotImplementedError(f"op {n.op}")
    return env


def _leaf_env(g: HDFG, models, x, y, metas):
    env: dict = {}
    for k, mid in enumerate(g.model_ids):
        env[mid] = models[k]
    if x is not None:
        for k, iid in enumerate(g.input_ids):
            xv = x if len(g.input_ids) == 1 else x[k]
            shape = g.node(iid).shape
            env[iid] = xv.reshape(shape) if shape else xv
    if y is not None:
        for k, oid in enumerate(g.output_ids):
            env[oid] = y if len(g.output_ids) == 1 else y[k]
    for k, nid in enumerate(g.meta_ids):
        env[nid] = metas[k]
    return env


def compile_hdfg(g: HDFG, part: Partition):
    """Returns (pre_fn, post_fn, conv_fn, merge_spec).

    merge_spec = (op_name, coef) or None when the UDF has no merge (pure
    sequential SGD). Without a merge, pre_fn directly returns updated models
    and post_fn is identity.
    """
    merge_spec = None
    if g.merge_id is not None:
        mnode = g.node(g.merge_id)
        merge_spec = (mnode.attrs["op"], mnode.attrs["coef"])
        merge_src = mnode.inputs[0]

        def pre_fn(models, x, y, metas):
            env = _leaf_env(g, models, x, y, metas)
            env = _eval_nodes(g, part.pre_merge, env)
            return env[merge_src]

        def post_fn(models, merged, metas):
            env = _leaf_env(g, models, None, None, metas)
            env[g.merge_id] = merged
            env = _eval_nodes(g, [i for i in part.post_merge if i != g.merge_id], env)
            return [env[nid] for nid in g.new_model_ids]

    else:

        def pre_fn(models, x, y, metas):
            env = _leaf_env(g, models, x, y, metas)
            env = _eval_nodes(g, part.pre_merge, env)
            return [env[nid] for nid in g.new_model_ids]

        def post_fn(models, merged, metas):
            return merged

    def conv_fn(models, merged, metas):
        if g.convergence_id is None:
            return torch.tensor(False)
        env = _leaf_env(g, models, None, None, metas)
        if g.merge_id is not None:
            env[g.merge_id] = merged
            env = _eval_nodes(g, [i for i in part.post_merge if i != g.merge_id], env)
        env = _eval_nodes(g, part.convergence, env)
        return _as_tensor(env[g.convergence_id]) > 0

    return pre_fn, post_fn, conv_fn, merge_spec


def reference_sgd(g: HDFG, part: Partition):
    """Sequential tuple-at-a-time reference (merge coefficient 1): the oracle
    the multi-threaded engine is validated against, and the semantic model of
    the paper's single-thread baseline (TABLA-style)."""
    pre_fn, post_fn, conv_fn, merge_spec = compile_hdfg(g, part)

    def step(models, xi, yi, metas):
        v = pre_fn(models, xi, yi, metas)
        if merge_spec is None:
            return v
        # a single tuple merging with itself is identity for +/max; for "+"
        # with averaging semantics the post function handles the coefficient
        return post_fn(models, v, metas)

    return step
