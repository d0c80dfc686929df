"""Parameter construction: tensors and logical sharding axes from one source
(counterpart of ``repro.models.params``, which it is held against).

``Maker`` builds a nested dict of parameters and, in lockstep, a nested dict
of logical-axis tuples, with ``repro``'s shapes, axes and ``fan_in`` scales.
Its draws come from an explicit ``torch.Generator`` on the parameters'
device, so a full-width model is drawn on the card and never on the host;
they are not ``jax.random``'s numbers. ``params_from_numpy`` carries a
``repro`` parameter tree over instead, so that both packages compute with the
same weights.

Storage type. ``repro`` keeps f32 masters and casts each matrix to the
compute type (bf16) at every use. Training does the same: its leaves are the
f32 masters (``cfg.param_dtype``), and each projection casts them at its use.
Serving may store the matrices already cast, once at load
(``dtype=torch.bfloat16``): every use then reads the same bits the
reference's cast would give, at half the bytes. Norm scales, which the
reference applies in f32, stay f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


class Maker:
    def __init__(self, generator: torch.Generator, device, dtype=torch.float32):
        self.gen = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def param(self, shape, axes, scale: float | str = "fan_in", dtype=None):
        """One N(0, scale) tensor (zeros for ``scale=0``) stored as ``dtype``
        (the maker's by default), and its logical axes. On the meta device
        (no generator) the tensor is its shape and type only."""
        if len(shape) != len(axes):
            raise ValueError(f"{shape} vs {axes}")
        dtype = self.dtype if dtype is None else dtype
        if scale == "fan_in":
            scale = 1.0 / np.sqrt(max(shape[0], 1))
        if self.device.type == "meta":
            arr = torch.empty(shape, dtype=dtype, device=self.device)
        elif scale == 0.0:
            arr = torch.zeros(shape, dtype=dtype, device=self.device)
        else:
            arr = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                              device=self.device).mul_(scale).to(dtype)
        return arr, tuple(axes)


def split_tree(tree):
    """Nested dict of (tensor, axes) -> (params, specs)."""
    if isinstance(tree, dict):
        params, specs = {}, {}
        for k, v in tree.items():
            params[k], specs[k] = split_tree(v)
        return params, specs
    if isinstance(tree, list):
        pairs = [split_tree(v) for v in tree]
        return [p for p, _ in pairs], [s for _, s in pairs]
    return tree


def stack_layers(maker_fn, n_layers: int):
    """``n_layers`` copies of a layer's (tensor, axes) tree stacked on a
    leading 'layers' axis. The stacked tensors are allocated once and filled
    layer by layer, so the peak is the stack plus one layer's draws."""

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        arr, axes = t
        out = torch.empty((n_layers, *arr.shape), dtype=arr.dtype, device=arr.device)
        out[0] = arr
        return out, ("layers", *axes)

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[0][i] = src[0]

    stacked = alloc(maker_fn(0))
    for i in range(1, n_layers):
        fill(stacked, maker_fn(i), i)
    return stacked


def leaves(tree):
    """The tensors of a nested dict/list tree, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists, with the matching leaves
    of ``rest`` (trees of the same structure) as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def count_params(params) -> int:
    return sum(int(t.numel()) for t in leaves(params))


def params_from_numpy(cfg, tree, device=None, dtype=torch.bfloat16):
    """A ``repro`` parameter tree (``model_zoo.init_params(cfg, key)[0]``,
    leaves as jax or numpy arrays) as the port's tree on ``device``
    (``None``: the card). Norm scales (leaves named ``scale``) stay f32;
    every other leaf is stored as ``dtype``, by round-to-nearest-even as
    ``astype`` rounds. Raises ``ValueError`` when the tree was not made for
    ``cfg`` (its embedding, its segments or, for an enc-dec model, its
    encoder's and decoder's depths differ)."""
    from repro_torch.models.transformer import segments_for

    def depth(stack):
        return len(stack["ln1"]["scale"]) if isinstance(stack, dict) else -1

    if cfg.family == "encdec":
        fits = (depth(tree.get("enc")) == cfg.enc_layers
                and depth(tree.get("dec")) == cfg.n_layers)
    else:
        fits = len(tree.get("segments", ())) == len(segments_for(cfg))
    if not fits or np.shape(tree["embed"]["table"]) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"the parameter tree was not made for {cfg.name}")
    device = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device=device, dtype=torch.float32 if key == "scale" else dtype)

    return walk(tree)
