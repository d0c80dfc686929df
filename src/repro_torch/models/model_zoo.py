"""Uniform model API over every family and the shape cells' input specs
(counterpart of ``repro.models.model_zoo``, which it is held against);
encoder-decoder models dispatch to ``encdec``, the others to
``transformer``.

  init_params(cfg, seed, device, dtype) -> (params, logical-axis specs)
  loss_fn(cfg, remat)                   -> f(params, batch) -> scalar loss
  prefill_fn(cfg, remat)                -> f(params, batch) -> last-pos logits
  decode_fn(cfg)                        -> f(params, tokens, cache, pos)
                                           (pos: scalar or (B,) per-slot vector)
  make_cache(cfg, batch, seq, device)   -> dense decode cache
  make_paged_cache(cfg, num_blocks, block_size, device, *, slots,
                   ring_num_blocks, ring_width) -> block-pool cache
                                           (decoder-only families)
  demo_batch(cfg, batch, seq, rng, device) -> a random training batch
  cache_specs(cache, paged)             -> the caches' logical axes (the
                                           sharded server places them by
                                           these, ``meshes.tree_shardings``)
  input_specs(cfg, shape, device)       -> the inputs of a shape cell, as
                                           meta tensors by default (dry-runs)

Shape cells (``SHAPES``, the reference's four): train_4k / prefill_32k /
decode_32k / long_500k. ``device="meta"`` gives ``init_params``,
``make_cache`` and ``input_specs`` (and ``train.optimizer.adamw_init``, which
follows the parameters' device) their shapes-only form, the counterpart of
the reference's ``abstract=True``: nothing is allocated and nothing is
drawn.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch

import numpy as np

from repro_torch.core.engine import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, unembed


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: 524k dense-attention decode is "
            "quadratic/unbounded-cache by construction (DESIGN.md §5)"
        )
    return True, ""


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=torch.bfloat16):
    """Random weights drawn on ``device`` (``None``: the card) from a
    ``torch.Generator`` seeded with ``seed``, layer by layer, matrices stored
    as ``dtype`` and norm scales as f32. Serving stores bf16 (cast once);
    training passes ``getattr(torch, cfg.param_dtype)``, the f32 masters.
    On ``"meta"`` the tensors have their shapes and types only, and nothing
    is drawn (a generator cannot live there). Returns (params, specs)."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "encdec":
        return encdec.init_encdec(cfg, gen, device, dtype)
    return transformer.init_lm(cfg, gen, device, dtype)


def loss_counts(batch, cfg: ModelConfig) -> dict:
    """The token count of each term of the loss of ``batch``'s rows, by the
    term's name in ``layers.global_counts``: the next-token cross-entropy,
    and deepseek-v3's multi-token prediction (one position fewer)."""
    mask = batch["loss_mask"]
    counts = {"xent": mask.sum()}
    if cfg.mtp and cfg.family != "encdec":
        counts["mtp"] = mask[:, 1:].sum()
    return counts


def loss_fn(cfg: ModelConfig, remat: str = "full", wkv_impl: str = "kernel"):
    """f(params, batch) -> the mean next-token loss (``encdec.encdec_loss``
    or ``transformer.lm_loss``). Its ``counts(batch)`` gives the count of
    each loss term (``loss_counts``), which a train step on a mesh sums over
    the data axes."""
    if cfg.family == "encdec":
        fn = partial(encdec.encdec_loss, cfg=cfg, remat=remat)
    else:
        fn = partial(transformer.lm_loss, cfg=cfg, remat=remat, wkv_impl=wkv_impl)
    fn.counts = partial(loss_counts, cfg=cfg)
    return fn


def prefill_fn(cfg: ModelConfig, remat: str = "none", wkv_impl: str = "kernel"):
    """Full-sequence forward -> logits (B, padded_vocab) at the last position
    (inference prefill; no loss). Enc-dec: ``encode`` the frames, then the
    decoder over the whole token sequence."""
    if cfg.family == "encdec":
        def run_encdec(params, batch):
            enc_out = encdec.encode(params, batch["frames"], cfg, remat)
            h = encdec.decode_hidden(params, batch["tokens"], enc_out, cfg, remat)
            return unembed(params["embed"], h[:, -1:], cfg)[:, 0]

        return run_encdec

    def run(params, batch):
        x, positions = transformer.embed_inputs(params, batch, cfg)
        x = transformer._run_segments(params["segments"], x, cfg, positions, remat, wkv_impl)
        h = apply_norm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embed"], h[:, -1:], cfg)[:, 0]

    return run


def decode_fn(cfg: ModelConfig):
    """One decode step: f(params, tokens (B,), cache, pos, **kw) -> (logits,
    cache). ``pos`` is a scalar position, or a (B,) vector when every cache
    row decodes at its own position (continuous batching). Extra kwargs
    (``paged``, ``slot``, ``write_ok``) forward to ``lm_decode_step``;
    enc-dec's ``encdec_decode_step`` takes none."""
    if cfg.family == "encdec":
        return partial(encdec.encdec_decode_step, cfg=cfg)
    return partial(transformer.lm_decode_step, cfg=cfg)


def make_cache(cfg: ModelConfig, batch: int, seq: int, device=None):
    """Dense decode caches (zeros; on ``"meta"`` shapes only); enc-dec's
    cross K/V hold ``seq`` source rows, as the reference's do."""
    if cfg.family == "encdec":
        return encdec.init_encdec_cache(cfg, batch, seq, src=seq, device=resolve_device(device))
    return transformer.init_cache(cfg, batch, seq, resolve_device(device))


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, device=None, *,
                     slots: int = 0, ring_num_blocks: int = 0, ring_width: int = 0):
    """Paged decode cache: attention leaves are block pools
    ``(num_blocks + 1, block_size, ...)`` shared across slots
    (serve/kv_pool.py allocates the first ``num_blocks``); sliding-window
    layers' pools hold ``ring_num_blocks`` when ``ring_width`` is set, and
    recurrent state ``slots`` dense rows. Enc-dec has none (``ValueError``,
    as in the reference)."""
    if cfg.family == "encdec":
        raise ValueError(f"family {cfg.family!r} has no paged attention cache")
    return transformer.init_paged_cache(cfg, num_blocks, block_size, resolve_device(device),
                                        slots=slots, ring_num_blocks=ring_num_blocks,
                                        ring_width=ring_width)


def demo_batch(cfg: ModelConfig, batch: int, seq: int, rng=None, device=None) -> dict:
    """A random training batch from ``rng`` (numpy; default seed 0), the same
    numbers as ``repro``'s ``demo_batch`` with the same generator state: of
    ``seq`` positions, ``cfg.vis_tokens`` are patches (f32 ``patches``
    (batch, vis_tokens, d_model)) and the rest text; enc-dec models take
    f32 ``frames`` (batch, seq, d_model) besides."""
    rng = rng or np.random.default_rng(0)
    device = resolve_device(device)
    t = seq - cfg.vis_tokens
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, t + 1)))
    out = {
        "tokens": tokens[:, :-1].to(device, torch.int32),
        "targets": tokens[:, 1:].to(device, torch.int32),
        "loss_mask": torch.ones((batch, t), dtype=torch.float32, device=device),
    }
    if cfg.vis_tokens:
        patches = rng.normal(0, 1, (batch, cfg.vis_tokens, cfg.d_model))
        out["patches"] = torch.from_numpy(patches).to(device, torch.float32)
    if cfg.family == "encdec":
        frames = rng.normal(0, 1, (batch, seq, cfg.d_model))
        out["frames"] = torch.from_numpy(frames).to(device, torch.float32)
    return out


# --------------------------------------------------------------------------
# the caches' logical axes (the reference's, lines 143-185)
# --------------------------------------------------------------------------
_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "xk": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "xv": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "c": ("batch", "kv_seq", "lora"),
    "kr": ("batch", "kv_seq", "head_dim"),
    "wkv": ("batch", "heads", "head_dim", "head_dim"),
    "shift_t": ("batch", "seq", "embed"),
    "shift_c": ("batch", "seq", "embed"),
    "ssm": ("batch", "inner", "state"),
    "conv": ("batch", "conv", "inner"),
}

# paged layout (make_paged_cache): attention leaves lose their batch dim and
# gain (kv_blocks, block): the block pool shards over the data axes instead
# of the slot dim, per meshes.SERVE_CACHE_RULES
_PAGED_CACHE_AXES = {
    "k": ("kv_blocks", "block", "kv_heads", "head_dim"),
    "v": ("kv_blocks", "block", "kv_heads", "head_dim"),
    "c": ("kv_blocks", "block", "lora"),
    "kr": ("kv_blocks", "block", "head_dim"),
}


def cache_specs(cache, paged: bool = False):
    """Logical-axis tree parallel to a decode cache: each leaf's axes, with
    ``"layers"`` in front of a layer-stacked leaf. ``paged=True`` maps the
    attention leaves of a ``make_paged_cache`` tree to their block-pool
    axes; per-slot recurrent leaves keep the dense axes."""
    axes_map = {**_CACHE_AXES, **_PAGED_CACHE_AXES} if paged else _CACHE_AXES

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        axes = axes_map[key]
        if len(node.shape) == len(axes) + 1:  # stacked over layers
            return ("layers",) + axes
        return axes

    return walk(cache)


# --------------------------------------------------------------------------
# the shape cells' inputs (the reference's, lines 188-210)
# --------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """Every model input of the cell ``shape``, as empty tensors on
    ``device`` (meta: shapes and types only), with the reference's names,
    shapes and types: decode takes ``tokens`` (B,) and a scalar ``pos``;
    train and prefill take ``tokens``/``targets``/``loss_mask`` over the
    text positions, the VLM's ``patches`` and enc-dec's ``frames``."""
    b, s = shape.global_batch, shape.seq_len
    empty = partial(torch.empty, device=resolve_device(device))
    if shape.kind == "decode":
        return {"tokens": empty((b,), dtype=torch.int32),
                "pos": empty((), dtype=torch.int32)}
    t = _text_len(cfg, s)
    specs = {
        "tokens": empty((b, t), dtype=torch.int32),
        "targets": empty((b, t), dtype=torch.int32),
        "loss_mask": empty((b, t), dtype=torch.float32),
    }
    if cfg.vis_tokens:
        specs["patches"] = empty((b, cfg.vis_tokens, cfg.d_model), dtype=torch.float32)
    if cfg.family == "encdec":
        specs["frames"] = empty((b, s, cfg.d_model), dtype=torch.float32)
    return specs


def _text_len(cfg: ModelConfig, s: int) -> int:
    return s - cfg.vis_tokens if cfg.vis_tokens else s
