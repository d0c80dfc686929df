"""Uniform model API for serving (counterpart of ``repro.models.model_zoo``,
lines 53-168, which it is held against).

  init_params(cfg, seed, device, dtype) -> (params, logical-axis specs)
  decode_fn(cfg)                        -> f(params, tokens, cache, pos)
                                           (pos: scalar or (B,) per-slot vector)
  make_cache(cfg, batch, seq, device)   -> dense decode cache
  make_paged_cache(cfg, num_blocks, block_size, device) -> block-pool cache

``loss_fn``, ``prefill_fn``, the shape cells and the dry-run input specs
wait for the training and tooling slices (ROADMAP A18, A21).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=torch.bfloat16):
    """Random weights drawn on ``device`` (``None``: the card) from a
    ``torch.Generator`` seeded with ``seed``, layer by layer, matrices stored
    as ``dtype`` and norm scales as f32. Returns (params, specs)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return transformer.init_lm(cfg, gen, device, dtype)


def decode_fn(cfg: ModelConfig):
    """One decode step: f(params, tokens (B,), cache, pos, **kw) -> (logits,
    cache). ``pos`` is a scalar position, or a (B,) vector when every cache
    row decodes at its own position (continuous batching). Extra kwargs
    (``paged``, ``slot``, ``write_ok``) forward to ``lm_decode_step``."""
    transformer.check_supported(cfg)
    return partial(transformer.lm_decode_step, cfg=cfg)


def make_cache(cfg: ModelConfig, batch: int, seq: int, device=None):
    return transformer.init_cache(cfg, batch, seq, resolve_device(device))


def make_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, device=None):
    """Paged decode cache: attention leaves are block pools
    ``(num_blocks + 1, block_size, ...)`` shared across slots
    (serve/kv_pool.py allocates the first ``num_blocks``)."""
    return transformer.init_paged_cache(cfg, num_blocks, block_size,
                                        resolve_device(device))
