"""Decoder-only LM assembly for serving (counterpart of
``repro.models.transformer``, lines 45-130 and 240-434, which it is held
against).

The layer stack is a list of homogeneous *segments*; each segment's
parameters are stacked on a leading layer axis. ``repro`` runs a segment with
``lax.scan``; here a Python loop walks the stacked tensors (each layer's
parameters and caches are views, so nothing is copied).

``segments_for`` covers every family. The port serves the families whose
segments are all ``attn_mlp`` with GQA attention (dense and VLM backbones:
internlm2, mistral-nemo, deepseek-67b, internvl2). The others raise
``NotImplementedError`` naming the ROADMAP item that ports them. The training
loss and the prefill forward wait for the training slice (ROADMAP A18).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed,
    make_embedding,
    make_mlp,
    make_norm,
    unembed,
)
from repro_torch.models.params import Maker, split_tree, stack_layers


# --------------------------------------------------------------------------
# segment structure
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str  # attn_mlp | attn_moe | rwkv | hybrid_swa | hybrid_global
    n_layers: int


def segments_for(cfg: ModelConfig) -> list[Segment]:
    if cfg.family == "ssm":
        return [Segment("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid":
        segs: list[Segment] = []
        globals_ = set(cfg.global_layer_ids())
        run = 0
        for i in range(cfg.n_layers):
            if i in globals_:
                if run:
                    segs.append(Segment("hybrid_swa", run))
                    run = 0
                segs.append(Segment("hybrid_global", 1))
            else:
                run += 1
        if run:
            segs.append(Segment("hybrid_swa", run))
        return segs
    if cfg.is_moe:
        segs = []
        if cfg.first_dense_layers:
            segs.append(Segment("attn_mlp", cfg.first_dense_layers))
        segs.append(Segment("attn_moe", cfg.n_layers - cfg.first_dense_layers))
        return segs
    return [Segment("attn_mlp", cfg.n_layers)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port cannot serve yet,
    naming the ROADMAP item that ports it."""
    if cfg.family == "encdec":
        why = "encoder-decoder models wait for ROADMAP A15 (encdec)"
    elif cfg.attn_kind == "mla":
        why = "MLA attention waits for ROADMAP A13 (MLA decode, B5 at its shapes)"
    elif cfg.family == "ssm":
        why = "RWKV6 layers wait for ROADMAP A14 (ssm.py, kernel B6)"
    elif cfg.family == "hybrid":
        why = "Mamba and sliding-window layers wait for ROADMAP A14 (ssm.py, SWA rings)"
    elif cfg.is_moe:
        why = "MoE layers wait for ROADMAP A14 (moe.py)"
    elif cfg.mtp:
        why = "multi-token prediction waits for ROADMAP A18"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: {why}")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def _make_layer(m: Maker, cfg: ModelConfig):
    return {
        "ln1": make_norm(m, cfg.d_model),
        "ln2": make_norm(m, cfg.d_model),
        "attn": attn.make_gqa(m, cfg),
        "mlp": make_mlp(m, cfg.d_model, cfg.d_ff),
    }


def init_lm(cfg: ModelConfig, generator: torch.Generator, device,
            dtype=torch.bfloat16):
    """Returns (params, specs): nested dicts; repeated layers stacked. The
    matrices are stored as ``dtype``, the norm scales as f32 (see params)."""
    check_supported(cfg)
    m = Maker(generator, device, dtype)
    tree = {
        "embed": make_embedding(m, cfg),
        "final_norm": make_norm(m, cfg.d_model),
        "segments": [stack_layers(lambda i: _make_layer(m, cfg), s.n_layers)
                     for s in segments_for(cfg)],
    }
    if cfg.vis_tokens:
        tree["vis_proj"] = m.param((cfg.d_model, cfg.d_model), ("embed", "embed"))
    return split_tree(tree)


# --------------------------------------------------------------------------
# decode (one token, batched, cached)
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq: int, device):
    """Dense caches, one dict per segment of layer-stacked
    (L, batch + 1, seq, KVH, D) tensors (see attention: the spare row)."""
    check_supported(cfg)
    layer = attn.init_gqa_cache(cfg, batch, seq, device=device)
    return [_stacked(layer, s.n_layers) for s in segments_for(cfg)]


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, device):
    """Paged caches: block pools (L, num_blocks + 1, block_size, KVH, D)
    shared by all slots (see attention: the spare block). The reference's
    per-slot recurrent state and SWA ring pools belong to families the port
    does not serve yet."""
    check_supported(cfg)
    layer = attn.init_gqa_cache_paged(cfg, num_blocks, block_size, device=device)
    return [_stacked(layer, s.n_layers) for s in segments_for(cfg)]


def _stacked(layer_cache, n_layers):
    return {k: v.new_zeros((n_layers, *v.shape)) for k, v in layer_cache.items()}


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _layer_decode(p, x, cache, pos, cfg: ModelConfig, paged=None, slot=None,
                  write_ok=None):
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if paged is None:
        a, _ = attn.gqa_decode(p["attn"], h, cache, pos, cfg, slot=slot,
                               write_ok=write_ok)
    else:
        a, _ = attn.gqa_decode_paged(
            p["attn"], h, cache, pos, cfg, table=paged["table"],
            block_size=paged["block_size"], max_seq=paged["max_seq"],
            write_ok=paged["write_ok"], impl=paged.get("impl", "gather"),
        )
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h)


def lm_decode_step(params, tokens, caches, pos, cfg: ModelConfig, paged=None,
                   slot=None, write_ok=None):
    """tokens (B,) int; caches from init_cache; pos: current position, a
    scalar or a (B,) vector of per-slot positions (continuous batching).
    ``paged`` switches the attention caches to the block-pool layout
    (init_paged_cache): a dict with ``table`` ((B, nb) int32, or per-token
    (T, nb) when ``slot`` is given), ``write_ok`` (B,) bool (or None),
    ``block_size``/``max_seq``, and optional ``impl`` (``"gather"`` |
    ``"kernel"`` paged-attention read path). ``slot``/``write_ok`` enable
    token-level batching over dense caches: tokens is a flattened (T,) mix of
    prefill chunks and decode tokens, ``slot`` (T,) maps each token to its
    cache row, and ``write_ok`` (T,) masks padding rows out of cache writes.
    The caches are updated in place. Returns (logits (B, padded_vocab),
    caches)."""
    x = embed(params["embed"], tokens[:, None], cfg)
    for seg, sp, sc in zip(segments_for(cfg), params["segments"], caches):
        for i in range(seg.n_layers):
            x = _layer_decode(_layer(sp, i), x, _layer(sc, i), pos, cfg,
                              paged=paged, slot=slot, write_ok=write_ok)
    h = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], h, cfg)[:, 0], caches
