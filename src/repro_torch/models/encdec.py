"""Encoder-decoder transformer, the seamless-m4t backbone (counterpart of
``repro.models.encdec``, which it is held against).

The speech frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``frames`` (B, S_src, d_model). The encoder is
a bidirectional transformer over them, the decoder a causal transformer
with cross attention to the encoder's output, both on the attention and
layer modules of the decoder-only stack. ``repro`` runs the stacked layers
with ``lax.scan`` (and ``lax.map``); here a Python loop walks views of the
stacked tensors, as ``transformer`` does. Decode keeps the decoder's own
K/V in a dense cache (``k``/``v``, written in place, with ``attention``'s
spare landing row) beside the cross K/V of the source (``xk``/``xv``),
which ``precompute_cross_kv`` computes once a source.
"""
from __future__ import annotations

import functools

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
    softmax_xent,
    unembed,
)
from repro_torch.models.params import Maker, split_tree, stack_layers
from repro_torch.models.transformer import _layer, _unbind_layers, run_stacked


def _make_enc_layer(m: Maker, cfg: ModelConfig):
    return {
        "ln1": make_norm(m, cfg.d_model),
        "attn": attn.make_gqa(m, cfg),
        "ln2": make_norm(m, cfg.d_model),
        "mlp": make_mlp(m, cfg.d_model, cfg.d_ff),
    }


def _make_dec_layer(m: Maker, cfg: ModelConfig):
    return {
        "ln1": make_norm(m, cfg.d_model),
        "attn": attn.make_gqa(m, cfg),
        "ln_x": make_norm(m, cfg.d_model),
        "cross": attn.make_cross(m, cfg),
        "ln2": make_norm(m, cfg.d_model),
        "mlp": make_mlp(m, cfg.d_model, cfg.d_ff),
    }


def init_encdec(cfg: ModelConfig, generator: torch.Generator, device,
                dtype=torch.bfloat16):
    """Returns (params, specs) with the reference's tree: ``embed``,
    ``frame_proj``, the stacked ``enc`` layers, ``enc_norm``, the stacked
    ``dec`` layers and ``final_norm``; matrices stored as ``dtype``, norm
    scales as f32."""
    m = Maker(generator, device, dtype)
    tree = {
        "embed": make_embedding(m, cfg),
        "frame_proj": m.param((cfg.d_model, cfg.d_model), ("embed", "embed")),
        "enc": stack_layers(lambda i: _make_enc_layer(m, cfg), cfg.enc_layers),
        "enc_norm": make_norm(m, cfg.d_model),
        "dec": stack_layers(lambda i: _make_dec_layer(m, cfg), cfg.n_layers),
        "final_norm": make_norm(m, cfg.d_model),
    }
    return split_tree(tree)


def _enc_layer(p, x, positions, cfg: ModelConfig):
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_train(p["attn"], h, cfg, positions, kind="bidir")
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h)


def _dec_layer(p, x, enc_out, positions, cfg: ModelConfig):
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_train(p["attn"], h, cfg, positions, kind="causal")
    h = apply_norm(p["ln_x"], x, cfg.norm_eps)
    x = x + attn.cross_train(p["cross"], h, enc_out, cfg)
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h)


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def encode(params, frames, cfg: ModelConfig, remat: str = "full"):
    """frames (B, S_src, d) -> the encoder's output (B, S_src, d) in bf16:
    the frames cast to bf16 through ``frame_proj``, the bidirectional layers
    at RoPE positions 0..S_src-1, the final norm. ``remat`` as in
    ``transformer.run_stacked``."""
    b, s, _ = frames.shape
    x = frames.to(torch.bfloat16) @ params["frame_proj"].to(torch.bfloat16)
    x = run_stacked(functools.partial(_enc_layer, cfg=cfg), params["enc"], cfg.enc_layers, x,
                    _positions(b, s, x.device), remat=remat)
    return apply_norm(params["enc_norm"], x, cfg.norm_eps)


def decode_hidden(params, tokens, enc_out, cfg: ModelConfig, remat: str = "full"):
    """The decoder over the whole sequence: tokens (B, S) against enc_out
    -> the final-normed hidden states (B, S, d)."""
    b, s = tokens.shape
    x = embed(params["embed"], tokens, cfg)
    x = run_stacked(functools.partial(_dec_layer, cfg=cfg), params["dec"], cfg.n_layers, x,
                    enc_out, _positions(b, s, x.device), remat=remat)
    return apply_norm(params["final_norm"], x, cfg.norm_eps)


def encdec_loss(params, batch, cfg: ModelConfig, remat: str = "full"):
    """Mean next-token cross-entropy of the decoder over ``batch``
    (``tokens``, ``targets`` (B, S) int, ``loss_mask`` (B, S) f32,
    ``frames`` (B, S_src, d) f32)."""
    enc_out = encode(params, batch["frames"], cfg, remat)
    h = decode_hidden(params, batch["tokens"], enc_out, cfg, remat)
    return softmax_xent(unembed(params["embed"], h, cfg), batch["targets"],
                        batch["loss_mask"], cfg.vocab_size)


# ------------------------------- decode ------------------------------------
def init_encdec_cache(cfg: ModelConfig, batch: int, seq: int, src: int, device):
    """bf16 caches: the decoder's ``k``/``v`` (L, batch + 1, seq, KVH, hd)
    (``attention.gqa_decode``'s layout: the spare landing row) and the
    source's cross ``xk``/``xv`` (L, batch, src, KVH, hd)."""
    kvh, hd, n = cfg.n_kv_heads, cfg.hd, cfg.n_layers

    def zeros(rows, length):
        return torch.zeros((n, rows, length, kvh, hd), dtype=torch.bfloat16, device=device)

    return {"k": zeros(batch + 1, seq), "v": zeros(batch + 1, seq),
            "xk": zeros(batch, src), "xv": zeros(batch, src)}


def precompute_cross_kv(params, enc_out, cfg: ModelConfig):
    """Every decoder layer's cross K and V of ``enc_out`` in bf16: a pair of
    (L, B, S_src, KVH, hd) tensors."""
    src = enc_out.to(torch.bfloat16)
    ks, vs = [], []
    for lp in _unbind_layers(params["dec"]["cross"], cfg.n_layers):
        ks.append(attn._proj(src, lp["wk"]))
        vs.append(attn._proj(src, lp["wv"]))
    return torch.stack(ks), torch.stack(vs)


def encdec_decode_step(params, tokens, cache, pos, cfg: ModelConfig):
    """One decoder step: tokens (B,) against the cached self K/V (written in
    place at ``pos``) and the precomputed cross K/V. ``pos`` may be a scalar
    or a (B,) per-slot position vector. Returns (logits (B, padded_vocab),
    cache)."""
    x = embed(params["embed"], tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        lp, c = _layer(params["dec"], i), _layer(cache, i)
        h = apply_norm(lp["ln1"], x, cfg.norm_eps)
        a, _ = attn.gqa_decode(lp["attn"], h, c, pos, cfg)  # reads c's k and v
        x = x + a
        h = apply_norm(lp["ln_x"], x, cfg.norm_eps)
        x = x + attn.cross_decode(lp["cross"], h, {"k": c["xk"], "v": c["xv"]}, cfg)
        h = apply_norm(lp["ln2"], x, cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], h)
    h = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], h, cfg)[:, 0], cache
