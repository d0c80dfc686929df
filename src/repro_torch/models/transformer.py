"""Decoder-only LM assembly (counterpart of ``repro.models.transformer``,
lines 45-217 and 240-434, which it is held against).

The layer stack is a list of homogeneous *segments*; each segment's
parameters are stacked on a leading layer axis. ``repro`` runs a segment with
``lax.scan``; here a Python loop walks the stacked tensors. Each layer reads
views of them (``torch.unbind`` once per forward), so the stacked tensors stay
the autograd leaves and nothing is copied.

``segments_for`` covers every family. The port runs the dense and VLM
backbones (``attn_mlp`` segments, GQA attention: internlm2, mistral-nemo,
deepseek-67b, internvl2; MLA: minicpm3), the MoE family (``attn_moe``
segments, after ``first_dense_layers`` ``attn_mlp`` layers where the model
has them: olmoe, and deepseek-v3 with MLA beside its experts and its
multi-token-prediction loss), the ``rwkv`` family (rwkv6-3b) and the hybrid
family (hymba-1.5b: attention, sliding-window or global, beside a Mamba
mixer in every layer): training, prefill, ``lm_decode_step`` and the
server. Encoder-decoder models run through ``models.encdec`` (on this
module's ``run_stacked``); this stack refuses them (``check_decoder_only``).

Recurrent state (RWKV's ``wkv``/``shift_t``/``shift_c``, Mamba's
``ssm``/``conv``) is per slot, dense ``(L, B, ...)`` under paged KV too, and
written in place only on the rows whose ``write_ok`` is set: the port's
form of the reference's ``select_rows``, so a row that does not run a
sub-step keeps its state. On a mesh (the sharded server) a state leaf
placed over the ranks is made whole for its layer's decode and each rank's
slice written back (``_state_decode``).

``remat`` follows the reference: ``"none"`` keeps every activation,
``"full"`` keeps each layer's input only (``torch.utils.checkpoint``, one
layer at a time), ``"dots"`` keeps the matrix products' outputs and
recomputes the rest (a selective checkpoint, like
``jax.checkpoint_policies.checkpoint_dots``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.dist import meshes
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    chunked_xent,
    embed,
    make_embedding,
    make_mlp,
    make_norm,
    softmax_xent,
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


HYBRID = ("hybrid_swa", "hybrid_global")


def check_decoder_only(cfg: ModelConfig) -> None:
    """This module's decoder-only stack, its paged caches and the server take
    every family but enc-dec, which runs through ``models.encdec`` and is not
    served (as in the reference): raise ``ValueError`` for it."""
    if cfg.family == "encdec":
        raise ValueError(f"family 'encdec' ({cfg.name}) runs through models.encdec: "
                         "the decoder-only stack, paged caches and the server refuse it")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def _make_layer(m: Maker, cfg: ModelConfig, kind: str):
    if kind == "rwkv":
        return {
            "ln_t": make_norm(m, cfg.d_model),
            "ln_c": make_norm(m, cfg.d_model),
            "tmix": ssm.make_rwkv_tmix(m, cfg),
            "cmix": ssm.make_rwkv_cmix(m, cfg),
        }
    p = {
        "ln1": make_norm(m, cfg.d_model),
        "ln2": make_norm(m, cfg.d_model),
        "attn": attn.kind_of(cfg).make(m, cfg),
    }
    if kind in HYBRID:
        p["mamba"] = ssm.make_mamba(m, cfg)
        p["ln_attn_out"] = make_norm(m, cfg.d_model)
        p["ln_mamba_out"] = make_norm(m, cfg.d_model)
    if kind == "attn_moe":
        p["moe"] = moe_mod.make_moe(m, cfg)
    else:
        p["mlp"] = make_mlp(m, cfg.d_model, cfg.d_ff)
    return p


def init_lm(cfg: ModelConfig, generator: torch.Generator, device,
            dtype=torch.bfloat16):
    """Returns (params, specs): nested dicts; repeated layers stacked. The
    matrices are stored as ``dtype``, the norm scales as f32 (see params)."""
    check_decoder_only(cfg)
    m = Maker(generator, device, dtype)
    tree = {
        "embed": make_embedding(m, cfg),
        "final_norm": make_norm(m, cfg.d_model),
        "segments": [stack_layers(lambda i, k=s.kind: _make_layer(m, cfg, k), s.n_layers)
                     for s in segments_for(cfg)],
    }
    if cfg.vis_tokens:
        tree["vis_proj"] = m.param((cfg.d_model, cfg.d_model), ("embed", "embed"))
    if cfg.mtp:
        tree["mtp"] = {
            "norm_h": make_norm(m, cfg.d_model),
            "norm_e": make_norm(m, cfg.d_model),
            "proj": m.param((2 * cfg.d_model, cfg.d_model), ("ff", "embed")),
            "layer": _make_layer(m, cfg, _mtp_kind(cfg)),
        }
    return split_tree(tree)


def _mtp_kind(cfg: ModelConfig) -> str:
    return "attn_moe" if cfg.is_moe else "attn_mlp"


# --------------------------------------------------------------------------
# training / prefill forward
# --------------------------------------------------------------------------
def _layer_train(p, x, positions, cfg: ModelConfig, kind: str, wkv_impl: str = "kernel"):
    """One layer of the training and prefill forward; ``positions`` (B, S)
    reach the attention's rotary embedding (RWKV ignores them)."""
    if kind == "rwkv":
        h, _ = ssm.rwkv_tmix(p["tmix"], apply_norm(p["ln_t"], x, cfg.norm_eps), cfg,
                             wkv_impl=wkv_impl)
        x = x + h
        h, _ = ssm.rwkv_cmix(p["cmix"], apply_norm(p["ln_c"], x, cfg.norm_eps), cfg)
        return x + h
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    if kind in HYBRID:
        akind = "causal" if kind == "hybrid_global" else "swa"
        a = attn.kind_of(cfg).train(p["attn"], h, cfg, positions, kind=akind,
                                    window=cfg.swa_window)
        s, _ = ssm.mamba_mix(p["mamba"], h, cfg)
        x = x + _hybrid_mix(p, a, s, cfg)
    else:
        x = x + attn.kind_of(cfg).train(p["attn"], h, cfg, positions)
    return x + _ffn(p, x, cfg, kind)


def _ffn(p, x, cfg: ModelConfig, kind: str):
    """The layer's feed-forward block on its second norm: the experts in an
    ``attn_moe`` layer, the gated MLP elsewhere."""
    h = apply_norm(p["ln2"], x, cfg.norm_eps)
    if kind == "attn_moe":
        return moe_mod.apply_moe(p["moe"], h, cfg)
    return apply_mlp(p["mlp"], h)


def _hybrid_mix(p, a, s, cfg: ModelConfig):
    """The hybrid layer's merge of its attention (``a``) and Mamba (``s``)
    outputs: the mean of the two, each normed."""
    return 0.5 * (apply_norm(p["ln_attn_out"], a, cfg.norm_eps)
                  + apply_norm(p["ln_mamba_out"], s, cfg.norm_eps))


# the outputs a "dots" rematerialisation keeps: matrix products
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _unbind_layers(tree, n_layers):
    """Per-layer views of a stacked parameter tree: each leaf is unbound
    once, so its gradient is one stack of the layers' gradients."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, n_layers) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n_layers)]
    return list(torch.unbind(tree, 0))


def run_stacked(body, stacked, n_layers, x, *args, remat: str):
    """``x = body(lp, x, *args)`` over the layers of a stacked parameter
    tree, each layer under ``remat``'s checkpoint (see the module's
    docstring)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none|full|dots, got {remat!r}")
    for lp in _unbind_layers(stacked, n_layers):
        if remat == "none":
            x = body(lp, x, *args)
        elif remat == "full":
            x = checkpoint(body, lp, x, *args, use_reentrant=False)
        else:
            x = checkpoint(body, lp, x, *args, use_reentrant=False,
                           context_fn=functools.partial(
                               create_selective_checkpoint_contexts, _save_dots))
    return x


def _run_segments(seg_params, x, cfg: ModelConfig, positions, remat: str,
                  wkv_impl: str = "kernel"):
    for seg, sp in zip(segments_for(cfg), seg_params):
        body = functools.partial(_layer_train, cfg=cfg, kind=seg.kind, wkv_impl=wkv_impl)
        x = run_stacked(body, sp, seg.n_layers, x, positions, remat=remat)
    return x


def embed_inputs(params, batch, cfg: ModelConfig):
    """The first layer's input and its positions: the tokens' embeddings,
    after the projected patch embeddings (``batch["patches"]`` (B, P, d))
    where the model takes them (``cfg.vis_tokens``); positions count from 0
    over both. Returns (x (B, S, d), positions (B, S))."""
    x = embed(params["embed"], batch["tokens"], cfg)
    if cfg.vis_tokens:
        vis = batch["patches"].to(x.dtype) @ params["vis_proj"].to(x.dtype)
        x = torch.cat([vis, x], dim=1)
    b, s = x.shape[:2]
    return x, torch.arange(s, device=x.device).expand(b, s)


def lm_loss(params, batch, cfg: ModelConfig, remat: str = "full",
            wkv_impl: str = "kernel"):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``targets``
    (B, S) int, ``loss_mask`` (B, S) f32, and ``patches`` where the model
    takes them) over the text positions. ``wkv_impl`` as in
    ``ssm.rwkv_tmix``."""
    check_decoder_only(cfg)
    x, positions = embed_inputs(params, batch, cfg)
    x = _run_segments(params["segments"], x, cfg, positions, remat, wkv_impl)
    h = apply_norm(params["final_norm"], x, cfg.norm_eps)[:, cfg.vis_tokens:]
    if cfg.loss_chunk:
        loss = chunked_xent(params["embed"], h, batch["targets"], batch["loss_mask"], cfg,
                            cfg.loss_chunk)
    else:
        loss = softmax_xent(unembed(params["embed"], h, cfg), batch["targets"],
                            batch["loss_mask"], cfg.vocab_size)
    if cfg.mtp:
        loss = loss + cfg.mtp_loss_weight * _mtp_loss(params, h, batch, cfg,
                                                      positions[:, :h.shape[1]])
    return loss


def _mtp_loss(params, h, batch, cfg: ModelConfig, positions):
    """DeepSeek-V3 multi-token prediction: one extra layer predicts t+2 from
    [h_t ; emb(token_{t+1})] with the shared embedding and head."""
    p = params["mtp"]
    tokens, targets, mask = batch["tokens"], batch["targets"], batch["loss_mask"]
    h_in = apply_norm(p["norm_h"], h[:, :-1], cfg.norm_eps)
    e_in = apply_norm(p["norm_e"], embed(params["embed"], tokens[:, 1:], cfg), cfg.norm_eps)
    z = torch.cat([h_in, e_in], dim=-1) @ p["proj"].to(h.dtype)
    z = _layer_train(p["layer"], z, positions[:, :-1], cfg, _mtp_kind(cfg))
    logits = unembed(params["embed"], z, cfg)
    # the target at offset +2: position t predicts targets[t + 1]
    return softmax_xent(logits, targets[:, 1:], mask[:, 1:], cfg.vocab_size, term="mtp")


# --------------------------------------------------------------------------
# decode (one token, batched, cached)
# --------------------------------------------------------------------------
def _rwkv_cache(cfg: ModelConfig, batch: int, device):
    h, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    return {
        "wkv": torch.zeros((batch, h, hs, hs), dtype=torch.float32, device=device),
        "shift_t": torch.zeros((batch, 1, cfg.d_model), dtype=torch.bfloat16, device=device),
        "shift_c": torch.zeros((batch, 1, cfg.d_model), dtype=torch.bfloat16, device=device),
    }


def _mamba_cache(cfg: ModelConfig, batch: int, device):
    di = cfg.ssm_expand * cfg.d_model
    return {
        "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=torch.bfloat16, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq: int, device):
    """Dense caches, one dict per segment of layer-stacked tensors: GQA
    ``k``/``v`` (L, batch + 1, seq, KVH, D) (see attention: the spare row;
    a sliding-window layer's ring holds ``min(swa_window, seq)`` rows);
    MLA the latent ``c`` (L, batch + 1, seq, kv_lora) and ``kr``
    (L, batch + 1, seq, rope); RWKV the per-row state, ``wkv``
    (L, batch, H, hs, hs) f32 and the token shifts ``shift_t``/``shift_c``
    (L, batch, 1, d_model) bf16; a hybrid layer its attention's and Mamba's
    ``ssm`` (L, batch, d_inner, N) f32 and ``conv`` (L, batch, conv - 1,
    d_inner) bf16."""
    check_decoder_only(cfg)
    caches = []
    for s in segments_for(cfg):
        if s.kind == "rwkv":
            layer = _rwkv_cache(cfg, batch, device)
        else:
            window = cfg.swa_window if s.kind == "hybrid_swa" else 0
            layer = (attn.init_gqa_cache(cfg, batch, seq, window=window, device=device)
                     if window else attn.kind_of(cfg).init_cache(cfg, batch, seq, device=device))
            if s.kind in HYBRID:
                layer.update(_mamba_cache(cfg, batch, device))
        caches.append(_stacked(layer, s.n_layers))
    return caches


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, device, *,
                     slots: int = 0, ring_num_blocks: int = 0, ring_width: int = 0):
    """Paged caches: block pools (L, num_blocks + 1, block_size, ...) shared
    by all slots (see attention: the spare block), GQA's ``k``/``v`` or
    MLA's ``c``/``kr``. Sliding-window layers draw theirs from the ring
    pool, ``ring_num_blocks`` blocks, when ``ring_width`` is set. Recurrent
    state keeps its dense per-slot rows, ``slots`` of them: it is O(1) a
    slot, not a token, so there is nothing to page."""
    check_decoder_only(cfg)
    caches = []
    for s in segments_for(cfg):
        if s.kind == "rwkv":
            layer = _rwkv_cache(cfg, slots, device)
        else:
            n = ring_num_blocks if s.kind == "hybrid_swa" and ring_width else num_blocks
            layer = attn.kind_of(cfg).init_cache_paged(cfg, n, block_size, device=device)
            if s.kind in HYBRID:
                layer.update(_mamba_cache(cfg, slots, device))
        caches.append(_stacked(layer, s.n_layers))
    return caches


def _stacked(layer_cache, n_layers):
    return {k: v.new_zeros((n_layers, *v.shape)) for k, v in layer_cache.items()}


def _layer(tree, i):
    """Layer ``i`` of a tree of layer-stacked leaves (a leaf placed on a mesh
    stays placed: ``meshes.layer_view``)."""
    return {k: _layer(v, i) if isinstance(v, dict) else meshes.layer_view(v, i)
            for k, v in tree.items()}


def _state_decode(fn, cache, keys, *args):
    """``fn(cache, *args)`` with the recurrent state leaves ``keys`` of one
    layer made whole on this rank for the call (a leaf placed on a mesh,
    ``meshes.gather_serve``), each rank's slice written back after it."""
    whole = {k: meshes.gather_serve(cache[k]) for k in keys}
    out = fn({**cache, **{k: w for k, (w, _) in whole.items()}}, *args)
    for k, (w, own) in whole.items():
        meshes.write_back(cache[k], w, own)
    return out


def _write_state(leaf, new, write_ok):
    """Write a recurrent state leaf (B, ...) in place: every row, or only the
    rows whose ``write_ok`` (B,) is set (the others keep their state)."""
    new = new.to(leaf.dtype)
    if write_ok is not None:
        new = torch.where(write_ok.view(-1, *([1] * (leaf.dim() - 1))), new, leaf)
    leaf.copy_(new)


def _layer_decode_rwkv(p, x, cache, cfg: ModelConfig, write_ok=None):
    h = apply_norm(p["ln_t"], x, cfg.norm_eps)
    h, (wkv_s, shift_t) = ssm.rwkv_tmix(
        p["tmix"], h, cfg, state=cache["wkv"],
        shift_prev=cache["shift_t"].to(h.dtype), use_chunked=False)
    x = x + h
    h = apply_norm(p["ln_c"], x, cfg.norm_eps)
    h, shift_c = ssm.rwkv_cmix(p["cmix"], h, cfg, shift_prev=cache["shift_c"].to(h.dtype))
    _write_state(cache["wkv"], wkv_s, write_ok)
    _write_state(cache["shift_t"], shift_t, write_ok)
    _write_state(cache["shift_c"], shift_c, write_ok)
    return x + h


def _mamba_decode(p, h, cache, cfg: ModelConfig, write_ok=None):
    s, (ssm_s, conv_s) = ssm.mamba_mix(p, h, cfg, state=cache["ssm"],
                                       conv_prev=cache["conv"].to(h.dtype))
    _write_state(cache["ssm"], ssm_s, write_ok)
    _write_state(cache["conv"], conv_s, write_ok)
    return s


def _layer_decode(p, x, cache, pos, cfg: ModelConfig, kind: str = "attn_mlp", paged=None,
                  slot=None, write_ok=None):
    if slot is not None and kind not in ("attn_mlp", "attn_moe"):
        raise ValueError(
            f"token-batched decode (slot mapping) needs per-token caches; segment kind "
            f"{kind!r} carries per-slot recurrent state")
    state_ok = write_ok if paged is None else paged["write_ok"]
    if kind == "rwkv":
        if paged is not None:
            raise ValueError("RWKV layers carry per-row recurrent state: no paged cache")
        return _state_decode(lambda c: _layer_decode_rwkv(p, x, c, cfg, state_ok), cache,
                             ("wkv", "shift_t", "shift_c"))
    h = apply_norm(p["ln1"], x, cfg.norm_eps)
    ops = attn.kind_of(cfg)
    window = cfg.swa_window if kind == "hybrid_swa" else 0
    if paged is None:
        kw = {"window": window} if window else {}
        a, _ = ops.decode(p["attn"], h, cache, pos, cfg, slot=slot, write_ok=write_ok, **kw)
    else:
        ring = bool(window and paged.get("ring_width"))
        kw = {"ring_width": paged["ring_width"]} if ring else {}
        a, _ = ops.decode_paged(
            p["attn"], h, cache, pos, cfg,
            table=paged["ring_table"] if ring else paged["table"],
            block_size=paged["block_size"], max_seq=paged["max_seq"],
            write_ok=paged["write_ok"], impl=paged.get("impl", "gather"),
            runs=paged.get("runs"), **kw,
        )
    if kind in HYBRID:
        s = _state_decode(lambda c: _mamba_decode(p["mamba"], h, c, cfg, state_ok), cache,
                          ("ssm", "conv"))
        x = x + _hybrid_mix(p, a, s, cfg)
    else:
        x = x + a
    return x + _ffn(p, x, cfg, kind)


def lm_decode_step(params, tokens, caches, pos, cfg: ModelConfig, paged=None,
                   slot=None, write_ok=None):
    """tokens (B,) int; caches from init_cache; pos: current position, a
    scalar or a (B,) vector of per-slot positions (continuous batching;
    RWKV's recurrent caches are position-free).
    ``paged`` switches the attention caches to the block-pool layout
    (init_paged_cache): a dict with ``table`` ((B, nb) int32, or per-token
    (T, nb) when ``slot`` is given), ``write_ok`` (B,) bool (or None),
    ``block_size``/``max_seq``, for sliding-window layers ``ring_table``
    ((B, nb_ring) int32, the ring pool's) and ``ring_width`` (0: they read
    the full table), and optional ``impl`` (``"gather"`` |
    ``"kernel"`` paged-attention read path) and ``runs`` ((R, 2) int32 rows
    that share one table row, a hint for the kernel path; see
    ``kernels.paged_attn.ops``). ``slot``/``write_ok`` enable
    token-level batching over dense caches: tokens is a flattened (T,) mix of
    prefill chunks and decode tokens, ``slot`` (T,) maps each token to its
    cache row, and ``write_ok`` (T,) masks padding rows out of cache writes
    (attention-only segments).
    The caches are updated in place. Returns (logits (B, padded_vocab),
    caches)."""
    x = embed(params["embed"], tokens[:, None], cfg)
    for seg, sp, sc in zip(segments_for(cfg), params["segments"], caches):
        for i in range(seg.n_layers):
            x = _layer_decode(_layer(sp, i), x, _layer(sc, i), pos, cfg, seg.kind,
                              paged=paged, slot=slot, write_ok=write_ok)
    h = apply_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], h, cfg)[:, 0], caches
