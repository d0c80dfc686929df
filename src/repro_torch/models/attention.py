"""Attention: GQA and MLA, their training forms and their decode paths over
dense and paged KV caches, and the encoder-decoder's cross attention
(counterpart of ``repro.models.attention``, which it is held against).

The training forms (``gqa_train``, ``mla_train``) run plain PyTorch: einsum,
softmax and, with ``cfg.attn_q_chunk``, query tiles each under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``). MLA serves
in the absorbed-latent form: the queries are projected into the KV latent
space, so the cache holds ``kv_lora + rope`` values a token
(``init_mla_cache``), and the paged kernel path runs it as one MQA call of
B5 (``mla_decode_paged``).

Decode positions are per-row: every decode entry point accepts ``pos`` as a
scalar (single stream) or a (B,) vector (continuous batching: each cache row
advances at its own position, with per-row validity masks so a freed slot
restarted at pos 0 never sees the previous occupant's stale entries).

The caches are updated in place (the reference returns new, donated
buffers): each decode function writes its token's K/V into ``cache`` and
returns ``(out, cache)`` with the same tensors.

Gated-off writes. The reference drops a write whose row ``write_ok`` gates
off by sending it out of range (JAX drops out-of-range scatters). PyTorch
raises there instead, and clamping such a write onto a live index would race
a live write to the same element on the card. So every cache holds one spare
row that nothing reads: dense caches are ``(B + 1, S, KVH, D)`` with slot
``B`` the landing row, paged pools ``(NB + 1, bs, KVH, D)`` with block ``NB``
the landing block, which the allocator never maps. Reads slice the spare off
(dense) or never reach it (paged: tables map blocks ``< NB``).

One case differs: a dense decode with one batch row per cache row
(``slot`` None), the chunked server's step. There the reference writes every
row and reverts the rows that did not run afterwards, so such a row's
attention reads its own new entry at its position. The port writes every
row in place too and restores the gated rows' entries after the read
(``_dense_write``): each row reads what it reads in the reference, and the
cache ends as the reference's. It matters where a row's output reaches
another row's: MoE routes a decode batch as one group, in which an idle row
claims expert capacity.

On a mesh (the sharded server, ``serve.serving.BatchedServer(mesh=)``) a
cache leaf may be a DTensor placed by ``meshes.place_serve``: its local
tensor is this rank's slice of the slots or blocks and of the KV heads, with
a landing row or block of its own. Each decode reads the placement
(``_split_dense``, ``_split_paged``): a read that splits along a sharded dim
with no sum across it runs on this rank's part only (its slot rows of a
dense cache, its KV heads with their G query heads each, on the kernel path
B5 over its own contiguous pools); a block pool split over the data axes is
made whole for the layer (any slot maps any block) and this rank's blocks
written back. Each rank's part of the attention output lies in zeros
elsewhere, in f32, and one ``all_reduce`` SUM joins the parts exactly
(``meshes.join``); the projections around it run whole on every rank.

Cross attention (``cross_train``, ``cross_decode``) is GQA's parameters
over the encoder's output: no rotary embedding, no mask, in plain PyTorch
as in the reference (its decode reads the K and V that
``encdec.precompute_cross_kv`` computed once a source).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import meshes
from repro_torch.kernels.paged_attn import ops as paged_attn_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, apply_rope, make_norm, rope_tables
from repro_torch.models.params import Maker

NEG = -1e9
ATTN_IMPLS = ("gather", "kernel")


def _mask(sq: int, skv: int, kind: str, window: int, offset: int = 0, device=None):
    """(sq, skv) additive f32 mask. offset = kv position of query row 0."""
    if kind == "bidir":
        return torch.zeros((sq, skv), dtype=torch.float32, device=device)
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    ok = kpos <= qpos
    if kind == "swa":
        ok &= (qpos - kpos) < window
    return torch.where(ok, 0.0, NEG).to(torch.float32)


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,KVH,G,D), k/v (B,Skv,KVH,D*), mask (Sq,Skv) or (B,1,1,Sq,Skv)
    f32 (both broadcast over the scores)."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    probs = torch.softmax(scores + mask, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))


def _sdpa_qchunk(q, k, v, kind, window, scale, q_chunk, qk_bf16: bool = False):
    """Query-chunked attention, the same function as ``_sdpa`` over
    ``_mask``: the scores exist one (B, KVH, G, q_chunk, Skv) tile at a time,
    each tile under ``torch.utils.checkpoint``, so the backward recomputes it
    and the peak drops from O(Sq*Skv) to O(q_chunk*Skv) a layer.

    ``qk_bf16`` rounds the operands of both products (q, k, the
    probabilities and v) to bf16 and sums in f32, as the reference's bf16
    einsums with ``preferred_element_type=f32`` do: bf16 products are exact
    in f32, so only the roundings of the operands change the result."""
    b, sq, kvh, g, d = q.shape
    q_chunk = min(q_chunk, sq)
    pad = (-sq) % q_chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))

    def rounded(x):
        return x.to(torch.bfloat16).to(torch.float32) if qk_bf16 else x.to(torch.float32)

    kf, vf = rounded(k), rounded(v)

    def block(qb, offset):
        mask = _mask(q_chunk, kf.shape[1], kind, window, offset=offset, device=qb.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", rounded(qb), kf) * scale
        p = torch.softmax(s + mask, dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", rounded(p), vf)

    out = torch.cat([checkpoint(block, q[:, i:i + q_chunk], i, use_reentrant=False)
                     for i in range(0, q.shape[1], q_chunk)], dim=1)
    return out[:, :sq]


# =============================== GQA =========================================
def make_gqa(m: Maker, cfg: ModelConfig, d_in: int | None = None):
    d = d_in or cfg.d_model
    hd = cfg.hd
    return {
        "wq": m.param((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": m.param((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": m.param((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": m.param((cfg.n_heads, hd, d), ("heads", "head_dim", "embed")),
    }


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w)."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).reshape(*x.shape[:-1], h, k)


def _out_proj(out, w):
    """einsum("bshk,hkd->bsd", out, w)."""
    h, k, d = w.shape
    return out.reshape(*out.shape[:-2], h * k) @ w.reshape(h * k, d).to(out.dtype)


def gqa_project(p, x, cfg: ModelConfig, positions):
    """x (B,S,d), positions (B,S) -> rotated q (B,S,H,hd), k (B,S,KVH,hd), v."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_attend(p, q, k, v, cfg: ModelConfig, kind, window):
    """Attention of rotated q (B,Sq,H,hd) over k/v (B,Skv,KVH,hd), then the
    output projection: (B,Sq,d)."""
    b, sq, h, hd = q.shape
    kvh = cfg.n_kv_heads
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    scale = 1.0 / math.sqrt(hd)
    if cfg.attn_q_chunk:
        out = _sdpa_qchunk(qg, k, v, kind, window, scale, cfg.attn_q_chunk,
                           qk_bf16=cfg.attn_qk_bf16)
    else:
        out = _sdpa(qg, k, v, _mask(sq, k.shape[1], kind, window, device=q.device), scale)
    return _out_proj(out.reshape(b, sq, h, hd).to(q.dtype), p["wo"])


def gqa_train(p, x, cfg: ModelConfig, positions, kind="causal", window=0):
    """Training and prefill form: x (B,S,d), positions (B,S) -> (B,S,d)."""
    q, k, v = gqa_project(p, x, cfg, positions)
    return gqa_attend(p, q, k, v, cfg, kind, window)


def _batch_pos(pos, b: int, device):
    """A decode position in per-row form: a scalar (the whole batch at one
    position) or a (B,) vector (every slot at its own position)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.expand(b) if pos.dim() == 0 else pos


def gqa_decode(p, x, cache, pos, cfg: ModelConfig, window=0, slot=None,
               write_ok=None):
    """x (B,1,d); cache {k,v}: (B+1,S,KVH,D) (full) or (B+1,W,KVH,D) (SWA
    ring), row B the landing row. Returns (out (B,1,d), cache). ``pos`` is a
    scalar or a (B,) vector of per-slot positions. ``slot`` (B,) maps batch
    rows onto cache rows for the token-batched serving step (None keeps
    row == slot); ``write_ok`` (B,) bool gates the cache write (see
    ``_dense_write``). Leaves placed on a mesh: ``_split_dense``."""
    b = x.shape[0]
    dt = x.dtype
    pos_b = _batch_pos(pos, b, x.device)
    q, k, v = gqa_project(p, x, cfg, pos_b[:, None])
    kvh, hd = cfg.n_kv_heads, cfg.hd
    qg = q.reshape(b, 1, kvh, cfg.n_heads // kvh, hd)
    read = functools.partial(_gqa_read, window=window)
    if meshes.is_dtensor(cache["k"]):
        out = _split_dense(read, cache["k"], cache["v"], (qg,), k[:, 0], v[:, 0], pos_b, slot,
                           write_ok)
    else:
        out = read(qg, k[:, 0], v[:, 0], pos_b, cache["k"], cache["v"], slot, write_ok)
    out = _out_proj(out.reshape(b, 1, cfg.n_heads, hd).to(dt), p["wo"])
    return out, cache


def _gqa_read(qg, k_new, v_new, pos_b, ck, cv, slot, write_ok, window=0):
    """The dense write of each row's new K/V and the attention read: qg
    (B,1,KVH,G,D), k_new/v_new (B,KVH,D), caches (rows,S,KVH,D) -> the
    attention output (B,1,KVH,G,D) in f32."""
    b = qg.shape[0]
    s = ck.shape[1]
    row = pos_b % s if window else pos_b.clamp(max=s - 1)
    restore = _dense_write(((ck, k_new), (cv, v_new)), row, slot, write_ok)
    # validity (per row): full caches are valid <= pos; ring buffers are fully
    # valid once warm (pos >= ring size) and valid <= pos while still cold,
    # which also hides a freed slot's stale entries from a request that
    # restarts the slot at pos 0
    kpos = torch.arange(s, device=qg.device)[None, :]
    valid = kpos <= pos_b[:, None]
    if window:
        valid |= pos_b[:, None] >= s
    gk, gv = (ck[:b], cv[:b]) if slot is None else (ck[slot], cv[slot])
    mask = torch.where(valid, 0.0, NEG)[:, None, None, None, :]
    out = _sdpa(qg, gk, gv, mask, 1.0 / math.sqrt(qg.shape[-1]))
    restore()
    return out


def _split_dense(read, c0, c1, qs, new0, new1, pos_b, slot, write_ok):
    """``read`` (``_gqa_read`` or ``_mla_read``) on this rank's part of a
    dense cache pair placed on a mesh, joined: its slot rows (``slot`` None:
    the batch rows of those slots; else the rows whose slot it holds, the
    others sent to its landing row and their output zeroed) and, where the
    leaves split their KV heads (GQA's dim 2), those heads with their query
    heads (dim 2 of each of ``qs``). The parts lie in zeros, in f32, and
    one ``all_reduce`` SUM over the leaves' axes joins them
    (``meshes.join``)."""
    reg = meshes.region(c0)
    rows, heads = reg[0], reg[2] if c0.dim() == 4 else slice(None)
    if slot is None:
        sel, lslot, own = rows, None, None
        ok = None if write_ok is None else write_ok[rows]
    else:
        sel = slice(None)
        own = (slot >= rows.start) & (slot < rows.stop)
        lslot = torch.where(own, slot - rows.start, meshes.local(c0).shape[0] - 1)
        ok = own if write_ok is None else own & write_ok
    part = read(*(q[sel][:, :, heads] for q in qs), new0[sel][:, heads], new1[sel][:, heads],
                pos_b[sel], meshes.local(c0), meshes.local(c1), lslot, ok).to(torch.float32)
    if own is not None:
        part = torch.where(own.view(-1, *[1] * (part.dim() - 1)), part, 0.0)
    shape = [qs[0].shape[0], *part.shape[1:]]
    if c0.dim() == 4:  # the heads of GQA's output, dim 2 as in its queries
        shape[2] = qs[0].shape[2]
    full = torch.zeros(shape, dtype=torch.float32, device=part.device)
    full[sel, :, heads] = part
    return meshes.join(full, c0.device_mesh, meshes.split_axes(c0))


def _dense_write(pairs, row, slot, write_ok):
    """Write each (cache leaf (B + 1, S, ...), value (B, ...)) pair's rows at
    their positions ``row`` (B,). With ``slot`` (token batching), gated-off
    rows land in the spare row. With one batch row a cache row (``slot``
    None), every row writes in place and the gated-off rows' old entries
    come back when the returned function is called, after the read (see
    the module's docstring). Returns that function."""
    b = row.shape[0]
    if slot is not None or write_ok is None:
        rows = torch.arange(b, device=row.device) if slot is None else slot
        if write_ok is not None:
            rows = torch.where(write_ok, rows, pairs[0][0].shape[0] - 1)
        for leaf, val in pairs:
            leaf[rows, row] = val.to(leaf.dtype)
        return lambda: None
    rows = torch.arange(b, device=row.device)
    old = [leaf[rows, row] for leaf, _ in pairs]
    for leaf, val in pairs:
        leaf[rows, row] = val.to(leaf.dtype)

    def restore():
        for (leaf, val), kept in zip(pairs, old):
            ok = write_ok.view(-1, *[1] * (kept.dim() - 1))
            leaf[rows, row] = torch.where(ok, val.to(leaf.dtype), kept)

    return restore


def init_gqa_cache(cfg: ModelConfig, batch: int, seq: int, window=0, device="cpu"):
    """Dense cache: ``batch`` slot rows and the spare landing row."""
    w = min(window, seq) if window else seq
    shape = (batch + 1, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


# ============================ paged decode ===================================
# Paged KV: the cache is a pool of fixed-size token blocks (num_blocks + 1,
# block_size, ...) shared by every slot; ``table`` (B, nb_slot) maps a slot's
# logical block index to a physical block id (serve/kv_pool.py owns the
# allocation). Decode writes the current token through the table and reads
# the slot's blocks back: the gather path as a padded (B, nb_slot*bs, ...)
# view, the kernel path by walking the table (B5). Padding rows (beyond
# max_seq / ring width, or in not-yet-mapped blocks) are masked with NEG,
# which softmaxes to exactly 0.0 in f32, so the paged path is token-exact vs
# the dense reference.


def _paged_write_idx(table, pos_b, block_size, ring_width, num_blocks,
                     write_ok):
    """(block id, in-block offset) each row writes. ``ring_width`` > 0 maps
    positions onto ring rows ``pos % ring_width`` (SWA). Rows with
    ``write_ok`` False write to the landing block ``num_blocks`` (idle
    chunked-prefill rows, parked slots). A parked row's position may lie past
    its table; the reference's gather clamps that index, and so does this
    one (the row is gated off either way)."""
    row = pos_b % ring_width if ring_width else pos_b
    col = (row // block_size).clamp(max=table.shape[1] - 1)
    blk = table[torch.arange(pos_b.shape[0], device=table.device), col]
    if write_ok is not None:
        blk = torch.where(write_ok, blk, num_blocks)
    return blk, row % block_size


def _paged_valid(pos_b, s_pad, ring_width, max_rows):
    """Per-row validity over the gathered (ring-ordered for SWA) view.
    Full region: rows <= pos. Ring region: the dense ring's exact rule
    (rows <= pos while cold, every ring row once warm), with the gather
    padding (rows >= width) always invalid."""
    kpos = torch.arange(s_pad, device=pos_b.device)[None, :]
    p = pos_b[:, None]
    if ring_width:
        return (kpos < ring_width) & ((kpos <= p) | (p >= ring_width))
    return (kpos <= p) & (kpos < max_rows)


def gqa_decode_paged(p, x, cache, pos, cfg: ModelConfig, table, block_size,
                     ring_width=0, max_seq=None, write_ok=None,
                     impl="gather", runs=None):
    """Paged variant of ``gqa_decode``: cache {k,v}: (NB+1, bs, KVH, D) block
    pools, block NB the landing block; ``table`` (B, nb_slot) int32.
    ``ring_width`` > 0 selects SWA ring semantics (the table then maps ring
    rows). ``impl`` picks the attention read path: ``"gather"`` (padded-view
    reference) or ``"kernel"`` (the block-walking kernel B5 in
    kernels/paged_attn). ``runs`` ((R, 2) int32, the rows that share one
    table row; see ``kernels.paged_attn.ops``) reaches the kernel only; the
    gather path ignores it. Pools placed on a mesh: ``_split_paged``.
    Returns (out, cache)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}, got {impl!r}")
    b = x.shape[0]
    dt = x.dtype
    pos_b = _batch_pos(pos, b, x.device)
    q, k, v = gqa_project(p, x, cfg, pos_b[:, None])
    kvh, hd = cfg.n_kv_heads, cfg.hd
    max_rows = max_seq if max_seq is not None else table.shape[1] * block_size
    read = functools.partial(_gqa_paged_read, table=table, pos_b=pos_b, block_size=block_size,
                             ring_width=ring_width, max_rows=max_rows, write_ok=write_ok,
                             impl=impl, runs=runs)
    qg = q.reshape(b, kvh, cfg.n_heads // kvh, hd)
    if meshes.is_dtensor(cache["k"]):
        out = _split_paged(read, cache["k"], cache["v"], qg, k[:, 0], v[:, 0])
    else:
        out = read(qg, k[:, 0], v[:, 0], cache["k"], cache["v"])
    out = _out_proj(out.reshape(b, 1, cfg.n_heads, hd).to(dt), p["wo"])
    return out, cache


def _gqa_paged_read(qg, k_new, v_new, ck, cv, *, table, pos_b, block_size, ring_width,
                    max_rows, write_ok, impl, runs):
    """The paged write of each row's new K/V and the attention read: qg
    (B,KVH,G,D), k_new/v_new (B,KVH,D), pools (NB+1,bs,KVH,D) -> the
    attention output in f32 ((B,KVH,G,D) from the kernel, (B,1,KVH,G,D)
    from the gather)."""
    b, kvh, g, hd = qg.shape
    blk, off = _paged_write_idx(table, pos_b, block_size, ring_width,
                                ck.shape[0] - 1, write_ok)
    ck[blk, off] = k_new.to(ck.dtype)
    cv[blk, off] = v_new.to(cv.dtype)
    scale = 1.0 / math.sqrt(hd)
    if impl == "kernel":
        return paged_attn_ops.paged_attention(
            qg, ck, cv, table, pos_b, block_size=block_size, ring_width=ring_width,
            max_rows=max_rows, scale=scale, runs=runs,
        )
    tl = table.long()
    gk = ck[tl].reshape(b, -1, kvh, hd)
    gv = cv[tl].reshape(b, -1, kvh, hd)
    valid = _paged_valid(pos_b, gk.shape[1], ring_width, max_rows)
    mask = torch.where(valid, 0.0, NEG)[:, None, None, None, :]
    return _sdpa(qg[:, None], gk, gv, mask, scale)


def _split_paged(read, ck, cv, qg, k_new, v_new):
    """``read`` (``_gqa_paged_read``) on this rank's part of block pools
    placed on a mesh, joined: pools split over the data axes are made whole
    for the layer (any slot maps any block), written, and this rank's blocks
    written back; the KV heads it holds (dim 2) run with their query heads,
    on the kernel path through B5 over its own contiguous pools. The parts
    lie in zeros, in f32, and one ``all_reduce`` SUM over the heads' axes
    joins them (``meshes.join``)."""
    heads = meshes.region(ck)[2]
    (wk, own), (wv, _) = meshes.gather_serve(ck, {0}), meshes.gather_serve(cv, {0})
    part = read(qg[:, heads].contiguous(), k_new[:, heads], v_new[:, heads], wk, wv)
    meshes.write_back(ck, wk, own)
    meshes.write_back(cv, wv, own)
    full = torch.zeros((*part.shape[:-3], qg.shape[1], *part.shape[-2:]),
                       dtype=torch.float32, device=qg.device)
    full[..., heads, :, :] = part
    return meshes.join(full, ck.device_mesh, meshes.split_axes(ck, {2}))


def init_gqa_cache_paged(cfg: ModelConfig, num_blocks: int, block_size: int,
                         device="cpu"):
    """Block pools of ``num_blocks`` blocks and the spare landing block."""
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


# =============================== MLA =========================================
def make_mla(m: Maker, cfg: ModelConfig):
    d = cfg.d_model
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = m.param((d, cfg.q_lora_rank), ("embed", "lora"))
        p["q_norm"] = make_norm(m, cfg.q_lora_rank)
        p["wq_b"] = m.param((cfg.q_lora_rank, cfg.n_heads, qk), ("lora", "heads", "qk_dim"))
    else:
        p["wq"] = m.param((d, cfg.n_heads, qk), ("embed", "heads", "qk_dim"))
    p["wkv_a"] = m.param((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), ("embed", "lora"))
    p["kv_norm"] = make_norm(m, cfg.kv_lora_rank)
    p["wkv_b"] = m.param((cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_head_dim + cfg.v_head_dim),
                         ("lora", "heads", "qk_dim"))
    p["wo"] = m.param((cfg.n_heads, cfg.v_head_dim, d), ("heads", "head_dim", "embed"))
    return p


def _rope_part(x, positions, cfg: ModelConfig):
    """Rotary embedding of x (B,S,H,rope) at positions (B,S)."""
    cos, sin = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return apply_rope(x, cos[:, :, None, :], sin[:, :, None, :])


def _mla_q(p, x, cfg: ModelConfig, positions):
    """x (B,S,d) -> the queries' no-rope part (B,S,H,nope) and rotated rope
    part (B,S,H,rope)."""
    if cfg.q_lora_rank:
        cq = apply_norm(p["q_norm"], x @ p["wq_a"].to(x.dtype), cfg.norm_eps)
        q = _proj(cq, p["wq_b"])
    else:
        q = _proj(x, p["wq"])
    nope = cfg.qk_nope_head_dim
    return q[..., :nope], _rope_part(q[..., nope:], positions, cfg)


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """x (B,S,d) -> the normed KV latent (B,S,kv_lora) and the one rotated
    rope head every query head shares (B,S,rope)."""
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv = apply_norm(p["kv_norm"], kv[..., :cfg.kv_lora_rank], cfg.norm_eps)
    kr = _rope_part(kv[..., cfg.kv_lora_rank:][:, :, None, :], positions, cfg)
    return c_kv, kr[:, :, 0, :]


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def mla_train(p, x, cfg: ModelConfig, positions, kind="causal", window=0):
    """Training and prefill form: the latent expanded to per-head keys and
    values, each head its own kv head (G = 1). x (B,S,d) -> (B,S,d)."""
    b, s, _ = x.shape
    qn, qr = _mla_q(p, x, cfg, positions)
    c_kv, kr = _mla_latent(p, x, cfg, positions)
    kv = _proj(c_kv, p["wkv_b"])
    nope = cfg.qk_nope_head_dim
    kn, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([kn, kr[:, :, None, :].expand(*kn.shape[:3], cfg.qk_rope_head_dim)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    qg = q.reshape(b, s, cfg.n_heads, 1, q.shape[-1])
    if cfg.attn_q_chunk:
        out = _sdpa_qchunk(qg, k, v, kind, window, _mla_scale(cfg), cfg.attn_q_chunk,
                           qk_bf16=cfg.attn_qk_bf16)
    else:
        out = _sdpa(qg, k, v, _mask(s, s, kind, window, device=x.device), _mla_scale(cfg))
    return _out_proj(out.reshape(b, s, cfg.n_heads, cfg.v_head_dim).to(x.dtype), p["wo"])


def _mla_absorb(p, qn, cfg: ModelConfig):
    """The no-rope queries (B,1,H,nope) projected into the latent space
    (B,1,H,kv_lora) through wkv_b's key half, in the activations' type."""
    w_uk = p["wkv_b"][..., :cfg.qk_nope_head_dim].to(qn.dtype)  # (r, H, nope)
    return torch.einsum("bthk,rhk->bthr", qn, w_uk)


def _mla_out(p, out_lat, cfg: ModelConfig):
    """The attention's latent output (B,H,kv_lora) through wkv_b's value half
    and wo: (B,1,d)."""
    w_uv = p["wkv_b"][..., cfg.qk_nope_head_dim:].to(out_lat.dtype)  # (r, H, v)
    out = torch.einsum("bhr,rhv->bhv", out_lat, w_uv)
    return _out_proj(out, p["wo"])[:, None, :]


def _mla_latent_attn(q_lat, qr, gc, gkr, valid, scale):
    """The reference's absorbed attention over a gathered latent: both score
    products in the activations' type (bf16 in serving) and added there, as
    the reference's einsums round them, then f32 from the scale on.
    q_lat (B,1,H,r), qr (B,1,H,rope), gc (B,S,r), gkr (B,S,rope), valid (B,S)
    -> (B,H,r) in the activations' type."""
    dt = q_lat.dtype
    scores = torch.einsum("bthr,bsr->bhs", q_lat, gc.to(dt))
    scores = scores + torch.einsum("bthk,bsk->bhs", qr, gkr.to(dt))
    scores = scores.to(torch.float32) * scale + torch.where(valid, 0.0, NEG)[:, None]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", probs, gc.to(torch.float32)).to(dt)


def mla_decode(p, x, cache, pos, cfg: ModelConfig, slot=None, write_ok=None):
    """Absorbed-latent decode over dense caches {c (B+1,S,kv_lora),
    kr (B+1,S,rope)}, row B the landing row. ``pos``, ``slot`` and
    ``write_ok`` as in ``gqa_decode``; leaves placed on a mesh run on this
    rank's slot rows (``_split_dense``). Returns (out (B,1,d), cache)."""
    b = x.shape[0]
    pos_b = _batch_pos(pos, b, x.device)
    qn, qr = _mla_q(p, x, cfg, pos_b[:, None])
    c_t, kr_t = _mla_latent(p, x, cfg, pos_b[:, None])
    q_lat = _mla_absorb(p, qn, cfg)
    read = functools.partial(_mla_read, scale=_mla_scale(cfg))
    if meshes.is_dtensor(cache["c"]):
        out_lat = _split_dense(read, cache["c"], cache["kr"], (q_lat, qr), c_t[:, 0],
                               kr_t[:, 0], pos_b, slot, write_ok).to(x.dtype)
    else:
        out_lat = read(q_lat, qr, c_t[:, 0], kr_t[:, 0], pos_b, cache["c"], cache["kr"], slot,
                       write_ok)
    return _mla_out(p, out_lat, cfg), cache


def _mla_read(q_lat, qr, c_t, kr_t, pos_b, c, kr, slot, write_ok, scale):
    """The dense write of each row's latent and the absorbed attention
    read: q_lat (B,1,H,r) and qr (B,1,H,rope) the queries, c_t (B,r), kr_t
    (B,rope), caches (rows,S,*) -> (B,H,r) in the queries' type."""
    b = q_lat.shape[0]
    s = c.shape[1]
    row = pos_b.clamp(max=s - 1)
    restore = _dense_write(((c, c_t), (kr, kr_t)), row, slot, write_ok)
    gc, gkr = (c[:b], kr[:b]) if slot is None else (c[slot], kr[slot])
    valid = torch.arange(s, device=q_lat.device)[None, :] <= pos_b[:, None]
    out_lat = _mla_latent_attn(q_lat, qr, gc, gkr, valid, scale)
    restore()
    return out_lat


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, device="cpu"):
    """Dense latent cache: ``batch`` slot rows and the spare landing row."""
    return {"c": torch.zeros((batch + 1, seq, cfg.kv_lora_rank), dtype=torch.bfloat16,
                             device=device),
            "kr": torch.zeros((batch + 1, seq, cfg.qk_rope_head_dim), dtype=torch.bfloat16,
                              device=device)}


def mla_decode_paged(p, x, cache, pos, cfg: ModelConfig, table, block_size, max_seq=None,
                     write_ok=None, impl="gather", runs=None):
    """Paged variant of ``mla_decode``: cache {c (NB+1, bs, kv_lora),
    kr (NB+1, bs, rope)} block pools, block NB the landing block; ``table``
    (B, nb_slot) int32. ``impl="kernel"`` runs the absorbed attention as one
    MQA call of B5 (the reference's ``"pallas"``) through its latent entry:
    q = [q_lat ; qr] as (B, H, kv_lora + rope), K the latent [c ; kr] shared
    by every head and V the latent c, read from the cache's own c and kr
    pools (the reference concatenates the pool at every call; the kernel
    joins each row as it loads it); ``runs`` reaches the kernel.
    ``"gather"`` reads the padded (B, nb_slot*bs) view with the reference's
    bf16 score products. Returns (out, cache)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}, got {impl!r}")
    b = x.shape[0]
    pos_b = _batch_pos(pos, b, x.device)
    qn, qr = _mla_q(p, x, cfg, pos_b[:, None])
    c_t, kr_t = _mla_latent(p, x, cfg, pos_b[:, None])

    # pools split over the data axes are made whole for the layer (any slot
    # maps any block) and this rank's blocks written back; the kernel path
    # keeps them replicated
    (c, own), (kr, _) = meshes.gather_serve(cache["c"]), meshes.gather_serve(cache["kr"])
    blk, off = _paged_write_idx(table, pos_b, block_size, 0, c.shape[0] - 1, write_ok)
    c[blk, off] = c_t[:, 0].to(c.dtype)
    kr[blk, off] = kr_t[:, 0].to(kr.dtype)
    meshes.write_back(cache["c"], c, own)
    meshes.write_back(cache["kr"], kr, own)

    q_lat = _mla_absorb(p, qn, cfg)
    max_rows = max_seq if max_seq is not None else table.shape[1] * block_size
    if impl == "kernel":
        out_lat = paged_attn_ops.paged_latent_attention(
            torch.cat([q_lat, qr], dim=-1)[:, 0], c, kr, table, pos_b, block_size=block_size,
            max_rows=max_rows, scale=_mla_scale(cfg), runs=runs,
        ).to(x.dtype)
    else:
        tl = table.long()
        gc = c[tl].reshape(b, -1, cfg.kv_lora_rank)
        gkr = kr[tl].reshape(b, -1, cfg.qk_rope_head_dim)
        valid = _paged_valid(pos_b, gc.shape[1], 0, max_rows)
        out_lat = _mla_latent_attn(q_lat, qr, gc, gkr, valid, _mla_scale(cfg))
    return _mla_out(p, out_lat, cfg), cache


def init_mla_cache_paged(cfg: ModelConfig, num_blocks: int, block_size: int, device="cpu"):
    """Latent block pools of ``num_blocks`` blocks and the spare landing
    block."""
    return {"c": torch.zeros((num_blocks + 1, block_size, cfg.kv_lora_rank),
                             dtype=torch.bfloat16, device=device),
            "kr": torch.zeros((num_blocks + 1, block_size, cfg.qk_rope_head_dim),
                              dtype=torch.bfloat16, device=device)}


# ============================ cross attention ================================
def make_cross(m: Maker, cfg: ModelConfig):
    return make_gqa(m, cfg)


def _cross_attend(p, q, k, v, cfg: ModelConfig):
    """Unmasked attention of q (B,Sq,H,hd) over the encoder's k/v
    (B,Ssrc,KVH,hd), then the output projection: (B,Sq,d)."""
    b, sq = q.shape[:2]
    kvh, hd = cfg.n_kv_heads, cfg.hd
    mask = torch.zeros((sq, k.shape[1]), dtype=torch.float32, device=q.device)
    out = _sdpa(q.reshape(b, sq, kvh, cfg.n_heads // kvh, hd), k, v, mask,
                1.0 / math.sqrt(hd))
    return _out_proj(out.reshape(b, sq, cfg.n_heads, hd).to(q.dtype), p["wo"])


def cross_train(p, x, enc_out, cfg: ModelConfig):
    """Training and prefill form: the decoder's x (B,S,d) over the encoder's
    output enc_out (B,Ssrc,d), cast to x's type -> (B,S,d)."""
    src = enc_out.to(x.dtype)
    return _cross_attend(p, _proj(x, p["wq"]), _proj(src, p["wk"]), _proj(src, p["wv"]), cfg)


def cross_decode(p, x, cross_kv, cfg: ModelConfig):
    """Decode form: x (B,1,d) over the precomputed encoder K/V
    ``cross_kv`` {k, v} (B,Ssrc,KVH,hd) -> (B,1,d). K/V placed on a mesh
    (the dry-run's decode): each rank attends over its rows and KV heads,
    its part in zeros in f32, and one ``all_reduce`` joins the parts
    (``meshes.join``), as ``_split_dense`` does for the self-attention."""
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), cross_kv["k"], cross_kv["v"]
    if not meshes.is_dtensor(k):
        return _cross_attend(p, q, k.to(dt), v.to(dt), cfg)
    b, sq = q.shape[:2]
    kvh, hd = cfg.n_kv_heads, cfg.hd
    qg = q.reshape(b, sq, kvh, cfg.n_heads // kvh, hd)
    rows, _, heads, _ = meshes.region(k)
    kl, vl = meshes.local(k).to(dt), meshes.local(v).to(dt)
    mask = torch.zeros((sq, kl.shape[1]), dtype=torch.float32, device=q.device)
    part = _sdpa(qg[rows][:, :, heads], kl, vl, mask, 1.0 / math.sqrt(hd))
    full = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    full[rows, :, heads] = part.to(torch.float32)
    out = meshes.join(full, k.device_mesh, meshes.split_axes(k))
    return _out_proj(out.reshape(b, sq, cfg.n_heads, hd).to(dt), p["wo"])


@dataclasses.dataclass(frozen=True)
class Kind:
    """What the layer stack calls of one attention kind (``cfg.attn_kind``):
    its parameters, its training form, its decode over dense and paged
    caches, and those caches."""
    make: Callable
    train: Callable
    decode: Callable
    decode_paged: Callable
    init_cache: Callable
    init_cache_paged: Callable


_KIND_NAMES = ("make_{}", "{}_train", "{}_decode", "{}_decode_paged", "init_{}_cache",
               "init_{}_cache_paged")


def kind_of(cfg: ModelConfig) -> Kind:
    """The functions of ``cfg.attn_kind`` (``gqa`` or ``mla``), looked up in
    this module at each call, so that a function patched here reaches the
    layer stack."""
    return Kind(*(globals()[name.format(cfg.attn_kind)] for name in _KIND_NAMES))
