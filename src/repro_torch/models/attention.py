"""GQA decode attention over dense and paged KV caches (counterpart of
``repro.models.attention``, lines 102-310, which it is held against).

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

MLA, cross attention and the training forms wait for later slices; the
model stack (``transformer``) raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attn import ops as paged_attn_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rope_tables
from repro_torch.models.params import Maker

NEG = -1e9
ATTN_IMPLS = ("gather", "kernel")


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,KVH,G,D), k/v (B,Skv,KVH,D), mask (B,1,1,Sq,Skv) f32."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    probs = torch.softmax(scores + mask, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))


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
    row == slot); ``write_ok`` (B,) bool gates the cache write (gated-off
    rows land in the spare row)."""
    b = x.shape[0]
    dt = x.dtype
    pos_b = _batch_pos(pos, b, x.device)
    q, k, v = gqa_project(p, x, cfg, pos_b[:, None])

    ck, cv = cache["k"], cache["v"]
    s = ck.shape[1]
    nslots = ck.shape[0] - 1
    row = pos_b % s if window else pos_b.clamp(max=s - 1)
    rows = torch.arange(b, device=x.device) if slot is None else slot
    wrow = rows if write_ok is None else torch.where(write_ok, rows, nslots)
    ck[wrow, row] = k[:, 0].to(ck.dtype)
    cv[wrow, row] = v[:, 0].to(cv.dtype)

    kvh, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kvh
    # validity (per row): full caches are valid <= pos; ring buffers are fully
    # valid once warm (pos >= ring size) and valid <= pos while still cold,
    # which also hides a freed slot's stale entries from a request that
    # restarts the slot at pos 0
    kpos = torch.arange(s, device=x.device)[None, :]
    valid = kpos <= pos_b[:, None]
    if window:
        valid |= pos_b[:, None] >= s
    gk, gv = (ck[:b], cv[:b]) if slot is None else (ck[slot], cv[slot])
    mask = torch.where(valid, 0.0, NEG)[:, None, None, None, :]
    out = _sdpa(q.reshape(b, 1, kvh, g, hd), gk, gv, mask, 1.0 / math.sqrt(hd))
    out = _out_proj(out.reshape(b, 1, cfg.n_heads, hd).to(dt), p["wo"])
    return out, cache


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
    gather path ignores it. Returns (out, cache)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}, got {impl!r}")
    b = x.shape[0]
    dt = x.dtype
    pos_b = _batch_pos(pos, b, x.device)
    q, k, v = gqa_project(p, x, cfg, pos_b[:, None])

    ck, cv = cache["k"], cache["v"]
    blk, off = _paged_write_idx(table, pos_b, block_size, ring_width,
                                ck.shape[0] - 1, write_ok)
    ck[blk, off] = k[:, 0].to(ck.dtype)
    cv[blk, off] = v[:, 0].to(cv.dtype)

    kvh, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kvh
    max_rows = max_seq if max_seq is not None else table.shape[1] * block_size
    scale = 1.0 / math.sqrt(hd)
    if impl == "kernel":
        out = paged_attn_ops.paged_attention(
            q.reshape(b, kvh, g, hd), ck, cv, table, pos_b,
            block_size=block_size, ring_width=ring_width,
            max_rows=max_rows, scale=scale, runs=runs,
        )
    else:
        tl = table.long()
        gk = ck[tl].reshape(b, -1, kvh, hd)
        gv = cv[tl].reshape(b, -1, kvh, hd)
        valid = _paged_valid(pos_b, gk.shape[1], ring_width, max_rows)
        mask = torch.where(valid, 0.0, NEG)[:, None, None, None, :]
        out = _sdpa(q.reshape(b, 1, kvh, g, hd), gk, gv, mask, scale)
    out = _out_proj(out.reshape(b, 1, cfg.n_heads, hd).to(dt), p["wo"])
    return out, cache


def init_gqa_cache_paged(cfg: ModelConfig, num_blocks: int, block_size: int,
                         device="cpu"):
    """Block pools of ``num_blocks`` blocks and the spare landing block."""
    shape = (num_blocks + 1, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
