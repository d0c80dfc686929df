"""Gather oracle for block-table paged decode attention (plain PyTorch), held
against ``repro.kernels.paged_attn.ref`` (``paged_valid``,
``paged_attn_ref``).

Gather every table-mapped block into a padded ``(T, nb*bs, KVH, D)`` view,
mask invalid rows with NEG (which softmaxes to exactly 0.0 in f32), and run
a plain softmax attention in f32. The kernel B5 must match it on every
mapped-block pattern: partial trailing blocks, recycled (stale) blocks,
unmapped entries clamped to 0, ``max_rows`` clipping and SWA rings.
``paged_latent_attn_ref`` is the same function at the absorbed-MLA layout:
one kv head whose K row is the latent [c ; kr] and whose V row is c.
"""
from __future__ import annotations

import torch

NEG = -1e9


def paged_valid(pos, s_pad, ring_width: int, max_rows: int):
    """(T, s_pad) bool validity over the gathered (ring-ordered for SWA)
    view. Full region: rows <= pos and rows < max_rows. Ring region: rows <=
    pos while cold, every ring row once warm, gather padding always dead."""
    kpos = torch.arange(s_pad, device=pos.device)[None, :]
    p = pos[:, None]
    if ring_width:
        return (kpos < ring_width) & ((kpos <= p) | (p >= ring_width))
    return (kpos <= p) & (kpos < max_rows)


def paged_attn_ref(q, k_pool, v_pool, table, pos, *, block_size: int,
                   ring_width: int = 0, max_rows: int, scale: float, runs=None):
    """q (T, KVH, G, Dk); k_pool (NB, bs, KVH, Dk); v_pool (NB, bs, KVH, Dv);
    table (T, nb_slot) int32 physical block ids; pos (T,) int32 positions.
    ``runs`` (the kernel's hint) does not change the function and is
    ignored. Returns (T, KVH, G, Dv) float32."""
    del block_size, runs  # the pools carry the block size
    t, kvh, _, dk = q.shape
    dv = v_pool.shape[-1]
    table = table.long()
    gk = k_pool[table].reshape(t, -1, kvh, dk).to(torch.float32)
    gv = v_pool[table].reshape(t, -1, kvh, dv).to(torch.float32)
    scores = torch.einsum("tkgd,tskd->tkgs", q.to(torch.float32), gk) * scale
    valid = paged_valid(pos, gk.shape[1], ring_width, max_rows)
    scores = scores + torch.where(valid, 0.0, NEG)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("tkgs,tskd->tkgd", probs, gv)


def paged_latent_attn_ref(q, c_pool, kr_pool, table, pos, *, block_size: int,
                          max_rows: int, scale: float, runs=None):
    """q (T, H, Dc + Dr); c_pool (NB, bs, Dc); kr_pool (NB, bs, Dr); table
    and pos as ``paged_attn_ref``'s. K's row is [c row ; kr row], V's the c
    row: ``paged_attn_ref(q[:, None], cat(c, kr)[:, :, None], c[:, :, None],
    ...)[:, 0]``, with the score q·K summed as q's c part against the
    gathered c rows plus its kr part against the kr rows (nothing is
    concatenated). Returns (T, H, Dc) float32."""
    del block_size, runs
    t, dc = q.shape[0], c_pool.shape[-1]
    table = table.long()
    gc = c_pool[table].reshape(t, -1, dc).to(torch.float32)
    gkr = kr_pool[table].reshape(t, -1, kr_pool.shape[-1]).to(torch.float32)
    q = q.to(torch.float32)
    scores = (torch.einsum("thd,tsd->ths", q[..., :dc], gc)
              + torch.einsum("thd,tsd->ths", q[..., dc:], gkr)) * scale
    valid = paged_valid(pos, gc.shape[1], 0, max_rows)
    scores = scores + torch.where(valid, 0.0, NEG)[:, None, :]
    return torch.einsum("ths,tsd->thd", torch.softmax(scores, dim=-1), gc)
