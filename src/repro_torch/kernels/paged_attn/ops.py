"""Public block-table paged decode attention: the plain gather version for CPU
tensors, the Hopper kernel B5 for CUDA tensors (counterpart of
``repro.kernels.paged_attn.ops``).

The JAX wrapper's ``use_kernel=`` has no counterpart: the tensors' device
picks the kernel or the plain version. Its padding of G to 8 sublanes and of
Dk and Dv to 128 lanes has none either: the kernel takes any G, Dk and Dv.
There is no fallback: CUDA tensors either launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attn import kernel, ref


def paged_attention(q, k_pool, v_pool, table, pos, *, block_size: int,
                    ring_width: int = 0, max_rows: int, scale: float,
                    runs=None) -> torch.Tensor:
    """Block-table paged decode attention.

    q (T, KVH, G, Dk) queries (G query heads per kv head; an MLA absorbed
    decode passes KVH=1, G=n_heads, Dk=kv_lora+rope, Dv=kv_lora);
    k_pool/v_pool (NB, bs, KVH, D*) block pools; table (T, nb_slot) physical
    block ids per token (unmapped entries clamped to 0: reads through them
    are masked); pos (T,) positions. ``ring_width`` > 0 selects SWA ring
    validity (logical rows are ``pos % ring_width``). Returns
    (T, KVH, G, Dv) float32 on q's device.

    ``runs`` is a hint that does not change the result: None (every row its
    own run) or (R, 2) int32 on q's device, rows (first row, row count) that
    cover the rows 0..T-1 in order, once each, where the rows of one run
    share one table row (one slot's tokens in a serving step; each keeps its
    own position, so its own causal limit). The kernel then reads each run's
    context once for all its rows. The caller guarantees this precondition:
    neither this function nor the kernel reads the tensor back to check it,
    and a run whose rows map different blocks reads the first row's. The
    plain version ignores it.
    """
    table = table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    kw = dict(block_size=int(block_size), ring_width=int(ring_width),
              max_rows=int(max_rows), scale=float(scale))
    if q.device.type == "cpu":
        return ref.paged_attn_ref(q, k_pool, v_pool, table, pos, runs=runs, **kw)
    if runs is not None:
        runs = runs.to(torch.int32).contiguous()
    return kernel.paged_attention(q.contiguous(), k_pool.contiguous(),
                                  v_pool.contiguous(), table, pos, runs=runs, **kw)


def paged_latent_attention(q, c_pool, kr_pool, table, pos, *, block_size: int,
                           max_rows: int, scale: float, runs=None) -> torch.Tensor:
    """The absorbed-MLA call of block-table paged decode attention, over the
    latent pools as the cache holds them.

    q (T, H, Dc + Dr) queries ([q_lat ; qr] of H heads); c_pool (NB, bs, Dc)
    and kr_pool (NB, bs, Dr) the latent pools: K's row is [c row ; kr row]
    and V's the c row, one kv head shared by every query head. table, pos,
    max_rows and ``runs`` as in ``paged_attention`` (no SWA ring). Returns
    (T, H, Dc) float32 on q's device: ``paged_attention(q[:, None], cat(c,
    kr)[:, :, None], c[:, :, None], ...)[:, 0]`` without building the
    concatenated pool. On CUDA tensors it launches the kernel's latent mode,
    which takes bf16 q and pools, Dc a multiple of 32 up to 512 and Dr a
    multiple of 16, and raises on anything else.
    """
    table = table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    kw = dict(block_size=int(block_size), max_rows=int(max_rows), scale=float(scale))
    if q.device.type == "cpu":
        return ref.paged_latent_attn_ref(q, c_pool, kr_pool, table, pos, runs=runs, **kw)
    if runs is not None:
        runs = runs.to(torch.int32).contiguous()
    return kernel.paged_latent_attention(q.contiguous(), c_pool.contiguous(),
                                         kr_pool.contiguous(), table, pos, runs=runs, **kw)
