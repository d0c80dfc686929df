"""Binding of the Hopper paged-attention kernel (``csrc/paged_attn.cu``, B5).

It replaces ``repro.kernels.paged_attn.kernel.paged_attn_pallas`` (the Pallas
``_paged_attn_kernel``). The library is built at first use; the wrapper
checks its inputs, allocates the output with ``torch.empty``, launches on the
current stream, never synchronises, and counts its launches in
``paged_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_TYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    lib = build.load("paged_attn")
    fn = lib.paged_attn
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _check(q, k_pool, v_pool, table, pos, block_size, max_rows):
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q, k_pool and v_pool must be 4-D")
    t, kvh, g, dk = q.shape
    nb, bs = k_pool.shape[:2]
    if tuple(k_pool.shape) != (nb, bs, kvh, dk) or tuple(v_pool.shape[:3]) != (nb, bs, kvh):
        raise ValueError(f"pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if bs != block_size:
        raise ValueError(f"block_size {block_size} != the pools' {bs}")
    if table.dim() != 2 or table.shape[0] != t or tuple(pos.shape) != (t,):
        raise ValueError(f"table {tuple(table.shape)} / pos {tuple(pos.shape)} do not "
                         f"match {t} tokens")
    if min(kvh, g, dk, v_pool.shape[3], table.shape[1], max_rows) < 1:
        raise ValueError("every head dim, the table width and max_rows must be >= 1")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.dtype not in _TYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError("k_pool and v_pool must share a type")
    for name, x in (("table", table), ("pos", pos)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table),
                    ("pos", pos)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention(q, k_pool, v_pool, table, pos, *, block_size: int,
                    ring_width: int = 0, max_rows: int, scale: float) -> torch.Tensor:
    """q (T, KVH, G, Dk); k_pool (NB, bs, KVH, Dk); v_pool (NB, bs, KVH, Dv),
    f32 or bf16, contiguous, on one card; table (T, nb_slot) and pos (T,)
    int32. Returns (T, KVH, G, Dv) f32."""
    _check(q, k_pool, v_pool, table, pos, block_size, max_rows)
    t, kvh, g, dk = q.shape
    dv = v_pool.shape[3]
    out = torch.empty((t, kvh, g, dv), dtype=torch.float32, device=q.device)
    if t == 0:
        return out
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), t, kvh, g, dk, dv, block_size,
            table.shape[1], ring_width, max_rows, scale,
            int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, err, "paged_attn launch")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
