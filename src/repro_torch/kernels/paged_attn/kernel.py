"""Binding of the Hopper paged-attention kernel (``csrc/paged_attn.cu``, B5).

It replaces ``repro.kernels.paged_attn.kernel.paged_attn_pallas`` (the Pallas
``_paged_attn_kernel``). The library is built at first use; the wrapper
checks its inputs, allocates the output and the split body's scratch with
``torch.empty``, launches on the current stream, never synchronises, and
counts its calls in ``paged_attention.launches`` (one per call, whatever
the kernels it launches; ``paged_attention.kernels`` holds the kernels the
latest call launched: the split body and, where the table is wider than one
split, the merge).
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
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return lib, fn, int(lib.paged_attn_split_rows())


def n_splits(table_width: int, block_size: int, ring_width: int, max_rows: int,
             split_rows: int) -> int:
    """Context splits of the grid: enough for the most rows a token may read."""
    cap = min(table_width * block_size, ring_width if ring_width else max_rows)
    return max(1, -(-cap // split_rows))


def _check(q, k_pool, v_pool, table, pos, block_size, max_rows, runs):
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
    if runs is not None and (runs.dim() != 2 or runs.shape[1] != 2
                             or not 1 <= runs.shape[0] <= t or runs.dtype != torch.int32):
        raise ValueError(f"runs must be (R, 2) int32 with 1 <= R <= {t}, got "
                         f"{tuple(runs.shape)} {runs.dtype}")
    named = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table), ("pos", pos))
    for name, x in named + ((("runs", runs),) if runs is not None else ()):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention(q, k_pool, v_pool, table, pos, *, block_size: int,
                    ring_width: int = 0, max_rows: int, scale: float,
                    runs=None) -> torch.Tensor:
    """q (T, KVH, G, Dk); k_pool (NB, bs, KVH, Dk); v_pool (NB, bs, KVH, Dv),
    f32 or bf16, contiguous, on one card; table (T, nb_slot) and pos (T,)
    int32; runs None or (R, 2) int32 on the card (see ``ops``). Returns
    (T, KVH, G, Dv) f32."""
    _check(q, k_pool, v_pool, table, pos, block_size, max_rows, runs)
    t, kvh, g, dk = q.shape
    dv = v_pool.shape[3]
    out = torch.empty((t, kvh, g, dv), dtype=torch.float32, device=q.device)
    if t == 0:
        return out
    lib, fn, split_rows = _entry()
    nsplit = n_splits(table.shape[1], block_size, ring_width, max_rows, split_rows)
    scratch = (torch.empty(nsplit * t * kvh * g * (dv + 2), dtype=torch.float32,
                           device=q.device) if nsplit > 1 else None)
    kernels = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            pos.data_ptr(), None if runs is None else runs.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), t,
            t if runs is None else runs.shape[0], nsplit, kvh, g, dk, dv, block_size,
            table.shape[1], ring_width, max_rows, scale,
            int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(kernels),
        )
    build.check(lib, err, "paged_attn launch")
    paged_attention.launches += 1
    paged_attention.kernels = kernels.value
    return out


paged_attention.launches = 0
paged_attention.kernels = 0
