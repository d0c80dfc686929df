"""Binding of the Hopper paged-attention kernel (``csrc/paged_attn.cu``, B5).

It replaces ``repro.kernels.paged_attn.kernel.paged_attn_pallas`` (the Pallas
``_paged_attn_kernel``), in two entries: ``paged_attention`` (separate K and V
pools) and ``paged_latent_attention`` (the absorbed-MLA call over the latent
pools c and kr as the cache holds them, K = [c ; kr], V = c). The library is
built at first use; each wrapper checks its inputs, allocates the output and
the scratch of the context splits with ``torch.empty``, launches on the
current stream, never synchronises, and counts its calls in ``.launches``
(one per call, whatever the kernels it launches). ``.kernels`` holds the
kernels the latest call launched (the body and, where the table is wider
than one split, the merge) and ``.body`` the body it ran (``BODIES``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_TYPES = (torch.float32, torch.bfloat16)
# the C entries' body codes: the split body (GQA), its latent mode (MLA), and
# the tiled body (what neither takes)
BODIES = ("split", "latent", "tiled")
# context rows per CTA the latent mode takes; the host picks one (see
# ``latent_split_rows``)
LATENT_SPLITS = (32, 64, 128)


@functools.cache
def _entry():
    lib = build.load("paged_attn")
    out = ctypes.POINTER(ctypes.c_int)
    fn = lib.paged_attn
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, out, out])
    fn.restype = ctypes.c_int
    latent = lib.paged_latent_attn
    latent.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float]
                       + [ctypes.c_void_p, out, out, out])
    latent.restype = ctypes.c_int
    return lib, fn, int(lib.paged_attn_split_rows()), latent


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(table_width: int, block_size: int, ring_width: int, max_rows: int,
             split_rows: int) -> int:
    """Context splits of the grid: enough for the most rows a token may read."""
    cap = min(table_width * block_size, ring_width if ring_width else max_rows)
    return max(1, -(-cap // split_rows))


def latent_split_rows(n_runs: int, t_rows: int, heads: int, table_width: int,
                      block_size: int, max_rows: int, sms: int) -> int:
    """Context rows a work item of the latent mode takes, from the call's
    shape alone (no read of the device): the largest of ``LATENT_SPLITS``
    whose items could number one an SM. An item is one pass of 64 query
    rows of a run against one split; a call has at most (T H / 64 + runs)
    passes a split, and as many splits as the table's rows need. Larger
    splits reload the queries and write partial states less often; smaller
    ones give a decode step of a few slots work for every SM."""
    cap = min(table_width * block_size, max_rows)
    passes = t_rows * heads // 64 + n_runs
    for split in sorted(LATENT_SPLITS, reverse=True):
        if -(-cap // split) * passes >= sms:
            return split
    return LATENT_SPLITS[0]


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
    lib, fn, split_rows, _ = _entry()
    nsplit = n_splits(table.shape[1], block_size, ring_width, max_rows, split_rows)
    scratch = (torch.empty(nsplit * t * kvh * g * (dv + 2), dtype=torch.float32,
                           device=q.device) if nsplit > 1 else None)
    kernels, body = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            pos.data_ptr(), None if runs is None else runs.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), t,
            t if runs is None else runs.shape[0], nsplit, kvh, g, dk, dv, block_size,
            table.shape[1], ring_width, max_rows, scale,
            int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(kernels),
            ctypes.byref(body),
        )
    build.check(lib, err, "paged_attn launch")
    paged_attention.launches += 1
    paged_attention.kernels = kernels.value
    paged_attention.body = BODIES[body.value]
    return out


paged_attention.launches = 0
paged_attention.kernels = 0
paged_attention.body = None


def _check_latent(q, c_pool, kr_pool, table, pos, block_size, max_rows, runs, split_rows):
    if q.device.type != "cuda":
        raise ValueError(f"paged_latent_attention needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or c_pool.dim() != 3 or kr_pool.dim() != 3:
        raise ValueError("q, c_pool and kr_pool must be 3-D")
    t, g, dk = q.shape
    nb, bs, dc = c_pool.shape
    dr = kr_pool.shape[2]
    if tuple(kr_pool.shape[:2]) != (nb, bs) or dk != dc + dr:
        raise ValueError(f"pools {tuple(c_pool.shape)} / {tuple(kr_pool.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if bs != block_size:
        raise ValueError(f"block_size {block_size} != the pools' {bs}")
    if table.dim() != 2 or table.shape[0] != t or tuple(pos.shape) != (t,):
        raise ValueError(f"table {tuple(table.shape)} / pos {tuple(pos.shape)} do not "
                         f"match {t} tokens")
    if min(g, table.shape[1], max_rows) < 1:
        raise ValueError("the heads, the table width and max_rows must be >= 1")
    if dc % 32 or dc > 512 or dr % 16 or dr < 16:
        raise ValueError(f"the latent kernel takes Dc a multiple of 32 up to 512 and Dr a "
                         f"multiple of 16, got Dc {dc}, Dr {dr}")
    for name, x in (("q", q), ("c_pool", c_pool), ("kr_pool", kr_pool)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the latent kernel takes bf16 {name}, got {x.dtype}")
    for name, x in (("table", table), ("pos", pos)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if runs is not None and (runs.dim() != 2 or runs.shape[1] != 2
                             or not 1 <= runs.shape[0] <= t or runs.dtype != torch.int32):
        raise ValueError(f"runs must be (R, 2) int32 with 1 <= R <= {t}, got "
                         f"{tuple(runs.shape)} {runs.dtype}")
    if split_rows is not None and split_rows not in LATENT_SPLITS:
        raise ValueError(f"split_rows must be one of {LATENT_SPLITS}, got {split_rows}")
    named = (("q", q), ("c_pool", c_pool), ("kr_pool", kr_pool), ("table", table),
             ("pos", pos))
    for name, x in named + ((("runs", runs),) if runs is not None else ()):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("q", "c_pool", "kr_pool") and x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def paged_latent_attention(q, c_pool, kr_pool, table, pos, *, block_size: int,
                           max_rows: int, scale: float, runs=None,
                           split_rows: int | None = None) -> torch.Tensor:
    """q (T, H, Dc + Dr), c_pool (NB, bs, Dc), kr_pool (NB, bs, Dr), bf16,
    contiguous, on one card; table (T, nb_slot) and pos (T,) int32; runs None
    or (R, 2) int32 on the card (see ``ops``). K's row is [c row ; kr row]
    and V's the c row. ``split_rows`` (one of ``LATENT_SPLITS``) overrides
    the host's choice of context split (``latent_split_rows``). Returns
    (T, H, Dc) f32."""
    _check_latent(q, c_pool, kr_pool, table, pos, block_size, max_rows, runs, split_rows)
    t, g, dk = q.shape
    dc, dr = c_pool.shape[2], kr_pool.shape[2]
    out = torch.empty((t, g, dc), dtype=torch.float32, device=q.device)
    if t == 0:
        return out
    lib, _, _, fn = _entry()
    n_runs = t if runs is None else runs.shape[0]
    if split_rows is None:
        split_rows = latent_split_rows(n_runs, t, g, table.shape[1], block_size, max_rows,
                                       _sms(q.device.index or 0))
    nsplit = n_splits(table.shape[1], block_size, 0, max_rows, split_rows)
    scratch = (torch.empty(nsplit * t * g * (dc + 2), dtype=torch.float32, device=q.device)
               if nsplit > 1 else None)
    kernels, body, ctas = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), c_pool.data_ptr(), kr_pool.data_ptr(), table.data_ptr(),
            pos.data_ptr(), None if runs is None else runs.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), t, n_runs, nsplit, split_rows,
            g, dc, dr, block_size, table.shape[1], max_rows, scale,
            torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(kernels),
            ctypes.byref(body), ctypes.byref(ctas),
        )
    build.check(lib, err, "paged_latent_attn launch")
    paged_latent_attention.launches += 1
    paged_latent_attention.kernels = kernels.value
    paged_latent_attention.body = BODIES[body.value]
    paged_latent_attention.grid = (ctas.value, split_rows)
    return out


paged_latent_attention.launches = 0
paged_latent_attention.kernels = 0
paged_latent_attention.body = None
paged_latent_attention.grid = None  # (CTAs launched, context rows a split) of the latest call
