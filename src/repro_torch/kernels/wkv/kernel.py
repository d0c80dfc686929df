"""Bindings of the Hopper WKV6 kernels: the chunkwise forward
(``csrc/wkv.cu``, B6) and its backward (``csrc/wkv_bwd.cu``, B6-bwd).

The forward replaces ``repro.kernels.wkv.wkv.wkv_pallas`` (the Pallas
``_wkv_kernel``); the backward has no TPU counterpart (the reference cannot
differentiate ``wkv_pallas``). Each library is built at first use; a wrapper
checks its inputs, allocates its outputs and scratch with ``torch.empty``,
launches on the current stream and never synchronises. The forward is two CUDA
launches (a serial state pass that writes each chunk's starting state, then a
chunk-parallel output pass that reads them), counted as one in
``wkv_forward.launches``. The backward is three (a serial pass that writes the
gradient of the state after each chunk, a chunk-parallel pass that computes
every chunk's gradients from the chunk states and those, then du's
fixed-order sum over the batch), counted as one in ``wkv_backward.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_TYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _fwd_entry():
    lib = build.load("wkv")
    fn = lib.wkv_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = lib.wkv_fwd_info
    info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    info.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_entry():
    lib = build.load("wkv_bwd")
    fn = lib.wkv_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    info = lib.wkv_bwd_info
    info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    info.restype = ctypes.c_int
    return lib, fn


def _check(what, chunk, r, k, v, lw, u, state):
    """Validate the forward's inputs; returns (B, T, H, K, V)."""
    if r.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {r.device}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, K), got {tuple(r.shape)}")
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    if r.dtype not in _TYPES:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    want = {"r": (r, (b, t, h, kd), r.dtype), "k": (k, (b, t, h, kd), r.dtype),
            "v": (v, (b, t, h, vd), r.dtype), "lw": (lw, (b, t, h, kd), torch.float32),
            "u": (u, (h, kd), torch.float32), "state": (state, (b, h, kd, vd), torch.float32)}
    for name, (x, shape, dtype) in want.items():
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if chunk < 1 or t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    return b, t, h, kd, vd


def wkv_forward(r, k, v, lw, u, state, chunk: int, save_states: bool = False):
    """r, k (B,T,H,K) and v (B,T,H,V) in f32 or bf16, lw (B,T,H,K) f32,
    u (H,K) f32, state (B,H,K,V) f32, all contiguous on one card ->
    (y (B,T,H,V) in r's dtype, state_out (B,H,K,V) f32, the chunks' starting
    states (B*H, T/chunk, K, V) f32 for the backward, or None unless
    ``save_states``). The output pass reads the chunk states either way:
    without ``save_states`` they are scratch, freed after the call."""
    b, t, h, kd, vd = _check("wkv_forward", chunk, r, k, v, lw, u, state)
    y = torch.empty((b, t, h, vd), dtype=r.dtype, device=r.device)
    s_out = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    states = torch.empty((b * h, t // chunk, kd, vd), dtype=torch.float32, device=r.device)
    if b * h == 0 or t == 0:
        s_out.copy_(state)
        return y, s_out, states if save_states else None
    lib, fn = _fwd_entry()
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
                 state.data_ptr(), y.data_ptr(), s_out.data_ptr(), states.data_ptr(),
                 b, t, h, kd, vd, chunk, int(r.dtype == torch.bfloat16),
                 torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, err, "wkv_forward launch")
    wkv_forward.launches += 1
    return y, s_out, states if save_states else None


wkv_forward.launches = 0


def wkv_forward_info(kd: int, vd: int, chunk: int, dtype) -> dict:
    """The build's registers a thread, CTAs an SM and shared bytes a CTA of
    the forward's two kernels (state pass, output pass) at these sizes, as
    the card's runtime reports them."""
    lib, _ = _fwd_entry()
    out = (ctypes.c_int * 6)()
    build.check(lib, lib.wkv_fwd_info(kd, vd, chunk, int(dtype == torch.bfloat16), out),
                "wkv_forward_info")
    return {name: {"registers": out[i], "ctas_per_sm": out[2 + i], "smem_bytes": out[4 + i]}
            for i, name in enumerate(("state_pass", "output_pass"))}


def wkv_backward(r, k, v, lw, u, state, states, s_out, dy, dstate, chunk: int,
                 save_dstates: bool = False):
    """Gradients of ``wkv_forward``'s (y, state_out) under the cotangents
    ``dy`` (B,T,H,V) in r's dtype and ``dstate`` (B,H,K,V) f32 or None (zero),
    given the forward's inputs, its saved chunk states and its state_out.
    Returns (dr, dk, dv in r's dtype, dlw f32, du (H,K) f32, dstate_in f32),
    and with ``save_dstates`` also the gradient of the state after each chunk
    (B*H, T/chunk, K, V) f32, which the gradient pass reads either way
    (scratch, freed after the call, without it)."""
    b, t, h, kd, vd = _check("wkv_backward", chunk, r, k, v, lw, u, state)
    nc = t // chunk
    for name, x, shape, dtype in (
            ("states", states, (b * h, nc, kd, vd), torch.float32),
            ("s_out", s_out, (b, h, kd, vd), torch.float32),
            ("dy", dy, (b, t, h, vd), r.dtype),
            ("dstate", dstate, (b, h, kd, vd), torch.float32)):
        if x is None and name == "dstate":
            continue
        if x.device != r.device or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} on {r.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dlw = torch.empty_like(lw)
    du = torch.empty_like(u)
    ds0 = torch.empty_like(state)
    dstates = torch.empty((b * h, nc, kd, vd), dtype=torch.float32, device=r.device)
    extra = (dstates,) if save_dstates else ()
    if b * h == 0 or t == 0:
        du.zero_()
        ds0.copy_(dstate if dstate is not None else torch.zeros_like(state))
        return dr, dk, dv, dlw, du, ds0, *extra
    du_part = torch.empty((b * h, nc, kd), dtype=torch.float32, device=r.device)
    lib, fn = _bwd_entry()
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
                 states.data_ptr(), s_out.data_ptr(), dy.data_ptr(),
                 dstate.data_ptr() if dstate is not None else None,
                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
                 dstates.data_ptr(), du_part.data_ptr(), du.data_ptr(), ds0.data_ptr(),
                 b, t, h, kd, vd, chunk, int(r.dtype == torch.bfloat16),
                 torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, err, "wkv_backward launch")
    wkv_backward.launches += 1
    return dr, dk, dv, dlw, du, ds0, *extra


wkv_backward.launches = 0


def wkv_backward_info(kd: int, vd: int, chunk: int, dtype) -> dict:
    """The build's registers a thread, CTAs an SM, shared bytes and threads a
    CTA of the backward's three kernels (state-gradient pass, gradient pass,
    du's sum) at these sizes, as the card's runtime reports them."""
    lib, _ = _bwd_entry()
    out = (ctypes.c_int * 12)()
    build.check(lib, lib.wkv_bwd_info(kd, vd, chunk, int(dtype == torch.bfloat16), out),
                "wkv_backward_info")
    return {name: {"registers": out[i], "ctas_per_sm": out[3 + i], "smem_bytes": out[6 + i],
                   "threads": out[9 + i]}
            for i, name in enumerate(("dstate_pass", "grad_pass", "du_reduce"))}
