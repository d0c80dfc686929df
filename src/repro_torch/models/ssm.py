"""RWKV6 (Finch) time mix and channel mix, and the Mamba mixer of the
hybrid family (counterpart of ``repro.models.ssm``, which it is held
against).

Training and prefill run the chunkwise-parallel WKV core through
``kernels.wkv.ops.wkv`` (the kernels B6 and B6-bwd on the card, the plain
chunked form on the CPU) under exactly the reference's condition; decode
runs the per-token recurrence ``wkv_scan``. Every cast of the reference is
kept where it is: the projections run in the activation type with the
weights cast at each use, and the log-decay is computed in f32 and clipped
to [-8, -1e-4].

The Mamba mixer (``mamba_mix``) is plain PyTorch, as the reference's is
plain ``jnp``: the selective scan runs in f32, chunk by chunk, each chunk a
log-step (Hillis-Steele) scan of (decay, drive) pairs with the reference's
``combine`` and the state carried from chunk to chunk in order. The decay
and drive tensors, (B, C, d_inner, N), exist one chunk at a time. The chunk
boundaries are the reference's wherever it runs a length; where its reshape
fails (its chunk count does not divide the length) the port adds one ragged
last chunk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv.ref import wkv_chunked_grouped
from repro_torch.kernels.wkv.ref import wkv_chunked_ref as wkv_chunked
from repro_torch.kernels.wkv.ref import wkv_ref as wkv_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, make_norm
from repro_torch.models.layers import silu_rounded as _silu
from repro_torch.models.params import Maker

LORA_TM = 32  # token-shift ddlerp lora rank
LORA_W = 64  # decay lora rank
WKV_IMPLS = ("kernel", "plain", "grouped")


# ============================ RWKV6 time mix ==================================
def make_rwkv_tmix(m: Maker, cfg: ModelConfig):
    d = cfg.d_model
    h = d // cfg.rwkv_head_size
    return {
        "mu": m.param((6, d), ("state", "embed"), scale=0.02),  # base lerps (r,k,v,w,g,base)
        "tm_w1": m.param((d, 5 * LORA_TM), ("embed", "lora"), scale=0.02),
        "tm_w2": m.param((5, LORA_TM, d), ("state", "lora", "embed"), scale=0.02),
        "wd1": m.param((d, LORA_W), ("embed", "lora"), scale=0.02),
        "wd2": m.param((LORA_W, d), ("lora", "embed"), scale=0.02),
        "w0": m.param((d,), ("embed",), scale=0.02),
        "u": m.param((h, cfg.rwkv_head_size), ("heads", "head_dim"), scale=0.02),
        "wr": m.param((d, d), ("embed", "inner")),
        "wk": m.param((d, d), ("embed", "inner")),
        "wv": m.param((d, d), ("embed", "inner")),
        "wg": m.param((d, d), ("embed", "inner")),
        "wo": m.param((d, d), ("inner", "embed")),
        "ln_x": make_norm(m, d),
    }


def _tshift(x, prev=None):
    """Token shift: x[t-1] (zeros / carried state at t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_inputs(p, x, cfg: ModelConfig, shift_prev=None):
    dt = x.dtype
    xx = _tshift(x, shift_prev)
    dx = xx - x
    base = x + dx * p["mu"][5].to(dt)
    ddl = torch.tanh(base @ p["tm_w1"].to(dt))
    ddl = ddl.reshape(*ddl.shape[:-1], 5, LORA_TM)
    delta = torch.einsum("btir,ird->btid", ddl, p["tm_w2"].to(dt))
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (p["mu"][:5].to(dt)[None, None] + delta)
    xr, xk, xv, xw, xg = mixed.unbind(2)

    b, t, d = x.shape
    h, hs = d // cfg.rwkv_head_size, cfg.rwkv_head_size
    r = (xr @ p["wr"].to(dt)).reshape(b, t, h, hs)
    k = (xk @ p["wk"].to(dt)).reshape(b, t, h, hs)
    v = (xv @ p["wv"].to(dt)).reshape(b, t, h, hs)
    g = F.silu(xg @ p["wg"].to(dt))
    # data-dependent decay (log domain, clamped for stability)
    f32 = torch.float32
    lw = -torch.exp(p["w0"].to(f32)
                    + torch.tanh(xw.to(f32) @ p["wd1"].to(f32)) @ p["wd2"].to(f32))
    lw = lw.clamp(-8.0, -1e-4).reshape(b, t, h, hs)
    return r, k, v, g, lw, xx


def rwkv_tmix(p, x, cfg: ModelConfig, state=None, shift_prev=None,
              use_chunked=True, wkv_impl: str = "kernel"):
    """Full time-mix block body. Returns (out, (wkv_state, shift_state)).
    ``wkv_impl="plain"`` runs the chunked WKV as plain PyTorch on any
    device (the comparison path of ``chip_smoke.py``); ``"grouped"`` the
    same function in far fewer ops (``wkv_chunked_grouped``, the dry-run's
    form on meta tensors); ``"kernel"`` goes through ``kernels.wkv.ops``."""
    if wkv_impl not in WKV_IMPLS:
        raise ValueError(f"wkv_impl must be one of {WKV_IMPLS}, got {wkv_impl!r}")
    b, t, d = x.shape
    h, hs = d // cfg.rwkv_head_size, cfg.rwkv_head_size
    r, k, v, g, lw, _ = _rwkv_inputs(p, x, cfg, shift_prev)
    if state is None:
        state = torch.zeros((b, h, hs, hs), dtype=torch.float32, device=x.device)
    if use_chunked and t % cfg.chunk_len == 0 and t > 1:
        wkv = {"kernel": wkv_ops.wkv, "plain": wkv_chunked,
               "grouped": wkv_chunked_grouped}[wkv_impl]
        y, state = wkv(r, k, v, lw, p["u"], state, cfg.chunk_len)
    else:
        y, state = wkv_scan(r, k, v, lw, p["u"], state)
    y = y.reshape(b, t, d)
    y = apply_norm(p["ln_x"], y, 1e-5) * g
    out = y @ p["wo"].to(x.dtype)
    return out, (state, x[:, -1:])


# ============================ RWKV6 channel mix ================================
def make_rwkv_cmix(m: Maker, cfg: ModelConfig):
    d = cfg.d_model
    return {
        "mu_k": m.param((d,), ("embed",), scale=0.02),
        "mu_r": m.param((d,), ("embed",), scale=0.02),
        "wk": m.param((d, cfg.d_ff), ("embed", "ff")),
        "wv": m.param((cfg.d_ff, d), ("ff", "embed")),
        "wr": m.param((d, d), ("embed", "inner")),
    }


def rwkv_cmix(p, x, cfg: ModelConfig, shift_prev=None):
    dt = x.dtype
    xx = _tshift(x, shift_prev)
    dx = xx - x
    xk = x + dx * p["mu_k"].to(dt)
    xr = x + dx * p["mu_r"].to(dt)
    k = torch.square(F.relu(xk @ p["wk"].to(dt)))
    v = k @ p["wv"].to(dt)
    r = torch.sigmoid(xr @ p["wr"].to(dt))
    return r * v, x[:, -1:]


# ============================== Mamba (hybrid) =================================
def make_mamba(m: Maker, cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    return {
        "w_in": m.param((d, 2 * di), ("embed", "inner")),
        "conv": m.param((cfg.ssm_conv, di), ("conv", "inner"), scale=0.2),
        "w_dt": m.param((di, di), ("inner", "inner"), scale=0.01),
        "dt_bias": m.param((di,), ("inner",), scale=0.02),
        "w_b": m.param((di, n), ("inner", "state"), scale=0.05),
        "w_c": m.param((di, n), ("inner", "state"), scale=0.05),
        "a_log": m.param((di, n), ("inner", "state"), scale=0.02),
        "d_skip": m.param((di,), ("inner",), scale=0.02),
        "w_out": m.param((di, d), ("inner", "embed")),
    }


def chunk_bounds(t: int, chunk: int) -> list[tuple[int, int]]:
    """(start, end) of the scan's chunks over ``t`` tokens: the reference's
    ``nc = max(t // chunk, 1)`` chunks of ``t // nc`` tokens, and one more,
    ragged, for the tokens they leave over (where the reference raises)."""
    nc = max(t // chunk, 1)
    c = t // nc
    bounds = [(i * c, (i + 1) * c) for i in range(nc)]
    if nc * c < t:
        bounds.append((nc * c, t))
    return bounds


def _scan_pairs(a, b):
    """Inclusive scan along axis 1 of the pairs (a, b) under the reference's
    ``combine(e1, e2) = (a1 a2, b1 a2 + b2)``, in log2(C) steps: step d
    combines each element with the one d before it."""
    d, c = 1, a.shape[1]
    while d < c:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], torch.addcmul(b[:, d:], b[:, :-d], a[:, d:])], dim=1))
        d *= 2
    return a, b


def _mamba_core(p, xc, cfg: ModelConfig, h0, chunk: int):
    """xc: (B, T, di) post-conv activations; h0: (B, di, N) state. Returns
    (y (B, T, di) in xc's type, the state after the last token, f32)."""
    f32 = torch.float32
    x = xc.to(f32)
    dt = F.softplus(x @ p["w_dt"].to(f32) + p["dt_bias"].to(f32))  # (B,T,di)
    bm = x @ p["w_b"].to(f32)  # (B,T,N)
    cm = x @ p["w_c"].to(f32)
    a = -torch.exp(p["a_log"].to(f32))  # (di,N)
    u = dt * x
    h = h0.to(f32)
    ys = []
    for s, e in chunk_bounds(x.shape[1], chunk):
        decay = torch.exp(dt[:, s:e, :, None] * a)  # (B,C,di,N)
        drive = u[:, s:e, :, None] * bm[:, s:e, None, :]
        aa, bb = _scan_pairs(decay, drive)  # one token (decode): the pair itself
        hs = torch.addcmul(bb, aa, h[:, None])
        ys.append((hs @ cm[:, s:e, :, None])[..., 0])
        h = hs[:, -1]
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + p["d_skip"].to(f32) * x
    return y.to(xc.dtype), h


def mamba_mix(p, x, cfg: ModelConfig, state=None, conv_prev=None, chunk=256):
    """Returns (out, (ssm_state (B,di,N) f32, conv_state (B,conv-1,di) in
    x's type))."""
    b, t, d = x.shape
    di = cfg.ssm_expand * d
    dt_ = x.dtype
    xi = x @ p["w_in"].to(dt_)
    xz, z = xi[..., :di], xi[..., di:]
    kw = cfg.ssm_conv
    if conv_prev is None:
        conv_prev = x.new_zeros((b, kw - 1, di))
    xpad = torch.cat([conv_prev.to(dt_), xz], dim=1)
    w = p["conv"].to(dt_)
    xc = xpad[:, :t] * w[0]
    for i in range(1, kw):
        xc = xc + xpad[:, i:i + t] * w[i]
    xc = _silu(xc)
    if state is None:
        state = torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32, device=x.device)
    y, state = _mamba_core(p, xc, cfg, state, chunk=min(chunk, t))
    out = (y * _silu(z)) @ p["w_out"].to(dt_)
    return out, (state, xpad[:, t:][:, -(kw - 1):] if kw > 1 else xpad[:, :0])
