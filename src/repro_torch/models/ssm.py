"""RWKV6 (Finch) time mix and channel mix (counterpart of
``repro.models.ssm``, lines 25-188, which it is held against).

Training and prefill run the chunkwise-parallel WKV core through
``kernels.wkv.ops.wkv`` (the kernels B6 and B6-bwd on the card, the plain
chunked form on the CPU) under exactly the reference's condition; decode
runs the per-token recurrence ``wkv_scan``. Every cast of the reference is
kept where it is: the projections run in the activation type with the
weights cast at each use, and the log-decay is computed in f32 and clipped
to [-8, -1e-4]. The Mamba mixer of the hybrid family waits for ROADMAP
queue item 3.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv.ref import wkv_chunked_ref as wkv_chunked
from repro_torch.kernels.wkv.ref import wkv_ref as wkv_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, make_norm
from repro_torch.models.params import Maker

LORA_TM = 32  # token-shift ddlerp lora rank
LORA_W = 64  # decay lora rank
WKV_IMPLS = ("kernel", "plain")


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
    device (the comparison path of ``chip_smoke.py``); ``"kernel"`` goes
    through ``kernels.wkv.ops``."""
    if wkv_impl not in WKV_IMPLS:
        raise ValueError(f"wkv_impl must be one of {WKV_IMPLS}, got {wkv_impl!r}")
    b, t, d = x.shape
    h, hs = d // cfg.rwkv_head_size, cfg.rwkv_head_size
    r, k, v, g, lw, _ = _rwkv_inputs(p, x, cfg, shift_prev)
    if state is None:
        state = torch.zeros((b, h, hs, hs), dtype=torch.float32, device=x.device)
    if use_chunked and t % cfg.chunk_len == 0 and t > 1:
        wkv = wkv_ops.wkv if wkv_impl == "kernel" else wkv_chunked
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
