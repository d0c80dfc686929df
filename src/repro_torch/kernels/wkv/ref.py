"""Plain PyTorch WKV6 (counterpart of ``repro.kernels.wkv.ref`` and the WKV
core of ``repro.models.ssm``, which they are held against):

  wkv_ref          the per-token sequential recurrence (``ssm.wkv_scan``),
                   the oracle and the decode path
  wkv_chunked_ref  the chunkwise-parallel form (``ssm.wkv_chunked``), the
                   kernel B6's plain version
  wkv_bwd_ref      autograd through ``wkv_chunked_ref``, the kernel
                   B6-bwd's plain version
  wkv_chunk_states_ref  each chunk's starting state, the plain version of
                   the chunk states B6 writes for B6-bwd

    y_t = r_t . S_{t-1}  +  (r_t * u * k_t) . v_t
    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T

r/k/v/lw (B, T, H, K) with v (B, T, H, V), u (H, K), state (B, H, K, V).
Everything computes in f32 (in f64 when r is f64, the precision witness of
the kernels' tests); y comes back in r's dtype, the state in f32 (f64).

One deliberate difference from ``ssm.wkv_chunked``: the reference computes
``exp(q_ex_t - cum_s)`` for every (t, s) and multiplies the pairs s >= t by
zero afterwards. For s > t the exponent is positive, and with log-decays near
their clip bound (-8) it overflows to inf, so inf * 0 turns y into NaN. Here
the exponent of those pairs is set to -inf before the exponential: the pairs
that are kept compute the same numbers, the others give 0, and the
gradients stay finite.
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, lw, u, state):
    """Per-token sequential recurrence. Returns (y (B,T,H,V), state_out)."""
    cdt = torch.promote_types(r.dtype, torch.float32)
    s = state.to(cdt)
    uu = u.to(cdt)
    ys = []
    for t in range(r.shape[1]):
        rr, kk, vv, ll = (a[:, t].to(cdt) for a in (r, k, v, lw))
        y = torch.einsum("bhk,bhkv->bhv", rr, s) + \
            torch.einsum("bhk,hk,bhk->bh", rr, uu, kk)[..., None] * vv
        s = torch.exp(ll)[..., None] * s + kk[..., None] * vv[..., None, :]
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else r.new_zeros((*r.shape[:3], v.shape[-1]))
    return y.to(r.dtype), s


def _by_chunk(x, chunk, cdt):
    """(B, T, H, d) -> (T/chunk, B, H, chunk, d) in ``cdt``."""
    b, t, h, d = x.shape
    return x.to(cdt).reshape(b, t // chunk, chunk, h, d).permute(1, 0, 3, 2, 4)


def _next_state(s, kk, vv, cum):
    """The state after a chunk: S' = e^{cum_last} S + sum_s (k_s
    e^{cum_last - cum_s}) v_s^T, with cum the chunk's inclusive cumsum of
    the log-decays; kk, cum (B,H,C,K), vv (B,H,C,V), s (B,H,K,V)."""
    last = cum[:, :, -1:, :]
    return torch.exp(last[:, :, 0, :, None]) * s + torch.einsum(
        "bhsk,bhsv->bhkv", kk * torch.exp(last - cum), vv)


def wkv_chunked_ref(r, k, v, lw, u, state, chunk: int):
    """Chunkwise-parallel WKV6 with T % chunk == 0. Returns (y (B,T,H,V),
    state_out)."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    nc = t // chunk
    cdt = torch.promote_types(r.dtype, torch.float32)

    rc, kc, vc, lwc = (_by_chunk(x, chunk, cdt) for x in (r, k, v, lw))
    uu = u.to(cdt)
    ids = torch.arange(chunk, device=r.device)
    lower = (ids[None, :] < ids[:, None])[None, None, :, :, None]  # s < t
    s = state.to(cdt)
    ys = []
    for c in range(nc):
        rr, kk, vv, ll = rc[c], kc[c], vc[c], lwc[c]
        cum = torch.cumsum(ll, dim=-2)  # inclusive (B,H,C,K)
        q_ex = cum - ll  # exclusive
        y = torch.einsum("bhck,bhkv->bhcv", rr * torch.exp(q_ex), s)
        expo = q_ex[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,H,t,s,K)
        dmat = torch.exp(torch.where(lower, expo, float("-inf")))
        a = torch.einsum("bhtk,bhsk,bhtsk->bhts", rr, kk, dmat)
        diag = torch.einsum("bhtk,hk,bhtk->bht", rr, uu, kk)
        y = y + torch.einsum("bhts,bhsv->bhtv", a, vv) + diag[..., None] * vv
        s = _next_state(s, kk, vv, cum)
        ys.append(y)
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4).reshape(b, t, h, vd)
    return y.to(r.dtype), s


def wkv_chunk_states_ref(k, v, lw, state, chunk: int):
    """Each chunk's starting state and the final state, by the state update
    of ``wkv_chunked_ref`` (the same operations, so the same final state).
    Returns (states (B*H, T/chunk, K, V), state_out (B,H,K,V)) in f32, or
    f64 for f64 inputs; states[:, 0] is ``state``."""
    b, t, h, kd = k.shape
    vd = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    nc = t // chunk
    cdt = torch.promote_types(k.dtype, torch.float32)

    kc, vc, lwc = (_by_chunk(x, chunk, cdt) for x in (k, v, lw))
    s = state.to(cdt)
    starts = []
    for c in range(nc):
        starts.append(s)
        s = _next_state(s, kc[c], vc[c], torch.cumsum(lwc[c], dim=-2))
    states = (torch.stack(starts, dim=2) if starts
              else s.new_zeros((b, h, 0, kd, vd))).reshape(b * h, nc, kd, vd)
    return states, s


def wkv_bwd_ref(r, k, v, lw, u, state, chunk: int, dy, dstate):
    """Gradients of (y, state_out) = wkv_chunked_ref(...) under the
    cotangents ``dy`` (B,T,H,V) and ``dstate`` (B,H,K,V) or None. Returns
    (dr, dk, dv, dlw, du, dstate_in), each in its input's dtype."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(True) for x in (r, k, v, lw, u, state)]
        y, s = wkv_chunked_ref(*ins, chunk)
        outs, cots = [y], [dy]
        if dstate is not None:
            outs.append(s)
            cots.append(dstate)
        return torch.autograd.grad(outs, ins, cots, allow_unused=True)
