"""Plain PyTorch WKV6 (counterpart of ``repro.kernels.wkv.ref`` and the WKV
core of ``repro.models.ssm``, which they are held against):

  wkv_ref          the per-token sequential recurrence (``ssm.wkv_scan``),
                   the oracle and the decode path
  wkv_chunked_ref  the chunkwise-parallel form (``ssm.wkv_chunked``), the
                   kernel B6's plain version
  wkv_bwd_ref      autograd through ``wkv_chunked_ref``, the kernel
                   B6-bwd's plain version

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


def wkv_chunked_ref(r, k, v, lw, u, state, chunk: int):
    """Chunkwise-parallel WKV6 with T % chunk == 0. Returns (y (B,T,H,V),
    state_out)."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    nc = t // chunk
    cdt = torch.promote_types(r.dtype, torch.float32)

    def resh(x, d):  # (B, T, H, d) -> (nc, B, H, C, d) in cdt
        return x.to(cdt).reshape(b, nc, chunk, h, d).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = resh(r, kd), resh(k, kd), resh(v, vd), resh(lw, kd)
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
        last = cum[:, :, -1:, :]
        s = torch.exp(last[:, :, 0, :, None]) * s + torch.einsum(
            "bhsk,bhsv->bhkv", kk * torch.exp(last - cum), vv)
        ys.append(y)
    y = torch.stack(ys, dim=0).permute(1, 0, 3, 2, 4).reshape(b, t, h, vd)
    return y.to(r.dtype), s


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
