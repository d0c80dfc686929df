"""Plain PyTorch WKV6 (counterpart of ``repro.kernels.wkv.ref`` and the WKV
core of ``repro.models.ssm``, which they are held against):

  wkv_ref          the per-token sequential recurrence (``ssm.wkv_scan``),
                   the oracle and the decode path
  wkv_chunked_ref  the chunkwise-parallel form (``ssm.wkv_chunked``), the
                   kernel B6's plain version
  wkv_chunked_grouped  the same function in far fewer ops: every chunk's
                   state drive in one product, the outputs a group of
                   chunks at a time (the dry-run's form on meta tensors)
  wkv_bwd_ref      autograd through ``wkv_chunked_ref``, the kernel
                   B6-bwd's plain version
  wkv_chunk_states_ref  each chunk's starting state, the plain version of
                   the chunk states B6 writes for B6-bwd
  wkv_chunk_dstates_ref  the gradient of the state after each chunk, the
                   plain version of B6-bwd's serial state-gradient pass
  wkv_bwd_chunked_ref  every chunk's gradients at once from the chunk
                   states and their gradients, the plain version of B6-bwd's
                   chunk-parallel gradient pass and du's sum

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


# chunks whose outputs wkv_chunked_grouped computes together
CHUNK_GROUP = 16


def wkv_chunked_grouped(r, k, v, lw, u, state, chunk: int):
    """``wkv_chunked_ref``'s function in about a fortieth of its ops: every
    chunk's state drive (``_next_state``'s product) in one batched product,
    then only the state walks the chunks one by one, two ops a chunk; the
    outputs come ``CHUNK_GROUP`` chunks at a time from their starting
    states, which keeps the (t, s) decay tensors to a group's. The same
    values up to rounding (grouped products round otherwise), not the same
    bits: the card's comparison path keeps ``wkv_chunked_ref``. A step on
    meta tensors pays for each op, not for its size."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    cdt = torch.promote_types(r.dtype, torch.float32)

    rc, kc, vc, lwc = (_by_chunk(x, chunk, cdt) for x in (r, k, v, lw))  # (N,B,H,C,d)
    ids = torch.arange(chunk, device=r.device)
    later = (ids[None, :] >= ids[:, None])[None, None, None, :, :, None]  # s >= t
    cum = torch.cumsum(lwc, dim=-2)  # inclusive, per chunk
    q_ex = cum - lwc  # exclusive
    last = cum[..., -1:, :]
    decay = torch.exp(last[..., 0, :, None])  # (N,B,H,K,1)
    drive = (kc * torch.exp(last - cum)).transpose(-1, -2) @ vc  # (N,B,H,K,V)
    s, starts = state.to(cdt), []
    for d, w in zip(decay.unbind(0), drive.unbind(0)):
        starts.append(s)
        s = d * s + w
    uu, ys = u.to(cdt), []
    for g in range(0, len(starts), CHUNK_GROUP):
        n = slice(g, g + CHUNK_GROUP)
        rr, kk, vv, qq, cc = rc[n], kc[n], vc[n], q_ex[n], cum[n]
        y = torch.einsum("nbhck,nbhkv->nbhcv", rr * torch.exp(qq), torch.stack(starts[n]))
        dmat = qq[..., :, None, :] - cc[..., None, :, :]  # (N,B,H,t,s,K)
        dmat = dmat.masked_fill_(later, float("-inf")).exp_()
        a = torch.einsum("nbhtk,nbhsk,nbhtsk->nbhts", rr, kk, dmat)
        diag = torch.einsum("nbhtk,hk,nbhtk->nbht", rr, uu, kk)
        ys.append(y + torch.einsum("nbhts,nbhsv->nbhtv", a, vv) + diag[..., None] * vv)
    y = torch.cat(ys) if ys else r.new_zeros((0, b, h, chunk, vd), dtype=cdt)
    y = y.permute(1, 0, 3, 2, 4).reshape(b, t, h, vd)
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


def wkv_chunk_dstates_ref(r, lw, dy, ds_out, chunk: int):
    """The gradient of the state after each chunk, walking the chunks
    backwards from ``ds_out`` (B,H,K,V) or zero (None) by dS <- e^{cum_last}
    dS + sum_t (r_t e^{q_ex_t}) dy_t^T. Returns (dstates (B*H, T/chunk, K, V),
    ds0 (B,H,K,V)) in f32, or f64 for f64 inputs; dstates[:, -1] is
    ``ds_out``."""
    b, t, h, kd = r.shape
    vd = dy.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    nc = t // chunk
    cdt = torch.promote_types(r.dtype, torch.float32)

    rc, lwc, dyc = (_by_chunk(x, chunk, cdt) for x in (r, lw, dy))
    ds = r.new_zeros((b, h, kd, vd), dtype=cdt) if ds_out is None else ds_out.to(cdt)
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = ds
        cum = torch.cumsum(lwc[c], dim=-2)
        rq = rc[c] * torch.exp(cum - lwc[c])
        ds = torch.exp(cum[:, :, -1, :, None]) * ds + torch.einsum(
            "bhtk,bhtv->bhkv", rq, dyc[c])
    dstates = (torch.stack(ends, dim=2) if ends
               else ds.new_zeros((b, h, 0, kd, vd))).reshape(b * h, nc, kd, vd)
    return dstates, ds


def wkv_bwd_chunked_ref(r, k, v, lw, u, states, dstates, dy):
    """The gradients of ``wkv_chunked_ref``'s (y, state_out) in r, k, v, lw
    and u, every chunk at once by the closed form of ``csrc/wkv_bwd.cu``,
    from each chunk's starting state ``states`` and the gradient of the
    state after it ``dstates`` (both (B*H, T/chunk, K, V)) and ``dy``
    (B,T,H,V). Returns (dr, dk, dv in r's dtype, dlw, du (H,K) in f32, or
    f64 for f64 inputs); the gradient of the initial state is
    ``wkv_chunk_dstates_ref``'s."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    nc = states.shape[1]
    chunk = t // nc
    cdt = torch.promote_types(r.dtype, torch.float32)

    def chunks(x):  # (B, T, H, d) -> (T/C, B, H, C, d)
        return _by_chunk(x, chunk, cdt)

    def per_chunk(x):  # (B*H, T/C, K, V) -> (T/C, B, H, K, V)
        return x.to(cdt).reshape(b, h, nc, kd, vd).permute(2, 0, 1, 3, 4)

    rc, kc, vc, lwc, dyc = (chunks(x) for x in (r, k, v, lw, dy))
    s0, ds = per_chunk(states), per_chunk(dstates)
    uu = u.to(cdt)
    cum = torch.cumsum(lwc, dim=-2)
    q_ex = cum - lwc
    last = cum[..., -1:, :]
    ids = torch.arange(chunk, device=r.device)
    lower = (ids[None, :] < ids[:, None])[:, :, None]  # s < t
    expo = q_ex[..., :, None, :] - cum[..., None, :, :]  # (.., t, s, K)
    dmat = torch.exp(torch.where(lower, expo, float("-inf")))
    a = torch.einsum("nbhtk,nbhsk,nbhtsk->nbhts", rc, kc, dmat)
    g = torch.einsum("nbhtv,nbhsv->nbhts", dyc, vc)
    gdiag = torch.diagonal(g, dim1=-2, dim2=-1)  # (.., C)
    diag = torch.einsum("nbhtk,hk,nbhtk->nbht", rc, uu, kc)
    ukg = uu[:, None, :] * gdiag[..., None]  # u G[t, t], (.., C, K)
    decay_out = torch.exp(last - cum)  # e^{cum_last - cum_s}
    dv = (torch.einsum("nbhsk,nbhkv->nbhsv", kc * decay_out, ds)
          + torch.einsum("nbhts,nbhtv->nbhsv", a, dyc) + diag[..., None] * dyc)
    dr = (torch.exp(q_ex) * torch.einsum("nbhtv,nbhkv->nbhtk", dyc, s0)
          + torch.einsum("nbhts,nbhsk,nbhtsk->nbhtk", g, kc, dmat) + kc * ukg)
    dk = (decay_out * torch.einsum("nbhsv,nbhkv->nbhsk", vc, ds)
          + torch.einsum("nbhts,nbhtk,nbhtsk->nbhsk", g, rc, dmat) + rc * ukg)
    du = torch.einsum("nbhtk,nbhtk,nbht->hk", rc, kc, gdiag)
    # dlw_j = g_last + sum_{t >= j} g_cum_t + sum_{t > j} g_qex_t
    s_end = _next_state(s0.flatten(0, 1), kc.flatten(0, 1), vc.flatten(0, 1),
                        cum.flatten(0, 1)).reshape(s0.shape)
    g_last = (ds * s_end).sum(-1)[..., None, :]
    g_qex = rc * (dr - kc * ukg)
    g_cum = -kc * (dk - rc * ukg)

    def rev_cumsum(x):
        return torch.flip(torch.cumsum(torch.flip(x, (-2,)), -2), (-2,))

    dlw = g_last + rev_cumsum(g_cum) + rev_cumsum(g_qex) - g_qex

    def unchunk(x):  # (T/C, B, H, C, d) -> (B, T, H, d)
        return x.permute(1, 0, 3, 2, 4).reshape(b, t, h, x.shape[-1])

    return (unchunk(dr).to(r.dtype), unchunk(dk).to(r.dtype), unchunk(dv).to(r.dtype),
            unchunk(dlw), du)
