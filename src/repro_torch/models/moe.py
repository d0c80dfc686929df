"""Mixture-of-Experts: token-choice top-k routing with per-group capacity
(counterpart of ``repro.models.moe``, lines 26-134, which it is held
against, with its names, shapes and parameter axes).

Each batch row is a routing group (a decode batch, S == 1, routes as one
group across the batch). Within a group, tokens claim expert capacity slots
first come, first served (a cumsum over the group); a choice past its
expert's capacity is dropped. Dispatch gathers each live slot's token row,
the three expert products run as batched products in the activation type,
and the combine gathers every token's k slots at once and mixes them by the
renormalised router weights. The shared expert, where the model has one, is
added.

Four points where PyTorch differs from the reference and the port keeps
the reference's result:

* **Tie order.** ``jax.lax.top_k`` takes the lower expert first on equal
  probabilities; the port takes its top k from a stable descending sort,
  which keeps that order on every device (``torch.topk`` promises none).
* **Scatter.** Every live slot is written by exactly one token; only dropped
  choices share an index, the dump slot past the live ones, which nothing
  reads. So no live value depends on the order of a scatter's writes.
* **SiLU** rounds step by step in bf16 as XLA rounds ``jax.nn.silu``
  (``layers.silu_rounded``): with the fused ``F.silu`` an expert's output
  leaves the reference's by up to 0.25 on reduced olmoe in bf16.
* **Backward.** The autograd backward of a row gather is an ``index_add``,
  which sums up to k rows into a token with atomics on the card, in no fixed
  order. Dispatch and combine are one pair of autograd Functions instead,
  each one's backward the other direction's gather: dispatch's backward
  gathers a token's k slot gradients and sums them over k in order;
  combine's gathers each live slot's one choice. No float atomics anywhere,
  so a step gives the same bits twice.

The slots of all groups lie in one (E, G·C) layout, expert-major, so the
dispatched rows are the expert products' batched operand as they stand.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, make_mlp
from repro_torch.models.layers import silu_rounded as _silu
from repro_torch.models.params import Maker


def make_moe(m: Maker, cfg: ModelConfig):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": m.param((d, e), ("embed", "experts"), scale=0.005),
        "wi": m.param((e, d, f), ("experts", "embed", "ff")),
        "wg": m.param((e, d, f), ("experts", "embed", "ff")),
        "wo": m.param((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.n_shared_experts:
        p["shared"] = make_mlp(m, d, cfg.n_shared_experts * f)
    return p


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    c = int(group_tokens * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def route(x, router, k: int):
    """Router probabilities in f32 and each token's top ``k`` experts, the
    lower index first on ties as ``jax.lax.top_k`` takes them. x (..., d);
    returns (probs (..., E) f32, topw (..., k) renormalised, topi (..., k)
    int64)."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topi = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    topw = probs.gather(-1, topi)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


class Routing:
    """The capacity routing of G groups of T tokens onto E experts of C slots
    each. Slot ``e * G * C + g * C + p`` is expert e's p-th slot in group g;
    the dump slot S = E·G·C takes every dropped choice. Index tensors (all
    int64, tokens numbered ``g * T + t``):

    * ``choice_slot`` (N, k): the slot of each token's j-th choice, clipped
      to the expert's last slot where the choice was dropped;
    * ``choice_ok`` (N, k) bool: the choice holds its slot;
    * ``slot_tok`` (S,): the token in each slot (0 where empty);
    * ``slot_choice`` (S,): the flat choice index ``n * k + j`` that holds
      each slot (0 where empty);
    * ``filled`` (S,) bool: the slot is held."""

    def __init__(self, topi, cap: int, n_experts: int):
        g, t, k = topi.shape
        dev = topi.device
        mask = torch.zeros((g, t, n_experts), dtype=torch.int32, device=dev)
        mask.scatter_(-1, topi, 1)
        pos = torch.cumsum(mask, dim=1) * mask - 1  # (G, T, E); -1 where unrouted
        p_k = pos.gather(-1, topi).long()  # (G, T, k), >= 0
        ok = p_k < cap
        grp = torch.arange(g, device=dev).view(g, 1, 1) * cap
        slot = topi * (g * cap) + grp + p_k.clamp(max=cap - 1)
        n = g * t
        self.n_slots = n_experts * g * cap
        self.cap, self.groups = cap, g
        self.choice_slot = slot.reshape(n, k)
        self.choice_ok = ok.reshape(n, k)
        dst = torch.where(self.choice_ok, self.choice_slot, self.n_slots).reshape(-1)
        choice = torch.arange(n * k, device=dev)
        tok = choice // k
        # duplicate destinations are the dump slot's alone, sliced off here
        self.slot_tok = torch.zeros(self.n_slots + 1, dtype=torch.long,
                                    device=dev).scatter_(0, dst, tok)[:-1]
        self.slot_choice = torch.zeros(self.n_slots + 1, dtype=torch.long,
                                       device=dev).scatter_(0, dst, choice)[:-1]
        self.filled = torch.zeros(self.n_slots + 1, dtype=torch.bool,
                                  device=dev).scatter_(0, dst, True)[:-1]


class _Dispatch(torch.autograd.Function):
    """x (N, d) -> each slot's token row (S, d), zero in empty slots. The
    backward sums, for each token, its kept choices' slot gradients over k
    in order: a gather, no atomics."""

    @staticmethod
    def forward(ctx, x, slot_tok, filled, choice_slot, choice_ok):
        ctx.save_for_backward(choice_slot, choice_ok)
        return x[slot_tok] * filled[:, None].to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        choice_slot, choice_ok = ctx.saved_tensors
        rows = grad[choice_slot] * choice_ok[..., None].to(grad.dtype)  # (N, k, d)
        return rows.sum(1), None, None, None, None


class _Combine(torch.autograd.Function):
    """y (S, d) -> each token's k choices' slot rows (N, k, d). The backward
    gathers, for each held slot, the gradient of the one choice that holds
    it; a dropped choice reads a held slot too, but with weight 0, so its
    gradient is 0 and is left out."""

    @staticmethod
    def forward(ctx, y, choice_slot, slot_choice, filled):
        ctx.save_for_backward(slot_choice, filled)
        return y[choice_slot]

    @staticmethod
    def backward(ctx, grad):
        slot_choice, filled = ctx.saved_tensors
        flat = grad.reshape(-1, grad.shape[-1])
        return flat[slot_choice] * filled[:, None].to(grad.dtype), None, None, None


def route_groups(x, p, cfg: ModelConfig, cap: int, routing_out=None):
    """x (G, T, d) routing groups -> (G, T, d) routed experts' output.
    ``routing_out`` (a list), where given, receives the ``Routing``."""
    g, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    dt = x.dtype
    _, topw, topi = route(x, p["router"], k)
    r = Routing(topi, cap, e)
    if routing_out is not None:
        routing_out.append(r)
    xs = _Dispatch.apply(x.reshape(g * t, d), r.slot_tok, r.filled, r.choice_slot,
                         r.choice_ok)
    xs = xs.view(e, g * cap, d)
    h = torch.bmm(xs, p["wi"].to(dt))
    gate = torch.bmm(xs, p["wg"].to(dt))
    y = torch.bmm(_silu(gate) * h, p["wo"].to(dt))  # (E, G·C, d)
    rows = _Combine.apply(y.reshape(e * g * cap, d), r.choice_slot, r.slot_choice, r.filled)
    w = topw.to(dt).reshape(g * t, k) * r.choice_ok.to(dt)
    out = torch.bmm(w[:, None, :], rows)[:, 0]  # (N, d): the k rows mixed in one product
    return out.view(g, t, d)


def apply_moe(p, x, cfg: ModelConfig, routing_out=None):
    """x (B, S, d). Each batch row is a routing group (S > 1); decode
    batches (S == 1) route as a single group across the batch."""
    b, s, d = x.shape
    grouped = x.reshape(1, b, d) if s == 1 else x
    cap = capacity(cfg, grouped.shape[1])
    out = route_groups(grouped, p, cfg, cap, routing_out).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], x)
    return out


def moe_dense_reference(p, x, cfg: ModelConfig):
    """Oracle: every expert computed densely and the top-k mixed, with no
    capacity drops. Matches ``apply_moe`` when capacity does not bind."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    dt = x.dtype
    probs, topw, topi = route(xt, p["router"], cfg.experts_per_token)
    h = torch.einsum("td,edf->tef", xt, p["wi"].to(dt))
    g = torch.einsum("td,edf->tef", xt, p["wg"].to(dt))
    y = torch.einsum("tef,efd->ted", _silu(g) * h, p["wo"].to(dt))
    w_full = torch.zeros_like(probs).scatter(-1, topi, topw)
    out = torch.einsum("te,ted->td", w_full.to(dt), y).reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], x)
    return out
