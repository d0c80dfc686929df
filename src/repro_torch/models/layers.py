"""Shared neural layers: RMSNorm, RoPE, embeddings, gated MLP (counterpart of
``repro.models.layers``, lines 18-86, which it is held against).

Every cast of the reference is kept where it is: norms and rotary
embeddings compute in f32 and return the input's type, the embedding and
the unembedding run in bf16 whatever the configuration says (the reference's
``embed`` casts the table to bf16, so every activation after it is bf16),
and the projections cast their weights to the activation type (a no-op for
weights stored already cast, see ``params``). The cross-entropy losses
(lines 89-145 of the reference) read the target's logit with a ``gather``
where the reference multiplies by ``one_hot(targets)``: the same value,
without a (B, S, V) f32 tensor.

Each loss term divides by its token count, ``mask.sum()``. On a mesh the
train step first sums every term's count over the data axes and installs
the sums with ``global_counts``: each rank then divides its own rows' sum
by the global batch's count, so the ranks' losses add up to the global
batch's mean (ROADMAP §C).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Maker


def rms_norm(x, weight, eps):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.to(torch.float32)).to(dt)


def make_norm(m: Maker, d: int):
    # stored as (w - 1), and always f32: the reference applies it in f32
    return {"scale": m.param((d,), ("embed",), scale=0.0, dtype=torch.float32)}


def apply_norm(p, x, eps):
    return rms_norm(x, p["scale"].to(torch.float32) + 1.0, eps)


# -- rotary position embeddings -------------------------------------------------
def rope_tables(positions, dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., dim/2) f32. The frequencies are
    ``theta ** (-arange/half)`` in f32, as the reference computes them."""
    half = dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(theta, expo)  # f32: the Python base takes the exponent's type
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin broadcastable (..., S, 1, D/2)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embedding --------------------------------------------------------------------
def make_embedding(m: Maker, cfg: ModelConfig):
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"table": m.param((v, d), ("vocab", "embed"), scale=0.01)}
    if not cfg.tie_embeddings:
        p["unembed"] = m.param((d, v), ("embed", "vocab"))
    return p


def embed(p, tokens, cfg: ModelConfig):
    return p["table"][tokens].to(torch.bfloat16)


def unembed(p, x, cfg: ModelConfig):
    w = (p["table"].T if cfg.tie_embeddings else p["unembed"]).to(torch.bfloat16)
    return x.to(torch.bfloat16) @ w


# -- gated MLP (SwiGLU) -----------------------------------------------------------
def make_mlp(m: Maker, d: int, d_ff: int):
    return {
        "wi": m.param((d, d_ff), ("embed", "ff")),
        "wg": m.param((d, d_ff), ("embed", "ff")),
        "wo": m.param((d_ff, d), ("ff", "embed")),
    }


def silu_rounded(x):
    """SiLU rounded as the reference rounds it: in bf16, ``jax.nn.silu``
    lowers to x * (1 / (1 + exp(-x))) with each step rounded to bf16, which
    the fused ``F.silu`` (one rounding) misses by an ulp on many elements.
    The Mamba scan's exponentials carry such an ulp far, and an expert
    product's output moves by as much as 0.25 in bf16 on reduced olmoe. In
    f32 the two agree within an ulp and ``F.silu`` keeps its stable
    gradient. (``apply_mlp`` keeps ``F.silu``: the dense models match the
    reference within their bf16 bounds with it.)"""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))


def apply_mlp(p, x):
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    g = x @ p["wg"].to(dt)
    return (F.silu(g) * h) @ p["wo"].to(dt)


# -- losses -------------------------------------------------------------------------
def _token_nll(logits, targets, true_vocab: int):
    """Per-token negative log-likelihood in f32; padded vocab entries are
    masked to -1e9 in the logits' type first, as the reference masks them."""
    v = logits.shape[-1]
    if true_vocab < v:
        pad = torch.arange(v, device=logits.device) >= true_vocab
        logits = logits.masked_fill(pad, -1e9)
    logits = logits.to(torch.float32)
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return lse - tgt


_COUNTS = threading.local()


@contextlib.contextmanager
def global_counts(counts: dict):
    """Divide each loss term named in ``counts`` (``"xent"``, ``"mtp"``) by
    its count there, a tensor: the term's tokens over the whole batch,
    where the rows at hand are one rank's share of it."""
    prev = getattr(_COUNTS, "counts", None)
    _COUNTS.counts = counts
    try:
        yield
    finally:
        _COUNTS.counts = prev


def token_count(mask, term: str = "xent"):
    """The divisor of the loss term ``term``: its count under
    ``global_counts``, else the tokens where ``mask`` is set; at least 1."""
    counts = getattr(_COUNTS, "counts", None)
    n = mask.sum() if counts is None else counts[term]
    return torch.clamp(n, min=1.0)


def softmax_xent(logits, targets, mask, true_vocab: int, term: str = "xent"):
    """Mean cross-entropy over the tokens where ``mask`` is set."""
    nll = _token_nll(logits, targets, true_vocab) * mask
    return nll.sum() / token_count(mask, term)


def chunked_xent(p_embed, h, targets, mask, cfg: ModelConfig, chunk: int):
    """Cross-entropy over sequence chunks, each under
    ``torch.utils.checkpoint``: the (B, S, V) logits never exist at once,
    only one (B, chunk, V) tile (recomputed in the backward)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))

    def chunk_loss(hx, tx, mx):
        nll = _token_nll(unembed(p_embed, hx, cfg), tx, cfg.vocab_size)
        return (nll * mx).sum()

    total = h.new_zeros((), dtype=torch.float32)
    for c in range(0, h.shape[1], chunk):
        total = total + checkpoint(chunk_loss, h[:, c:c + chunk], targets[:, c:c + chunk],
                                   mask[:, c:c + chunk], use_reentrant=False)
    return total / token_count(mask)
