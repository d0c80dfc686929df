"""Public fused GLM gradient: the plain version for CPU tensors, the Hopper
kernel for CUDA tensors (counterpart of ``repro.kernels.engine.ops``).

The TPU wrapper's padding of N and D to 128 lanes has no counterpart: the
kernel masks its own ragged edges. There is no fallback: CUDA tensors either
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.engine import kernel, ref


def glm_grad(x, y, w, mask=None, act: str = "linear") -> torch.Tensor:
    """Merged GLM gradient over a tuple batch (the fused engine step):
    x (N, D), y (N,), w (D,), mask (N,) -> (D,) f32 on x's device."""
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    x, y, w, mask = (t.to(torch.float32).contiguous() for t in (x, y, w, mask))
    if x.device.type == "cpu":
        return ref.glm_grad_ref(x, y, w, mask, act)
    return kernel.glm_grad(x, y, w, mask, act)
