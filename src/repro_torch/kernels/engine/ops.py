"""Public fused GLM gradient and GLM scoring: the plain version for CPU
tensors, the Hopper kernel for CUDA tensors (counterpart of
``repro.kernels.engine.ops``).

The JAX wrapper's ``use_kernel=`` has no counterpart: the tensors' device
picks the kernel or the plain version. Its padding of N and D to 128 lanes
has none either: the kernels mask their own ragged edges. There is no
fallback: CUDA tensors either launch the kernel or raise.
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


def glm_predict(x, w, mask=None, act: str = "linear") -> torch.Tensor:
    """Batch GLM scoring: x (N, D), w (D,), mask (N,) -> (N,) predictions
    act(X·w), 0 on dead rows, f32 on x's device."""
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    x, w, mask = (t.to(torch.float32).contiguous() for t in (x, w, mask))
    if x.device.type == "cpu":
        return ref.glm_predict_ref(x, w, mask, act)
    return kernel.glm_predict(x, w, mask, act)
