"""Public fused GLM gradient, SGD over a chunk's merge batches and GLM
scoring: the plain version for CPU tensors, the Hopper kernel for CUDA
tensors (counterpart of ``repro.kernels.engine.ops``).

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


def glm_sgd_chunk(
    x, y, mask, w, coef: int, act: str, a: float, b: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The engine's epoch over one chunk: SGD over the merge batches of
    ``coef`` rows of x (N, D), y (N,), mask (N,), in order, from w (D,),
    with the update w <- a*w - b*g. Returns (w, each batch's merged-gradient
    norm), f32 on x's device."""
    x, y, mask, w = (t.to(torch.float32).contiguous() for t in (x, y, mask, w))
    if x.device.type == "cpu":
        return ref.glm_sgd_chunk_ref(x, y, mask, w, coef, act, a, b)
    return kernel.glm_sgd_chunk(x, y, mask, w, coef, act, a, b)


def glm_predict(x, w, mask=None, act: str = "linear") -> torch.Tensor:
    """Batch GLM scoring: x (N, D), w (D,), mask (N,) -> (N,) predictions
    act(X·w), 0 on dead rows, f32 on x's device. A bool mask is taken as it
    is (a row lives where it is True); any other mask as f32 (where > 0)."""
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    x, w = (t.to(torch.float32).contiguous() for t in (x, w))
    mask = (mask if mask.dtype == torch.bool else mask.to(torch.float32)).contiguous()
    if x.device.type == "cpu":
        return ref.glm_predict_ref(x, w, mask, act)
    return kernel.glm_predict(x, w, mask, act)
