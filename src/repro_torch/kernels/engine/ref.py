"""Plain PyTorch fused GLM gradient, held against
``repro.kernels.engine.ref`` (``ACTS``, ``glm_error``, ``glm_grad_ref``)."""
from __future__ import annotations

import torch

ACTS = ("linear", "logistic", "svm")


def glm_error(z: torch.Tensor, y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "linear":
        return z - y
    if act == "logistic":
        return torch.sigmoid(z) - y
    if act == "svm":
        return torch.where(y * z < 1.0, -y, 0.0)
    raise ValueError(f"unknown GLM activation {act!r}")


def glm_grad_ref(
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, act: str
) -> torch.Tensor:
    """Merged (summed) gradient over the batch: X' e, e = err(act(Xw), y)."""
    x = x.to(torch.float32)
    z = x @ w.to(torch.float32)
    e = glm_error(z, y.to(torch.float32), act) * mask.to(torch.float32)
    return e @ x
