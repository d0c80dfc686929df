"""Plain PyTorch fused GLM gradient, SGD over merge batches and GLM scoring,
held against ``repro.kernels.engine.ref`` (``ACTS``, ``glm_error``,
``glm_grad_ref``, ``glm_act``, ``glm_predict_ref``) and, for
``glm_sgd_chunk_ref``, against ``glm_grad_pallas`` batch by batch."""
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


def glm_sgd_chunk_ref(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
    coef: int, act: str, a: float, b: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SGD over the merge batches of ``coef`` rows in order (the last holds
    the rows left over): per batch g = glm_grad_ref, |g|, then
    w <- a*w - b*g. Returns (w, the batches' |g|)."""
    w = w.to(torch.float32)
    gnorms = []
    for s in range(0, x.shape[0], coef):
        g = glm_grad_ref(x[s:s + coef], y[s:s + coef], w, mask[s:s + coef], act)
        gnorms.append(g.square().sum().sqrt())
        w = w * a - g * b
    if not gnorms:
        return w.clone(), torch.zeros((0,), dtype=torch.float32, device=x.device)
    return w, torch.stack(gnorms)


def glm_act(z: torch.Tensor, act: str) -> torch.Tensor:
    """Forward activation for scoring: the model's prediction from z = X·w."""
    if act == "linear":
        return z
    if act == "logistic":
        return torch.sigmoid(z)
    if act == "svm":
        return torch.where(z >= 0.0, 1.0, -1.0)
    raise ValueError(f"unknown GLM activation {act!r}")


def glm_predict_ref(
    x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, act: str
) -> torch.Tensor:
    """Per-row predictions act(X·w); dead rows (mask 0) come back as 0, by a
    select, so a dead row of inf is 0 and not NaN."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    return torch.where(mask.to(torch.float32) > 0.0, glm_act(z, act), 0.0)
