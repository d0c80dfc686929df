"""Public fused GLM gradient, SGD over a chunk's merge batches and GLM
scoring: the plain version for CPU tensors, the Hopper kernel for CUDA
tensors (counterpart of ``repro.kernels.engine.ops``).

The JAX wrapper's ``use_kernel=`` has no counterpart: the tensors' device
picks the kernel or the plain version. Its padding of N and D to 128 lanes
has none either: the kernels mask their own ragged edges. There is no
fallback: CUDA tensors either launch the kernel or raise.

``glm_grad_sharded`` is the gradient on a mesh: each rank's share of a merge
batch through ``glm_grad`` (B2 on the card), summed over the ranks with
``all_reduce``, the tree-bus merge across ranks.
"""
from __future__ import annotations

import torch

from repro_torch.dist import meshes
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


def glm_grad_sharded(x, y, w, mask=None, act: str = "linear", *, mesh=None,
                     data_axes: tuple[str, ...] = (),
                     model_axis: str | None = None) -> torch.Tensor:
    """The merged GLM gradient of a merge batch split over ``mesh`` (the
    current mesh when None): x (n, D) and y, mask (n,) are this rank's rows.

    Without a model axis, w (D,) is whole: ``glm_grad`` (B2 on a CUDA
    tensor, the plain version on a CPU one) takes the rank's rows, and one
    ``all_reduce`` sums the result over ``data_axes``. With ``model_axis``,
    x (n, D_f) and w (D_f,) are the rank's feature slice, in the reference's
    row-parallel form: the hypothesis z = X_f w_f summed over the model
    axis, the error, then g_f = e X_f summed over ``data_axes``; the products
    are ``torch.matmul``, as ``repro``'s are plain dots outside its kernel.
    Returns this rank's (D,) or (D_f,) f32 gradient. Only ``all_reduce``
    crosses ranks."""
    mesh = meshes.current_mesh() if mesh is None else mesh
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    if model_axis is None:
        g = glm_grad(x, y, w, mask, act=act)
    else:
        xf = x.to(torch.float32)
        z = meshes.all_reduce(torch.matmul(xf, w.to(torch.float32)), mesh, (model_axis,))
        e = ref.glm_error(z, y.to(torch.float32), act) * mask.to(torch.float32)
        g = torch.matmul(e, xf)
    return meshes.all_reduce(g, mesh, data_axes)
