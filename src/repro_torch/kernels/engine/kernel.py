"""Bindings of the Hopper GLM kernels: the fused gradient
(``csrc/glm_grad.cu``, B2) and row-parallel scoring (``csrc/glm_predict.cu``,
B4).

They replace ``repro.kernels.engine.engine.glm_grad_pallas`` and
``glm_predict_pallas`` (the Pallas ``_glm_kernel`` and
``_glm_predict_kernel``). Each library is built at first use; a wrapper
checks its inputs, allocates its outputs and scratch with ``torch.empty``,
launches on the current stream and never synchronises. The gradient's two
CUDA launches (partial sums, then their fixed-order reduction) count as one
in ``glm_grad.launches``; ``glm_predict.launches`` counts the scoring
kernel's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ACT_CODES = {"linear": 0, "logistic": 1, "svm": 2}


@functools.cache
def _entry():
    lib = build.load("glm_grad")
    fn = lib.glm_grad
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.glm_grad_tile_rows.argtypes = []
    lib.glm_grad_tile_rows.restype = ctypes.c_int
    return lib, fn, lib.glm_grad_tile_rows()


def _check(what: str, act: str, x: torch.Tensor, **vectors) -> tuple[int, int]:
    """Validate x (N, D) and the named vectors, each given with its length
    ("n" or "d"): f32, contiguous, on x's card. Returns (N, D)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown GLM activation {act!r}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D), got {tuple(x.shape)}")
    n, d = x.shape
    for name, (t, dim) in {"x": (x, None), **vectors}.items():
        shape = (n, d) if dim is None else ({"n": n, "d": d}[dim],)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, d


def glm_grad(
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, act: str
) -> torch.Tensor:
    """x (N, D), y (N,), w (D,), mask (N,), all f32, contiguous and on one
    card -> X' (err(X w, y) * mask), (D,) f32."""
    n, d = _check("glm_grad", act, x, y=(y, "n"), w=(w, "d"), mask=(mask, "n"))
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out.zero_()
    lib, fn, tile_rows = _entry()
    partial = torch.empty(
        (-(-n // tile_rows), d), dtype=torch.float32, device=x.device
    )
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), mask.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, d, _ACT_CODES[act],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, err, "glm_grad launch")
    glm_grad.launches += 1
    return out


glm_grad.launches = 0


@functools.cache
def _predict_entry():
    lib = build.load("glm_predict")
    fn = lib.glm_predict
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def glm_predict(
    x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, act: str
) -> torch.Tensor:
    """x (N, D), w (D,), mask (N,), all f32, contiguous and on one card ->
    where(mask > 0, act(X w), 0), (N,) f32."""
    n, d = _check("glm_predict", act, x, w=(w, "d"), mask=(mask, "n"))
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib, fn = _predict_entry()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, d, _ACT_CODES[act],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, err, "glm_predict launch")
    glm_predict.launches += 1
    return out


glm_predict.launches = 0
