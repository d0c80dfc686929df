"""Bindings of the Hopper strider decode kernels: the full decode
(``csrc/strider_decode.cu``, B1) and the projected decode
(``csrc/strider_decode_projected.cu``, B3).

They replace ``repro.kernels.strider.strider.strider_decode`` without and
with a ``plan`` (the Pallas ``_strider_kernel`` and
``_strider_kernel_projected``). Each library is built at first use; a
wrapper checks its inputs, allocates the outputs with ``torch.empty``,
launches on the current stream and never synchronises. Each wrapper's
``launches`` attribute counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.striders import ProjectionPlan
from repro_torch.db.page import PageLayout
from repro_torch.kernels import build

# output words a block aims to write: enough to keep 256 threads busy over
# a few iterations, small enough that a page splits over several blocks
_WORDS_PER_BLOCK = 2048


@functools.cache
def _entry():
    lib = build.load("strider_decode")
    fn = lib.strider_decode
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_pages(pages: torch.Tensor, layout: PageLayout, what: str) -> None:
    if pages.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {pages.device}")
    if pages.dtype != torch.int32:
        raise TypeError(f"pages must be an int32 view of the u32 words, got {pages.dtype}")
    if pages.dim() != 2 or pages.shape[1] != layout.page_words:
        raise ValueError(
            f"pages shape {tuple(pages.shape)} != (P, {layout.page_words})"
        )
    if not pages.is_contiguous():
        raise ValueError("pages must be contiguous")


def strider_decode(
    pages: torch.Tensor, layout: PageLayout
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pages (P, page_words) int32 on the card -> (feats (P,T,D), labels
    (P,T), mask (P,T)), all f32 on the same card."""
    _check_pages(pages, layout, "strider_decode")
    p, t, d = pages.shape[0], layout.tuples_per_page, layout.n_features
    feats = torch.empty((p, t, d), dtype=torch.float32, device=pages.device)
    labels = torch.empty((p, t), dtype=torch.float32, device=pages.device)
    mask = torch.empty((p, t), dtype=torch.float32, device=pages.device)
    if p == 0:
        return feats, labels, mask
    lib, fn = _entry()
    with torch.cuda.device(pages.device):
        err = fn(
            pages.data_ptr(), feats.data_ptr(), labels.data_ptr(), mask.data_ptr(),
            p, layout.page_words, t, d,
            layout.stride // 4,
            layout.payload_bytes // 4,
            (layout.data_end - t * layout.stride) // 4,
            layout.data_end // 4,
            int(layout.quantized),
            max(1, min(t, _WORDS_PER_BLOCK // d)),
            torch.cuda.current_stream(pages.device).cuda_stream,
        )
    build.check(lib, err, "strider_decode launch")
    strider_decode.launches += 1
    return feats, labels, mask


strider_decode.launches = 0


@functools.cache
def _projected_entry():
    lib = build.load("strider_decode_projected")
    fn = lib.strider_decode_projected
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def plan_sources(plan: ProjectionPlan) -> list[int]:
    """The kernel's plan table: per output column, its payload word (f32
    pages) or payload byte (int8 pages). Either is the column's index: an f32
    column is one payload word, an int8 column one payload byte."""
    return list(plan.columns)


def strider_decode_projected(
    pages: torch.Tensor, layout: PageLayout, plan: ProjectionPlan,
    src: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pages (P, page_words) int32 on the card -> (feats (P,T,C) in
    ``plan.columns`` order, labels (P,T), zeros unless the plan keeps the
    label, mask (P,T)), all f32 on the same card. ``src`` is the plan table
    (``plan_sources``) as an int32 tensor on the card; a caller that decodes
    many chunks with one plan builds it once."""
    _check_pages(pages, layout, "strider_decode_projected")
    if plan.layout != layout:
        raise ValueError("the plan was built for another page layout")
    p, t, c = pages.shape[0], layout.tuples_per_page, plan.n_columns
    if src is None:
        src = torch.tensor(plan_sources(plan), dtype=torch.int32).to(pages.device)
    if src.dtype != torch.int32 or tuple(src.shape) != (c,) or src.device != pages.device:
        raise ValueError(f"src must be ({c},) int32 on {pages.device}")
    feats = torch.empty((p, t, c), dtype=torch.float32, device=pages.device)
    labels = torch.empty((p, t), dtype=torch.float32, device=pages.device)
    mask = torch.empty((p, t), dtype=torch.float32, device=pages.device)
    if p == 0:
        return feats, labels, mask
    lib, fn = _projected_entry()
    with torch.cuda.device(pages.device):
        err = fn(
            pages.data_ptr(), src.data_ptr(), feats.data_ptr(), labels.data_ptr(),
            mask.data_ptr(),
            p, layout.page_words, t, c,
            layout.stride // 4,
            layout.payload_bytes // 4,
            (layout.data_end - t * layout.stride) // 4,
            layout.data_end // 4,
            int(layout.quantized),
            int(plan.include_label),
            max(1, min(t, _WORDS_PER_BLOCK // max(c, 1))),
            torch.cuda.current_stream(pages.device).cuda_stream,
        )
    build.check(lib, err, "strider_decode_projected launch")
    strider_decode_projected.launches += 1
    return feats, labels, mask


strider_decode_projected.launches = 0
