"""Binding of the Hopper strider decode kernel (``csrc/strider_decode.cu``).

Replaces ``repro.kernels.strider.strider.strider_decode`` (the Pallas
``_strider_kernel``). The library is built at first use; the wrapper checks
its inputs, allocates the outputs with ``torch.empty``, launches on the
current stream and never synchronises. ``strider_decode.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

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


def strider_decode(
    pages: torch.Tensor, layout: PageLayout
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pages (P, page_words) int32 on the card -> (feats (P,T,D), labels
    (P,T), mask (P,T)), all f32 on the same card."""
    if pages.device.type != "cuda":
        raise ValueError(f"strider_decode needs a CUDA tensor, got {pages.device}")
    if pages.dtype != torch.int32:
        raise TypeError(f"pages must be an int32 view of the u32 words, got {pages.dtype}")
    if pages.dim() != 2 or pages.shape[1] != layout.page_words:
        raise ValueError(
            f"pages shape {tuple(pages.shape)} != (P, {layout.page_words})"
        )
    if not pages.is_contiguous():
        raise ValueError("pages must be contiguous")
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
