"""Public strider decode, full and projected: the plain version for a CPU
tensor, the Hopper kernel for a CUDA tensor (counterpart of
``repro.kernels.strider.ops``).

The JAX wrapper's ``use_kernel=`` has no counterpart: the tensor's device
picks the kernel or the plain version. There is no fallback: a CUDA tensor
either launches the kernel or raises. The TPU's VMEM check has no
counterpart, since neither kernel holds a whole page on chip.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.striders import ProjectionPlan
from repro_torch.db.page import PageLayout
from repro_torch.kernels.strider import kernel, ref


def pages_tensor(pages: np.ndarray) -> torch.Tensor:
    """(P, page_words) u32 heap pages -> the int32 CPU tensor the decode
    takes, sharing the array's memory (same bits)."""
    pages = np.ascontiguousarray(pages, dtype=np.uint32)
    return torch.from_numpy(pages.view(np.int32))


def decode_pages(
    pages: torch.Tensor, layout: PageLayout
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pages (P, page_words) int32 -> (feats (P,T,D), labels (P,T),
    mask (P,T)) f32 on the pages' device."""
    if pages.device.type == "cpu":
        return ref.decode_pages_ref(pages, layout)
    return kernel.strider_decode(pages, layout)


def decode_pages_projected(
    pages: torch.Tensor, layout: PageLayout, plan: ProjectionPlan,
    src: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pushdown decode: pages (P, page_words) int32 -> (feats (P,T,C) in
    ``plan.columns`` order, labels (P,T), mask (P,T)) f32 on the pages'
    device. ``src`` is the kernel's prebuilt plan table (CUDA only)."""
    if pages.device.type == "cpu":
        return ref.decode_pages_projected_ref(pages, layout, plan)
    return kernel.strider_decode_projected(pages, layout, plan, src)
