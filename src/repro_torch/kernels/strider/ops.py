"""Public strider decode, full and projected: the plain version for a CPU
tensor, the Hopper kernel for a CUDA tensor (counterpart of
``repro.kernels.strider.ops``).

The JAX wrapper's ``use_kernel=`` has no counterpart: the tensor's device
picks the kernel or the plain version. There is no fallback: a CUDA tensor
either launches the kernel or raises. The TPU's VMEM check has no
counterpart, since neither kernel holds a whole page on chip.

On a mesh (``decode_page_range``) each rank's Strider decodes the page range
that ``PAGE_AXES`` gives it, and the ranks make the decoded chunk whole by
broadcasts, so that each can take its slice of every merge batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.striders import ProjectionPlan
from repro_torch.db.page import PageLayout
from repro_torch.dist import meshes
from repro_torch.kernels.strider import kernel, ref

# logical axes of the raw page stream and its decoded tensors: pages spread
# over the mesh's data axes (each rank's Strider decodes a local page
# range); tuple-in-page and feature dims resolve per the active rule table
PAGE_AXES = ("heap_pages", None)
DECODED_AXES = {
    "feats": ("heap_pages", None, "features"),
    "labels": ("heap_pages", None),
    "mask": ("heap_pages", None),
}


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


def decode_page_range(
    pages: np.ndarray, layout: PageLayout, mesh, stage, rules: dict | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode of a chunk on a mesh: ``pages`` (P, page_words) u32 on the
    host; ``stage`` carries an array of pages to the rank's device (an int32
    tensor there). ``PAGE_AXES`` resolves the page dim against ``mesh``
    (tensor name ``engine_pages``). Where it shards, this rank stages and
    decodes only its own page range, and the ranks of its group over those
    axes broadcast their decoded ranges in turn (one broadcast a rank, the
    features, labels and mask packed together), so every rank returns the
    whole chunk's (feats (P,T,D), labels (P,T), mask (P,T)) with the
    decode's bits. Where the page count does not divide the axes (a
    fallback is recorded), every rank decodes the whole chunk."""
    spec = meshes.resolve_spec(PAGE_AXES, pages.shape, mesh, rules=rules,
                               tensor_name="engine_pages")
    axes = meshes.entry_axes(spec[0])
    if not axes:
        return decode_pages(stage(pages), layout)
    start, stop = meshes.shard_range(pages.shape[0], mesh, axes)
    feats, labels, mask = decode_pages(stage(pages[start:stop]), layout)
    p, t, d = feats.shape
    whole = torch.empty((pages.shape[0], t, d + 2), dtype=torch.float32, device=feats.device)
    group = meshes.axis_group(mesh, axes)
    for i, src in enumerate(meshes.axis_ranks(mesh, axes)):
        part = whole[i * p:(i + 1) * p]
        if i * p == start:
            torch.cat([feats, labels[..., None], mask[..., None]], dim=-1, out=part)
        meshes.broadcast(part, src=src, group=group)
    return whole[..., :d], whole[..., d], whole[..., d + 1]
