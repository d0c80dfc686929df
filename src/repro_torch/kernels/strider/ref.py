"""Plain PyTorch strider page decode, full and projected, held against
``repro.kernels.strider.ref.decode_pages_ref`` and
``decode_pages_projected_ref`` bit for bit.

Pages travel as an int32 view of their u32 words: this torch has no ``>>`` or
``<`` for ``uint32``, and the int32 view is the same bits (an arithmetic
shift followed by ``& 0xFF`` yields the same byte). f32 payload words stay
integers until the final ``view``, and dead slots are zeroed by a select on
the integers, so denormal-encoded tokens keep their bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.striders import ProjectionPlan
from repro_torch.db.page import TUPLE_HEADER_BYTES, PageLayout


def decode_pages_ref(
    pages: torch.Tensor, layout: PageLayout
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pages (P, page_words) int32 -> (feats (P,T,D) f32, labels (P,T) f32,
    mask (P,T) f32)."""
    p = pages.shape[0]
    t = layout.tuples_per_page
    stride_w = layout.stride // 4
    hdr_w = TUPLE_HEADER_BYTES // 4
    payload_w = layout.payload_bytes // 4
    region_start_w = (layout.data_end - t * layout.stride) // 4

    n_tuples = pages[:, 4]  # header word 4
    region = pages[:, region_start_w : region_start_w + t * stride_w]
    # ascending addresses hold slots T-1..0 (downward packing) -> reverse
    tup = region.reshape(p, t, stride_w).flip(1)
    live = torch.arange(t, device=pages.device)[None, :] < n_tuples[:, None]

    payload = tup[:, :, hdr_w : hdr_w + payload_w]
    if layout.quantized:
        shifts = torch.arange(4, dtype=torch.int32, device=pages.device) * 8
        raw = ((payload[..., None] >> shifts) & 0xFF).reshape(p, t, payload_w * 4)
        raw = raw[:, :, : layout.n_features]
        scale = pages[:, layout.data_end // 4].view(torch.float32)
        feats = (raw - 128).to(torch.float32) * scale[:, None, None]
        feats = torch.where(live[:, :, None], feats, 0.0)
    else:
        words = payload[:, :, : layout.n_features]
        feats = torch.where(live[:, :, None], words, 0).view(torch.float32)

    labels = torch.where(live, tup[:, :, hdr_w + payload_w], 0).view(torch.float32)
    mask = live.to(torch.float32)
    return feats.contiguous(), labels.contiguous(), mask


def _take(x: torch.Tensor, positions) -> torch.Tensor:
    """``x[..., positions]`` as a concatenation of the positions' contiguous
    runs (the Pallas kernel's ``_word_runs``): slices need no index tensor,
    so the plain version makes no host-to-device copy on the card."""
    runs: list[list[int]] = []
    for p in positions:
        if runs and runs[-1][1] == p:
            runs[-1][1] = p + 1
        else:
            runs.append([p, p + 1])
    if not runs:
        return x[..., :0]
    return torch.cat([x[..., a:b] for a, b in runs], dim=-1)


def decode_pages_projected_ref(
    pages: torch.Tensor, layout: PageLayout, plan: ProjectionPlan
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pushdown decode: only ``plan``'s payload words leave the page.

    pages (P, page_words) int32 -> (feats (P,T,n_columns) f32 in
    ``plan.columns`` order, labels (P,T) f32 (zeros when the plan drops the
    label), mask (P,T) f32). Same slot walk as the full decode."""
    p = pages.shape[0]
    t = layout.tuples_per_page
    stride_w = layout.stride // 4
    hdr_w = TUPLE_HEADER_BYTES // 4
    payload_w = layout.payload_bytes // 4
    region_start_w = (layout.data_end - t * layout.stride) // 4

    n_tuples = pages[:, 4]
    region = pages[:, region_start_w : region_start_w + t * stride_w]
    tup = region.reshape(p, t, stride_w).flip(1)
    live = torch.arange(t, device=pages.device)[None, :] < n_tuples[:, None]

    sel = _take(tup, [hdr_w + w for w in plan.words])  # (P, T, n_words)
    if layout.quantized:
        shifts = torch.arange(4, dtype=torch.int32, device=pages.device) * 8
        raw = ((sel[..., None] >> shifts) & 0xFF).reshape(p, t, len(plan.words) * 4)
        raw = _take(raw, plan.column_byte_positions())
        scale = pages[:, layout.data_end // 4].view(torch.float32)
        feats = (raw - 128).to(torch.float32) * scale[:, None, None]
        feats = torch.where(live[:, :, None], feats, 0.0)
    else:
        feats = torch.where(live[:, :, None], sel, 0).view(torch.float32)

    if plan.include_label:
        labels = torch.where(live, tup[:, :, hdr_w + payload_w], 0).view(torch.float32)
    else:
        labels = torch.zeros((p, t), dtype=torch.float32, device=pages.device)
    mask = live.to(torch.float32)
    return feats.contiguous(), labels.contiguous(), mask
