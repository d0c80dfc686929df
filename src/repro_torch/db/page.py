"""PostgreSQL-like slotted page format.

Layout of a page (all fields 4-byte aligned, little-endian):

    +--------------------------------------------------------------+
    | page header (32 B = 8 u32 words)                             |
    |   w0 magic  w1 page_size  w2 lower  w3 upper                 |
    |   w4 n_tuples  w5 special_off  w6 flags  w7 reserved         |
    +--------------------------------------------------------------+
    | line pointers (4 B each):                                    |
    |   (offset_in_MAXALIGN_units << 16) | (alloc_len_in_units)      |
    +--------------------------------------------------------------+
    | ... free space ...                                           |
    +--------------------------------------------------------------+
    | tuple data, packed DOWNWARD from (page_size - special);      |
    | slot i lives at  page_size - special - (i+1) * stride        |
    |   tuple header (8 B): w0 = t_len (u32, exact bytes)          |
    |                       w1 = row id                            |
    |   payload: n_features * f32  (or int8-quantized, word-padded)|
    |   label: f32                                                 |
    +--------------------------------------------------------------+
    | special space (16 B): quant scale f32, reserved              |
    +--------------------------------------------------------------+

This mirrors the page organization DAnA's Striders are programmed against
(page header -> tuple pointers -> tuple headers -> raw training data), with
PostgreSQL's downward tuple packing and MAXALIGN-8 tuple strides. Line
pointers address in MAXALIGN units so pages up to 512 KB (wide LRMF tuples)
stay within the 16-bit pointer fields; the Strider program rescales with a
single `mul` (core/striders.py).

Copy of ``repro.db.page``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAGIC = 0xDA7ABA5E
HEADER_BYTES = 32
LINE_PTR_BYTES = 4
TUPLE_HEADER_BYTES = 8
SPECIAL_BYTES = 16
MAXALIGN = 8

FLAG_QUANTIZED = 0x1


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Static geometry of a table's pages; the compiler's source of truth."""

    n_features: int
    page_bytes: int = 32 * 1024
    quantized: bool = False  # int8 feature payloads + scale in special space

    # -- derived geometry ---------------------------------------------------
    @property
    def payload_bytes(self) -> int:
        if self.quantized:
            return ((self.n_features + 3) // 4) * 4  # int8, word-padded
        return self.n_features * 4

    @property
    def tuple_len(self) -> int:
        return TUPLE_HEADER_BYTES + self.payload_bytes + 4  # + f32 label

    @property
    def stride(self) -> int:
        return ((self.tuple_len + MAXALIGN - 1) // MAXALIGN) * MAXALIGN

    @property
    def tuples_per_page(self) -> int:
        usable = self.page_bytes - HEADER_BYTES - SPECIAL_BYTES
        t = usable // (self.stride + LINE_PTR_BYTES)
        if t < 1:
            raise ValueError(
                f"tuple of {self.tuple_len} B does not fit a {self.page_bytes} B page"
            )
        return t

    @property
    def page_words(self) -> int:
        return self.page_bytes // 4

    @property
    def data_end(self) -> int:
        """Byte offset one past the tuple data region (== start of special)."""
        return self.page_bytes - SPECIAL_BYTES

    def slot_offset(self, i: int) -> int:
        """Byte offset of tuple slot ``i`` (downward packing)."""
        return self.data_end - (i + 1) * self.stride

    def n_pages(self, n_tuples: int) -> int:
        return -(-n_tuples // self.tuples_per_page)


def _quantize(features: np.ndarray) -> tuple[np.ndarray, float]:
    scale = float(np.max(np.abs(features))) / 127.0 or 1.0
    q = np.clip(np.round(features / scale), -127, 127).astype(np.int16)
    return (q + 128).astype(np.uint8), scale


def build_pages(
    features: np.ndarray, labels: np.ndarray, layout: PageLayout
) -> np.ndarray:
    """Pack (N, D) float32 features + (N,) float32 labels into pages.

    Returns a ``(n_pages, page_words) uint32`` array — the exact bytes a heap
    file stores and the Strider kernel decodes. Fully vectorized.
    """
    features = np.ascontiguousarray(features, dtype=np.float32)
    labels = np.ascontiguousarray(labels, dtype=np.float32).reshape(-1)
    n, d = features.shape
    if d != layout.n_features:
        raise ValueError(f"feature width {d} != layout {layout.n_features}")
    if labels.shape[0] != n:
        raise ValueError("features/labels length mismatch")

    tpp = layout.tuples_per_page
    n_pages = layout.n_pages(n)
    stride = layout.stride

    scale = 1.0
    if layout.quantized:
        payload, scale = _quantize(features)
        pad = layout.payload_bytes - d
        if pad:
            payload = np.pad(payload, ((0, 0), (0, pad)))
    else:
        payload = features.view(np.uint8).reshape(n, d * 4)

    # --- all tuples as (N, stride) bytes -----------------------------------
    tup = np.zeros((n, stride), dtype=np.uint8)
    hdr = tup[:, :TUPLE_HEADER_BYTES].view(np.uint32)
    hdr[:, 0] = layout.tuple_len  # exact byte length (u32: wide LRMF tuples)
    hdr[:, 1] = np.arange(n, dtype=np.uint32)  # row id
    tup[:, TUPLE_HEADER_BYTES : TUPLE_HEADER_BYTES + payload.shape[1]] = payload
    lab_off = TUPLE_HEADER_BYTES + layout.payload_bytes
    tup[:, lab_off : lab_off + 4] = labels.view(np.uint8).reshape(n, 4)

    # pad to whole pages, reshape, and reverse slots (downward packing means
    # ascending byte offsets hold slots T-1 ... 0)
    total = n_pages * tpp
    if total != n:
        tup = np.pad(tup, ((0, total - n), (0, 0)))
    region = tup.reshape(n_pages, tpp, stride)[:, ::-1, :].reshape(n_pages, -1)

    # --- page skeletons -----------------------------------------------------
    pages = np.zeros((n_pages, layout.page_bytes), dtype=np.uint8)
    words = pages.view(np.uint32).reshape(n_pages, layout.page_words)

    counts = np.full(n_pages, tpp, dtype=np.uint32)
    if n % tpp:
        counts[-1] = n % tpp

    words[:, 0] = MAGIC
    words[:, 1] = layout.page_bytes
    words[:, 2] = HEADER_BYTES + counts * LINE_PTR_BYTES  # lower
    words[:, 3] = layout.data_end - counts * stride  # upper
    words[:, 4] = counts
    words[:, 5] = layout.data_end  # special offset
    words[:, 6] = FLAG_QUANTIZED if layout.quantized else 0

    # line pointers (MAXALIGN units): word i = (off_units << 16) | len_units
    slots = np.arange(tpp, dtype=np.uint32)
    offs = ((layout.data_end - (slots + 1) * stride) // MAXALIGN).astype(np.uint32)
    lp = ((offs << 16) | (stride // MAXALIGN)).astype(np.uint32)
    lp_region = np.broadcast_to(lp, (n_pages, tpp)).copy()
    lp_region[slots[None, :] >= counts[:, None]] = 0
    lpw = HEADER_BYTES // 4
    words[:, lpw : lpw + tpp] = lp_region

    # special space: quant scale
    sw = layout.data_end // 4
    words[:, sw] = np.float32(scale).view(np.uint32)

    # tuple data region (vectorized scatter: all pages share the region start
    # of a FULL page; partially-filled last page has its live slots at the
    # high end of the region, which the reversed layout already guarantees)
    region_start = layout.data_end - tpp * stride
    pages[:, region_start : layout.data_end] = region
    return words


def page_header(page_words: np.ndarray) -> dict:
    w = np.asarray(page_words).reshape(-1)
    return {
        "magic": int(w[0]),
        "page_size": int(w[1]),
        "lower": int(w[2]),
        "upper": int(w[3]),
        "n_tuples": int(w[4]),
        "special": int(w[5]),
        "flags": int(w[6]),
    }


def parse_page(
    page_words: np.ndarray, layout: PageLayout
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Honest per-tuple parse following line pointers (oracle for tests and the
    baseline's tuple-at-a-time path). Returns (features, labels, row_ids)."""
    w = np.asarray(page_words, dtype=np.uint32).reshape(-1)
    b = w.view(np.uint8)
    hdr = page_header(w)
    if hdr["magic"] != MAGIC:
        raise ValueError("bad page magic")
    n = hdr["n_tuples"]
    scale = b[hdr["special"] : hdr["special"] + 4].view(np.float32)[0]

    feats = np.empty((n, layout.n_features), dtype=np.float32)
    labs = np.empty(n, dtype=np.float32)
    rids = np.empty(n, dtype=np.uint32)
    for i in range(n):
        lp = w[HEADER_BYTES // 4 + i]
        off = int(lp >> 16) * MAXALIGN
        alloc = int(lp & 0xFFFF) * MAXALIGN
        th = b[off : off + TUPLE_HEADER_BYTES].view(np.uint32)
        assert int(th[0]) == layout.tuple_len and alloc == layout.stride
        rids[i] = th[1]
        payload = b[off + TUPLE_HEADER_BYTES : off + TUPLE_HEADER_BYTES + layout.payload_bytes]
        if layout.quantized:
            q = payload[: layout.n_features].astype(np.int32) - 128
            feats[i] = q.astype(np.float32) * scale
        else:
            feats[i] = payload.view(np.float32)[: layout.n_features]
        lo = off + TUPLE_HEADER_BYTES + layout.payload_bytes
        labs[i] = b[lo : lo + 4].view(np.float32)[0]
    return feats, labs, rids
