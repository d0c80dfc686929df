"""Heap files: a table is a sequence of fixed-size pages in one file on disk.

Copy of ``repro.db.heap``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.db.page import PageLayout, build_pages


FORMAT_VERSION = 2  # v2: MAXALIGN-unit line pointers, u32 tuple length


class HeapFile:
    """Page-addressable heap file. Pages are read on demand (the buffer pool
    sits on top); ``read_pages`` is the device-handoff granularity."""

    def __init__(self, path: str):
        self.path = path
        with open(path + ".meta") as f:
            meta = json.load(f)
        if meta.get("format", 1) != FORMAT_VERSION:
            raise ValueError(
                f"{path}: heap format v{meta.get('format', 1)} != "
                f"v{FORMAT_VERSION}; rebuild the table"
            )
        self.layout = PageLayout(
            n_features=meta["n_features"],
            page_bytes=meta["page_bytes"],
            quantized=meta["quantized"],
        )
        self.n_tuples = meta["n_tuples"]
        self.n_pages = meta["n_pages"]

    def read_page(self, page_id: int) -> np.ndarray:
        return self.read_pages(np.array([page_id]))[0]

    def read_pages(self, page_ids: np.ndarray) -> np.ndarray:
        """Returns (len(page_ids), page_words) uint32."""
        pw = self.layout.page_words
        out = np.empty((len(page_ids), pw), dtype=np.uint32)
        with open(self.path, "rb") as f:
            for k, pid in enumerate(np.asarray(page_ids)):
                f.seek(int(pid) * self.layout.page_bytes)
                out[k] = np.frombuffer(f.read(self.layout.page_bytes), dtype=np.uint32)
        return out

    def read_all(self) -> np.ndarray:
        data = np.fromfile(self.path, dtype=np.uint32)
        return data.reshape(self.n_pages, self.layout.page_words)


def write_table(
    path: str,
    features: np.ndarray,
    labels: np.ndarray,
    page_bytes: int = 32 * 1024,
    quantized: bool = False,
) -> HeapFile:
    """Materialize a training table as a heap file + sidecar metadata."""
    layout = PageLayout(
        n_features=features.shape[1], page_bytes=page_bytes, quantized=quantized
    )
    pages = build_pages(features, labels, layout)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    pages.tofile(tmp)
    os.replace(tmp, path)
    with open(path + ".meta", "w") as f:
        json.dump(
            {
                "format": FORMAT_VERSION,
                "n_features": layout.n_features,
                "page_bytes": layout.page_bytes,
                "quantized": layout.quantized,
                "n_tuples": int(features.shape[0]),
                "n_pages": int(pages.shape[0]),
            },
            f,
        )
    return HeapFile(path)


def write_token_table(
    path: str,
    seqs: list,
    page_bytes: int = 32 * 1024,
    width: int | None = None,
) -> HeapFile:
    """Materialize token sequences as a heap table the strider can decode.

    Each tuple's feature payload is its int32 token ids stored as raw words
    (float32 view — the strider streams bits, not values), right-padded with
    zeros to ``width``; the label column records the true sequence length.
    This is the table format LM PREDICT queries score from.
    """
    if not seqs:
        raise ValueError("token table needs at least one sequence")
    width = width or max(len(s) for s in seqs)
    if width <= 0:
        raise ValueError("token table width must be positive")
    feats = np.zeros((len(seqs), width), dtype=np.int32)
    for i, s in enumerate(seqs):
        if len(s) > width:
            raise ValueError(f"sequence {i} longer than table width {width}")
        feats[i, : len(s)] = np.asarray(s, dtype=np.int32)
    labels = np.array([len(s) for s in seqs], dtype=np.float32)
    return write_table(
        path, feats.view(np.float32), labels, page_bytes=page_bytes
    )
