"""Data pipelines, including the paper's technique applied to LM training
(counterpart of ``repro.data.pipeline``, which it is held against).

``PageTokenDataset`` packs token sequences into the SAME 32 KB slotted-page
format the RDBMS uses (tokens as int32 'features'), and the training input
pipeline decodes pages on the device with the strider kernel B1 — the
storage-format boundary lives on the accelerator, exactly DAnA's thesis
(``--data-path=pages`` in launch/train.py).

Tokens cross as bits. Pages travel as an int32 view of their u32 words, B1
decodes them into f32 tensors whose words are the tokens' bits, and the batch
reads them back with ``.view(torch.int32)``. A token below 2**23 is an f32
denormal, so every step between B1 and the embedding is a bit copy (``view``,
``index_select``, slicing): a float multiply or a mask would flush or change
it. Host-to-card copies go through pinned memory without blocking, so a
batch reads nothing back and waits for nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.data.synthetic import lm_token_batch
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.heap import write_table
from repro_torch.kernels.strider import ops as strider_ops


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: through pinned memory and a copy that
    does not block the host when ``device`` is a card (the caching host
    allocator keeps the pinned block until the copy has run)."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class PageTokenDataset:
    """Token sequences stored as DB pages; decoded on the device per batch.

    The batch pipeline is double-buffered: ``batch(step)`` consumes the pages
    the previous call prefetched on the pool's background thread and enqueues
    the fetch for ``step+1``, so page I/O for the next batch overlaps the
    caller's train step — the solver's pipelined executor applied to the LM
    data path. Batches address *tuple* space (``step * batch_size`` onward,
    modulo ``n_tuples``), so wraparound past the heap end and a partial last
    page never surface dead slots as sequences. ``device=None`` means the
    card."""

    def __init__(self, path: str, n_seqs: int, seq_len: int, vocab: int,
                 seed: int = 0, page_bytes: int = 32 * 1024, device=None):
        self.device = resolve_device(device)
        rows = []
        labels = np.zeros(n_seqs, np.float32)
        for i in range(n_seqs):
            b = lm_token_batch(seed * 131 + i, 1, seq_len, vocab)
            # pack tokens+targets as the tuple's feature payload (int32 bits
            # stored via float32 view — the strider decodes raw words)
            row = np.concatenate([b["tokens"][0], b["targets"][0]]).astype(np.int32)
            rows.append(row.view(np.float32))
        feats = np.stack(rows)
        self.seq_len = seq_len
        self.heap = write_table(path, feats, labels, page_bytes=page_bytes)
        self.pool = BufferPool(pool_bytes=64 * page_bytes, page_bytes=page_bytes)
        self._pending = None  # (page-id key, PrefetchHandle) for the next step

    def _batch_pages(self, step: int, batch_size: int):
        """Deterministic (step -> pages) addressing: the tuple ids a batch
        covers and the sorted unique pages that hold them."""
        tpp = self.heap.layout.tuples_per_page
        n = self.heap.n_tuples
        start = (step * batch_size) % n
        tuple_ids = (start + np.arange(batch_size)) % n
        page_ids = np.unique(tuple_ids // tpp)
        return page_ids, tuple_ids

    def batch(self, step: int, batch_size: int):
        """Decode a batch of sequences from pages on the device (B1)."""
        page_ids, tuple_ids = self._batch_pages(step, batch_size)
        key = tuple(page_ids.tolist())
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] == key:
            pages = pending[1].result()
        else:
            if pending is not None and not pending[1].cancel():
                pending[1].result()  # non-sequential access: drain, refetch
            pages = self.pool.fetch_batch(self.heap, page_ids)
        nxt_pages, _ = self._batch_pages(step + 1, batch_size)
        self._pending = (
            tuple(nxt_pages.tolist()),
            self.pool.prefetch_batch(self.heap, nxt_pages),
        )

        feats, _, _ = strider_ops.decode_pages(
            _upload(strider_ops.pages_tensor(pages), self.device), self.heap.layout)
        tpp = self.heap.layout.tuples_per_page
        flat = feats.view(torch.int32).reshape(-1, self.heap.layout.n_features)
        # global tuple id -> row within the fetched (sorted) pages
        pos = np.searchsorted(page_ids, tuple_ids // tpp) * tpp + tuple_ids % tpp
        words = flat.index_select(0, _upload(torch.from_numpy(pos), self.device))
        s = self.seq_len
        return {
            "tokens": words[:, :s],
            "targets": words[:, s : 2 * s],
            "loss_mask": torch.ones((batch_size, s), dtype=torch.float32,
                                    device=self.device),
        }


def synthetic_data_fn(cfg, batch: int, seq: int, shard: int = 0, device=None):
    """Deterministic (step, shard)-keyed batch function for the train loop,
    on ``device`` (``None``: the card), the reference's numbers: a VLM's
    text cut to ``seq - vis_tokens`` beside f32 ``patches`` (batch,
    vis_tokens, d_model) from ``default_rng(step)``; an enc-dec model's f32
    ``frames`` (batch, seq, d_model) from ``default_rng(step + 7)``."""
    device = resolve_device(device)

    def normal(seed, shape):
        draw = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
        return _upload(torch.from_numpy(draw), device)

    def fn(step: int):
        b = lm_token_batch(step, batch, seq, cfg.vocab_size, shard)
        if cfg.vis_tokens:
            b = {k: v[:, :seq - cfg.vis_tokens] for k, v in b.items()}
        out = {k: _upload(torch.from_numpy(np.ascontiguousarray(v)), device)
               for k, v in b.items()}
        if cfg.vis_tokens:
            out["patches"] = normal(step, (batch, cfg.vis_tokens, cfg.d_model))
        if cfg.family == "encdec":
            out["frames"] = normal(step + 7, (batch, seq, cfg.d_model))
        return out

    return fn
