"""Port storage layer (repro_torch.db) against repro.db: byte-equal pages,
heap files readable across packages, identical buffer-pool accounting."""
import numpy as np
import pytest

from repro.db import page as jpage
from repro.db.bufferpool import BufferPool as JBufferPool
from repro.db.heap import HeapFile as JHeapFile
from repro.db.heap import write_table as jwrite_table
from repro_torch.db import page as tpage
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.heap import HeapFile, write_table, write_token_table


def _table(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (n, d)).astype(np.float32),
            rng.normal(0, 2, n).astype(np.float32))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page_kb", [8, 16, 32, 128])
def test_build_pages_byte_equal(page_kb, quant):
    feats, labels = _table(700, 13, seed=page_kb)
    lo_t = tpage.PageLayout(n_features=13, page_bytes=page_kb * 1024, quantized=quant)
    lo_j = jpage.PageLayout(n_features=13, page_bytes=page_kb * 1024, quantized=quant)
    got = tpage.build_pages(feats, labels, lo_t)
    want = jpage.build_pages(feats, labels, lo_j)
    assert got.dtype == want.dtype == np.uint32
    assert got.tobytes() == want.tobytes()
    for p in range(got.shape[0]):
        for a, b in zip(tpage.parse_page(got[p], lo_t), jpage.parse_page(want[p], lo_j)):
            np.testing.assert_array_equal(a, b)


def test_heap_files_cross_packages(tmp_path):
    feats, labels = _table(500, 7, seed=1)
    jheap = jwrite_table(str(tmp_path / "j.heap"), feats, labels, page_bytes=8192)
    theap = HeapFile(jheap.path)
    assert theap.n_pages == jheap.n_pages and theap.n_tuples == 500
    assert (theap.layout.n_features, theap.layout.page_bytes, theap.layout.quantized) == (
        jheap.layout.n_features, jheap.layout.page_bytes, jheap.layout.quantized)
    np.testing.assert_array_equal(theap.read_all(), jheap.read_all())
    ids = np.array([2, 0, 1])
    np.testing.assert_array_equal(theap.read_pages(ids), jheap.read_pages(ids))
    # and the reverse direction
    theap2 = write_table(str(tmp_path / "t.heap"), feats, labels, page_bytes=8192,
                         quantized=True)
    jheap2 = JHeapFile(theap2.path)
    np.testing.assert_array_equal(jheap2.read_all(), theap2.read_all())


def test_token_table_keeps_int32_bits(tmp_path):
    seqs = [[5, 9, 1], [2**31 - 1, 0, 7, 3], [1]]
    heap = write_token_table(str(tmp_path / "tok.heap"), seqs, page_bytes=8192)
    feats, labels, _ = tpage.parse_page(heap.read_page(0), heap.layout)
    tokens = feats.view(np.int32)
    for i, s in enumerate(seqs):
        np.testing.assert_array_equal(tokens[i, : len(s)], s)
        assert labels[i] == len(s)


def test_bufferpool_accounting_matches_repro(tmp_path):
    feats, labels = _table(2000, 16, seed=2)
    heap = write_table(str(tmp_path / "p.heap"), feats, labels, page_bytes=8192)
    jheap = JHeapFile(heap.path)
    page_bytes = heap.layout.page_bytes
    tpool = BufferPool(pool_bytes=4 * page_bytes, page_bytes=page_bytes)
    jpool = JBufferPool(pool_bytes=4 * page_bytes, page_bytes=page_bytes)
    for ids in (np.arange(6), np.arange(2), np.array([5, 9, 1]), np.arange(3, 8)):
        np.testing.assert_array_equal(
            tpool.fetch_batch(heap, ids), jpool.fetch_batch(jheap, ids)
        )
        assert (tpool.hits, tpool.misses, tpool.evictions, tpool.resident) == (
            jpool.hits, jpool.misses, jpool.evictions, jpool.resident)
    # background prefetch accounts exactly like the foreground sequence
    bg = BufferPool(pool_bytes=4 * page_bytes, page_bytes=page_bytes)
    jbg = JBufferPool(pool_bytes=4 * page_bytes, page_bytes=page_bytes)
    for ids in (np.arange(6), np.arange(2)):
        np.testing.assert_array_equal(
            bg.prefetch_batch(heap, ids).result(timeout=30),
            jbg.prefetch_batch(jheap, ids).result(timeout=30),
        )
    assert (bg.hits, bg.misses, bg.evictions) == (jbg.hits, jbg.misses, jbg.evictions)
    # a warm pool serves every page without a miss
    warm = BufferPool(pool_bytes=heap.n_pages * page_bytes, page_bytes=page_bytes)
    jwarm = JBufferPool(pool_bytes=heap.n_pages * page_bytes, page_bytes=page_bytes)
    assert warm.warm(heap) == jwarm.warm(jheap) == heap.n_pages
    misses = warm.misses
    warm.fetch_batch(heap, np.arange(heap.n_pages))
    assert warm.misses == misses
