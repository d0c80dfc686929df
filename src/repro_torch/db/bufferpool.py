"""Buffer pool: fixed-size frame cache over heap files with LRU replacement.

The pool is the RDBMS side of DAnA's data handoff: queries fill frames, and
``fetch_batch`` hands *whole pages* (a batched uint32 array) to the accelerator
— page-granular transfer, exactly the paper's amortization argument.

``prefetch_batch`` is the pipelined variant: it runs the same fetch on a
single background thread and returns a :class:`PrefetchHandle`, so the
solver's double-buffered loop can overlap page I/O for chunk k+1 with device
compute on chunk k (the paper's Striders overlapping page access with the
execution engine). All pool state is lock-protected; hit/miss/eviction
accounting is identical whether a fetch ran in the foreground or background.

Copy of ``repro.db.bufferpool``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from repro_torch.db.heap import HeapFile


class PrefetchHandle:
    """Handle to an in-flight background page fetch.

    ``result()`` joins the fetch and returns the ``(n, page_words)`` uint32
    batch; ``fetch_s`` (valid once done) is the wall time the fetch itself
    took, which callers compare against their blocked time to split I/O into
    overlapped vs exposed seconds.
    """

    def __init__(self, page_ids: np.ndarray):
        self.page_ids = page_ids
        self.fetch_s = 0.0  # filled in by the worker when the fetch completes
        self._future: Future = Future()

    def done(self) -> bool:
        return self._future.done()

    def cancel(self) -> bool:
        """Best-effort cancel; returns True only if the fetch never started."""
        return self._future.cancel()

    def result(self, timeout: float | None = None) -> np.ndarray:
        return self._future.result(timeout)


class BufferPool:
    def __init__(self, pool_bytes: int = 8 * 1024 * 1024, page_bytes: int = 32 * 1024):
        """``pool_bytes`` is the pool's total frame budget in BYTES; capacity
        in pages is ``pool_bytes // page_bytes`` (floor, min 1 frame). The
        default is 8 MB = 256 frames of 32 KB pages. Callers sizing by page
        count should pass ``pool_bytes=n_pages * page_bytes``."""
        self.page_bytes = page_bytes
        self.capacity = max(1, pool_bytes // page_bytes)
        self._frames: OrderedDict[tuple[str, int], np.ndarray] = OrderedDict()
        self._pins: dict[tuple[str, int], int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.RLock()
        self._prefetcher: ThreadPoolExecutor | None = None

    # -- core API ------------------------------------------------------------
    def get_page(self, heap: HeapFile, page_id: int, pin: bool = False) -> np.ndarray:
        with self._lock:
            key = (heap.path, page_id)
            frame = self._frames.get(key)
            if frame is not None:
                self.hits += 1
                self._frames.move_to_end(key)
            else:
                self.misses += 1
                frame = heap.read_page(page_id)
                self._insert(key, frame)
            if pin:
                self._pins[key] = self._pins.get(key, 0) + 1
            return frame

    def unpin(self, heap: HeapFile, page_id: int) -> None:
        with self._lock:
            key = (heap.path, page_id)
            if key in self._pins:
                self._pins[key] -= 1
                if self._pins[key] <= 0:
                    del self._pins[key]

    def fetch_batch(self, heap: HeapFile, page_ids: np.ndarray) -> np.ndarray:
        """Batched page fetch -> (n, page_words) uint32, ready for the device.

        Misses are read from disk in one pass; all requested pages end up
        resident (subject to capacity). The lock covers only hit/miss
        classification and frame insertion — the disk read itself runs
        unlocked, so a foreground fetch is never stalled behind a large
        background prefetch's I/O (a racing fetch of the same page at worst
        reads it twice — both reads return identical bytes and both count as
        misses; frames stay consistent)."""
        page_ids = np.asarray(page_ids)
        out = np.empty((len(page_ids), heap.layout.page_words), dtype=np.uint32)
        miss_pos, miss_ids = [], []
        with self._lock:
            for k, pid in enumerate(page_ids):
                key = (heap.path, int(pid))
                frame = self._frames.get(key)
                if frame is not None:
                    self.hits += 1
                    self._frames.move_to_end(key)
                    out[k] = frame
                else:
                    self.misses += 1
                    miss_pos.append(k)
                    miss_ids.append(int(pid))
        if miss_ids:
            fetched = heap.read_pages(np.array(miss_ids))
            with self._lock:
                for k, pid, frame in zip(miss_pos, miss_ids, fetched):
                    out[k] = frame
                    self._insert((heap.path, pid), frame.copy())
        return out

    def prefetch_batch(self, heap: HeapFile, page_ids: np.ndarray) -> PrefetchHandle:
        """Start ``fetch_batch`` on the pool's background thread and return a
        handle immediately. One worker serializes prefetches, so LRU order and
        hit/miss/eviction counters evolve exactly as the equivalent foreground
        fetch sequence would."""
        page_ids = np.asarray(page_ids)
        handle = PrefetchHandle(page_ids)

        def work():
            if not handle._future.set_running_or_notify_cancel():
                return
            try:
                t0 = time.perf_counter()
                pages = self.fetch_batch(heap, page_ids)
                handle.fetch_s = time.perf_counter() - t0
                handle._future.set_result(pages)
            except BaseException as e:  # surfaced to the caller at result()
                handle._future.set_exception(e)

        self._executor().submit(work)
        return handle

    def warm(self, heap: HeapFile) -> int:
        """Preload as much of the heap as fits (the paper's warm-cache setup).
        Returns the number of resident pages of this heap."""
        n = min(heap.n_pages, self.capacity)
        ids = np.arange(heap.n_pages - n, heap.n_pages)  # keep the tail, like a scan would
        self.fetch_batch(heap, ids)
        return n

    def clear(self) -> None:
        """Cold-cache setup."""
        with self._lock:
            self._frames.clear()
            self._pins.clear()

    @property
    def resident(self) -> int:
        return len(self._frames)

    # -- internals -----------------------------------------------------------
    def _executor(self) -> ThreadPoolExecutor:
        if self._prefetcher is None:
            with self._lock:
                if self._prefetcher is None:
                    self._prefetcher = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="bufferpool-prefetch"
                    )
        return self._prefetcher

    def _insert(self, key, frame) -> None:
        if key in self._frames:  # same-key overwrite doesn't grow the pool
            self._frames[key] = frame
            self._frames.move_to_end(key)
            return
        while len(self._frames) >= self.capacity:
            evicted = False
            for victim in self._frames:
                if victim not in self._pins:
                    del self._frames[victim]
                    self.evictions += 1
                    evicted = True
                    break
            if not evicted:
                raise RuntimeError("buffer pool exhausted: all frames pinned")
        self._frames[key] = frame
