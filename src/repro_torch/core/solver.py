"""End-to-end in-database training driver on PyTorch (counterpart of
``repro.core.solver``, which it is held against).

Ties the stack together the way Figure 2 of the paper draws it: the buffer
pool streams pages, the access engine (strider kernel or host path) decodes
tuples, and the execution engine runs the epochs until the terminator fires.

Execution modes (the paper's evaluation axes):
  "dana"            device-side page decode (strider kernel) + threaded engine
  "dana-nostrider"  host-side per-page decode + threaded engine (Fig 11 ablation)
  "madlib"          host-side per-page decode + threaded engine here, as in
                    ``repro``; ``madlib_train`` is the tuple-at-a-time baseline

Executors (``pipelined=``):
  pipelined (default)  double-buffered: while the card trains chunk k, the
      buffer pool's background thread fetches chunk k+1; in "dana" mode the
      decode, batch reshape and epoch loop are queued on the card with no host
      join (``Engine.run_chunk``) and the host joins the card exactly once per
      epoch. I/O that hides under compute is reported as ``overlapped_io_s``;
      only the residue the loop actually blocked on is ``exposed_io_s``.
  synchronous          the paper-figure ablation: fetch -> decode -> sync ->
      batch -> epoch -> sync per chunk, so io_s/decode_s/compute_s add
      instead of overlap.

``train`` and ``train_units`` run on the card unless the caller passes
``device="cpu"``, and raise when there is no card.

``mesh=`` (or an enclosing ``meshes.use_mesh``) turns on the engine's
sharded epoch mode, and ``shard_model=True`` also partitions the model's
feature dim over the mesh's model axis (``Engine.sharded_path``). Every rank
of the mesh calls ``train`` with the same arguments; ``TrainResult.models``
holds the whole arrays on every rank, and ``device_syncs`` counts the
solver's own joins (pipelined: one an epoch), not the collectives' waits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.engine import (
    Engine,
    batches_from_stream as _batches,
    init_models,
    make_engine,
    models_from_numpy,
    resolve_device,
)
from repro_torch.core.hdfg import HDFG
from repro_torch.core.translator import Partition
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.heap import HeapFile
from repro_torch.db.page import parse_page
from repro_torch.dist import meshes
from repro_torch.kernels.strider import ops as strider_ops

MAX_RESIDENT_PAGES = 512  # pages decoded per device chunk (16 MB of 32 KB pages)
MODES = ("dana", "dana-nostrider", "madlib")


@dataclasses.dataclass
class TrainResult:
    """Timing contract: ``total_s`` is wall time. Synchronous executor:
    ``io_s + decode_s + compute_s`` ~= the hot loop (phases add). Pipelined
    executor: ``io_s = exposed_io_s + overlapped_io_s`` is total I/O work;
    only ``exposed_io_s`` contributes to wall time (``overlapped_io_s`` hid
    under device compute), and in "dana" mode ``decode_s`` is 0 because the
    decode is queued with the epoch on the card (counted in ``compute_s``).
    ``device_syncs`` counts hot-loop host↔device joins (pipelined: one per
    epoch)."""

    models: list[np.ndarray]
    epochs_run: int
    converged: bool
    grad_norms: list[float]
    decode_s: float
    compute_s: float
    io_s: float
    total_s: float
    exposed_io_s: float = 0.0
    overlapped_io_s: float = 0.0
    device_syncs: int = 0
    pipelined: bool = False


def _device_sync(models, gnorm):
    """The hot loop's single host↔device join point (tests instrument this):
    reading the epoch's last gradient norm waits for every launch queued
    before it on the stream, the model updates included."""
    return models, float(gnorm)


def _whole(models) -> list[np.ndarray]:
    """The trained models as whole arrays, the same on every rank (a model
    the mesh shards is gathered by broadcasts)."""
    return [meshes.full_tensor(m).cpu().numpy() for m in models]


def _wait(t: torch.Tensor) -> None:
    """Block until the card has produced ``t`` (synchronous executor)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _decode_chunk(pages_np, heap, mode, device):
    layout = heap.layout
    if mode == "dana":
        pages = strider_ops.pages_tensor(pages_np).to(device)
        feats, labels, mask = strider_ops.decode_pages(pages, layout)
        t = feats.shape[0] * feats.shape[1]
        return (
            feats.reshape(t, layout.n_features),
            labels.reshape(t),
            mask.reshape(t),
        )
    # host decode (the "without striders" CPU data-transformation path)
    fs, ls = [], []
    for p in pages_np:
        f, l, _ = parse_page(p, layout)
        fs.append(f)
        ls.append(l)
    feats = torch.from_numpy(np.concatenate(fs)).to(device)
    labels = torch.from_numpy(np.concatenate(ls)).to(device)
    return feats, labels, torch.ones(feats.shape[0], dtype=torch.float32, device=device)


def _setup(g, part, heap, pool, mode, engine, merge_coef, models, seed, device,
           mesh, shard_model):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if engine is not None and shard_model and not engine.shard_model:
        # silently training replicated when the caller asked for a
        # partitioned model would be a lie; the flag belongs to make_engine
        raise ValueError(
            "shard_model=True but the pre-built engine was made without it; "
            "pass make_engine(..., shard_model=True)"
        )
    if engine is None:
        engine = make_engine(g, part, merge_coef=merge_coef, mesh=mesh,
                             shard_model=shard_model, device=device)
    elif device is not None and resolve_device(device) != engine.device:
        raise ValueError(f"device {device} != the engine's {engine.device}")
    pool = pool or BufferPool(
        pool_bytes=MAX_RESIDENT_PAGES * heap.layout.page_bytes,
        page_bytes=heap.layout.page_bytes,
    )
    if models is None:
        models = init_models(
            g, np.random.default_rng(seed), scale=0.01, device=engine.device
        )
    elif all(isinstance(m, torch.Tensor) for m in models):
        models = [m.to(device=engine.device, dtype=torch.float32) for m in models]
    else:
        models = models_from_numpy(models, engine.device)
    page_chunks = [
        np.arange(s, min(s + MAX_RESIDENT_PAGES, heap.n_pages))
        for s in range(0, heap.n_pages, MAX_RESIDENT_PAGES)
    ]
    return engine, pool, models, page_chunks


def train_units(
    g: HDFG,
    part: Partition,
    heap: HeapFile,
    pool: BufferPool | None = None,
    mode: str = "dana",
    engine: Engine | None = None,
    max_epochs: int | None = None,
    merge_coef: int | None = None,
    models=None,
    seed: int = 0,
    device=None,
    mesh=None,
    shard_model: bool = False,
):
    """Generator form of the pipelined executor: yields once per device chunk
    *dispatch* and returns the TrainResult via ``StopIteration.value``.

    The op sequence (prefetch order, chunk order, ONE device sync per epoch,
    convergence checks on the cached first-chunk batch) is exactly
    ``train(pipelined=True)``'s, which drains this generator."""
    t_start = time.perf_counter()
    engine, pool, models, page_chunks = _setup(
        g, part, heap, pool, mode, engine, merge_coef, models, seed, device,
        mesh, shard_model,
    )
    if not page_chunks:
        raise ValueError("train_units needs a non-empty heap (nothing to scan)")

    epochs = max_epochs or g.epochs or 100
    coef = engine.merge_coef
    grad_norms: list[float] = []
    decode_s = compute_s = 0.0
    exposed_io_s = overlapped_io_s = 0.0
    device_syncs = 0
    converged = False
    epochs_run = 0
    conv_cache: dict = {}  # decoded first-chunk convergence batch, per call

    mesh_ctx = meshes.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with mesh_ctx:
        # -- double-buffered executor: fetch k+1 under compute on k ----------
        handle = pool.prefetch_batch(heap, page_chunks[0])
        try:
            for epoch in range(epochs):
                t_epoch = time.perf_counter()
                exposed_epoch = decode_epoch = 0.0
                gnorm_dev = None
                for k, chunk_ids in enumerate(page_chunks):
                    t0 = time.perf_counter()
                    pages_np = handle.result()
                    waited = time.perf_counter() - t0
                    exposed_epoch += waited
                    overlapped_io_s += max(handle.fetch_s - waited, 0.0)
                    # enqueue the next fetch before dispatching compute; the
                    # epoch wrap primes chunk 0 for the next epoch, unless this
                    # is the last one (the convergence check reuses its cached
                    # batch, so it never needs pages)
                    if k + 1 < len(page_chunks) or epoch + 1 < epochs:
                        nxt = page_chunks[(k + 1) % len(page_chunks)]
                        handle = pool.prefetch_batch(heap, nxt)
                    if mode == "dana":
                        # strider decode + batch reshape + epoch loop, queued on
                        # the card with no intermediate join
                        models, gnorms = engine.run_chunk(models, pages_np, heap.layout)
                    else:
                        t1 = time.perf_counter()
                        feats, labels, mask = _decode_chunk(
                            pages_np, heap, mode, engine.device
                        )
                        decode_epoch += time.perf_counter() - t1
                        X, Y, M = _batches(feats, labels, mask, coef)
                        models, gnorms = engine.run_epoch(models, X, Y, M)
                    gnorm_dev = gnorms[-1]
                    yield  # chunk dispatched: the scheduling point
                models, gnorm = _device_sync(models, gnorm_dev)
                device_syncs += 1
                exposed_io_s += exposed_epoch
                decode_s += decode_epoch
                compute_s += time.perf_counter() - t_epoch - exposed_epoch - decode_epoch
                grad_norms.append(gnorm)
                epochs_run = epoch + 1
                if g.convergence_id is not None:
                    if _check_convergence(engine, models, heap, pool, mode, coef, conv_cache):
                        converged = True
                        break
        finally:
            # drain the trailing (speculative) prefetch so the pool is quiescent
            # on return; its outcome can't affect a result already computed, so
            # its error is dropped, and a generator closed early cleans up the
            # same way
            if not handle.cancel():
                try:
                    handle.result()
                except Exception:
                    pass
    return TrainResult(
        models=_whole(models),
        epochs_run=epochs_run,
        converged=converged,
        grad_norms=grad_norms,
        decode_s=decode_s,
        compute_s=compute_s,
        io_s=exposed_io_s + overlapped_io_s,
        total_s=time.perf_counter() - t_start,
        exposed_io_s=exposed_io_s,
        overlapped_io_s=overlapped_io_s,
        device_syncs=device_syncs,
        pipelined=True,
    )


def train(
    g: HDFG,
    part: Partition,
    heap: HeapFile,
    pool: BufferPool | None = None,
    mode: str = "dana",
    engine: Engine | None = None,
    max_epochs: int | None = None,
    merge_coef: int | None = None,
    models=None,
    seed: int = 0,
    pipelined: bool = True,
    device=None,
    mesh=None,
    shard_model: bool = False,
) -> TrainResult:
    """Train the UDF ``(g, part)`` over ``heap``. ``pipelined=True``
    (default) drains the ``train_units`` generator, the double-buffered
    executor; ``pipelined=False`` keeps the fully synchronous per-chunk loop
    (the ablation both tests and benchmarks compare against). ``device=None``
    means the card. ``mesh`` (or an enclosing ``meshes.use_mesh``) turns on
    the engine's sharded epoch mode: the decoded tuple stream is split over
    the mesh's data axes, parallel Striders feeding one merge tree.
    ``shard_model=True`` also partitions the model's feature dim (GLM
    coefficients, LRMF factors) over the mesh's model axis, per the logical
    axes the algorithm declared."""
    if pipelined and heap.n_pages > 0:
        gen = train_units(
            g, part, heap, pool=pool, mode=mode, engine=engine,
            max_epochs=max_epochs, merge_coef=merge_coef, models=models,
            seed=seed, device=device, mesh=mesh, shard_model=shard_model,
        )
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    # -- synchronous executor (phases add; the ablation baseline) ------------
    t_start = time.perf_counter()
    engine, pool, models, page_chunks = _setup(
        g, part, heap, pool, mode, engine, merge_coef, models, seed, device,
        mesh, shard_model,
    )
    epochs = max_epochs or g.epochs or 100
    coef = engine.merge_coef
    grad_norms: list[float] = []
    decode_s = io_s = compute_s = 0.0
    device_syncs = 0
    converged = False
    epochs_run = 0
    conv_cache: dict = {}  # decoded first-chunk convergence batch, per call

    mesh_ctx = meshes.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with mesh_ctx:
        for epoch in range(epochs):
            last_gnorm = None
            for chunk_ids in page_chunks:
                t0 = time.perf_counter()
                pages_np = pool.fetch_batch(heap, chunk_ids)
                t1 = time.perf_counter()
                feats, labels, mask = _decode_chunk(pages_np, heap, mode, engine.device)
                _wait(feats)
                t2 = time.perf_counter()
                X, Y, M = _batches(feats, labels, mask, coef)
                models, gnorms = engine.run_epoch(models, X, Y, M)
                _wait(models[0])
                device_syncs += 2
                t3 = time.perf_counter()
                io_s += t1 - t0
                decode_s += t2 - t1
                compute_s += t3 - t2
                last_gnorm = float(gnorms[-1])
            grad_norms.append(last_gnorm if last_gnorm is not None else float("nan"))
            epochs_run = epoch + 1
            if g.convergence_id is not None and last_gnorm is not None:
                # convergence is evaluated once per epoch (paper §4.4) on the
                # cached first-chunk batch
                if _check_convergence(engine, models, heap, pool, mode, coef, conv_cache):
                    converged = True
                    break
    return TrainResult(
        models=_whole(models),
        epochs_run=epochs_run,
        converged=converged,
        grad_norms=grad_norms,
        decode_s=decode_s,
        compute_s=compute_s,
        io_s=io_s,
        total_s=time.perf_counter() - t_start,
        exposed_io_s=io_s,
        overlapped_io_s=0.0,
        device_syncs=device_syncs,
        pipelined=pipelined,
    )


def _convergence_batch(engine, heap, pool, mode, coef, cache):
    """Decode the first-chunk convergence batch once per train() call; every
    epoch's terminator check reuses the cached device tensors instead of
    refetching and re-decoding pages."""
    batch = cache.get("batch")
    if batch is None:
        ids = np.arange(min(heap.n_pages, 4))
        pages_np = pool.fetch_batch(heap, ids)
        feats, labels, mask = _decode_chunk(pages_np, heap, mode, engine.device)
        X, Y, M = _batches(feats, labels, mask, coef)
        batch = cache["batch"] = (X[0], Y[0], M[0])
    return batch


def _check_convergence(engine, models, heap, pool, mode, coef, cache) -> bool:
    """Evaluate the terminator on a fresh merged value from the first batch."""
    x0, y0, m0 = _convergence_batch(engine, heap, pool, mode, coef, cache)
    _, merged = engine.batch_step(models, x0, y0, m0)
    return engine.converged(models, merged)


# ---------------------------------------------------------------------------
def madlib_train(
    g: HDFG,
    part: Partition,
    heap: HeapFile,
    max_epochs: int | None = None,
    models=None,
    seed: int = 0,
    batch: int | None = None,
) -> TrainResult:
    """MADlib+PostgreSQL analogue: tuple-at-a-time host execution. Pages are
    parsed tuple by tuple on the host and the update rule runs per mini-batch
    on the CPU, with no device and no page-granular decode."""
    from repro_torch.baselines.madlib import run as madlib_run

    return madlib_run(g, part, heap, max_epochs=max_epochs, models=models, seed=seed,
                      batch=batch)
