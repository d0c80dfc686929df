#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: DAnA's TRAIN path at
full size, through the port's hand-written CUDA kernels.

Phases, one JSON line each:

  env      torch and CUDA versions, the card's name and power limit
  build    nvcc builds of src/repro_torch/csrc/*.cu, all started together
  parity   each kernel against its plain PyTorch version on the same CUDA
           tensors: the strider decode bit for bit, the GLM gradient at
           rtol=2e-5, atol=2e-4 (the reference's own tolerance)
  e2e      remote_sensing_lr from the paper's Table 3 (logistic regression,
           54 features, 581,102 tuples in 4,211 pages of 32 KB, warm pool)
           trained for 3 epochs by solver.train(mode="dana") on the card;
           launch counts, one join per epoch, and the coefficients against
           the same run on the CPU
  syncs    one more epoch under torch.cuda.set_sync_debug_mode("warn")
  profile  one more epoch under torch.profiler: the card's busy and idle share
  kernels  each kernel's launches on the main path, error, time, bound,
           plain version's time and library yardstick

The last line is {"ok": true, "device": {...}}. Any failure raises, exits
non-zero and prints no such line. Without a CUDA card the script exits 1.

    python3 chip_smoke.py
"""
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
WORKLOAD = "remote_sensing_lr"
SCALE = 1.0  # the paper's full table
EPOCHS = 3
MERGE_COEF = 256
# Table 3's tuples and features; 138 tuples fit a 32 KB page, so 4,211 pages;
# 9 chunks of at most 512 pages and 2,270 merge batches of 256 per epoch
EXPECT = {"geometry": (581_102, 54, 138, 4211),
          "launches": {"strider_decode": 27, "glm_grad": 6810}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(calls, reps=5):
    """Device time per call: the calls are captured into one CUDA graph and
    replayed between two CUDA events, so host launch overhead is left out.
    Median over ``reps`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:  # warm the allocator outside the capture
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def eager_ms(calls, reps=5):
    """Time per call launched eagerly from Python, as the engine's loop
    launches it: host overhead included. Median over ``reps`` runs."""
    import torch

    for call in calls:
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build("strider_decode", "glm_grad")
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        for name, (_, log) in report.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v[0] for k, v in report.items()},
          "build_dir": os.path.relpath(build.BUILD_DIR, ROOT), "ptxas": ptxas})


def phase_parity_strider():
    import numpy as np
    import torch

    from repro_torch.db.heap import write_token_table
    from repro_torch.db.page import PageLayout, build_pages
    from repro_torch.kernels.strider import kernel, ops, ref

    def check(pages_np, layout, what):
        cpu = ops.pages_tensor(pages_np)
        dev = cpu.cuda()
        got = kernel.strider_decode(dev, layout)
        plain = ref.decode_pages_ref(dev, layout)
        host = ref.decode_pages_ref(cpu, layout)
        torch.cuda.synchronize()
        for g, p, h in zip(got, plain, host):
            gi = g.view(torch.int32)
            if not (torch.equal(gi, p.view(torch.int32))
                    and torch.equal(gi.cpu(), h.view(torch.int32))):
                raise AssertionError(f"strider_decode differs from its plain version: {what}")
        return got

    rng = np.random.default_rng(0)
    cases = 0
    for quant in (False, True):
        for d in (1, 54, 520):
            for kb in (8, 32, 128):
                layout = PageLayout(n_features=d, page_bytes=kb * 1024, quantized=quant)
                t = layout.tuples_per_page
                n = 2 * t + t // 2 + 1  # two full pages and a partial last one
                feats = rng.normal(0, 2, (n, d)).astype(np.float32)
                labels = rng.normal(0, 2, n).astype(np.float32)
                got = check(build_pages(feats, labels, layout), layout,
                            f"d={d} page={kb}KB quantized={quant}")
                live = got[2].reshape(-1).bool()
                if int(live.sum()) != n:
                    raise AssertionError("live-slot count differs from the tuple count")
                if not quant and not torch.equal(
                    got[0].reshape(-1, d)[live].cpu(), torch.from_numpy(feats)
                ):
                    raise AssertionError("decoded f32 tuples differ from the table")
                cases += 1
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(os.path.join(SCRATCH, "tokens.heap"), seqs, page_bytes=8192)
    got = check(heap.read_all(), heap.layout, "token page (int32 as f32 denormals)")
    tokens = got[0].view(torch.int32).cpu()
    for i, s in enumerate(seqs):
        if tokens[0, i, : len(s)].tolist() != s:
            raise AssertionError("token ids changed in the decode")
    emit({"phase": "parity", "kernel": "strider_decode", "cases": cases + 1,
          "bit_exact": True})


def phase_parity_glm():
    import numpy as np
    import torch

    from repro_torch.kernels.engine import kernel, ref

    rng = np.random.default_rng(1)
    worst = 0.0
    cases = 0
    for act in ref.ACTS:
        for n, d in ((256, 54), (217, 31), (70_656, 54)):
            x = rng.normal(0, 1, (n, d)).astype(np.float32)
            y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
            if act == "logistic":
                y = (y > 0).astype(np.float32)
            w = rng.normal(0, 0.5, d).astype(np.float32)
            mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
            x[mask == 0] = 1e6  # dead rows must not contribute
            x, y, w, mask = (torch.from_numpy(a).cuda() for a in (x, y, w, mask))
            got = kernel.glm_grad(x, y, w, mask, act)
            again = kernel.glm_grad(x, y, w, mask, act)
            plain = ref.glm_grad_ref(x, y, w, mask, act)
            torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-4)
            if not torch.equal(got, again):
                raise AssertionError("glm_grad is not deterministic")
            worst = max(worst, float((got - plain).abs().max()))
            cases += 1
    emit({"phase": "parity", "kernel": "glm_grad", "cases": cases,
          "rtol": 2e-5, "atol": 2e-4, "max_abs_err": worst, "deterministic": True})


def _hot_loop_lines():
    """(file, first line, last line) of the code the engine runs per chunk."""
    from repro_torch.core import engine
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ops as glm_ops
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.strider import ops as strider_ops

    spans = []
    for obj in (engine.Engine.run_chunk, engine.Engine.run_epoch,
                engine.Engine.batch_step, engine._PinnedStager.__call__,
                engine.batches_from_stream, glm_kernel, glm_ops, strider_kernel,
                strider_ops):
        lines, first = inspect.getsourcelines(obj)
        spans.append((os.path.realpath(inspect.getsourcefile(obj)), first,
                      first + len(lines)))
    return spans


def phase_e2e():
    import numpy as np
    import torch

    from repro_torch.algorithms import logistic_regression
    from repro_torch.core import solver
    from repro_torch.core.engine import make_engine
    from repro_torch.core.translator import trace
    from repro_torch.data.synthetic import WORKLOADS, generate
    from repro_torch.db.bufferpool import BufferPool
    from repro_torch.db.heap import write_table
    from repro_torch.kernels.engine.kernel import glm_grad
    from repro_torch.kernels.strider.kernel import strider_decode

    wl = WORKLOADS[WORKLOAD]
    t0 = time.perf_counter()
    X, y = generate(wl, scale=SCALE, seed=0)
    heap = write_table(os.path.join(SCRATCH, f"{WORKLOAD}.heap"), X, y,
                       page_bytes=wl.page_bytes)
    pool = BufferPool(pool_bytes=heap.n_pages * heap.layout.page_bytes,
                      page_bytes=heap.layout.page_bytes)
    pool.warm(heap)
    setup_s = time.perf_counter() - t0
    if (heap.n_tuples, heap.layout.n_features, heap.layout.tuples_per_page,
            heap.n_pages) != EXPECT["geometry"]:
        raise AssertionError("remote_sensing_lr geometry differs from the paper's table")
    n_chunks = -(-heap.n_pages // solver.MAX_RESIDENT_PAGES)
    batches = sum(
        -(-min(solver.MAX_RESIDENT_PAGES, heap.n_pages - s) * heap.layout.tuples_per_page
          // MERGE_COEF)
        for s in range(0, heap.n_pages, solver.MAX_RESIDENT_PAGES)
    )

    g, part = trace(lambda: logistic_regression(54, lr=0.1, merge_coef=MERGE_COEF,
                                                epochs=EPOCHS))
    engine = make_engine(g, part, device="cuda")
    if engine.glm_template != "logistic" or not engine.use_fused_kernel:
        raise AssertionError("the engine did not take the fused GLM kernel")

    sync_at = []
    real_sync = solver._device_sync

    def timed_sync(models, gnorm):
        out = real_sync(models, gnorm)
        sync_at.append(time.perf_counter())
        return out

    misses = pool.misses
    solver._device_sync = timed_sync
    try:
        strider_decode.launches = glm_grad.launches = 0
        t_start = time.perf_counter()
        res = solver.train(g, part, heap, pool=pool, mode="dana", engine=engine, seed=0)
        t_end = time.perf_counter()
        launches = {"strider_decode": strider_decode.launches,
                    "glm_grad": glm_grad.launches}
    finally:
        solver._device_sync = real_sync
    epoch_s = [b - a for a, b in zip([t_start] + sync_at[:-1], sync_at)]

    want = {"strider_decode": EPOCHS * n_chunks, "glm_grad": EPOCHS * batches}
    if launches != want or want != EXPECT["launches"]:
        raise AssertionError(f"launches {launches}, expected {want}")
    if res.device_syncs != EPOCHS or res.epochs_run != EPOCHS or len(sync_at) != EPOCHS:
        raise AssertionError(f"device_syncs {res.device_syncs} != {EPOCHS}")
    if pool.misses != misses:
        raise AssertionError("the warm pool missed")
    w_gpu = res.models[0]
    if w_gpu.shape != (54,) or not np.isfinite(w_gpu).all():
        raise AssertionError("trained coefficients are not 54 finite values")

    t_cpu = time.perf_counter()
    cpu = solver.train(g, part, heap, pool=pool, mode="dana", seed=0, device="cpu")
    cpu_s = time.perf_counter() - t_cpu
    # both runs do the same f32 arithmetic and differ only in summation order
    # (warp shuffles against CPU BLAS) and expf's last bit; over 6,810
    # contractive SGD steps those stay orders below 1e-4
    np.testing.assert_allclose(w_gpu, cpu.models[0], rtol=1e-4, atol=1e-4)
    accuracy = float(((X @ w_gpu > 0).astype(np.float32) == y).mean())

    emit({"phase": "e2e", "workload": WORKLOAD, "algorithm": "logistic",
          "n_tuples": heap.n_tuples, "n_features": 54, "pages": heap.n_pages,
          "page_bytes": heap.layout.page_bytes, "heap_bytes": heap.n_pages * wl.page_bytes,
          "merge_coef": MERGE_COEF, "epochs": res.epochs_run, "chunks_per_epoch": n_chunks,
          "merge_batches_per_epoch": batches, "launches": launches,
          "device_syncs": res.device_syncs, "setup_s": setup_s,
          "total_s": t_end - t_start, "train_total_s": res.total_s, "epoch_s": epoch_s,
          "tuples_per_s": EPOCHS * heap.n_tuples / (t_end - t_start),
          "compute_s": res.compute_s, "exposed_io_s": res.exposed_io_s,
          "overlapped_io_s": res.overlapped_io_s, "grad_norms": res.grad_norms,
          "cpu_total_s": cpu_s, "max_abs_diff_vs_cpu": float(np.abs(w_gpu - cpu.models[0]).max()),
          "tolerance_vs_cpu": {"rtol": 1e-4, "atol": 1e-4},
          "train_accuracy": accuracy})

    # one more epoch with every synchronising CUDA call reported
    hot = _hot_loop_lines()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver.train(g, part, heap, pool=pool, mode="dana", engine=engine,
                         max_epochs=1, seed=0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where: dict[str, int] = {}
    in_hot_loop = 0
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        path = os.path.realpath(w.filename)
        where[f"{os.path.relpath(path, ROOT)}:{w.lineno}"] = where.get(
            f"{os.path.relpath(path, ROOT)}:{w.lineno}", 0) + 1
        in_hot_loop += any(path == f and a <= w.lineno < b for f, a, b in hot)
    emit({"phase": "syncs", "epochs": 1, "synchronizing_calls": sum(where.values()),
          "where": where, "in_run_chunk": in_hot_loop})
    if in_hot_loop:
        raise AssertionError("the chunk loop synchronises with the host")

    # one more epoch under the profiler: the card's busy time over the epoch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.train(g, part, heap, pool=pool, mode="dana", engine=engine,
                     max_epochs=1, seed=0)
        traced_s = time.perf_counter() - t0
    stats = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    busy_s = sum(dev_us(e) for e in stats) / 1e6
    steady_s = statistics.median(epoch_s[1:])
    emit({"phase": "profile", "epochs": 1, "traced_epoch_s": traced_s,
          "device_busy_s": busy_s if busy_s else None,
          "untraced_epoch_s": steady_s,
          "device_idle_share": 1.0 - busy_s / steady_s if busy_s else None,
          "top_device": [[e.key, dev_us(e) / 1e3, e.count]
                         for e in sorted(stats, key=dev_us, reverse=True)[:6]],
          "top_host_self": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                            for e in sorted(stats, key=lambda e: e.self_cpu_time_total,
                                            reverse=True)[:8]],
          "units": "ms totals over the epoch"})
    return heap, engine, res, launches


def phase_kernels(heap, engine, res, launches):
    import numpy as np
    import torch

    from repro_torch.core.engine import batches_from_stream
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ref as glm_ref
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.strider import ops as strider_ops
    from repro_torch.kernels.strider import ref as strider_ref

    layout = heap.layout
    p = 512  # the main path's chunk of pages
    # four chunks in turn: 64 MB of pages, more than the 50 MB L2
    chunks = [
        strider_ops.pages_tensor(
            heap.read_pages(np.arange(k * p, (k + 1) * p) % heap.n_pages)
        ).cuda()
        for k in range(4)
    ]
    got = strider_kernel.strider_decode(chunks[0], layout)
    plain = strider_ref.decode_pages_ref(chunks[0], layout)
    b1_err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    b1_bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, plain))
    t, d = layout.tuples_per_page, layout.n_features
    b1_bytes = p * layout.page_bytes + 4 * p * t * (d + 2)
    b1_calls = [lambda c=c: strider_kernel.strider_decode(c, layout) for c in chunks] * 5
    b1_plain = [lambda c=c: strider_ref.decode_pages_ref(c, layout) for c in chunks] * 5
    b1 = {
        "name": "strider_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/strider_decode.cu",
        "replaces": "src/repro/kernels/strider/strider.py:44",
        "launches": launches["strider_decode"], "max_abs_err": b1_err,
        "bit_exact": b1_bits,
        "shape": f"pages ({p}, {layout.page_words}) int32 -> feats ({p}, {t}, {d})",
        "ms": device_ms(b1_calls), "host_ms": eager_ms(b1_calls),
        "plain_ms": device_ms(b1_plain),
        "bound_ms": 1e3 * b1_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "bound_bytes": b1_bytes, "library_ms": None,
    }
    del b1_calls, b1_plain

    feats, labels, mask = strider_kernel.strider_decode(chunks[0], layout)
    n = p * t
    X, Y, M = batches_from_stream(feats.reshape(n, d), labels.reshape(n),
                                  mask.reshape(n), engine.merge_coef)
    w = torch.from_numpy(res.models[0]).cuda()
    nb, rows = X.shape[0], X.shape[1]
    b2_err = max(
        float((glm_kernel.glm_grad(X[b], Y[b], w, M[b], "logistic")
               - glm_ref.glm_grad_ref(X[b], Y[b], w, M[b], "logistic")).abs().max())
        for b in range(nb)
    )
    b2_bytes = 4 * (rows * d + 2 * rows + 2 * d)
    b2_flops = 4 * rows * d
    b2_calls = [lambda b=b: glm_kernel.glm_grad(X[b], Y[b], w, M[b], "logistic")
                for b in range(nb)]
    b2_plain = [lambda b=b: glm_ref.glm_grad_ref(X[b], Y[b], w, M[b], "logistic")
                for b in range(nb)]
    b2_lib = [lambda b=b: torch.matmul((torch.sigmoid(torch.matmul(X[b], w)) - Y[b]) * M[b],
                                       X[b]) for b in range(nb)]
    b2 = {
        "name": "glm_grad", "route": "cuda", "source": "src/repro_torch/csrc/glm_grad.cu",
        "replaces": "src/repro/kernels/engine/engine.py:26",
        "launches": launches["glm_grad"], "max_abs_err": b2_err,
        "shape": f"x ({rows}, {d}) f32, logistic",
        "ms": device_ms(b2_calls), "host_ms": eager_ms(b2_calls),
        "plain_ms": device_ms(b2_plain),
        "bound_ms": 1e3 * max(b2_bytes / HBM_BYTES_PER_S, b2_flops / F32_FLOPS),
        "bound_by": "bytes" if b2_bytes / HBM_BYTES_PER_S >= b2_flops / F32_FLOPS
        else "operations",
        "bound_bytes": b2_bytes,
        "library_ms": device_ms(b2_lib),
        "library": "composite: torch.matmul, sigmoid, sub, mul, torch.matmul",
    }
    emit({"kernels": [b1, b2]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails where the repository is absent)

    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})
    os.makedirs(SCRATCH, exist_ok=True)
    try:
        phase_build()
        phase_parity_strider()
        phase_parity_glm()
        heap, engine, res, launches = phase_e2e()
        phase_kernels(heap, engine, res, launches)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
