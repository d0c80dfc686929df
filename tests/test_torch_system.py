"""Port end to end (repro_torch.core.solver) on the CPU: heap -> buffer pool
-> strider decode -> threaded engine -> trained model, held against
repro.core.solver on the same heap for every mode, plus the ports of
tests/test_system.py and the single-device pipelined-executor contracts of
tests/test_pipeline_exec.py."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.algorithms as jalgos
from repro.core import solver as jsolver
from repro.core import translator as jtranslator
from repro.db.heap import write_table
from repro_torch.algorithms import linear_regression
from repro_torch.core import solver
from repro_torch.core.translator import trace
from repro_torch.db.bufferpool import BufferPool
from repro_torch.db.heap import HeapFile
from repro_torch.db.heap import write_table as twrite_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def linreg_heap(tmp_path_factory):
    """A heap written by repro and opened by the port."""
    tmp = tmp_path_factory.mktemp("torch_sys")
    rng = np.random.default_rng(42)
    w_true = rng.normal(0, 1, 16).astype(np.float32)
    X = rng.normal(0, 1, (3000, 16)).astype(np.float32)
    jheap = write_table(str(tmp / "lin.heap"), X, X @ w_true, page_bytes=8192)
    return HeapFile(jheap.path), jheap, w_true


def _udfs(**kw):
    g, part = trace(lambda: linear_regression(16, **kw))
    gj, pj = jtranslator.trace(lambda: jalgos.linear_regression(16, **kw))
    return (g, part), (gj, pj)


# ------------------------- against repro.core.solver -------------------------
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("mode", ["dana", "dana-nostrider", "madlib"])
def test_train_matches_repro(linreg_heap, mode, pipelined):
    heap, jheap, _ = linreg_heap
    (g, part), (gj, pj) = _udfs(lr=0.3, merge_coef=64, epochs=4)
    a = jsolver.train(gj, pj, jheap, mode=mode, seed=1, pipelined=pipelined)
    b = solver.train(g, part, heap, mode=mode, seed=1, pipelined=pipelined, device=CPU)
    assert (a.epochs_run, a.converged) == (b.epochs_run, b.converged)
    np.testing.assert_allclose(b.models[0], np.asarray(a.models[0]), **TOL)
    np.testing.assert_allclose(b.grad_norms, a.grad_norms, rtol=1e-4, atol=1e-4)
    assert a.device_syncs == b.device_syncs and b.pipelined == pipelined


def test_madlib_train_matches_repro(linreg_heap):
    heap, jheap, _ = linreg_heap
    (g, part), (gj, pj) = _udfs(lr=0.3, merge_coef=64, epochs=2)
    a = jsolver.madlib_train(gj, pj, jheap, seed=2)
    b = solver.madlib_train(g, part, heap, seed=2)
    np.testing.assert_allclose(b.models[0], np.asarray(a.models[0]), **TOL)
    np.testing.assert_allclose(b.grad_norms, a.grad_norms, rtol=1e-4, atol=1e-4)


def test_train_from_repro_models(linreg_heap):
    """A repro model (or TrainResult.models) carries over as the start point."""
    heap, jheap, _ = linreg_heap
    (g, part), (gj, pj) = _udfs(lr=0.3, merge_coef=64, epochs=2)
    start = jsolver.train(gj, pj, jheap, mode="dana", seed=3, max_epochs=1).models
    a = jsolver.train(gj, pj, jheap, mode="dana", models=start)
    b = solver.train(g, part, heap, mode="dana", models=start, device=CPU)
    np.testing.assert_allclose(b.models[0], np.asarray(a.models[0]), **TOL)


# ------------------------- ports of test_system.py ---------------------------
def test_dana_mode_trains(linreg_heap):
    heap, _, w_true = linreg_heap
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64, epochs=40))
    res = solver.train(g, part, heap, mode="dana", device=CPU)
    assert res.epochs_run == 40
    np.testing.assert_allclose(res.models[0], w_true, atol=0.02)
    assert res.decode_s >= 0 and res.compute_s > 0


def test_nostrider_mode_matches_dana(linreg_heap):
    heap, _, _ = linreg_heap
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64, epochs=5))
    a = solver.train(g, part, heap, mode="dana", seed=1, device=CPU)
    b = solver.train(g, part, heap, mode="dana-nostrider", seed=1, device=CPU)
    np.testing.assert_allclose(a.models[0], b.models[0], rtol=1e-5, atol=1e-6)


def test_convergence_stops_early(linreg_heap):
    heap, jheap, w_true = linreg_heap
    (g, part), (gj, pj) = _udfs(lr=0.3, merge_coef=64, conv_factor=0.08, epochs=200)
    res = solver.train(g, part, heap, mode="dana", device=CPU)
    assert res.converged and res.epochs_run < 200
    np.testing.assert_allclose(res.models[0], w_true, atol=0.1)
    want = jsolver.train(gj, pj, jheap, mode="dana")
    assert want.epochs_run == res.epochs_run


def test_warm_pool_has_no_misses(linreg_heap):
    heap, _, _ = linreg_heap
    pool = BufferPool(pool_bytes=heap.n_pages * heap.layout.page_bytes,
                      page_bytes=heap.layout.page_bytes)
    pool.warm(heap)
    misses_before = pool.misses
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64, epochs=2))
    solver.train(g, part, heap, pool=pool, mode="dana", device=CPU)
    assert pool.misses == misses_before  # every page served from the pool


def test_quantized_table_trains(tmp_path):
    rng = np.random.default_rng(9)
    w_true = rng.normal(0, 1, 8).astype(np.float32)
    X = rng.normal(0, 1, (2000, 8)).astype(np.float32)
    heap = twrite_table(str(tmp_path / "q.heap"), X, X @ w_true, page_bytes=8192,
                        quantized=True)
    g, part = trace(lambda: linear_regression(8, lr=0.3, merge_coef=64, epochs=40))
    res = solver.train(g, part, heap, mode="dana", device=CPU)
    # int8 feature quantization bounds accuracy but must still recover signal
    np.testing.assert_allclose(res.models[0], w_true, atol=0.1)


# ------------------------- pipelined executor contracts ----------------------
def test_exactly_one_device_sync_per_epoch(linreg_heap, monkeypatch):
    heap, _, _ = linreg_heap
    monkeypatch.setattr(solver, "MAX_RESIDENT_PAGES", 8)
    calls = {"n": 0}
    real = solver._device_sync

    def spy(models, gnorm):
        calls["n"] += 1
        return real(models, gnorm)

    monkeypatch.setattr(solver, "_device_sync", spy)
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64, epochs=5))
    pool = BufferPool(pool_bytes=heap.n_pages * heap.layout.page_bytes,
                      page_bytes=heap.layout.page_bytes)
    res = solver.train(g, part, heap, pool=pool, mode="dana", device=CPU)
    assert res.epochs_run == 5
    assert calls["n"] == res.epochs_run == res.device_syncs  # one join per epoch
    # every page fetched exactly once per epoch: no trailing prefetch
    assert pool.hits + pool.misses == res.epochs_run * heap.n_pages
    # the synchronous ablation pays two joins per chunk
    sync = solver.train(g, part, heap, mode="dana", pipelined=False, device=CPU)
    n_chunks = -(-heap.n_pages // solver.MAX_RESIDENT_PAGES)
    assert sync.device_syncs == 2 * n_chunks * sync.epochs_run


@pytest.mark.parametrize("mode", ["dana", "dana-nostrider"])
def test_pipelined_matches_synchronous_train(linreg_heap, monkeypatch, mode):
    heap, _, _ = linreg_heap
    # several chunks per epoch, so double buffering really rotates
    monkeypatch.setattr(solver, "MAX_RESIDENT_PAGES", 8)
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64, epochs=6))
    a = solver.train(g, part, heap, mode=mode, seed=3, pipelined=False, device=CPU)
    b = solver.train(g, part, heap, mode=mode, seed=3, pipelined=True, device=CPU)
    assert (a.epochs_run, a.converged) == (b.epochs_run, b.converged)
    np.testing.assert_allclose(a.models[0], b.models[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.grad_norms, b.grad_norms, rtol=1e-4, atol=1e-5)
    assert not a.pipelined and b.pipelined
    assert b.io_s == pytest.approx(b.exposed_io_s + b.overlapped_io_s)
    if mode == "dana":
        assert b.decode_s == 0.0  # decode queued with the epoch on the device


def test_train_units_yields_once_per_chunk(linreg_heap, monkeypatch):
    heap, _, _ = linreg_heap
    monkeypatch.setattr(solver, "MAX_RESIDENT_PAGES", 8)
    g, part = trace(lambda: linear_regression(16, lr=0.3, merge_coef=64, epochs=3))
    gen = solver.train_units(g, part, heap, mode="dana", seed=4, device=CPU)
    n = 0
    while True:
        try:
            next(gen)
            n += 1
        except StopIteration as stop:
            res = stop.value
            break
    assert n == 3 * -(-heap.n_pages // 8)
    want = solver.train(g, part, heap, mode="dana", seed=4, device=CPU)
    np.testing.assert_array_equal(res.models[0], want.models[0])


# ------------------------- device policy and isolation -----------------------
def test_entry_points_raise_without_a_card(linreg_heap, monkeypatch, tmp_path):
    heap, _, _ = linreg_heap
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, part = trace(lambda: linear_regression(16, epochs=1))
    for fn in (solver.train, solver.train_units):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            out = fn(g, part, heap)
            next(out)  # train_units is a generator: its body runs on next()
    with pytest.raises(ValueError, match="unknown mode"):
        solver.train(g, part, heap, mode="fpga", device=CPU)
    # the serving slice's entry points
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer

    cfg = get_reduced_config("mistral-nemo-12b")
    params, _ = model_zoo.init_params(cfg, device=CPU)
    # LM PREDICT through SQL
    from repro_torch.db.catalog import Catalog
    from repro_torch.db.heap import write_token_table
    from repro_torch.db.query import execute, register_lm_udf

    cat = Catalog(str(tmp_path))
    write_token_table(str(tmp_path / "t.heap"), [[5, 6, 7]], page_bytes=1024)
    cat.register_table("t", str(tmp_path / "t.heap"), {"kind": "tokens"})
    register_lm_udf(cat, "lm", cfg, params)
    for call in (lambda: model_zoo.init_params(cfg),
                 lambda: BatchedServer(cfg, params, batch_slots=1, max_seq=8),
                 lambda: serve_cli.main(["--arch", "mistral-nemo-12b", "--reduced"]),
                 lambda: execute("SELECT * FROM dana.predict('lm', 't');", cat)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the training slice's entry points
    from repro_torch.data.pipeline import PageTokenDataset, synthetic_data_fn
    from repro_torch.launch import train as train_cli

    rwkv = get_reduced_config("rwkv6-3b")
    for call in (lambda: model_zoo.init_params(rwkv),
                 lambda: model_zoo.demo_batch(rwkv, 1, 8),
                 lambda: synthetic_data_fn(rwkv, 1, 8),
                 lambda: PageTokenDataset(str(heap.path) + ".tok", 4, 8, rwkv.vocab_size),
                 lambda: train_cli.main(["--arch", "rwkv6-3b", "--reduced"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


_ISOLATION_SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ARCH_IDS:  # the configs package imports its modules lazily
        get_config(arch)
    for name in ("core.solver", "kernels.engine.kernel", "core.isa", "core.striders",
                 "core.scheduler", "core.hwgen", "db.catalog", "db.query", "db.scoring",
                 "db.executor", "db.session", "serve.scheduler", "launch.common",
                 "launch.score", "configs", "configs.mistral_nemo_12b", "models.config",
                 "models.params", "models.layers", "models.attention", "models.transformer",
                 "models.model_zoo", "dist.meshes", "kernels.paged_attn.ref",
                 "kernels.paged_attn.kernel", "kernels.paged_attn.ops", "serve.kv_pool",
                 "serve.metrics", "serve.faults", "serve.serving", "launch.serve",
                 "kernels.wkv.ref", "kernels.wkv.kernel", "kernels.wkv.ops", "models.ssm",
                 "train.optimizer", "train.grad_compress", "train.checkpoint",
                 "train.train_loop", "data.pipeline", "launch.train", "dist",
                 "launch.mesh", "kernels.strider.ops", "kernels.engine.ops",
                 "launch.dryrun", "launch.perf", "roofline", "roofline.analysis",
                 "roofline.collectives", "roofline.report", "launch.quickstart",
                 "launch.serve_lm", "launch.train_lm", "launch.workloads",
                 "launch.dana_vs_madlib"):
        assert "repro_torch." + name in sys.modules, name
    # importing starts no process group (the dry-run makes its fake one
    # when it runs)
    import torch.distributed as dist
    assert not dist.is_initialized(), "a module started a process group on import"
    # the mesh layer's lazy imports: a one-rank mesh, a DTensor, a sharded epoch
    import torch
    from repro_torch.algorithms import linear_regression
    from repro_torch.core.engine import init_models, make_engine
    from repro_torch.core.translator import trace
    from repro_torch.dist import meshes
    mesh = meshes.make_host_mesh(device="cpu")
    meshes.full_tensor(meshes.device_put(torch.zeros(4), meshes.replicated(mesh)))
    g, part = trace(lambda: linear_regression(4, merge_coef=4))
    eng = make_engine(g, part, device="cpu")
    eng.run_epoch_sharded(init_models(g, device="cpu"), torch.zeros(2, 4, 4),
                          torch.zeros(2, 4), torch.ones(2, 4), mesh=mesh)
    assert "torch.distributed.tensor" in sys.modules
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax"
    bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
    assert not bad, bad
    print("ISOLATED", len(names))
    """
)


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION_SCRIPT],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "ISOLATED" in out.stdout
