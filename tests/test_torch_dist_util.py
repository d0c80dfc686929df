"""Helpers of the port's multi-rank tests (no tests here): ``start`` runs one
case function of this module in ``world`` processes of their own, gloo ranks
that meet through a ``file://`` store in the test's temporary directory, and
``collect`` waits for them (each within its limit: a hung rank fails its
test, not the suite) and returns what each rank saved. The ranks import
``torch`` and ``repro_torch`` only, never ``jax`` or ``repro``: the test that
starts them holds their results against ``repro`` from the same numpy inputs
(``toy_inputs``).

    python tests/test_torch_dist_util.py CASE RANK WORLD WORKDIR DEVICE

On the CPU each rank runs one intra-op thread; on the card every rank binds
``cuda:0`` and gloo talks over the loopback interface.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 150  # each spawn's limit; the process group's own is below it
PG_TIMEOUT_S = 120
# the collectives gloo runs only on CPU tensors: a rank that calls one fails
FORBIDDEN = ("all_gather", "all_gather_into_tensor", "all_gather_object", "reduce_scatter",
             "reduce_scatter_tensor", "scatter", "gather", "all_to_all",
             "all_to_all_single", "reduce", "send", "recv", "isend", "irecv")


def start(case: str, world: int, workdir: str, device: str = "cpu"):
    """Start ``world`` ranks of ``case``; returns the handles ``collect``
    takes. Each rank's output goes to a file in ``workdir``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    handles = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"{case}.{rank}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(rank), str(world),
             workdir, device],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        )
        handles.append((proc, log))
    return case, world, workdir, handles, time.monotonic() + RANK_TIMEOUT_S


def collect(started) -> list[dict]:
    """Wait for the ranks of ``start``; kill them all if one fails or the
    limit passes, and raise with their output. Returns each rank's result."""
    import torch

    case, world, workdir, handles, deadline = started
    failed = []
    try:
        for rank, (proc, _) in enumerate(handles):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append((rank, "timeout"))
                break
            if rc != 0:
                failed.append((rank, rc))
                break
    finally:
        for proc, log in handles:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
    if failed:
        logs = []
        for rank in range(world):
            with open(os.path.join(workdir, f"{case}.{rank}.log")) as f:
                logs.append(f"--- rank {rank} ---\n{f.read()[-3000:]}")
        raise AssertionError(f"{case}: rank {failed[0][0]} ended with {failed[0][1]}\n"
                             + "\n".join(logs))
    return [torch.load(os.path.join(workdir, f"{case}.{r}.pt"), weights_only=False)
            for r in range(world)]


def toy_inputs() -> dict:
    """The inputs of ``repro``'s 8-device engine script and of its float64
    script (tests/test_shard_map_engine.py), drawn in the same order."""
    rng = np.random.default_rng(0)
    d = 16
    out = {}
    w = rng.normal(0, 1, d)
    out["X"] = rng.normal(0, 1, (1024, d)).astype(np.float32)
    out["y"] = (out["X"] @ w > 0).astype(np.float32)
    out["R"] = rng.normal(0, 1, (256, 24)).astype(np.float32)
    w_true = rng.normal(0, 1, d).astype(np.float32)
    out["Xt"] = rng.normal(0, 1, (2048, d)).astype(np.float32)
    out["yt"] = out["Xt"] @ w_true
    rng64 = np.random.default_rng(7)
    out["X64"] = rng64.normal(0, 1, (512, 12))
    out["y64"] = out["X64"] @ rng64.normal(0, 1, 12)
    return out


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------
def _guard_collectives():
    """Make every collective that gloo cannot run on CUDA tensors raise in
    this rank, and record any call."""
    import torch.distributed as dist

    called = []

    def forbid(name):
        def call(*a, **kw):
            called.append(name)
            raise AssertionError(f"the port called torch.distributed.{name}")
        return call

    for name in FORBIDDEN:
        if hasattr(dist, name):
            setattr(dist, name, forbid(name))
    return called


def _batches(x, y, coef, device, dtype=None):
    import torch

    X = torch.from_numpy(x).reshape(-1, coef, x.shape[1]).to(device)
    Y = torch.from_numpy(y).reshape(-1, coef).to(device)
    if dtype is not None:
        X, Y = X.to(dtype), Y.to(dtype)
    return X, Y, torch.ones(Y.shape, dtype=Y.dtype, device=device)


def _np(t):
    from repro_torch.dist import meshes

    return meshes.full_tensor(t).detach().cpu().numpy()


def placements(t):
    """A model's DTensor placements as "R" / "S(dim)", None for a whole
    tensor."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import meshes

    if not meshes.is_dtensor(t):
        return None
    return ["R" if isinstance(p, Replicate) else f"S({p.dim})" for p in t.placements]


def case_engine(rank, world, workdir, device):
    """The cases of repro's ``_MULTI_DEVICE_SCRIPT`` (and, on the CPU, its
    float64 script) on ``world`` ranks: the data mesh (world x 1) with the
    GLM kernel's path (B2 counted, the vmap thread path poisoned), the model
    mesh (2 x world/2, or 1 x 2) with GLM and LRMF, and ``solver.train`` on
    the model mesh."""
    import torch

    from repro_torch.algorithms import linear_regression, logistic_regression, lrmf
    from repro_torch.core import solver
    from repro_torch.core.engine import init_models, make_engine
    from repro_torch.core.translator import trace
    from repro_torch.db.heap import HeapFile
    from repro_torch.dist import meshes
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ops as engine_ops

    forbidden = _guard_collectives()
    inp = toy_inputs()
    d, coef = 16, 64
    out = {}
    g, part = trace(lambda: logistic_regression(d, lr=0.3, merge_coef=coef))
    Xb, Yb, Mb = _batches(inp["X"], inp["y"], coef, device)

    # 1. data mesh: the per-rank gradient through glm_grad, never _pre
    eng = make_engine(g, part, device=device)
    assert eng.use_fused_kernel
    models = init_models(g, device=device)
    calls = {"glm_grad": 0}
    real = engine_ops.glm_grad

    def spy(*a, **kw):
        calls["glm_grad"] += 1
        return real(*a, **kw)

    def poisoned(*a, **kw):
        raise AssertionError("the sharded epoch took the vmap thread path")

    engine_ops.glm_grad, eng._pre = spy, poisoned
    glm_kernel.glm_grad.launches = 0
    meshes.reset_collectives()
    mesh = meshes.make_host_mesh(device=device)
    with meshes.use_mesh(mesh):
        got, gotg = eng.run_epoch(models, Xb, Yb, Mb)
    engine_ops.glm_grad = real
    out["data"] = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   "path": eng.last_sharded_path, "calls": calls["glm_grad"],
                   "launches": glm_kernel.glm_grad.launches,
                   "collectives": dict(meshes.COLLECTIVES),
                   "w": _np(got[0]), "gnorms": _np(gotg)}

    # 2. data x model mesh: w feature-partitioned over the model axis
    mesh2 = meshes.make_host_mesh(model_parallel=4 if world == 8 else world, device=device)
    eng2 = make_engine(g, part, shard_model=True, device=device)
    meshes.reset_collectives()
    with meshes.use_mesh(mesh2):
        got2, gotg2 = eng2.run_epoch(models, Xb, Yb, Mb)
    out["model"] = {"mesh": dict(zip(mesh2.mesh_dim_names, mesh2.shape)),
                    "path": eng2.last_sharded_path, "placements": placements(got2[0]),
                    "local": got2[0].to_local().cpu().numpy(),
                    "collectives": dict(meshes.COLLECTIVES),
                    "w": _np(got2[0]), "gnorms": _np(gotg2)}

    # 3. LRMF factor matrix: generic graph, the gspmd path, items sharded
    gm, pm = trace(lambda: lrmf(24, rank=4, lr=1e-2, merge_coef=8))
    Rb, _, _ = _batches(inp["R"], np.zeros(256, np.float32), 8, device)
    Zb = torch.zeros(Rb.shape[:2], device=device)
    Ob = torch.ones(Zb.shape, device=device)
    engm = make_engine(gm, pm, shard_model=True, device=device)
    m0 = init_models(gm, np.random.default_rng(1), scale=0.05, device=device)
    with meshes.use_mesh(mesh2):
        gotm, _ = engm.run_epoch(m0, Rb, Zb, Ob)
    out["lrmf"] = {"path": engm.last_sharded_path, "placements": placements(gotm[0]),
                   "M": _np(gotm[0])}

    # 4. end to end: the pipelined solver on the model mesh
    gt, pt = trace(lambda: linear_regression(d, lr=0.3, merge_coef=64, epochs=4))
    heap = HeapFile(os.path.join(workdir, "t.heap"))
    shard = solver.train(gt, pt, heap, mode="dana", seed=2, pipelined=True, mesh=mesh2,
                         shard_model=True, device=device)
    out["train"] = {"w": shard.models[0], "device_syncs": shard.device_syncs,
                    "epochs_run": shard.epochs_run}

    # 5. float64 through the vmap thread path: the merge's summation order only
    if device == "cpu":
        g64, p64 = trace(lambda: linear_regression(12, lr=0.3, merge_coef=64))
        eng64 = make_engine(g64, p64, use_fused_kernel=False, device=device)
        X64, Y64, M64 = _batches(inp["X64"], inp["y64"], 64, device, torch.float64)
        got64, gotg64 = eng64.run_epoch_sharded(
            [torch.zeros(12, dtype=torch.float64)], X64, Y64, M64, mesh=mesh)
        out["f64"] = {"path": eng64.last_sharded_path, "dtype": str(got64[0].dtype),
                      "w": _np(got64[0]), "gnorms": _np(gotg64)}

    # placement helpers on a real mesh: shard_act, device_put, full_tensor
    x = torch.arange(8.0 * world, device=device).reshape(world, 8)
    with meshes.use_mesh(mesh2):
        placed = meshes.shard_act(x, ("batch", "ff"), "act")
    out["shard_act"] = {"placements": placements(placed), "whole": _np(placed),
                        "local": placed.to_local().cpu().numpy()}
    out["forbidden"] = list(forbidden)
    return out


CASES = {"engine": case_engine}


def main(argv) -> int:
    import torch
    import torch.distributed as dist

    case, rank, world, workdir, device = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/{case}.store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = CASES[case](rank, world, workdir, device)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"{case}.{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
