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
import json
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


# ---------------------------------------------------------------------------
# LM training on a mesh
# ---------------------------------------------------------------------------
MESH_BATCH, MESH_SEQ = 8, 16
MESH_OPT = {"lr": 1e-3, "warmup_steps": 2}


def unequal_mask_batch(vocab: int, rows: int = 8, seq: int = 16) -> dict:
    """A batch whose loss masks give the ranks of a 4-way data axis unequal
    counts: 32, 21, 9 and 0 tokens."""
    rng = np.random.default_rng(11)
    tok = rng.integers(0, vocab, (rows, seq + 1))
    keep = np.array([16, 16, 16, 5, 9, 0, 0, 0])[:rows, None]
    mask = (np.arange(seq)[None, :] < keep).astype(np.float32)
    return {"tokens": tok[:, :-1].astype(np.int32), "targets": tok[:, 1:].astype(np.int32),
            "loss_mask": mask}


def uncast():
    """f32 embedding and unembedding in the port (test_torch_rwkv._uncast's
    patches of the port's side); returns the function that undoes them."""
    from repro_torch.models import model_zoo, transformer

    saved = (transformer.embed, transformer.unembed, model_zoo.unembed)
    transformer.embed = lambda p, t, cfg: p["table"][t]
    transformer.unembed = lambda p, x, cfg: x @ p["unembed"]
    model_zoo.unembed = lambda p, x, cfg: x @ p["unembed"]

    def undo():
        transformer.embed, transformer.unembed, model_zoo.unembed = saved

    return undo


def first_grads(loss_fn, opt_cfg):
    """A train step that keeps its first step's gradients (as numpy, by
    path) in the dict it returns with it: the step's ``compress`` hook sees
    the gradients the update takes, whole and summed over the ranks."""
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.optimizer import make_train_step

    first = {}

    def keep(grads, error_fb):
        if not first:
            first.update({k: g.detach().cpu().numpy().copy() for k, g in _flatten(grads)})
        return grads, error_fb

    return first, make_train_step(loss_fn, opt_cfg, compress=keep)


def _whole_tree(tree):
    """Every leaf of a placed tree whole, as numpy, keyed by its path."""
    from repro_torch.dist import meshes
    from repro_torch.train.checkpoint import _flatten

    return {name: meshes.whole(x).detach().cpu().numpy() for name, x in _flatten(tree)}


def _placements_tree(tree):
    from repro_torch.train.checkpoint import _flatten

    return {name: placements(x) for name, x in _flatten(tree)}


def case_train_mesh(rank, world, workdir, device):
    """LM training on a (4 x 2) mesh: reduced rwkv6-3b with f32 activations
    through train_loop.run from the parent's numpy weights; the async and
    the sync checkpoint of the placed state; one step on a batch whose
    masks give the ranks unequal counts, and one on a batch of 6 rows (it
    does not divide 4 data ranks); the parent's repro checkpoint restored
    with shardings=."""
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import synthetic_data_fn
    from repro_torch.dist import meshes
    from repro_torch.models import model_zoo
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (
        OptConfig,
        adamw_init,
        make_train_step,
        param_shardings,
        state_shardings,
    )
    from repro_torch.train.train_loop import TrainLoopConfig, run

    forbidden = _guard_collectives()
    out = {}
    mesh = meshes.make_mesh((4, 2), ("data", "model"), device=device)
    cfg = get_reduced_config("rwkv6-3b")
    weights = torch.load(os.path.join(workdir, "rwkv_weights.pt"), weights_only=False)
    _, specs = model_zoo.init_params(cfg, 0, device, dtype=torch.float32)
    opt_cfg = OptConfig(**MESH_OPT)

    # 1. six steps of train_loop.run, f32 activations
    undo = uncast()
    try:
        params = params_from_numpy(cfg, weights, device=device, dtype=torch.float32)
        meshes.reset_collectives()
        with meshes.use_mesh(mesh):
            p, opt, hist = run(model_zoo.loss_fn(cfg, remat="none"), params,
                               synthetic_data_fn(cfg, MESH_BATCH, MESH_SEQ, device=device),
                               TrainLoopConfig(total_steps=6, ckpt_every=1000, log_every=1,
                                               ckpt_dir=os.path.join(workdir, f"run.{rank}")),
                               opt_cfg, param_specs=specs)
            collectives = dict(meshes.COLLECTIVES)
            want_sh = state_shardings(p, opt_cfg, mesh, specs)
            out["run"] = {"history": hist, "params": _whole_tree(p),
                          "opt": _whole_tree(opt), "collectives": collectives,
                          "placements": _placements_tree(p),
                          "opt_placements": _placements_tree(opt),
                          "opt_specs": {k: tuple(v.spec) for k, v in
                                        ckpt._flatten(want_sh)}}
            # 2. the checkpoints of the placed state: async, then sync
            saver = ckpt.AsyncCheckpointer(os.path.join(workdir, "async_ck"))
            saver.submit(6, {"params": p, "opt": opt})
            saver.close()
            ckpt.save(os.path.join(workdir, "sync_ck"), 6, {"params": p, "opt": opt})

        # 3. one step on unequal masks; one on a batch that does not divide
        step_fn = make_train_step(model_zoo.loss_fn(cfg, remat="none"), opt_cfg)
        for name, batch in (("unequal", unequal_mask_batch(cfg.vocab_size)),
                            ("six_rows", {k: v[:6] for k, v in
                                          unequal_mask_batch(cfg.vocab_size).items()})):
            with meshes.use_mesh(mesh):
                tp = params_from_numpy(cfg, weights, device=device, dtype=torch.float32)
                tp = meshes.place_tree(tp, param_shardings(tp, mesh, specs))
                opt = adamw_init(tp, opt_cfg, param_specs=specs)
                meshes.reset_collectives()
                tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
                tp, opt, m = step_fn(tp, opt, tb)
                out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "params": _whole_tree(tp), "fallbacks": meshes.fallbacks(),
                             "collectives": dict(meshes.COLLECTIVES)}
        # the unequal batch again: each rank's rows in 2 microbatches, and
        # with the weights and moments placed by FSDP's rules
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in unequal_mask_batch(cfg.vocab_size).items()}
        for name, micro, rules in (("micro2", 2, None), ("fsdp", 1, meshes.FSDP_PARAM_RULES)):
            with meshes.use_mesh(mesh):
                tp = params_from_numpy(cfg, weights, device=device, dtype=torch.float32)
                tp = meshes.place_tree(tp, meshes.tree_shardings(specs, tp, mesh, rules=rules))
                opt = adamw_init(tp, opt_cfg, param_specs=specs, rules=rules)
                step = make_train_step(model_zoo.loss_fn(cfg, remat="none"), opt_cfg,
                                       microbatches=micro)
                tp, opt, m = step(tp, opt, batch)
                out[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "params": _whole_tree(tp), "placements": _placements_tree(tp),
                             "opt": _whole_tree(opt)}
    finally:
        undo()

    # 4. the parent's repro checkpoint placed with shardings= on this mesh
    with meshes.use_mesh(mesh):
        tp = params_from_numpy(cfg, weights, device=device, dtype=torch.float32)
        template = {"params": tp, "opt": adamw_init(tp, opt_cfg)}
        shardings = {"params": param_shardings(tp, mesh, specs),
                     "opt": state_shardings(tp, opt_cfg, mesh, specs)}
        got, step = ckpt.restore(os.path.join(workdir, "repro_ck"), template,
                                 shardings=shardings)
        out["restored"] = {"step": step, "whole": _whole_tree(got),
                           "placements": _placements_tree(got),
                           "local": {k: meshes.local(v).cpu().numpy()
                                     for k, v in ckpt._flatten(got)}}

    out["forbidden"] = list(forbidden)
    return out


def case_train_families(rank, world, workdir, device):
    """Two steps on a (4 x 2) mesh of each family named in the parent's
    ``families.json``, from the port's ``init_params`` (seed 0) and
    ``synthetic_data_fn``'s batches: the losses, the gradient norms, the
    first step's summed gradients and the final weights, whole."""
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.data.pipeline import synthetic_data_fn
    from repro_torch.dist import meshes
    from repro_torch.models import model_zoo
    from repro_torch.train.optimizer import OptConfig, adamw_init, param_shardings

    forbidden = _guard_collectives()
    with open(os.path.join(workdir, "families.json")) as f:
        archs = json.load(f)
    mesh = meshes.make_mesh((4, 2), ("data", "model"), device=device)
    opt_cfg = OptConfig(**MESH_OPT)
    out = {}
    for arch in archs:
        fcfg = get_reduced_config(arch)
        data_fn = synthetic_data_fn(fcfg, MESH_BATCH, MESH_SEQ, device=device)
        fp, fspecs = model_zoo.init_params(fcfg, 0, device, dtype=torch.float32)
        first, step_fn = first_grads(model_zoo.loss_fn(fcfg, remat="none"), opt_cfg)
        with meshes.use_mesh(mesh):
            fp = meshes.place_tree(fp, param_shardings(fp, mesh, fspecs))
            opt = adamw_init(fp, opt_cfg, param_specs=fspecs)
            losses, norms = [], []
            for s in range(2):
                fp, opt, _, m = step_fn(fp, opt, data_fn(s), None)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            out[arch] = {"losses": losses, "grad_norms": norms, "grads": first,
                         "params": _whole_tree(fp), "placements": _placements_tree(fp)}
    out["forbidden"] = list(forbidden)
    return out


def case_elastic(rank, world, workdir, device):
    """The elastic flow of examples/elastic_restart.py through
    ``repro_torch.launch.elastic_restart.flow``: (4 x 2), save, restore onto
    (2 x 4), from the parent's numpy weights (repro's ``init_params``)."""
    import torch

    from repro_torch.dist import meshes
    from repro_torch.launch import elastic_restart

    forbidden = _guard_collectives()
    args = elastic_restart.build_parser().parse_args(
        ["--device", device, "--ranks", str(world), "--workdir", workdir])
    weights = torch.load(os.path.join(workdir, "elastic_weights.pt"), weights_only=False)
    meshes.reset_collectives()
    res = elastic_restart.flow(args, rank, device, weights)
    with meshes.use_mesh(res["mesh_b"]):
        whole = _whole_tree({"params": res["params"], "opt": res["opt"]})
    return {"losses": res["losses"], "grad_norms": res["grad_norms"], "step": res["step"],
            "restored_step": res["restored_step"], "whole": whole,
            "placements": _placements_tree(res["params"]),
            "opt_placements": _placements_tree(res["opt"]),
            "collectives": dict(meshes.COLLECTIVES), "barriers": dict(meshes.BARRIERS),
            "forbidden": list(forbidden)}


LM_CARD_STEPS, LM_CARD_BATCH, LM_CARD_SEQ = 3, 4, 32


def lm_card_run(cfg, weights, device, ckpt_dir, mesh=None):
    """LM_CARD_STEPS steps of reduced rwkv6-3b with f32 activations from
    ``weights`` (a numpy tree), on ``mesh`` or unsharded, through
    ``train_loop.run(param_specs=)`` in two calls: the first trains all but
    the last step and saves through the async checkpointer, the second
    resumes from that checkpoint (on a mesh, placed with the mesh's
    shardings) and trains the last step. The losses, the gradient norms,
    the whole final weights, B6's and B6-bwd's launches."""
    import torch

    from repro_torch.data.pipeline import synthetic_data_fn
    from repro_torch.dist import meshes
    from repro_torch.kernels.wkv import kernel as wkv_kernel
    from repro_torch.models import model_zoo
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainLoopConfig, run

    _, specs = model_zoo.init_params(cfg, 0, "cpu", dtype=torch.float32)
    data_fn = synthetic_data_fn(cfg, LM_CARD_BATCH, LM_CARD_SEQ, device=device)
    loss_fn = model_zoo.loss_fn(cfg, remat="none")
    undo = uncast()
    try:
        with meshes.use_mesh(mesh):
            wkv_kernel.wkv_forward.launches = wkv_kernel.wkv_backward.launches = 0
            hist = []
            for total in (LM_CARD_STEPS - 1, LM_CARD_STEPS):
                p = params_from_numpy(cfg, weights, device=device, dtype=torch.float32)
                p, opt, h = run(loss_fn, p, data_fn,
                                TrainLoopConfig(total_steps=total, ckpt_every=LM_CARD_STEPS - 1,
                                                log_every=1, ckpt_dir=ckpt_dir,
                                                async_checkpoint=True),
                                OptConfig(**MESH_OPT), param_specs=specs)
                hist += h
            assert [h["step"] for h in hist] == list(range(1, LM_CARD_STEPS + 1))
            assert int(opt["step"]) == LM_CARD_STEPS
            return {"losses": [h["loss"] for h in hist],
                    "grad_norms": [h["grad_norm"] for h in hist], "params": _whole_tree(p),
                    "placements": _placements_tree(p),
                    "launches": {"wkv": wkv_kernel.wkv_forward.launches,
                                 "wkv_bwd": wkv_kernel.wkv_backward.launches}}
    finally:
        undo()


def case_lm_card(rank, world, workdir, device):
    """Reduced rwkv6-3b on the card's gloo ranks, on (world x 1) and
    (1 x world), from the parent's numpy weights (lm_card_run: through
    ``train_loop.run``, a checkpoint and its resume)."""
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.dist import meshes

    forbidden = _guard_collectives()
    cfg = get_reduced_config("rwkv6-3b")
    weights = torch.load(os.path.join(workdir, "lm_card_weights.pt"), weights_only=False)
    out = {}
    for name, shape in (("data", (world, 1)), ("model", (1, world))):
        mesh = meshes.make_mesh(shape, ("data", "model"), device=device)
        meshes.reset_collectives()
        out[name] = lm_card_run(cfg, weights, device, os.path.join(workdir, f"ck_{name}"),
                                mesh)
        out[name]["collectives"] = dict(meshes.COLLECTIVES)
    out["forbidden"] = list(forbidden)
    return out


# ---------------------------------------------------------------------------
# The sharded server
# ---------------------------------------------------------------------------
# repro's stream of its 8-device serving scripts: 4 slots, 5 requests (rid,
# prompt, new tokens), here with priority 1 and arrival step 0
SERVE_STREAM = [(0, [5, 6, 7, 8], 12, 1, 0), (1, [1, 2], 3, 1, 0), (2, [8, 8], 4, 1, 0),
                (3, [3, 1, 4, 1], 5, 1, 0), (4, [9, 3, 9, 4], 5, 1, 0)]
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 24
# the paged cases: repro's 16-block pool (divides data 4) and its 10-block one
PAGED = {"kv": "paged", "block_size": 6, "kv_blocks": 16, "prefill_chunk": 2}
PAGED_10 = {"kv": "paged", "block_size": 6, "kv_blocks": 10}
KERNEL = dict(PAGED, step_mode="tokens", attn_impl="kernel")
# teacher-forced decode at staggered positions (repro's): 10 steps, 4 rows
SERVE_TF_STEPS, SERVE_TF_OFFSETS, SERVE_TF_SEED = 10, (0, 3, 1, 7), 5
# prefix sharing and a preemption: rid 4 is priority 0 and arrives with
# every slot taken, so it evicts rid 3, the template alone, which resumes
# once rid 0 has written the template's blocks: it shares them, and its
# last prompt position lies in a shared block, copied before it is written
TEMPLATE = [7, 3, 9, 2, 5, 1, 8, 6]
SHARE_STREAM = [(0, TEMPLATE + [4, 4, 1], 6, 2, 0), (1, [2, 9, 6], 8, 2, 0),
                (2, [5, 5, 3, 7, 1], 8, 2, 0), (3, list(TEMPLATE), 6, 2, 0),
                (4, [6, 1, 2], 4, 0, 1)]
SHARE = {"kv": "paged", "block_size": 4, "kv_blocks": 24, "prefill_chunk": 4}
# every served family on (4 x 2), each against repro's unsharded server.
# MoE runs every activation in f32 (``uncast``, f32 weights) in both
# packages, as tests/test_torch_serving_moe.py holds the unsharded server
# token for token: in bf16 the two packages' routers may flip a route
FAMILIES = {"minicpm3-4b": [{}, PAGED], "hymba-1.5b": [{}], "rwkv6-3b": [{}],
            "olmoe-1b-7b": [{"f32": True}]}


def run_arrivals(server, stream, request):
    """Step ``server`` through ``stream`` ((rid, prompt, new tokens,
    priority, arrival step)), each request submitted at its arrival step;
    {rid: its tokens} of the terminal requests. ``request`` is the server's
    package's ``Request``."""
    pending = sorted(stream, key=lambda r: (r[4], r[0]))
    i = 0
    while i < len(pending) or server.queue or any(r is not None for r in server.active):
        while i < len(pending) and pending[i][4] <= server.step_no:
            rid, prompt, new, prio, _ = pending[i]
            server.submit(request(rid, list(prompt), new, priority=prio))
            i += 1
        server.step()
    return {r.rid: list(r.out) for r in server.finished}


def serve_tf_tokens(vocab: int):
    """The teacher-forced decode's tokens (steps, rows) and row offsets."""
    rng = np.random.default_rng(SERVE_TF_SEED)
    return rng.integers(1, vocab, (SERVE_TF_STEPS, len(SERVE_TF_OFFSETS))).astype(np.int32), \
        np.asarray(SERVE_TF_OFFSETS, np.int32)


def _cache_layout(server):
    """Each cache leaf's placements and local shape, by segment and key."""
    from repro_torch.dist import meshes

    return [{k: (placements(c), tuple(meshes.local(c).shape)) for k, c in seg.items()}
            for seg in server.cache]


def _serve_on_mesh(cfg, params, specs, mesh, device, stream, **kw):
    """``stream`` through a server on ``mesh``: its tokens, decision and
    construction fallbacks, cache layout, metrics, collectives over the run
    and rank-0 disagreements."""
    from repro_torch.dist import meshes
    from repro_torch.serve.serving import BatchedServer, Request

    meshes.clear_fallbacks()
    srv = BatchedServer(cfg, params, batch_slots=kw.pop("batch_slots", SERVE_SLOTS),
                        max_seq=SERVE_MAX_SEQ, mesh=mesh, param_specs=specs, device=device,
                        **kw)
    fallbacks = meshes.fallbacks()
    meshes.reset_collectives()
    outs = run_arrivals(srv, stream, Request)
    m = srv.metrics
    return {"outs": outs, "path": srv.last_sharded_path, "fallbacks": fallbacks,
            "layout": _cache_layout(srv), "attn_impl": srv.attn_impl,
            "step_mode": srv.step_mode, "steps": m.steps, "finished": m.finished,
            "admitted": m.admitted, "preemptions": m.preemptions,
            "cow_splits": m.cow_splits, "prefix_hits": m.prefix_hits,
            "kv_blocks_peak": m.kv_blocks_peak, "kv_bytes_written": m.kv_bytes_written,
            "collectives": dict(meshes.COLLECTIVES), "disagreements": srv.rank_disagreements}


def _serve_inputs(arch, workdir, device, dtype=None):
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model_zoo
    from repro_torch.models.params import params_from_numpy

    cfg = get_reduced_config(arch)
    weights = torch.load(os.path.join(workdir, "serve_weights.pt"), weights_only=False)[arch]
    _, specs = model_zoo.init_params(cfg, 0, "cpu")
    return cfg, params_from_numpy(cfg, weights, device=device,
                                  dtype=dtype or torch.bfloat16), specs


def case_serve_mesh(rank, world, workdir, device):
    """repro's 8-device serving scripts on (4 x 2) from the parent's numpy
    weights of reduced internlm2-20b: the teacher-forced decode over the
    placed dense cache, the 5-request stream and its last request alone,
    the paged pool over data (16 blocks) and its 10-block fallback, and the
    kernel path (pool replicated, heads split)."""
    import torch

    from repro_torch.dist import meshes
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer

    forbidden = _guard_collectives()
    cfg, params, specs = _serve_inputs("internlm2-20b", workdir, device)
    mesh = meshes.make_mesh((world // 2, 2), ("data", "model"), device=device)
    out = {}
    srv = BatchedServer(cfg, params, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, mesh=mesh,
                        param_specs=specs, device=device)
    toks, offsets = serve_tf_tokens(cfg.vocab_size)
    decode, logits = model_zoo.decode_fn(cfg), []
    with meshes.use_mesh(mesh):
        for t in range(SERVE_TF_STEPS):
            lg, _ = decode(srv.params, torch.from_numpy(toks[t]).to(device), srv.cache,
                           torch.from_numpy(offsets + t).to(device))
            logits.append(lg[:, :cfg.vocab_size].float().cpu().numpy())
    out["tf_logits"] = np.stack(logits)
    out["tf_layout"] = _cache_layout(srv)
    del srv
    out["dense"] = _serve_on_mesh(cfg, params, specs, mesh, device, SERVE_STREAM)
    out["solo"] = _serve_on_mesh(cfg, params, specs, mesh, device, SERVE_STREAM[-1:])
    out["paged"] = _serve_on_mesh(cfg, params, specs, mesh, device, SERVE_STREAM, **PAGED)
    out["paged_10"] = _serve_on_mesh(cfg, params, specs, mesh, device, SERVE_STREAM,
                                     **PAGED_10)
    out["kernel"] = _serve_on_mesh(cfg, params, specs, mesh, device, SERVE_STREAM, **KERNEL)
    out["forbidden"] = list(forbidden)
    return out


def case_serve_families(rank, world, workdir, device):
    """Every served family on (4 x 2) from the parent's numpy weights
    (FAMILIES), and prefix sharing with a copy-on-write block and a
    preemption on reduced internlm2-20b (SHARE_STREAM): the tokens, the
    copies that crossed ranks."""
    import torch

    from repro_torch.dist import meshes
    from repro_torch.serve import serving

    forbidden = _guard_collectives()
    mesh = meshes.make_mesh((world // 2, 2), ("data", "model"), device=device)
    out = {}
    for arch, modes in FAMILIES.items():
        out[arch] = []
        for kw in modes:
            kw = dict(kw)
            f32 = kw.pop("f32", False)
            undo = uncast() if f32 else None
            try:
                cfg, params, specs = _serve_inputs(arch, workdir, device,
                                                   torch.float32 if f32 else None)
                out[arch].append(_serve_on_mesh(cfg, params, specs, mesh, device,
                                                SERVE_STREAM, **kw))
            finally:
                if undo is not None:
                    undo()
    crossed, real = [], serving._copy_blocks_across

    def spy(pool, pairs):
        n = meshes.region(pool)[1].stop - meshes.region(pool)[1].start
        crossed.extend((a, b) for a, b in pairs if a // n != b // n)
        return real(pool, pairs)

    serving._copy_blocks_across = spy
    cfg, params, specs = _serve_inputs("internlm2-20b", workdir, device)
    try:
        out["share"] = _serve_on_mesh(cfg, params, specs, mesh, device, SHARE_STREAM, **SHARE)
    finally:
        serving._copy_blocks_across = real
    out["share"]["crossed"] = crossed
    out["forbidden"] = list(forbidden)
    return out



def case_serve_card(rank, world, workdir, device):
    """The sharded server on the card's gloo ranks from the parent's numpy
    weights of reduced internlm2-20b: (1 x world) on the kernel path (B5 at
    its share of the KV heads, its launches counted) and (world x 1) on
    dense caches through the gather path (slots over data)."""
    from repro_torch.dist import meshes
    from repro_torch.kernels.paged_attn import kernel as pa_kernel

    forbidden = _guard_collectives()
    cfg, params, specs = _serve_inputs("internlm2-20b", workdir, device)
    out = {}
    for name, shape, kw in (("kernel", (1, world), KERNEL), ("dense", (world, 1), {})):
        mesh = meshes.make_mesh(shape, ("data", "model"), device=device)
        pa_kernel.paged_attention.launches = 0
        out[name] = _serve_on_mesh(cfg, params, specs, mesh, device, SERVE_STREAM, **kw)
        out[name]["launches"] = pa_kernel.paged_attention.launches
    out["forbidden"] = list(forbidden)
    return out


def case_encdec_mesh(rank, world, workdir, device):
    """Reduced seamless-m4t-medium's decode step on (world/2 x 2) from the
    parent's numpy weights, caches and inputs, the caches placed as the
    dry-run places them (``dryrun._place_cache``): layer 0's cross attention
    over its placed cross K/V, the joins it issued, and the whole step's
    logits."""
    import torch

    from repro_torch.dist import meshes
    from repro_torch.launch import dryrun
    from repro_torch.models import attention, model_zoo
    from repro_torch.models.transformer import _layer

    forbidden = _guard_collectives()
    cfg, params, _ = _serve_inputs("seamless-m4t-medium", workdir, device)
    inp = np.load(os.path.join(workdir, "encdec_inputs.npz"))
    cache = {k: torch.from_numpy(inp[k]).to(device, torch.bfloat16) for k in ENCDEC_CACHE}
    mesh = meshes.make_mesh((world // 2, 2), ("data", "model"), device=device)
    with meshes.use_mesh(mesh):
        placed = dryrun._place_cache(cache, mesh)
        c0 = _layer(placed, 0)
        x = torch.from_numpy(inp["x"]).to(device, torch.bfloat16)
        meshes.reset_collectives()
        cross = attention.cross_decode(_layer(params["dec"], 0)["cross"], x,
                                       {"k": c0["xk"], "v": c0["xv"]}, cfg)
        joins = dict(meshes.COLLECTIVES)
        logits, _ = model_zoo.decode_fn(cfg)(params, torch.from_numpy(inp["tokens"]).to(device),
                                             placed, torch.from_numpy(inp["pos"]).to(device))
    return {"cross": cross.float().cpu().numpy(), "joins": joins,
            "logits": logits[:, :cfg.vocab_size].float().cpu().numpy(),
            "layout": {k: (placements(c), tuple(meshes.local(c).shape))
                       for k, c in placed.items()},
            "forbidden": list(forbidden)}


# the enc-dec decode cache's leaves, as ``model_zoo.make_cache`` names them
ENCDEC_CACHE = ("k", "v", "xk", "xv")

CASES = {"engine": case_engine, "train_mesh": case_train_mesh,
         "train_families": case_train_families, "elastic": case_elastic,
         "lm_card": case_lm_card, "serve_mesh": case_serve_mesh,
         "serve_families": case_serve_families, "serve_card": case_serve_card,
         "encdec_mesh": case_encdec_mesh}


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
