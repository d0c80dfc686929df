"""Elastic reshard: checkpoint a training job, then restore it onto a
different mesh shape (counterpart of ``examples/elastic_restart.py``, which
it is held against). The checkpoint stores logical arrays, so a job that
loses ranks (or gains them) resumes with shardings resolved again.

    python -m repro_torch.launch.elastic_restart --ranks 8 --device cpu

starts ``--ranks`` gloo ranks of this module (each one thread on the CPU;
on the card every rank binds ``cuda:0``, since NCCL refuses two ranks on
one device), which meet through a ``file://`` store in ``--workdir``. They
train ``--steps`` steps on a (ranks/2 data x 2 model) mesh, save, restore
with ``restore(shardings=)`` onto (2 x ranks/2) and train ``--steps`` more
(``--steps-after``); rank 0 prints each phase's loss, checks that
``opt["step"]`` is their sum and prints ``OK``. The model is the example's,
internlm2-20b reduced to d_model 64 with 4/4 heads; ``--arch``, ``--layers``
(``--full-width`` keeps the published width and cuts only the depth),
``--batch``, ``--seq``, ``--data-path pages`` and the two meshes
(``--mesh-a 4x2 --mesh-b 2x4``) are flags.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import subprocess
import sys
import tempfile
import time

# the example's model: internlm2-20b at this width
EXAMPLE_WIDTH = {"internlm2-20b": dict(d_model=64, n_heads=4, n_kv_heads=4)}
# the example's warmup and seed (its weights are drawn from PRNGKey(0))
WARMUP_STEPS = 2
SEED = 0
RANK_TIMEOUT_S = 900
PG_TIMEOUT_S = 600


def mesh_shape(text: str) -> tuple[int, int]:
    """'4x2' -> (4, 2): (data, model)."""
    data, model = text.lower().split("x")
    return int(data), int(model)


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="internlm2-20b")
    ap.add_argument("--full-width", action="store_true",
                    help="the published width (default: the reduced config)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5, help="steps on the first mesh")
    ap.add_argument("--steps-after", type=int, default=None,
                    help="steps on the second mesh (default: --steps)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--data-path", default="synthetic", choices=["synthetic", "pages"])
    ap.add_argument("--mesh-a", type=mesh_shape, default=None,
                    help="DATAxMODEL of the first mesh (default ranks/2 x 2)")
    ap.add_argument("--mesh-b", type=mesh_shape, default=None,
                    help="DATAxMODEL of the second mesh (default 2 x ranks/2)")
    ap.add_argument("--workdir", default=None, help="store, checkpoint and logs")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def model_config(args):
    from repro_torch.configs import get_config, get_reduced_config

    if args.full_width:
        cfg = get_config(args.arch)
    else:
        cfg = get_reduced_config(args.arch, **EXAMPLE_WIDTH.get(args.arch, {}))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def meshes_of(args):
    a = args.mesh_a or (args.ranks // 2, 2)
    b = args.mesh_b or (2, args.ranks // 2)
    return a, b


class Hooks:
    """What a caller of ``flow`` may watch (each a no-op here): ``start``
    sees the weights before they are placed, their logical specs and the
    optimizer's configuration, ``phase`` and ``step`` are
    context managers around each mesh's steps and around each step (its
    one host read included), ``grads`` sees each step's gradients as the
    update takes them (whole, summed over the ranks: the step's
    ``compress`` hook, which hands them on unchanged), ``end`` sees each
    mesh's state after its steps (before the first mesh's save). ``phase``
    is "a" or "b"."""

    def start(self, params, specs, opt_cfg):
        pass

    def phase(self, phase, mesh):
        return contextlib.nullcontext()

    def step(self, phase, step):
        return contextlib.nullcontext()

    def grads(self, grads):
        pass

    def end(self, phase, mesh, params, opt):
        pass


def flow(args, rank: int, device, weights=None, hooks: Hooks | None = None) -> dict:
    """This rank's part of the example: train on the first mesh, save,
    restore onto the second with ``shardings=``, train on. ``weights`` is a
    numpy tree to start from (else weights drawn from ``SEED``).
    Returns the losses and gradient norms of each phase, the step count
    restored and reached, and the final params and optimizer state."""
    import torch

    from repro_torch.data.pipeline import PageTokenDataset, synthetic_data_fn
    from repro_torch.dist import meshes
    from repro_torch.models import model_zoo
    from repro_torch.models.params import params_from_numpy, tree_map
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (
        OptConfig,
        adamw_init,
        make_train_step,
        param_shardings,
        state_shardings,
    )

    cfg = model_config(args)
    if weights is None:
        params, specs = model_zoo.init_params(cfg, SEED, device, dtype=torch.float32)
    else:
        _, specs = model_zoo.init_params(cfg, SEED, "cpu", dtype=torch.float32)
        params = params_from_numpy(cfg, weights, device=device, dtype=torch.float32)
    if args.data_path == "pages":
        ds = PageTokenDataset(os.path.join(args.workdir, f"tokens.{rank}.heap"),
                              n_seqs=max(args.batch * 8, 64), seq_len=args.seq,
                              vocab=cfg.vocab_size, seed=SEED, device=device)
        data_fn = lambda step: ds.batch(step, args.batch)
    else:
        data_fn = synthetic_data_fn(cfg, args.batch, args.seq, device=device)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=WARMUP_STEPS)
    hooks = hooks or Hooks()

    def seen(grads, error_fb):
        hooks.grads(grads)
        return grads, error_fb

    step_fn = make_train_step(model_zoo.loss_fn(cfg, remat=args.remat), opt_cfg, compress=seen)
    ck_dir = os.path.join(args.workdir, "ck")
    shape_a, shape_b = meshes_of(args)
    steps_b = args.steps if args.steps_after is None else args.steps_after
    out = {"losses": {}, "grad_norms": {}, "meshes": {"a": shape_a, "b": shape_b}}

    def train(phase, mesh, p, opt, first, count):
        losses, norms = [], []
        with hooks.phase(phase, mesh):
            for s in range(first, first + count):
                with hooks.step(phase, s):
                    p, opt, _, m = step_fn(p, opt, data_fn(s), None)
                    losses.append(float(m["loss"]))  # the step's one host read
                norms.append(m["grad_norm"])
        hooks.end(phase, mesh, p, opt)
        out["losses"][phase] = losses
        out["grad_norms"][phase] = [float(x) for x in norms]
        return p, opt

    # phase 1: the first mesh
    mesh_a = meshes.make_mesh(shape_a, ("data", "model"), device=device)
    hooks.start(params, specs, opt_cfg)
    with meshes.use_mesh(mesh_a):
        p = meshes.place_tree(params, param_shardings(params, mesh_a, specs))
        del params
        opt = adamw_init(p, opt_cfg, param_specs=specs)
        p, opt = train("a", mesh_a, p, opt, 0, args.steps)
        t0 = time.perf_counter()
        ckpt.save(ck_dir, args.steps, {"params": p, "opt": opt})
        out["save_s"] = time.perf_counter() - t0

    # phase 2: restore onto the second mesh (as if ranks were lost or gained)
    mesh_b = meshes.make_mesh(shape_b, ("data", "model"), device=device)
    with meshes.use_mesh(mesh_b):
        shardings = {"params": param_shardings(p, mesh_b, specs),
                     "opt": state_shardings(p, opt_cfg, mesh_b, specs)}
        # the template gives the structure and each leaf's device only: the
        # first mesh's state is freed before the second's is loaded
        template = tree_map(lambda t: torch.empty(0, device=meshes.local(t).device),
                            {"params": p, "opt": opt})
        del p, opt
        t0 = time.perf_counter()
        restored, step = ckpt.restore(ck_dir, template, shardings=shardings)
        out["restore_s"] = time.perf_counter() - t0
        p, opt = train("b", mesh_b, restored["params"], restored["opt"], step, steps_b)
        del restored
        out["fallbacks"] = meshes.fallbacks()
    out.update(restored_step=step, step=int(opt["step"]), params=p, opt=opt, specs=specs,
               cfg=cfg, mesh_b=mesh_b)
    return out


def _rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.core.engine import resolve_device

    device = resolve_device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{args.workdir}/store",
                            rank=args.rank, world_size=args.ranks,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = flow(args, args.rank, device)
        want = args.steps + (args.steps if args.steps_after is None else args.steps_after)
        assert out["step"] == want, (out["step"], want)
        if args.rank == 0:
            (da, ma), (db, mb) = out["meshes"]["a"], out["meshes"]["b"]
            print(f"phase 1 on mesh ({da} data x {ma} model): step {args.steps}, "
                  f"loss {out['losses']['a'][-1]:.4f}")
            print(f"phase 2 on mesh ({db} data x {mb} model): resumed at "
                  f"{out['restored_step']}, loss {out['losses']['b'][-1]:.4f}")
            print("OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    from repro_torch.core.engine import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here
    (da, ma), (db, mb) = meshes_of(args)
    if da * ma != args.ranks or db * mb != args.ranks:
        raise SystemExit(f"meshes {da}x{ma} and {db}x{mb} need {args.ranks} ranks each")
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="elastic_")
    os.makedirs(args.workdir, exist_ok=True)
    store = os.path.join(args.workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    argv = list(sys.argv[1:] if argv is None else argv)
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = []
    for rank in range(args.ranks):
        log = open(os.path.join(args.workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.elastic_restart", *argv,
             "--workdir", args.workdir, "--rank", str(rank)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failed = None
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed = (rank, rc)
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
    if failed is not None:
        for rank in range(args.ranks):
            with open(os.path.join(args.workdir, f"rank{rank}.log")) as f:
                sys.stderr.write(f"--- rank {rank} ---\n{f.read()[-3000:]}\n")
        raise SystemExit(f"rank {failed[0]} ended with {failed[1]}")
    with open(os.path.join(args.workdir, "rank0.log")) as f:
        sys.stdout.write(f.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
