#!/usr/bin/env python3
"""rwkv6-3b at its published width (d_model 2,560, vocab 65,536), its depth
cut, trained for a few steps by both packages' train loops on the CPU from
the same weights and the same batches: each step's loss and gradient norm
side by side.

Both packages start from ``repro``'s numpy weights (``init_params`` with
``PRNGKey(SEED)``), the port's carried across by ``params_from_numpy(...,
dtype=torch.float32)``; the batches are each package's
``synthetic_data_fn`` (the same numbers); AdamW at lr 3e-4 with 2 warmup
steps, ``remat="none"``, as the card's training phase runs. Each package
runs in a process of its own, one after the other, so the peak memory is
one package's (about 8 GB of f32 weights, gradients and moments at 2
layers, besides the activations and the f32 logits of rows x 512 x
65,536).

``--activations f32`` (the default) keeps the embedding and the unembedding
in f32 in both packages, as ``tests/test_torch_train.py``'s
``test_train_loop_follows_repro_over_steps`` does, so that only the order
of sums differs and that test's tolerances (loss rtol 1e-4, gradient norm
rtol 1e-3) apply; ``bf16`` runs the packages as they ship.

    PYTHONPATH=src python tools/fullwidth_loss.py --layers 2 --rows 8 --steps 3

prints a line per step and, last, one JSON object with both runs, their
seconds and peak resident memory, and whether they agree within the
tolerances. It takes minutes and some 20-30 GB: it is a tool, not a test.
"""
import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "rwkv6-3b"
SEED = 0
LR = 3e-4
WARMUP = 2
# test_train_loop_follows_repro_over_steps' tolerances (f32 activations);
# the bf16 loss tolerance of test_torch_rwkv.BF16_LOSS for --activations bf16
TOL = {"f32": {"loss_rtol": 1e-4, "grad_norm_rtol": 1e-3},
       "bf16": {"loss_rtol": 2e-2, "grad_norm_rtol": 5e-2}}


def _uncast_repro():
    import jax.numpy as jnp

    from repro.models import model_zoo, transformer

    for mod in (transformer, model_zoo):
        mod.embed = lambda p, t, cfg: jnp.take(p["table"], t, axis=0)
        mod.unembed = lambda p, x, cfg: x @ p["unembed"]


def _uncast_port():
    from repro_torch.models import model_zoo, transformer

    transformer.embed = lambda p, t, cfg: p["table"][t]
    transformer.unembed = lambda p, x, cfg: x @ p["unembed"]
    model_zoo.unembed = lambda p, x, cfg: x @ p["unembed"]


def _repro_weights(layers):
    import dataclasses

    import jax
    import numpy as np

    from repro.configs import get_config
    from repro.models import model_zoo

    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    params, _ = model_zoo.init_params(cfg, jax.random.PRNGKey(SEED))
    return cfg, jax.tree.map(np.asarray, params)


def run_package(package, layers, rows, seq, steps, activations, workdir):
    """One package's run: (history, seconds of the loop)."""
    import dataclasses

    _, npt = _repro_weights(layers)
    if package == "repro":
        import jax

        from repro.configs import get_config
        from repro.data.pipeline import synthetic_data_fn
        from repro.models import model_zoo
        from repro.train.optimizer import OptConfig
        from repro.train.train_loop import TrainLoopConfig, run

        if activations == "f32":
            _uncast_repro()
        cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
        params = jax.tree.map(jax.numpy.asarray, npt)
        data = synthetic_data_fn(cfg, rows, seq)
    else:
        import torch

        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import synthetic_data_fn
        from repro_torch.models import model_zoo
        from repro_torch.models.params import params_from_numpy
        from repro_torch.train.optimizer import OptConfig
        from repro_torch.train.train_loop import TrainLoopConfig, run

        if activations == "f32":
            _uncast_port()
        cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
        params = params_from_numpy(cfg, npt, device="cpu", dtype=torch.float32)
        data = synthetic_data_fn(cfg, rows, seq, device="cpu")
    del npt
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=10**6, log_every=1,
                           ckpt_dir=os.path.join(workdir, package))
    t0 = time.perf_counter()
    _, _, hist = run(model_zoo.loss_fn(cfg, remat="none"), params, data, loop,
                     OptConfig(lr=LR, warmup_steps=WARMUP))
    return hist, time.perf_counter() - t0


def _child(args):
    hist, seconds = run_package(args.package, args.layers, args.rows, args.seq, args.steps,
                                args.activations, args.workdir)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print("RESULT " + json.dumps({
        "package": args.package, "seconds": seconds, "peak_rss_bytes": peak,
        "loss": [r["loss"] for r in hist], "grad_norm": [r["grad_norm"] for r in hist],
        "steps": [r["step"] for r in hist]}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--activations", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--package", choices=["repro", "port"], default=None,
                    help="run one package in this process (the parent runs both)")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    if args.package:
        return _child(args)

    workdir = args.workdir or tempfile.mkdtemp(prefix="fullwidth_loss_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    runs = {}
    t0 = time.perf_counter()
    for package in ("repro", "port"):
        cmd = [sys.executable, os.path.abspath(__file__), "--package", package,
               "--layers", str(args.layers), "--rows", str(args.rows), "--seq", str(args.seq),
               "--steps", str(args.steps), "--activations", args.activations,
               "--workdir", workdir]
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise SystemExit(f"{package}: exit {proc.returncode}")
        line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
        runs[package] = json.loads(line[len("RESULT "):])
    tol = TOL[args.activations]
    rows = []
    for i, step in enumerate(runs["repro"]["steps"]):
        jl, tl = runs["repro"]["loss"][i], runs["port"]["loss"][i]
        jg, tg = runs["repro"]["grad_norm"][i], runs["port"]["grad_norm"][i]
        rows.append({"step": step, "loss": [jl, tl], "grad_norm": [jg, tg],
                     "loss_rel": abs(tl - jl) / abs(jl), "grad_norm_rel": abs(tg - jg) / abs(jg)})
        print(f"step {step}: loss repro {jl:.6f} port {tl:.6f} (rel {rows[-1]['loss_rel']:.2e}); "
              f"grad norm repro {jg:.6f} port {tg:.6f} (rel {rows[-1]['grad_norm_rel']:.2e})")
    agree = all(r["loss_rel"] <= tol["loss_rtol"] and r["grad_norm_rel"] <= tol["grad_norm_rtol"]
                for r in rows)
    print(json.dumps({"arch": ARCH, "layers": args.layers, "rows": args.rows, "seq": args.seq,
                      "steps": args.steps, "activations": args.activations, "lr": LR,
                      "warmup": WARMUP, "tolerance": tol, "agree": agree, "per_step": rows,
                      "seconds": {p: runs[p]["seconds"] for p in runs},
                      "peak_rss_bytes": {p: runs[p]["peak_rss_bytes"] for p in runs},
                      "wall_s": time.perf_counter() - t0}))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
