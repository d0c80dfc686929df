"""End-to-end driver: train a small LM for a few hundred steps with
checkpoints, then kill and resume to show fault tolerance (counterpart of
``examples/train_lm.py``, which it is held against).

The model is the internlm2 family at width 512, 8 layers, vocab 32,000
(``--small``: width 128, 4 layers, vocab 8,000): the 20B config's code
path, only the dataclass numbers differ. Its f32 weights are drawn by
``model_zoo.init_params(cfg, 0, device, dtype=torch.float32)`` (the
example's key 0; a ``torch.Generator`` draws other numbers than
``PRNGKey(0)``). The data comes from the page-backed pipeline: 256 token
sequences stored in 32 KB slotted pages, decoded on the card by B1 every
step (the paper's technique feeding an LM); the attention and the MLP are
plain PyTorch, as ``repro``'s are plain ``jnp``, so B1 is the one kernel.

Phase 1 trains to 60% of the steps with an async checkpoint every quarter
of them; a "preemption" follows, and phase 2 resumes from the latest
checkpoint to the budget. As in the example, ``--steps`` under 4 makes the
checkpoint interval 0, and the loop raises ``ZeroDivisionError``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 200] [--small]
        [--device cpu]

``--device`` defaults to ``cuda``; without a card it raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

# the example's sizes, seed and optimizer
SEED = 0
N_SEQS = 256
PREEMPT_AT = 0.6
LR = 3e-4
WARMUP_STEPS = 20
LOG_EVERY = 10
SMALL = dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=8000,
             vocab_pad_multiple=64, name="lm-8m")
LARGE = dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32000,
             vocab_pad_multiple=64, name="lm-100m")


def build_cfg(small: bool):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("internlm2-20b"), **(SMALL if small else LARGE))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default=None,
                    help="the token heap and the checkpoints (default: a temporary directory)")
    return ap


def flow(args, params=None) -> dict:
    """Train, "preempt" and resume on ``args.device``; prints the example's
    lines and returns them with both phases' history, the step each phase
    reached and the count of parameters. ``params`` is the f32 weight tree
    on the device to start from (else drawn from ``SEED``); the loop
    updates it in place."""
    if args.workdir is None:
        with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
            return _flow(args, tmp, params)
    os.makedirs(args.workdir, exist_ok=True)
    return _flow(args, args.workdir, params)


def _flow(args, tmp, params) -> dict:
    import torch

    from repro_torch.core.engine import resolve_device
    from repro_torch.data.pipeline import PageTokenDataset
    from repro_torch.models import model_zoo
    from repro_torch.models.params import count_params
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainLoopConfig, run

    device = resolve_device(args.device)
    out = {"lines": []}

    def say(line):
        out["lines"].append(line)
        print(line, flush=True)

    cfg = build_cfg(args.small)
    if params is None:
        params, _ = model_zoo.init_params(cfg, SEED, device, dtype=torch.float32)
    out["n_params"] = count_params(params)
    say(f"model {cfg.name}: {out['n_params']/1e6:.1f}M params")

    ds = PageTokenDataset(os.path.join(tmp, "tokens.heap"), n_seqs=N_SEQS, seq_len=args.seq,
                          vocab=cfg.vocab_size, device=device)
    say(f"token store: {ds.heap.n_pages} DB pages, decoded on-device per step")

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.steps // 4,
                           ckpt_dir=os.path.join(tmp, "ckpt"), log_every=LOG_EVERY,
                           async_checkpoint=True)
    opt = OptConfig(lr=LR, warmup_steps=WARMUP_STEPS)
    hooks = [lambda r: say(f"  step {r['step']:4d}  loss {r['loss']:.4f}  "
                           f"{r['s_per_step']*1e3:.0f} ms/step")]
    data = lambda s: ds.batch(s, args.batch)  # noqa: E731

    # phase 1: train to 60% of the budget, as if the job were then preempted
    phase1 = dataclasses.replace(loop, total_steps=int(args.steps * PREEMPT_AT))
    _, o1, h1 = run(model_zoo.loss_fn(cfg, remat="none"), params, data, phase1, opt,
                    hooks=hooks)
    out["preempted_at"] = int(o1["step"])
    say(f"-- simulated preemption at step {out['preempted_at']} --")

    # phase 2: a fresh invocation resumes from the checkpoint by itself
    _, o2, h2 = run(model_zoo.loss_fn(cfg, remat="none"), params, data, loop, opt,
                    hooks=hooks)
    out["step"] = int(o2["step"])
    assert out["step"] == args.steps, (out["step"], args.steps)
    out["history"] = h1 + h2
    losses = [r["loss"] for r in out["history"]]
    out["resumed_at"] = h2[0]["step"] - 1 if h2 else None
    say(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps "
        f"(resumed across restart)")
    assert losses[-1] < losses[0], losses
    say("OK")
    return out


def main(argv=None) -> dict:
    """The command line: ``flow`` on the parsed flags; returns its dict."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.engine import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise here
    return flow(args)


if __name__ == "__main__":
    main()
