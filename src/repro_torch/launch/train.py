"""Training launcher of the port (counterpart of ``repro.launch.train``,
which it is held against).

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --steps 200 --batch 8 --seq 512 --remat full --data-path pages

``--data-path pages`` stores the token sequences as 32 KB heap pages and
decodes each batch on the device with the strider kernel B1 (the paper's data
path); ``synthetic`` draws them per step. The weights are random f32 masters
drawn on the device from ``--seed``. ``--device`` defaults to ``cuda``;
without a card the launcher raises unless ``--device cpu`` is given (with
``--reduced`` that runs in seconds). The port trains every family:
rwkv6-3b, the dense GQA and MLA attention models such as minicpm3-4b,
hymba-1.5b, the MoE models (``--arch olmoe-1b-7b``; deepseek-v3-671b at
``--reduced`` size, its multi-token-prediction loss included: 715 B
parameters do not fit one card), and from ``--data-path synthetic`` the VLM
(internvl2-26b, its patches) and the encoder-decoder model
(seamless-m4t-medium, its frames). As in the reference, the page data path
gives those two no patches or frames, and their loss raises ``KeyError``.

Like the reference, ``--microbatch`` is parsed and not passed on: the train
loop always steps with one microbatch.

The mesh flags are the reference's (``--mesh host`` by default,
``--model-parallel N``): the run goes through ``meshes.use_mesh`` with the
weights placed by their logical specs (``run(param_specs=)``). A lone
process gets the (1, 1) mesh, which trains to the same bits as ``--mesh
none``. Started by torchrun (``WORLD_SIZE`` > 1 and ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` set), each process is a gloo rank of a
(world / N, N) mesh: it takes its rows of every batch, its slice of the
moments, and rank 0 alone prints the summary and writes ``--bench-out``
and the checkpoints; on the page data path each rank keeps its own copy of
the token heap. For example, two ranks of the CPU::

    WORLD_SIZE=2 RANK=0 MASTER_ADDR=localhost MASTER_PORT=29511 \
        python -m repro_torch.launch.train --arch rwkv6-3b --reduced --device cpu &
    WORLD_SIZE=2 RANK=1 MASTER_ADDR=localhost MASTER_PORT=29511 \
        python -m repro_torch.launch.train --arch rwkv6-3b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import PageTokenDataset, synthetic_data_fn
from repro_torch.dist import meshes
from repro_torch.launch import common
from repro_torch.models import model_zoo
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import PreemptionGuard, TrainLoopConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--data-path", default="synthetic",
                    choices=["synthetic", "pages"],
                    help="'pages' = DB-page-backed tokens decoded on the device "
                         "by the strider kernel (the paper's data path)")
    # training always ran over the host mesh; --mesh none opts out
    common.add_mesh_flags(ap, default_mesh="host")
    common.add_bench_out_flag(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = common.mesh_from_args(args)
    say = print if common.is_rank0() else (lambda *a, **k: None)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    say(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}): "
        f"{cfg.n_params()/1e6:.1f}M params on {device}")

    params, specs = model_zoo.init_params(cfg, args.seed, device,
                                          dtype=getattr(torch, cfg.param_dtype))

    if args.data_path == "pages":
        heap = "tokens.heap" if common.is_rank0() else f"tokens.{dist.get_rank()}.heap"
        ds = PageTokenDataset(
            os.path.join(args.ckpt_dir, heap), n_seqs=max(args.batch * 8, 64),
            seq_len=args.seq, vocab=cfg.vocab_size, seed=args.seed, device=device,
        )
        data_fn = lambda step: ds.batch(step, args.batch)
    else:
        data_fn = synthetic_data_fn(cfg, args.batch, args.seq, device=device)

    loop_cfg = TrainLoopConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        async_checkpoint=args.async_ckpt,
        grad_compression=args.grad_compression,
    )
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(50, args.steps // 4 + 1))
    guard = PreemptionGuard(install=True)

    with meshes.use_mesh(mesh):
        params, opt_state, history = run(
            model_zoo.loss_fn(cfg, remat=args.remat),
            params,
            data_fn,
            loop_cfg,
            opt_cfg,
            preemption=guard,
            hooks=[lambda r: say(
                f"  step {r['step']:5d}  loss {r['loss']:.4f}  "
                f"gnorm {r['grad_norm']:.3f}  {r['s_per_step']*1e3:.0f} ms/step"
            )],
            param_specs=specs,
        )
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        say(f"[train] loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})")
    if not common.is_rank0():
        return history
    common.write_bench_out(args, {
        "arch": cfg.name,
        "steps": len(history),
        "loss_first": history[0]["loss"] if history else None,
        "loss_last": history[-1]["loss"] if history else None,
        "mean_s_per_step": (sum(r["s_per_step"] for r in history)
                            / len(history)) if history else None,
    })
    return history


if __name__ == "__main__":
    main()
