"""Serving launcher of the port: continuous-batching decode on the card
(counterpart of ``repro.launch.serve``, which it is held against).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
        --kv paged --batch 8 --requests 16 --prefill-chunk 16

Every decoder-only family the port serves takes the same flags: GQA
(mistral-nemo-12b, internlm2-20b, ...), MLA (``--arch minicpm3-4b``,
whose kernel path runs the absorbed-latent attention on B5), MoE
(``--arch olmoe-1b-7b``: 13.8 GB of bf16 weights, token stepping falls
back to chunked stepping; deepseek-v3-671b at ``--reduced`` size), the
hybrid (``--arch hymba-1.5b``) and RWKV6 (``--arch rwkv6-3b``). Submit more
requests than slots (``--requests``) to exercise mid-run admission. ``--kv paged`` swaps the dense per-slot cache for the block-pool
layout (``--block-size`` tokens per block, ``--kv-blocks`` total, by default
dense-equivalent capacity); ``--prefill-chunk C`` feeds C prompt tokens per
fused step. ``--attn-impl`` picks the paged attention read path: ``kernel``
(default, the block-table kernel B5; the reference's ``pallas``) or
``gather``; a dense cache serves gather and records the fallback. Prints the
``serve.metrics`` rollup (occupancy, tok/s, TTFT, paged blocks in use).

Scheduling knobs: ``--high-frac 0.25`` marks ~25% of the stream as the
interactive class (priority 0; the rest priority 2) so preemption has
something to preempt for; ``--scheduler fifo`` is the no-preemption
ablation; ``--scheduler wdrr`` adds weighted tenant shares
(``--tenant-weights 0=1,1=2``); ``--deadline-ttft`` / ``--deadline`` attach
wall-clock budgets to every request. ``--fault-seed N`` replays the seeded
chaos schedule ``FaultPlan.random(N)`` against the run. ``--trace-seed N``
replays a synthetic production trace (``serve.faults.synth_trace``) against
the server's step clock instead of the uniform stream.

The weights are random, drawn on the device from ``--seed``. ``--device``
defaults to ``cuda``; without a card the launcher raises unless
``--device cpu`` is given (with ``--reduced`` that runs in seconds).

``--mesh host`` (default ``none``) serves with the caches sharded over the
ranks of the host mesh, ``--model-parallel`` of them on the model axis
(``BatchedServer(mesh=, param_specs=)``). Under torchrun's variables
(``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) each rank
opens the default group with gloo and serves the same stream; rank 0 alone
prints the summary, with ``mesh=... path=...``, and writes ``--bench-out``::

    WORLD_SIZE=2 RANK=0 MASTER_ADDR=localhost MASTER_PORT=29511 \
        PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-20b \
        --reduced --device cpu --mesh host --model-parallel 2 &
    WORLD_SIZE=2 RANK=1 MASTER_ADDR=localhost MASTER_PORT=29511 \
        PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-20b \
        --reduced --device cpu --mesh host --model-parallel 2
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.launch import common
from repro_torch.models import model_zoo
from repro_torch.serve.faults import FaultPlan, replay_trace, synth_trace
from repro_torch.serve.serving import BatchedServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="decode batch slots")
    ap.add_argument("--requests", type=int, default=None,
                    help="total requests to stream (default: one per slot)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--admission", choices=["continuous", "drain"],
                    default="continuous",
                    help="drain = static-batch ablation (refill only when "
                         "the whole batch finished)")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt tokens fed per fused step (chunked prefill)")
    ap.add_argument("--attn-impl", choices=["gather", "kernel"], default="kernel",
                    help="paged attention read path: the block-table kernel "
                         "or the padded gather")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--trace-seed", type=int, default=None,
                    help="replay synth_trace(SEED) instead of the uniform "
                         "stream (bursty tenants, heavy tails, shared "
                         "prompt templates)")
    ap.add_argument("--trace-steps", type=int, default=24,
                    help="arrival horizon of the synthetic trace in steps")
    ap.add_argument("--trace-tenants", type=int, default=2,
                    help="tenants in the synthetic trace (weights default "
                         "to 2**tenant unless --tenant-weights is given)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the server runs on (cpu: the plain "
                         "versions of the kernels)")
    common.add_mesh_flags(ap)
    common.add_kv_flags(ap)
    common.add_scheduler_flags(ap, serving=True)
    common.add_bench_out_flag(ap)
    args = ap.parse_args(argv)

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("BatchedServer serves decoder-only families")
    mesh = common.mesh_from_args(args)
    params, specs = model_zoo.init_params(cfg, seed=args.seed, device=args.device)

    rng = np.random.default_rng(args.seed)
    weights = common.parse_tenant_weights(args.tenant_weights)
    trace = None
    if args.trace_seed is not None:
        trace = synth_trace(args.trace_seed, steps=args.trace_steps,
                            tenants=args.trace_tenants,
                            vocab=min(64, cfg.vocab_size - 1),
                            max_prompt=args.prompt_len + 16,
                            max_new=args.max_new, weights=weights)
        if weights is None:
            weights = trace.tenant_weights
        max_seq = args.prompt_len + 16 + args.max_new + 1
    else:
        max_seq = args.prompt_len + args.max_new + 1
    plan = (FaultPlan.random(args.fault_seed, horizon=args.fault_horizon)
            if args.fault_seed is not None else None)
    server = BatchedServer(cfg, params, batch_slots=args.batch, max_seq=max_seq,
                           temperature=args.temperature, seed=args.seed,
                           mesh=mesh, param_specs=specs if mesh is not None else None,
                           admission=args.admission, kv=args.kv,
                           block_size=args.block_size, kv_blocks=args.kv_blocks,
                           prefill_chunk=args.prefill_chunk,
                           attn_impl=args.attn_impl,
                           scheduler=args.scheduler, fault_plan=plan,
                           prefix_cache=common.prefix_cache_from_args(args),
                           tenant_weights=weights, device=args.device)
    if trace is not None:
        n_requests = len(trace)
        done = replay_trace(server, trace, max_steps=args.max_steps or 2000)
    else:
        n_requests = args.requests if args.requests is not None else args.batch
        hi = rng.random(n_requests) < args.high_frac
        for i in range(n_requests):
            prompt = rng.integers(1, cfg.vocab_size, args.prompt_len).tolist()
            server.submit(Request(rid=i, prompt=prompt,
                                  max_new_tokens=args.max_new,
                                  priority=0 if hi[i] else 2,
                                  deadline_ttft_s=args.deadline_ttft,
                                  deadline_s=args.deadline))
        done = server.run(max_steps=args.max_steps)
    if not common.is_rank0():
        return done
    m = server.metrics
    mesh_desc = f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} " \
        f"path={server.last_sharded_path}" if mesh is not None else ""
    kv_desc = (f" kv=paged blocks {m.kv_blocks_peak}/{m.kv_blocks_total} "
               f"({m.kv_blocks_peak_pct:.0f}% peak) attn={server.attn_impl}"
               if server.kv_mode == "paged" else "")
    ttft = (f"{m.mean_ttft_s*1e3:.0f}ms/{m.mean_ttft_steps:.0f} steps"
            if m.mean_ttft_s is not None else "n/a")
    print(f"[serve] {cfg.name} on {server.device}: {m.finished}/{n_requests} requests, "
          f"{m.tokens_generated} tokens in {m.wall_s:.2f}s "
          f"({m.tok_per_s:.1f} tok/s, occupancy {m.occupancy_pct:.0f}%, "
          f"mean TTFT {ttft}){kv_desc}{mesh_desc}")
    if (m.preemptions or m.deadline_misses or m.rejected
            or plan is not None or args.high_frac > 0):
        hi_ttft = m.mean_prio_ttft_e2e_steps(0)
        hi_desc = (f", interactive TTFT {hi_ttft:.1f} e2e steps"
                   if hi_ttft is not None else "")
        print(f"[sched] scheduler={args.scheduler} "
              f"preemptions={m.preemptions} "
              f"recompute_tokens={m.recompute_tokens} "
              f"deadline_misses={m.deadline_misses} "
              f"rejected={m.rejected}{hi_desc}"
              + (f" faults_applied={len(plan.applied)}"
                 if plan is not None else ""))
    if server.prefix_cache and m.admitted:
        print(f"[prefix] hits={m.prefix_hits}/{m.admitted} admissions, "
              f"{m.prefix_tokens} prompt tokens served from resident blocks, "
              f"{m.cow_splits} COW splits, "
              f"{m.kv_bytes_per_token / 1024:.1f} KiB of KV written per token")
    if trace is not None and m.per_tenant:
        shares = {t: v["tokens_generated"]
                  for t, v in sorted(m.per_tenant.items())}
        print(f"[trace] {len(trace)} arrivals over {args.trace_steps} steps "
              f"(shared-template fraction {trace.shared_fraction():.2f}), "
              f"tokens by tenant {shares}")
    for r in done[:4]:
        print(f"  req {r.rid}: {r.out[:12]}{'...' if len(r.out) > 12 else ''}")
    common.write_bench_out(args, {"arch": cfg.name, "device": str(server.device),
                                  "serving": m.as_dict()})
    return done


if __name__ == "__main__":
    main()
