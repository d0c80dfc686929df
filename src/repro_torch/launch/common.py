"""Shared CLI flag vocabulary for the port's launchers (counterpart of
``repro.launch.common``, which it is held against): the same concept is
spelled the same way, with the same default, in every launcher:

  mesh flags       ``--mesh none|host`` + ``--model-parallel N``
                   (``mesh_from_args`` builds the host mesh or returns None)
  kv flags         ``--kv dense|paged`` + ``--block-size`` + ``--kv-blocks``
                   + ``--prefix-cache``
  scheduler flags  ``--scheduler`` + ``--deadline-ttft`` / ``--deadline``;
                   with ``serving=True`` also ``wdrr``, ``--tenant-weights``,
                   ``--high-frac`` and the fault knobs
  bench output     ``--bench-out PATH`` writing a JSON rollup

``launch/score.py`` offers ``--scheduler priority|fifo`` only: ``wdrr``
weighs a request by its prompt, a SQL statement has none, so the query
executor cannot run it. ``launch/train.py`` takes the mesh flags (default
``--mesh host``, as in the reference): under torchrun's variables
(``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
``mesh_from_args`` first opens the default group with gloo (the one
backend that runs two ranks on one card), and a lone process gets the
(1, 1) mesh. ``launch/serve.py`` takes them too (default ``--mesh none``,
as in the reference): on the host mesh it serves with the caches sharded
(``BatchedServer(mesh=)``), each rank the same stream, and rank 0 alone
prints.

Every helper takes the ``argparse.ArgumentParser`` (or a group) and only
*adds* arguments; launchers keep their workload-specific flags alongside.
"""
from __future__ import annotations

import argparse
import json


def add_mesh_flags(ap: argparse.ArgumentParser, *, default_mesh: str = "none") -> None:
    """--mesh / --model-parallel: device-mesh topology, shared vocabulary."""
    ap.add_argument("--mesh", choices=["none", "host"], default=default_mesh,
                    help="host: build a mesh over the ranks of the process "
                         "group (data x model axes)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size of the host mesh")


def init_from_env(device=None) -> bool:
    """Open the default process group with gloo from torchrun's variables
    (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), each
    rank on card ``LOCAL_RANK`` modulo the cards there are unless ``device``
    is the CPU. Returns whether this process is one of several ranks; a
    lone process opens nothing."""
    import os

    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if not dist.is_initialized():
        if torch.device("cuda" if device is None else device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' to run on the CPU")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group("gloo", init_method="env://", world_size=world,
                                rank=int(os.environ["RANK"]))
    return True


def is_rank0() -> bool:
    """Whether this process prints and writes a launcher's summary: a lone
    process, or global rank 0 of the group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_from_args(args):
    """The mesh the flags asked for: a host mesh on ``args.device`` (the
    card unless it says ``cpu``) over the ranks of the default group
    (opened from torchrun's variables where they are set), or None
    (unsharded)."""
    if getattr(args, "mesh", "none") != "host":
        return None
    from repro_torch.dist import meshes

    device = getattr(args, "device", None)
    init_from_env(device)
    return meshes.make_host_mesh(model_parallel=args.model_parallel, device=device)


def add_kv_flags(ap: argparse.ArgumentParser) -> None:
    """--kv / --block-size / --kv-blocks / --prefix-cache: KV cache layout
    (serving)."""
    ap.add_argument("--kv", choices=["dense", "paged"], default="dense",
                    help="paged: block-pool KV cache (serve/kv_pool.py)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged only)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="total blocks in the paged pool (default: "
                         "slots * ceil(max_seq/block_size), i.e. dense-"
                         "equivalent capacity; pass less to oversubscribe)")
    ap.add_argument("--prefix-cache", choices=["auto", "on", "off"],
                    default="auto",
                    help="refcounted prefix-sharing KV blocks (paged). auto = "
                         "on wherever eligible; on records a fallback when "
                         "ineligible")


def prefix_cache_from_args(args) -> bool | None:
    """Map the --prefix-cache tri-state onto BatchedServer's argument
    (None = auto: enabled wherever the layout is eligible)."""
    return {"auto": None, "on": True, "off": False}[args.prefix_cache]


def parse_tenant_weights(spec: str | None) -> dict | None:
    """Parse '0=1,1=2,interactive=4' into a tenant->weight dict (keys become
    ints when they look like ints, matching Request.tenant defaults)."""
    if not spec:
        return None
    out: dict = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep or not k:
            raise SystemExit(f"--tenant-weights: bad entry {part!r} "
                             "(want TENANT=WEIGHT,...)")
        key = int(k) if k.strip().lstrip("-").isdigit() else k.strip()
        out[key] = float(v)
    return out


def add_scheduler_flags(ap: argparse.ArgumentParser, *, serving: bool = False) -> None:
    """--scheduler / --deadline-ttft / --deadline: admission policy and
    per-request deadlines. ``serving=True`` adds the ``wdrr`` policy,
    --tenant-weights, --high-frac and the fault-injection knobs."""
    policies = ["priority", "fifo", "wdrr"] if serving else ["priority", "fifo"]
    ap.add_argument("--scheduler", choices=policies, default="priority",
                    help="fifo = submission order, no preemption (ablation)"
                         + ("; wdrr = weighted deficit round robin over tenants "
                            "under the priority classes (--tenant-weights)"
                            if serving else ""))
    ap.add_argument("--deadline-ttft", type=float, default=None,
                    help="per-request time-to-first-output budget in "
                         "seconds (miss = cancel)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request end-to-end budget in seconds")
    if not serving:
        return
    ap.add_argument("--tenant-weights", default=None, metavar="T=W,...",
                    help="per-tenant wdrr weights, e.g. '0=1,1=2,2=4' "
                         "(unlisted tenants weigh 1)")
    ap.add_argument("--high-frac", type=float, default=0.0,
                    help="fraction of the stream in the interactive class "
                         "(priority 0; the rest are priority 2)")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="replay FaultPlan.random(SEED) against the run "
                         "(seeded chaos: pool shrinkage, forced preempts, "
                         "admission stalls)")
    ap.add_argument("--fault-horizon", type=int, default=24,
                    help="steps of injected chaos before the plan heals")


def add_bench_out_flag(ap: argparse.ArgumentParser) -> None:
    """--bench-out: where to write the run's JSON metrics rollup."""
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="write the run's metrics rollup as JSON to PATH")


def write_bench_out(args, payload: dict) -> None:
    """Write the rollup if --bench-out was given (no-op otherwise)."""
    path = getattr(args, "bench_out", None)
    if path:
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[bench] wrote {path}")
