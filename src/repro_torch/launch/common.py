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
executor cannot run it. ``launch/train.py`` and ``launch/serve.py`` take
no mesh flags yet: they wait for LM training on a mesh and the sharded
server (ROADMAP A19b, A19c).

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


def mesh_from_args(args):
    """The mesh the flags asked for: a host mesh on ``args.device`` (the
    card unless it says ``cpu``), or None (unsharded)."""
    if getattr(args, "mesh", "none") != "host":
        return None
    from repro_torch.dist import meshes

    return meshes.make_host_mesh(model_parallel=args.model_parallel,
                                 device=getattr(args, "device", None))


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
