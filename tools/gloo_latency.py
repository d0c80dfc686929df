#!/usr/bin/env python3
"""Latency and bandwidth of the collectives the sharded paths make: gloo ranks on
one NVIDIA card, as ``chip_smoke.py``'s train-sharded phase starts them
(each rank bound to cuda:0, gloo over loopback, one CPU thread).

For 1, 2 and 4 ranks, each rank times ``ITERS`` rounds (after 20 of warm-up)
of:

  cuda_all_reduce  a small kernel on a (54,) f32 CUDA tensor, then
                   ``all_reduce`` of it (gloo copies it to the host and back)
  staged_pinned    the kernel, a copy into a pinned host tensor,
                   ``all_reduce`` of that, a non-blocking copy back
  cpu_all_reduce   ``all_reduce`` of a (54,) CPU tensor alone
  gpu_sync_only    the kernel, then ``torch.cuda.synchronize()``: no
                   collective, the cost of several processes taking turns
                   on the card

then, for the LM training step's buckets, ``SIZE_ITERS`` rounds (after one
of warm-up) of ``all_reduce`` and of ``broadcast`` (from rank 0) of f32
CUDA tensors of each of ``--sizes-mb`` (4 to 256 MB: the gradient's
buckets are at most 256 MB), each round ended by ``torch.cuda.synchronize``;

and rank 0 prints one JSON line per world size: microseconds a round,
milliseconds and GB/s (the tensor's bytes over the time) at each size, and
the card's name and power limit.

    python3 tools/gloo_latency.py [--iters 300] [--sizes-mb 4,16,64,256]
"""
import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

FEATURES = 54  # remote_sensing_lr's gradient: the merge a batch sends


SIZE_ITERS = 5


def rank_main(rank: int, world: int, work: str, iters: int, sizes_mb: list[int]) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    x = torch.zeros(FEATURES, device="cuda")
    pinned = torch.zeros(FEATURES, pin_memory=True)
    host = torch.zeros(FEATURES)

    def cuda_all_reduce():
        x.add_(1.0)
        dist.all_reduce(x)

    def staged_pinned():
        pinned.copy_(x.add(1.0))
        dist.all_reduce(pinned)
        x.copy_(pinned, non_blocking=True)

    def cpu_all_reduce():
        dist.all_reduce(host)

    def gpu_sync_only():
        x.add_(1.0)
        torch.cuda.synchronize()

    out = {}
    for name, fn in (("cuda_all_reduce", cuda_all_reduce), ("staged_pinned", staged_pinned),
                     ("cpu_all_reduce", cpu_all_reduce), ("gpu_sync_only", gpu_sync_only)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e6 * (time.perf_counter() - t0) / iters
    by_size = {"all_reduce": {}, "broadcast": {}}
    for mb in sizes_mb:
        big = torch.ones(mb * (1 << 20) // 4, device="cuda")
        for name, fn in (("all_reduce", lambda: dist.all_reduce(big)),
                         ("broadcast", lambda: dist.broadcast(big, src=0))):
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(SIZE_ITERS):
                fn()
                torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / SIZE_ITERS
            by_size[name][mb] = {"ms": ms, "gb_per_s": big.numel() * 4 / ms / 1e6}
        del big
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[0]
        print(json.dumps({"ranks": world, "us_per_round": out, "iters": iters,
                          "cuda_f32_by_mb": by_size, "size_iters": SIZE_ITERS,
                          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                          "torch": torch.__version__}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]),
                  [int(x) for x in sys.argv[6].split(",")])
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--sizes-mb", default="4,16,64,256")
    args = ap.parse_args()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        for world in (1, 2, 4):
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                       str(r), str(world), work, str(args.iters),
                                       args.sizes_mb], env=env)
                     for r in range(world)]
            try:
                rcs = [p.wait(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(rcs):
                print(f"gloo_latency: a rank of {world} failed: {rcs}", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
