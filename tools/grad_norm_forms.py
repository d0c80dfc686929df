#!/usr/bin/env python3
"""The gradient norm of AdamW's update over rwkv6-3b's leaves at full width
and depth, in two forms on one card: ``optimizer._leaf_norm`` per leaf (the
update's form: a reduction over blocks of ``NORM_BLOCK`` elements, then one
over the blocks' norms) and ``torch.linalg.vector_norm`` per leaf in one
reduction. Each form's device time (CUDA events around 5 eager calls after
a warm one, median of 3) and its error against the float64 norm, as one
JSON line with the card's name and power limit.

    PYTHONPATH=src python3 tools/grad_norm_forms.py [--device cuda]
"""
import argparse
import json
import statistics
import subprocess

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.models import model_zoo
    from repro_torch.models.params import leaves
    from repro_torch.train import optimizer

    device = resolve_device(args.device)
    cfg = get_config("rwkv6-3b")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    grads, _ = model_zoo.init_params(cfg, 0, device, dtype=torch.float32)
    flat = list(leaves(grads))
    forms = {
        "blocked": lambda: torch.linalg.vector_norm(torch.stack(
            [optimizer._leaf_norm(g) for g in flat])),
        "vector_norm": lambda: torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in flat])),
    }
    exact = sum(float(torch.sum(torch.square(g.double()))) for g in flat) ** 0.5
    out = {"arch": cfg.name, "layers": cfg.n_layers, "elements": sum(g.numel() for g in flat),
           "leaves": len(flat), "exact": exact}
    for name, fn in forms.items():
        value = float(fn())
        times = []
        for _ in range(3):
            if device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 5)
        out[name] = {"value": value, "rel_err": abs(value - exact) / exact,
                     "ms": statistics.median(times) if times else None}
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
