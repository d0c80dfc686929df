#!/usr/bin/env python3
"""The dry-run's rwkv6-3b cell under each plain WKV form: the per-chunk
form (``wkv_chunked_ref``, ``wkv_impl="plain"``) and the grouped one the
dry-run runs (``wkv_chunked_grouped``, ``launch.dryrun.WKV_IMPL``). For each
form, in a process of its own on the CPU (meta tensors, a fake process
group; nothing is allocated), one JSON line: the seconds of the meta run and
the cell's flops, bytes and memory a device; then the grouped form's
figures over the per-chunk form's.

    PYTHONPATH=src python tools/dryrun_wkv_forms.py [--shape train_4k] [--mesh single]
"""
import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, sys, time
from repro_torch.configs import get_config
from repro_torch.dist import meshes
from repro_torch.launch import dryrun
from repro_torch.models import model_zoo

form, shape, multi = sys.argv[1], sys.argv[2], sys.argv[3] == "multi"
dryrun.WKV_IMPL = form
dryrun.fake_group(512 if multi else 256)
mesh = meshes.make_production_mesh(multi_pod=multi, device="cpu")
t0 = time.perf_counter()
m = dryrun._lower_and_measure(get_config("rwkv6-3b"), model_zoo.SHAPES[shape], mesh)
print(json.dumps({"form": form, "shape": shape, "mesh": dryrun.mesh_name(multi),
                  "seconds": time.perf_counter() - t0, "cost": m["cost"],
                  "memory": m["memory"]}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    got = {}
    for form in ("plain", "grouped"):
        out = subprocess.run([sys.executable, "-c", TURN, form, args.shape, args.mesh],
                             env=env, cwd=root, check=True, capture_output=True, text=True)
        got[form] = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(got[form]), flush=True)
    p, g = got["plain"], got["grouped"]
    ratios = {"seconds": g["seconds"] / p["seconds"]}
    ratios.update({k: g["cost"][k] / p["cost"][k] for k in p["cost"]})
    ratios.update({k: g["memory"][k] / p["memory"][k] for k in p["memory"] if p["memory"][k]})
    print(json.dumps({"grouped_over_plain": ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
