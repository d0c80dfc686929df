#!/usr/bin/env python3
"""The serve-mla phase and B5's split body from two checkouts of this
repository on one card, in turns (A B B A by default), each turn in a
process of its own started in that checkout's root.

Each turn builds the checkout's paged-attention kernel, times B5's generic
entry (the split body that mistral-nemo-12b's serve path runs) on the cases
``runs_gqa_dk128_bf16`` and ``long_context`` of
``tests/test_torch_paged_attn_cases.py`` with their runs, and runs the
checkout's ``chip_smoke.phase_serve_mla`` (minicpm3-4b served at full width,
at the depth that checkout's smoke gives it), whose JSON line it prints.
Host times spread between calls, so compare the two checkouts only within
one call of this script.

    python3 tools/ab_serve_mla.py PARENT_DIR CHANGE_DIR [--order ABBA]
"""
import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, os, shutil, sys
root = os.getcwd()
sys.path[:0] = [root, os.path.join(root, "src"), os.path.join(root, "tests")]
import torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.kernels.paged_attn import kernel
from test_torch_paged_attn_cases import CASES

os.makedirs(cs.SCRATCH, exist_ok=True)
build.build("paged_attn")
split_ms = {}
for name in ("runs_gqa_dk128_bf16", "long_context"):
    q, k, v, table, pos, kw, _, runs = CASES[name]()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v))
    table, pos, runs = (torch.from_numpy(a).cuda() for a in (table, pos, runs))
    split_ms[name] = cs.device_ms(
        [lambda: kernel.paged_attention(q, k, v, table, pos, runs=runs, **kw)] * 20)
print(json.dumps({"turn": sys.argv[1], "b5_split_ms": split_ms}), flush=True)
try:
    cs.phase_serve_mla()
finally:
    shutil.rmtree(cs.SCRATCH, ignore_errors=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve-mla and B5's split body from two checkouts, in turns, on one card")
    ap.add_argument("a", help="the first checkout (the parent)")
    ap.add_argument("b", help="the second checkout (the change)")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args(argv)
    for i, which in enumerate(args.order):
        root = os.path.abspath(args.a if which == "A" else args.b)
        label = f"{i}:{which}:{os.path.basename(root)}"
        print(json.dumps({"turn": label, "root": root}), flush=True)
        done = subprocess.run([sys.executable, "-c", TURN, label], cwd=root)
        if done.returncode:
            print(json.dumps({"turn": label, "failed": done.returncode}), flush=True)
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
