#!/usr/bin/env python3
"""Turns of one ``chip_smoke`` phase on one card, each turn in a process of
its own started in a checkout's root, for comparisons that only hold within
one call of this script (host times spread between calls).

  elastic PARENT_DIR CHANGE_DIR [--order ABBA]
      ``phase_train_elastic`` from the two checkouts in turns (A the first,
      B the second). A line a turn: the phase's seconds, and for each mesh
      the ranks' seconds and the median of their step seconds.

  serve CHECKOUT_DIR [--order ABBA]
      ``phase_serve`` (mistral-nemo-12b served at full width) from one
      checkout, alone (A) or with ``phase_roofline_host`` beside it in a
      process of its own (B), as the smoke runs them. A line a turn: the
      serve phase's wall seconds, tokens/s, mean step and mean TTFT.

  mla CHECKOUT_DIR [--order ABBA]
      ``phase_serve_mla`` (minicpm3-4b served at full width) the same way,
      alone (A) or with ``phase_examples`` (the four example drivers)
      beside it (B), as the smoke runs them; the B line also has the
      drivers' seconds and when the examples process ended after serve-mla.

    python3 tools/ab_beside.py elastic PARENT CHANGE --order ABBA
    python3 tools/ab_beside.py serve CHANGE --order ABBA
    python3 tools/ab_beside.py mla CHANGE --order ABAB
"""
import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, os, shutil, statistics, sys, time
root = os.getcwd()
sys.path[:0] = [root, os.path.join(root, "src"), os.path.join(root, "tests")]
import chip_smoke as cs

what, label, beside = sys.argv[1], sys.argv[2], sys.argv[3] == "B"
os.makedirs(cs.SCRATCH, exist_ok=True)
lines = []
real_emit = cs.emit


def keep(obj):
    lines.append(dict(obj, ended_unix_s=time.time()) if "phase" in obj else obj)
    real_emit(obj)


cs.emit = keep
t0 = time.perf_counter()
try:
    if what == "elastic":
        cs.phase_train_elastic()
    else:
        name = "roofline-host" if what == "serve" else "examples"
        handle = cs._phase_beside(name) if beside else None
        try:
            (cs.phase_serve if what == "serve" else cs.phase_serve_mla)()
        finally:
            if handle is not None:
                cs._join_beside(handle)
                with open(handle[2]) as f:  # the beside process's lines
                    lines.extend(json.loads(ln) for ln in f if ln.startswith("{"))
finally:
    shutil.rmtree(cs.SCRATCH, ignore_errors=True)
seconds = time.perf_counter() - t0
out = {"turn": label, "what": what, "seconds": seconds}
if what == "elastic":
    for ln in lines:
        if "per_step_per_rank" in ln:
            mesh = "x".join(str(v) for v in ln["mesh"].values())
            steps = [s["seconds"] for rank in ln["per_step_per_rank"] for s in rank]
            out[mesh] = {"seconds_per_rank": ln["seconds_per_rank"],
                         "median_step_s": statistics.median(steps)}
else:
    phase = "serve" if what == "serve" else "serve-mla"
    serve = next(ln for ln in lines if ln.get("phase") == phase)
    out.update(beside=beside, **{k: serve[k] for k in (
        "wall_s", "tokens_per_s", "mean_step_s", "mean_ttft_s", "steps")})
    if what == "mla" and beside:
        ex = [ln for ln in lines if ln.get("phase") == "examples"]
        out["examples_s"] = sum(ln["seconds"] for ln in ex)
        # > 0: the examples process ended after serve-mla did
        out["examples_end_after_mla_s"] = ex[-1]["ended_unix_s"] - serve["ended_unix_s"]
print("AB " + json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="turns of a chip_smoke phase on one card")
    ap.add_argument("what", choices=["elastic", "serve", "mla"])
    ap.add_argument("roots", nargs="+", help="elastic: PARENT CHANGE; serve, mla: CHECKOUT")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args(argv)
    if len(args.roots) != (2 if args.what == "elastic" else 1):
        ap.error("elastic takes two checkouts, serve and mla one")
    for i, which in enumerate(args.order):
        root = args.roots[0 if which == "A" or args.what != "elastic" else 1]
        root = os.path.abspath(root)
        label = f"{i}:{which}:{os.path.basename(root)}"
        done = subprocess.run([sys.executable, "-c", TURN, args.what, label, which], cwd=root)
        if done.returncode:
            print("AB " + json.dumps({"turn": label, "failed": done.returncode}), flush=True)
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
