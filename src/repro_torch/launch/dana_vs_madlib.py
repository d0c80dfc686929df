"""The paper's core comparison in miniature (counterpart of
``examples/dana_vs_madlib.py``, which it is held against): MADlib-analogue
(tuple-at-a-time host execution) vs DAnA (page-granular on-device decode +
multi-threaded merge engine) on the Remote Sensing logistic-regression
workload, with the Strider ablation (Fig 11) and the full-size FPGA cycle
model (Table 5).

The three modes, in the example's order, each timed by
``launch.workloads.time_mode`` over a warm buffer pool, one epoch:
  madlib          ``solver.madlib_train``: pages parsed and the update rule
                  run tuple by tuple on the host (the CPU, whatever the card)
  dana-nostrider  pages parsed on the host, the engine on the device (on the
                  card B2's ``glm_sgd_chunk`` once a 512-page chunk)
  dana            pages decoded on the device (B1) and the engine (B2), the
                  host joining the card once an epoch
Each device mode runs once untimed first (the kernels' build, CUDA's start).
The FPGA line is the analytic model of a 150 MHz VU9P at the table's full
size, not a measurement of any device here.

    PYTHONPATH=src python -m repro_torch.launch.dana_vs_madlib [--device cpu]

``--device`` defaults to ``cuda``; without a card it raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

# the example's workload, scale, epochs and modes (in its order)
WORKLOAD = "remote_sensing_lr"
SCALE = 0.01
EPOCHS = 1
MODES = ("madlib", "dana-nostrider", "dana")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--workdir", default=None,
                    help="the heap cache (default: a temporary directory)")
    return ap


def flow(args) -> dict:
    """The example's comparison on ``args.device``; prints its lines and
    returns what it printed and measured."""
    if args.workdir is None:
        with tempfile.TemporaryDirectory(prefix="dana_vs_madlib_") as tmp:
            return _flow(args, tmp)
    os.makedirs(args.workdir, exist_ok=True)
    return _flow(args, args.workdir)


def _flow(args, workdir) -> dict:
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch.workloads import build_heap, fpga_model, time_mode

    out = {"lines": []}

    def say(line):
        out["lines"].append(line)
        print(line, flush=True)

    w = WORKLOADS[WORKLOAD]
    heap = build_heap(w, scale=SCALE, directory=workdir)
    say(f"workload {w.name}: {heap.n_tuples} tuples x {w.n_features} features "
        f"({heap.n_pages} pages) [scaled from {w.n_tuples:,}]")
    out.update(n_tuples=heap.n_tuples, n_pages=heap.n_pages)

    seconds, results = {}, {}
    for mode in MODES:
        seconds[mode], res = time_mode(w, heap, mode, epochs=EPOCHS, device=args.device)
        results[mode] = {"models": res.models, "epochs_run": res.epochs_run,
                         "device_syncs": res.device_syncs}
    madlib_s, nostrider_s, dana_s = (seconds[m] for m in MODES)

    say(f"MADlib analogue (tuple-at-a-time host): {madlib_s*1e3:8.1f} ms")
    say(f"DAnA w/o striders (host decode):        {nostrider_s*1e3:8.1f} ms "
        f"({madlib_s/nostrider_s:.1f}x)")
    say(f"DAnA (device page decode + engine):     {dana_s*1e3:8.1f} ms "
        f"({madlib_s/dana_s:.1f}x)")
    out.update(seconds=seconds, results=results,
               ratios={"dana-nostrider": madlib_s / nostrider_s, "dana": madlib_s / dana_s})

    point, rt = fpga_model(w, epochs=EPOCHS)
    say("")
    say(f"FPGA cycle model @ full size ({w.n_tuples:,} tuples): "
        f"{rt['total_s']*1e3:.0f} ms end-to-end "
        f"({point.n_threads} threads, {rt['bound']}-bound) "
        f"— paper's DAnA+PostgreSQL: 100 ms")
    out.update(fpga_point=dataclasses.asdict(point), fpga_rt=rt)
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
