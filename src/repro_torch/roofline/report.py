"""Generate the data-driven tables of the port's roofline from its
artifacts (counterpart of ``repro.roofline.report``: the same sections and
the same text on the same records, the roofline priced on the H100).

    PYTHONPATH=src python -m repro_torch.roofline.report > ROOFLINE.generated.md

Sections: dry-run summary (both meshes), sharding fallbacks, single-pod
roofline table, perf experiment table; each reads ``artifacts/torch/dryrun``
or ``artifacts/torch/perf`` unless given another directory.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.roofline.analysis import load_records, roofline_terms, table

DRY = os.path.join("artifacts", "torch", "dryrun")
PERF = os.path.join("artifacts", "torch", "perf")


def dryrun_section(dry: str = DRY) -> str:
    recs = load_records(dry)
    lines = [
        "| arch | shape | mesh | status | GiB/dev (args+temp) | flops/dev | "
        "HBM bytes/dev | collective wire B/dev | compile (s) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    recs.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"]))
    n_ok = n_skip = n_err = 0
    for r in recs:
        if r.get("status") == "ok":
            n_ok += 1
            mem = r["memory"]
            gib = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {gib:.1f} | "
                f"{r['cost']['flops']:.2e} | {r['cost']['bytes_accessed']:.2e} | "
                f"{r['collectives']['total_wire_bytes']:.2e} | {r['compile_s']} |"
            )
        elif r.get("status") == "skipped":
            n_skip += 1
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | skipped | — | — | — "
                f"| — | — |"
            )
        else:
            n_err += 1
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** | — | — "
                f"| — | — | — |"
            )
    head = (
        f"**{n_ok} cells compiled**, {n_skip} skipped "
        f"(long_500k on pure full-attention archs, DESIGN.md §5), "
        f"{n_err} errors.\n"
    )
    return head + "\n".join(lines)


def roofline_section(dry: str = DRY) -> str:
    return table(dry, mesh="pod16x16")


def fallback_section(dry: str = DRY) -> str:
    recs = [r for r in load_records(dry)
            if r.get("mesh") == "pod16x16" and r.get("status") == "ok"]
    seen = {}
    for r in recs:
        for fb in r.get("fallbacks", []):
            key = (r["arch"], fb["axis"], fb["dim"])
            seen.setdefault(key, fb["why"])
    lines = ["| arch | logical axis | dim | fallback reason |", "|---|---|---|---|"]
    for (arch, axis, dim), why in sorted(seen.items()):
        lines.append(f"| {arch} | {axis} | {dim} | {why} |")
    return "\n".join(lines)


def perf_section(perf: str = PERF) -> str:
    if not os.path.isdir(perf):
        return "(run repro_torch.launch.perf first)"
    lines = [
        "| experiment | compute (s) | memory (s) | collective (s) | bound | "
        "roofline frac | temp GiB/dev | args GiB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for f in sorted(os.listdir(perf)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(perf, f)) as fh:
            r = json.load(fh)
        if r.get("status") != "ok":
            lines.append(f"| {r.get('label', f)} | — | — | — | {r.get('status')} "
                         f"| — | — | — |")
            continue
        t = roofline_terms(r)
        mem = r["memory"]
        lines.append(
            f"| {r['label']} | {t['compute_s']:.2f} | {t['memory_s']:.2f} | "
            f"{t['collective_s']:.2f} | {t['bound']} | "
            f"{t['roofline_fraction']:.4f} | {mem['temp_bytes']/2**30:.1f} | "
            f"{mem['argument_bytes']/2**30:.1f} |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default=DRY)
    ap.add_argument("--perf-dir", default=PERF)
    args = ap.parse_args(argv)
    print("## Generated: dry-run summary (all cells, both meshes)\n")
    print(dryrun_section(args.dryrun_dir))
    print("\n## Generated: sharding fallbacks (divisibility)\n")
    print(fallback_section(args.dryrun_dir))
    print("\n## Generated: single-pod roofline table (H100)\n")
    print(roofline_section(args.dryrun_dir))
    print("\n## Generated: perf experiments\n")
    print(perf_section(args.perf_dir))


if __name__ == "__main__":
    main()
