"""Three-term roofline from dry-run artifacts, with the H100's peaks
(counterpart of ``repro.roofline.analysis``, which it is held against):

    compute term    = flops_per_device / peak_FLOPs_per_card
    memory term     = bytes_accessed_per_device / HBM_bw_per_card
    collective term = collective_wire_bytes_per_device / (links * link_bw)

A dry-run record (``launch.dryrun``) holds one rank's numbers, so no
further division by the device count is needed. MODEL_FLOPS = 6*N*D for
training (6*N_active*D for MoE), 2*N*D for prefill, 2*N_active per decoded
token; the useful-compute ratio MODEL_FLOPS / (flops * devices) exposes
remat / dispatch / capacity waste, and on the port's mesh step also the
whole-weight compute every rank repeats (each rank runs the whole layer on
its rows, so the model axis divides nothing).

``cost.flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count:
matrix products, convolutions and attention only. The reference's XLA count
also holds the elementwise ops, so at equal work the port's is the smaller.

``H100`` is the NVIDIA H100 SXM5 80 GB from its datasheet: 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 as 18
links of 25 GB/s a direction (450 GB/s). Its name is the card's as
``nvidia-smi --query-gpu=name,power.limit`` prints it at the 700 W limit
the datasheet's peaks assume.
"""
from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str = "NVIDIA H100 80GB HBM3, 700.00 W"
    peak_flops: float = 989e12  # dense bf16 / card
    hbm_bw: float = 3.35e12  # B/s / card
    ici_link_bw: float = 25e9  # B/s / NVLink 4 link, one direction
    ici_links: int = 18  # NVLink 4 links / card


H100 = HWSpec()


def tokens_of(shape_name: str, record: dict) -> int:
    from repro_torch.models.model_zoo import SHAPES

    s = SHAPES[shape_name]
    if s.kind == "decode":
        return s.global_batch  # one new token per sequence
    return s.global_batch * s.seq_len


def model_flops(record: dict) -> float:
    kind = record["kind"]
    n_active = record["model"]["n_active_params"]
    toks = tokens_of(record["shape"], record)
    if kind == "train":
        # MTP adds roughly one extra layer forward+backward; ignored (noted)
        return 6.0 * n_active * toks
    return 2.0 * n_active * toks


def roofline_terms(record: dict, hw: HWSpec = H100) -> dict:
    flops = record["cost"]["flops"]
    mem_bytes = record["cost"]["bytes_accessed"]
    wire = record["collectives"]["total_wire_bytes"]
    n_dev = record.get("n_devices", 256)

    compute_s = flops / hw.peak_flops
    memory_s = mem_bytes / hw.hbm_bw
    collective_s = wire / (hw.ici_links * hw.ici_link_bw)
    bound = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(record)
    useful_ratio = mf / (flops * n_dev) if flops else 0.0
    step_s = max(compute_s, memory_s, collective_s)
    mfu = (mf / n_dev / hw.peak_flops) / step_s if step_s > 0 else 0.0
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bound": bound,
        "model_flops": mf,
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": mfu,  # fraction of card peak at the modeled step time
    }


def load_records(artifact_dir: str) -> list[dict]:
    recs = []
    if not os.path.isdir(artifact_dir):
        return recs
    for f in sorted(os.listdir(artifact_dir)):
        if f.endswith(".json"):
            with open(os.path.join(artifact_dir, f)) as fh:
                recs.append(json.load(fh))
    return recs


def table(artifact_dir: str, mesh: str = "pod16x16", hw: HWSpec = H100) -> str:
    """Markdown roofline table of one mesh's records."""
    rows = []
    for r in load_records(artifact_dir):
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append((r["arch"], r["shape"], None, r.get("reason", "")))
            continue
        if r.get("status") != "ok":
            rows.append((r["arch"], r["shape"], None,
                         f"ERROR {r.get('error','')[:60]}"))
            continue
        rows.append((r["arch"], r["shape"], roofline_terms(r, hw), ""))

    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | bound | "
        "MODEL_FLOPS | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape, t, note in rows:
        if t is None:
            lines.append(f"| {arch} | {shape} | — | — | — | skipped | — | — | {note} |")
            continue
        lines.append(
            f"| {arch} | {shape} | {t['compute_s']:.3e} | {t['memory_s']:.3e} | "
            f"{t['collective_s']:.3e} | **{t['bound']}** | {t['model_flops']:.3e} | "
            f"{t['useful_flops_ratio']:.2f} | {t['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)
