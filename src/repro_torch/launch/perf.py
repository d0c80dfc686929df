"""Perf experiments: named (cell x lever) dry-runs (counterpart of
``repro.launch.perf``, whose labels and arguments it keeps).

Each experiment re-runs a roofline cell of ``launch.dryrun`` on meta
tensors with one or more levers changed and records the full measurement
beside the baseline, so the roofline report can show hypothesis -> change
-> before -> after per iteration.

Cells:
  A. minicpm3-4b  prefill_32k: attention materializes 32k x 32k scores
     (levers: query chunks, bf16 operands; and its train_4k companion)
  B. deepseek-v3-671b  train_4k: the largest model (levers: bf16 moments,
     FSDP rules, microbatches, capacity factor, chunked loss)
  C. olmoe-1b-7b  train_4k: the cell closest to the paper's technique
     (DAnA's merge is the data-parallel gradient combine; its cost is this
     cell's collective term)

Usage: python -m repro_torch.launch.perf --cell A   (or --label A0_baseline, or --all)
"""
import argparse
import json
import os

from repro_torch.launch.dryrun import lower_cell

PERF_DIR = os.path.join("artifacts", "torch", "perf")

# label -> (arch, shape, mesh_multi, kwargs)
EXPERIMENTS = {
    # ---- Cell A: minicpm3-4b prefill_32k ---------------------------------------
    "A0_baseline": ("minicpm3-4b", "prefill_32k", False, {}),
    "A1_qchunk512": ("minicpm3-4b", "prefill_32k", False,
                     {"cfg_overrides": {"attn_q_chunk": 512}}),
    "A2_qchunk1024": ("minicpm3-4b", "prefill_32k", False,
                      {"cfg_overrides": {"attn_q_chunk": 1024}}),
    "A3_qchunk2048": ("minicpm3-4b", "prefill_32k", False,
                      {"cfg_overrides": {"attn_q_chunk": 2048}}),
    "A6_qchunk_bf16": ("minicpm3-4b", "prefill_32k", False,
                       {"cfg_overrides": {"attn_q_chunk": 512,
                                          "attn_qk_bf16": True}}),
    # train-side companion (same bottleneck, backward included)
    "A4_train_baseline": ("minicpm3-4b", "train_4k", False, {}),
    "A5_train_qchunk": ("minicpm3-4b", "train_4k", False,
                        {"cfg_overrides": {"attn_q_chunk": 512},
                         "loss_chunk": 512}),
    "A7_train_qchunk_bf16": ("minicpm3-4b", "train_4k", False,
                             {"cfg_overrides": {"attn_q_chunk": 512,
                                                "attn_qk_bf16": True},
                              "loss_chunk": 512, "microbatches": 4}),
    # ---- Cell B: deepseek-v3-671b train_4k ----------------------------------
    "B0_baseline": ("deepseek-v3-671b", "train_4k", False, {}),
    "B1_bf16_opt": ("deepseek-v3-671b", "train_4k", False,
                    {"opt_overrides": {"state_dtype": "bfloat16"}}),
    "B2_fsdp": ("deepseek-v3-671b", "train_4k", False, {"fsdp": True}),
    "B3_fsdp_micro4": ("deepseek-v3-671b", "train_4k", False,
                       {"fsdp": True, "microbatches": 4,
                        "opt_overrides": {"state_dtype": "bfloat16"}}),
    "B4_capacity1": ("deepseek-v3-671b", "train_4k", False,
                     {"cfg_overrides": {"capacity_factor": 1.0}}),
    "B5_qchunk_losschunk": ("deepseek-v3-671b", "train_4k", False,
                            {"cfg_overrides": {"attn_q_chunk": 512},
                             "loss_chunk": 512,
                             "opt_overrides": {"state_dtype": "bfloat16"}}),
    "B6_fused_combine": ("deepseek-v3-671b", "train_4k", False,
                         {"cfg_overrides": {"capacity_factor": 1.0}}),
    "B8_no_vmap_constraint": ("deepseek-v3-671b", "train_4k", False,
                              {"cfg_overrides": {"capacity_factor": 1.0}}),
    "B7_production": ("deepseek-v3-671b", "train_4k", False,
                      {"cfg_overrides": {"capacity_factor": 1.0,
                                         "attn_q_chunk": 512,
                                         "attn_qk_bf16": True},
                       "fsdp": True, "microbatches": 4, "loss_chunk": 512,
                       "opt_overrides": {"state_dtype": "bfloat16"}}),
    # ---- Cell C: olmoe-1b-7b train_4k ---------------------------------------
    "C0_baseline": ("olmoe-1b-7b", "train_4k", False, {}),
    "C1_qchunk": ("olmoe-1b-7b", "train_4k", False,
                  {"cfg_overrides": {"attn_q_chunk": 512}}),
    "C2_capacity1": ("olmoe-1b-7b", "train_4k", False,
                     {"cfg_overrides": {"capacity_factor": 1.0,
                                        "attn_q_chunk": 512}}),
    "C3_losschunk": ("olmoe-1b-7b", "train_4k", False,
                     {"cfg_overrides": {"attn_q_chunk": 512}, "loss_chunk": 512}),
    "C4_fused_combine": ("olmoe-1b-7b", "train_4k", False,
                         {"cfg_overrides": {"attn_q_chunk": 512}}),
    "C5_no_vmap_constraint": ("olmoe-1b-7b", "train_4k", False,
                              {"cfg_overrides": {"attn_q_chunk": 512}}),
}


def run_one(label: str, out_dir: str = PERF_DIR):
    arch, shape, multi, kw = EXPERIMENTS[label]
    rec = lower_cell(arch, shape, multi, **kw)
    rec["label"] = label
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{label}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if rec.get("status") == "ok":
        from repro_torch.roofline.analysis import roofline_terms

        t = roofline_terms(rec)
        mem = rec["memory"]
        print(
            f"[{label}] compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s "
            f"collective={t['collective_s']:.3e}s bound={t['bound']} "
            f"frac={t['roofline_fraction']:.4f} "
            f"| dev bytes: args={mem['argument_bytes']/2**30:.1f}G "
            f"temp={mem['temp_bytes']/2**30:.1f}G",
            flush=True,
        )
    else:
        print(f"[{label}] {rec.get('status')}: {rec.get('error', '')[:200]}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", choices=list(EXPERIMENTS))
    ap.add_argument("--cell", choices=["A", "B", "C"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=PERF_DIR)
    args = ap.parse_args(argv)

    labels = (
        [args.label]
        if args.label
        else [l for l in EXPERIMENTS if args.all or (args.cell and l.startswith(args.cell))]
    )
    for label in labels:
        path = os.path.join(args.out, f"{label}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[{label}] cached")
            continue
        run_one(label, args.out)


if __name__ == "__main__":
    main()
