#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: DAnA's TRAIN path (alone
and on meshes of 4 gloo ranks that share the card) and its in-database
scoring (SQL PREDICT) at full size, LM serving of
hymba-1.5b (hybrid), olmoe-1b-7b (MoE) and rwkv6-3b and LM training of
rwkv6-3b, minicpm3-4b, hymba-1.5b and seamless-m4t-medium (enc-dec, with its
greedy decode) at full width and depth, LM serving of mistral-nemo-12b
(GQA), minicpm3-4b (MLA) and internvl2-26b (the VLM) and LM training of
olmoe-1b-7b and internvl2-26b at full width and cut depth (and of rwkv6-3b
on meshes of 4 gloo ranks, a checkpoint resharded between them), through the
port's hand-written CUDA kernels, LM PREDICT of mistral-nemo-12b from
SQL over a token table, and the three example drivers (quickstart, serve_lm,
train_lm) as the port's launch modules.

Phases, one JSON line each:

  env      torch and CUDA versions, the card's name and power limit
  build    nvcc builds of src/repro_torch/csrc/*.cu, all started together
  parity   each kernel against its plain PyTorch version on the same CUDA
           tensors: the full and the projected strider decode bit for bit,
           the GLM gradient at rtol=2e-5, atol=2e-4, the SGD walk over a
           chunk's merge batches (w and the norms) at rtol=atol=1e-4 over
           every activation, widths 1-9,001 and batches of 1-256 rows with
           a ragged tail, GLM scoring at atol=2e-6, svm exactly, over
           tests/test_torch_predict_plan.py's cases (the scan's chunk, ragged
           N, odd and wide D, x off the 16-byte grid, no live row, one dead
           tile; a bool mask bit for bit the f32 one's), and paged attention at rtol=atol=2e-5
           over the CPU tests' cases, with and without their runs, the
           MLA shapes through the generic entry (the tiled body) and the
           latent entry's cases (its latent body; minicpm3-4b's and
           deepseek-v3's latents among them) (the reference's own
           tolerances), the WKV forward and backward at rtol=atol=2e-4 over
           the CPU tests' cases and the training shape (bf16 outputs within
           one bf16 step), each deterministic, with the forward's chunk
           states and the backward's state gradients against their plain
           versions, both on the shapes that take their general paths, and
           each one's kernels timed at the training shape
  e2e      remote_sensing_lr from the paper's Table 3 (logistic regression,
           54 features, 581,102 tuples in 4,211 pages of 32 KB, warm pool)
           trained for 3 epochs by solver.train(mode="dana") on the card;
           launch counts (B1 and the SGD walk once a chunk, the per-batch
           gradient never), the engine's affine update, one join per epoch,
           and the coefficients against the same run on the CPU
  syncs    one more epoch under torch.cuda.set_sync_debug_mode("warn")
  profile  one more epoch under torch.profiler: the card's busy and idle
           share and the epoch's cudaLaunchKernel calls
  predict  the same table through the SQL surface on the card
           (Database(device="cuda").connect()): the TRAIN statement against
           e2e's coefficients byte for byte, three scans (rows, aggregates,
           INSERT ... SELECT) with one join each and their launch counts,
           two of them replayed on the CPU, the concurrent executor against
           the serial run byte for byte, and one scan under the sync debug
           mode; B4's share of the scan's busy time and one chunk
           program's cudaLaunchKernel calls
  serve    mistral-nemo-12b (full width, 20 of its 40 layers, bf16 weights
           from seed 0 on the card) serving 48 greedy requests through
           BatchedServer(kv="paged", step_mode="tokens", attn_impl="kernel"):
           every request FINISHED, the kernel's launches against the fused
           steps, the same stream through the gather path and 8 requests
           through chunked stepping token for token (except at near-ties,
           which are reported, measured against a logit deviation that must
           stay within DEVIATION_LIMIT; a kernel that drops each token's own
           row must break that limit), one host read per fused step under
           the sync debug mode, and 5 profiled steps (busy time from the
           device's own events); B5's first calls at step 100 (a mixed
           step) and at the decode-only step with the most context are
           captured for the kernels line
  launch   launch/serve.py's main() at full width and depth (40 layers)
  serve-mla  minicpm3-4b (full width, 31 of its 62 layers, bf16 weights
           from seed 0)
           serving the same 48 requests the same way: the absorbed-latent
           decode is one call a layer of B5's latent entry at G 40, Dc 256,
           Dr 32 over the cache's c and kr pools (the latent body; no
           concatenation of a pool, checked on the largest torch.cat of 24
           steps); every request FINISHED, B5 62 times a fused step, each on
           the latent body, the gather path token for token except at
           reported near-ties within DEVIATION_LIMIT, one host read per fused
           step, 5 profiled steps (B5's share and every torch.cat's device
           time); B5's calls at step 100 and at the decode-only step with the
           most context captured for the kernels line
  serve-moe  (in a process of its own, beside serve)
           olmoe-1b-7b (16 layers, d_model 2,048, 16/16 heads of 128, 64
           experts, top-8, expert d_ff 1,024; bf16 weights from seed 0,
           13.8 GB) serving 24 greedy requests of 64-1,024 prompt tokens
           (16 at step 0, the rest one every 4 steps), 32 new tokens each,
           through BatchedServer with the serve phase's settings: token
           stepping falls back to chunked stepping (recorded), prefix
           sharing is off, every request FINISHED, B5 16 times a sub-step
           on the split body (KVH 16, G 1, D 128), every call of each fused
           step's first sub-step against its plain version at 2e-5; the
           share of (token, expert) choices capacity dropped in the sub-step
           of the capture, from the port's routing on each layer's captured
           input; the kernel and the gather path (and the gather path under
           a 1e-6 noise on its attention outputs, the noise floor) each
           serving the 4 shortest requests on 4 slots, compared row by row:
           each request's first divergence a near-tie or a route flip (a
           router margin below 1e-3), with its margins; one host read per
           fused step; one profiled step (B5's share, and the MoE block's
           from the device time of its decode call); B5's call of the
           first sub-step past position 1,040 for the kernels line
  serve-hybrid  (in a process of its own, beside serve) hymba-1.5b (32
           layers, d_model 1,600, 25/5 heads of 64, Mamba state 16, window
           1,024, global layers 0, 16 and 31; bf16 weights from seed 0)
           serving 20 greedy requests of 64-1,056
           prompt tokens (4 of 1,000-1,056, whose ring rows wrap), 32 new
           tokens each, through BatchedServer with the serve phase's
           settings: token stepping falls back to chunked stepping
           (recorded), prefix sharing is off, every request FINISHED, B5 32
           times a sub-step on the split body (29 calls on the ring table,
           3 on the full table); 2 wrapping and the 2 shortest requests
           through the gather path (in a process of its own, started with
           --hybrid-gather, beside the main run and waited for) token for
           token except at reported
           near-ties (measured along the two runs' own logits, the limit
           twice what a 1e-6 noise on the gather path's attention outputs
           moves copies of the same requests, as hymba's logits move far
           under it); every B5 call of each fused step's first sub-step
           against its plain version; one host read per fused step; one
           profiled step (B5's and the Mamba mixer's shares of busy time,
           launches a step); a sliding-window
           and a global layer's B5 call of the first sub-step past position
           1,040 captured for the kernels line
  train-sharded  (in a process of its own, beside serve-mla and serve)
           the TRAIN path on a mesh: the unsharded solver.train on the card as the
           baseline, then 4 gloo ranks on the one card (``--sharded-rank``,
           each bound to cuda:0, gloo over loopback) train the whole heap
           for 3 epochs through solver.train(mesh=) on a 4 x 1 data mesh
           (the shard_map path: each rank decodes its own page range with
           B1, once a chunk, and takes 64 rows of every merge batch through
           B2's glm_grad, 2,270 times an epoch, then one all_reduce; the
           vmap thread path poisoned; every glm_grad call of the first
           chunk on rank 0 against glm_grad_ref at rtol=2e-5, atol=2e-4)
           and on a 2 x 2 mesh with shard_model (w Shard(0) on the model
           axis, the row-parallel products); the coefficients within 1e-4
           of the baseline and the same bits on every rank, one join an
           epoch; then repro's LRMF case on the 2 x 2 mesh (the gspmd path,
           items Shard(0)) against the unsharded card run at rtol=1e-4,
           atol=1e-5. One line per mesh: seconds an epoch per rank,
           tuples/s, collectives an epoch, each rank's busy time over the
           run (traced, device events only) and its idle share, the
           largest difference
  serve-rwkv  (in a process of its own, beside serve-mla) rwkv6-3b (full
           width and depth, bf16 from seed 0) asked for paged KV and token
           stepping, served dense and chunked: 16 requests of 32-256 prompt
           tokens, every request FINISHED, no
           kernel launched (decode runs the per-token recurrence), one host
           read per fused step, every request against generate_greedy token
           for token except at reported near-ties
  lm-predict  (in a process of its own, beside serve-mla) the serve
           phase's model (20 layers) registered as an LM UDF
           (register_lm_udf: its 13.6 GB weights file written beside the
           catalog, the disk's free bytes printed first, loaded back onto
           the card bit for bit), then
           LM PREDICT through Session.sql over a token table of 40,960
           prompts of 32-256 tokens (1,322 pages of 32 KB, 3 chunks; token 7
           first in 32 rows): SELECT * ... WHERE c0 = 7 AND label >= 64, 32
           new tokens on 16 slots, then the same as INSERT INTO nemo_out
           under the sync debug mode. B3 once a chunk and no other kernel,
           one join a scan and no synchronising call in the scan's code, the
           kept and filtered rows, tokens equal to generate_greedy's except
           at reported near-ties within DEVIATION_LIMIT, the aggregate and
           column-list statements rejected, nemo_out read back through B1
           and B3; the statement's, the scan's and a direct score_tokens'
           seconds and rates, and B3 on the token chunks for the kernels line
  train    rwkv6-3b (32 layers, full width, f32 masters from seed 0 on the
           card) trained by train_loop.run for 6 steps of 8 x 512 tokens from
           the page data path (B1) with full rematerialisation and AdamW:
           every loss finite, B1 / B6 / B6-bwd launched 1 / 64 / 32 times a
           step, one host read a step (three at the logging step) under the
           sync debug mode, step time, tokens/s, peak memory, one
           profiled step (busy time and the WKV kernels' shares), and
           AdamW's update alone in pieces and in one pass
  train-parity  a 2-layer full-width rwkv6-3b's loss and gradients through
           the kernels against the plain WKV on the card, and prefill (B6)
           against token-by-token decode on 64 tokens
  train-mla  minicpm3-4b (62 layers, full width, f32 masters from seed 0)
           trained for 4 steps of 4 x 512 tokens from the page data path (B1
           once a step, no other kernel: the attention training forward is
           plain PyTorch), full rematerialisation, AdamW, checked as the
           train phase is (published width, losses, launches, one host
           read a step) and measured the same way; then a
           2-layer full-width model's prefill against 32 decode steps
           (argmax equal, logits within 3e-2)
  train-hybrid  hymba-1.5b (full width and depth, f32 masters from seed 0)
           trained for 4 steps of 8 x 512 tokens as the train-mla phase is
           (B1 once a step, no other kernel: the sliding-window attention
           and the Mamba scan are plain PyTorch), with the Mamba mixer's
           share of the profiled step; then a 2-layer full-width model (one
           global, one sliding-window layer) prefills 1,100 tokens, past the
           window, against 1,100 decode steps on the dense ring cache
           (argmax equal, logits within 3e-2 or twice what a 1e-6 noise on
           the decode's attention outputs moves them, where that is larger)
  train-moe  olmoe-1b-7b at full width, its depth cut to 9 of 16 layers
           (16 bytes a parameter: 110.7 GB at 16 layers, 63.7 GB at 9; the
           AdamW timing's one pass over the largest leaf needs room beside
           that), f32 masters from seed 0, trained for 4 steps of 8 x 512
           tokens as the train-mla phase is (B1 once a step, no other
           kernel: routing and the expert products are plain PyTorch, as in
           the reference), with the MoE block's share of the profiled step
           (a record_function range); then one step's loss and every
           gradient computed twice from the same state: the same bits
  train-encdec  seamless-m4t-medium (12 encoder and 12 decoder layers,
           d_model 1,024, vocab 256,206; full width and depth, f32 masters
           from seed 0) trained for 4 steps of 8 x 512 target tokens from
           the page data path (B1 once a step, no other kernel: the encoder,
           the decoder and the cross attention are plain PyTorch), each page
           batch given the 8 x 512 source frames that synthetic_data_fn
           draws for its step (the page path gives no frames, as the
           reference's gives none); checked and measured as train-mla is,
           then one step's loss and every gradient twice: the same bits
  decode-encdec  the same model in bf16: 4 sources of 512 frames, 32 target
           tokens, prefill_fn's last logits against 32 decode_fn steps on a
           make_cache cache holding precompute_cross_kv's K and V (rtol =
           atol = 3e-2, every argmax equal); then 64 greedy tokens from each
           source, twice: the same tokens
  train-vlm  internvl2-26b at full width, its depth cut to 6 of 48 layers
           (16 bytes a parameter: 55.7 GB, and the backward of one layer's
           f32 attention scores beside it), trained for 4 steps of 4 x
           (1,024 patches + 1,024 text tokens): the text from the page data
           path (B1 once a step), the patches synthetic_data_fn's draws;
           checked as train-mla is, then the same bits twice
  serve-vlm  (in a process of its own, beside serve-mla) internvl2-26b
           (full width, 16 of its 48 layers, bf16 weights from seed 0)
           serving the serve phase's 48 requests as serve-mla does: B5 at
           KVH 8, G 6, D 128 once a layer a fused step on the split body,
           every B5 call of every fused step against its plain version at
           2e-5, then the stream again without that check (the phase's
           times, the same tokens), the kernel and the gather path on the 4
           shortest requests alone, token for token except at reported
           near-ties;
           B5's calls at step 100 and at the decode-only step with the most
           context captured for the kernels line
  launch-train  launch/train.py's main() at full width for 2 steps
  examples  (in a process of its own, beside serve-mla) the four example
           drivers through main(argv) of launch/quickstart.py, serve_lm.py,
           train_lm.py and dana_vs_madlib.py on the card, each printing OK,
           a line each:
           quickstart (its TRAIN: B1 once an epoch and once for the
           convergence check's batch, B2's chunk walk once an epoch and its
           one-batch gradient once an epoch for the check; its three scans:
           B3 and B4 once each; one join an epoch and a scan); serve_lm at
           the example's settings (three reduced archs, dense KV, the
           gather path: no kernel; tokens/s an arch) and at internlm2-20b's
           full width on 2 layers through B5 (paged KV, KVH 8, G 6, D 128:
           once a layer a fused step, the first fused step's calls against
           the plain version at 2e-5, the last one's first call kept for
           the kernels line); train_lm at its defaults (200 steps of 4 x 128
           at width 512, the preemption at step 120 and the resume from 100:
           B1 once a step run, no other kernel); dana_vs_madlib (the
           paper's comparison on remote_sensing_lr at 0.01: MADlib on the
           host, dana-nostrider, dana, each mode's seconds and the ratios;
           B1 2, B2's chunk walk 4; the modes' coefficients at repro's own
           tolerances), then dana and dana-nostrider at Table 3's full size
           through launch/workloads.py's time_mode (B1 and B2 once a chunk
           a run; seconds, tuples/s, their ratio; coefficients equal)
  train-elastic  LM training on a mesh: rwkv6-3b at full width, its depth cut
           to 2 layers, 8 x 512 tokens from pages, full remat, AdamW; the
           same 5 steps unsharded on the card first, on the whole batch and
           split in microbatches as the meshes split the rows (both also
           with f32 activations, their changes within 5e-3), then 4
           gloo ranks on the card (``chip_smoke.py --elastic-rank``) run
           launch/elastic_restart.py's flow: 3 steps on a (2 data x 2
           model) mesh, save, the (4 x 1) mesh, restore(shardings=), 2
           steps. Each loss within 2e-2 of the whole batch's, the first
           step's gradient within 5e-2 of it (relative norm, by leaf), each
           leaf's change over a mesh's steps within 5e-2 of the split
           run's and of the whole batch's (a leaf off the whole batch's by
           more: at most 1e-3 of its elements flipped in sign and the rest
           within 5e-2), the
           ranks that hold a region the same bits, opt.step 5, the
           placements as state_specs resolves them, the checkpoint's
           manifest an unsharded save's, B1, B6 and B6-bwd launched on
           every rank, and each rank's first B6 and B6-bwd calls of each
           mesh against their plain versions (r, k, v in f32 at
           rtol=atol=2e-4; as captured, bf16 outputs within one bf16
           step); per rank and step its seconds, busy and idle share, peak
           memory, and the all_reduce and broadcast counts and bytes
  serve-sharded  the sharded server (BatchedServer(mesh=, param_specs=)):
           mistral-nemo-12b at full width on 2 of 40 layers, bf16 from seed
           0, the serve phase's first 16 requests with 32 new tokens,
           SERVE's settings, unsharded on the card first (and the 4
           shortest on dense caches through the gather path), then 4 gloo
           ranks on the card (``chip_smoke.py --serve-rank``) on a (2 data
           x 2 model) mesh: the pool replicated over data with repro's
           fallback recorded, the KV heads over model, so B5 at KVH 4, G 4,
           D 128 over each rank's own contiguous pools; every request
           FINISHED, B5 once a layer a fused decode on every rank, every
           call of the first fused step against its plain version at 2e-5,
           no rank's tokens other than rank 0's, the tokens the unsharded
           run's except at reported near-ties (the sharded decode
           teacher-forced against the unsharded one, within
           DEVIATION_LIMIT); the dense check (slots over data, heads over
           model) the same way; per rank its seconds and tokens/s, the
           collectives and their bytes a fused step, busy and idle share
           and peak memory; rank 0's B5 call of step 20 kept for the
           kernels line
  roofline-host  (in a process of its own, beside serve) the dry-run
           (repro_torch.launch.dryrun) on the host's CPU: ROOFLINE_CELLS'
           steps on meta tensors over a fake process group of 256 or 512
           ranks, a line per cell: status, GiB a device, flops a device,
           wire bytes, the H100 roofline's three terms and bound
  roofline  rwkv6-3b's train step at full width on a one-rank mesh on the
           card (train_4k's 4,096 positions, its batch cut to 4 rows and
           its depth to 2 of 32 layers), through B6 and B6-bwd, beside the
           dry-run's prediction of the same step on meta: 3 timed steps
           after a warm one, the peak memory; fails unless the predicted
           argument bytes are the card's bytes of weights, moments and
           inputs exactly, the predicted arguments plus temporaries lie
           within [0.5, 2] of the measured peak, and the step is no shorter
           than the compute term at the bf16 peak
  kernels  each kernel's launches on the main path (B1's, B6's and
           B6-bwd's on the mesh path too, per rank; B3's: the GLM scans' and
           the LM statements'; B2's one-batch gradient: the sharded ranks',
           and its time at their shares, (64, 54) and (128, 54)), error,
           time, bound,
           plain version's time and library yardstick; the SGD walk per full
           chunk, per tail chunk, per batch and at D = 2,000; B4 with the
           scan's bool mask and an f32 one, beside its bound on live rows and
           on every row, with X warm in L2, and torch.sum over the same
           rows; B5 at both captured
           calls, with their runs and without, beside its bounds on each
           distinct K/V row, on each run's context and token by token, and
           under "mla" serve-mla's two calls (the latent body, its CTAs
           launched and live), with the bound on the latent's own bytes and
           on q·K and P·V in three parts at the bf16 tensor rate, the
           tiled body's bound (P·V at the f32 rate) beside it, the [c ; kr]
           pool concatenation that path made before each call, and the
           gather path's composite as the library yardstick; under "hybrid"
           serve-hybrid's two calls (a sliding-window layer's on the ring
           table, bound on the ring's distinct valid rows, and a global
           layer's), with and without runs, and their launches; under
           "moe" serve-moe's call (KVH 16, G 1, D 128, 16 one-row runs),
           with its launches; under "vlm" serve-vlm's two calls (KVH 8, G
           6, D 128), with and without runs, and their launches; under
           "sharded" serve-sharded's per-rank call (KVH 4, G 4, D 128) and
           each rank's launches, and under "examples" serve_lm's full-width
           call (KVH 8, G 6, D 128, decode-only); the example drivers'
           launches under "examples_launches" in B1-B5's rows; B6's
           two kernels and B6-bwd's three a call, each one's time,
           registers and CTAs per SM, beside the bytes its design moves

The serving phases are bound by their host's launches and the card idles most
of the time in each, so some run beside others, each in a process of its own
(``chip_smoke.py --beside NAME``, its lines printed when it is joined, its
phase's result handed back through a file under build/chip_smoke/):
lm-predict, serve-rwkv, serve-vlm and examples beside serve-mla, then serve-moe and
serve-hybrid (which starts its own gather run) and roofline-host beside
serve and launch;
train-sharded (which starts its 4 ranks) runs through both stages. The peak device memory of the phases
that run together adds to at most 72 GB; the training phases, each near its
own peak of 28-73 GB, run alone, and so do train-elastic and serve-sharded (4 ranks each). Each phase's line carries the time it ended
(``ended_unix_s``). Every kernel-line time is taken with no other process on
the card (B2's one-batch gradient at the ranks' shares, (64, 54) and (128,
54), before the serving phases; its launches are the ranks'). Every process
started is waited for, or killed when a phase fails (a rank whose parent is
gone ends itself).

The last line is {"ok": true, "device": {...}}. Any failure raises, exits
non-zero and prints no such line. Without a CUDA card the script exits 1.

    python3 chip_smoke.py
"""
import contextlib
import dataclasses
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense (NVIDIA data sheet)
WORKLOAD = "remote_sensing_lr"
SCALE = 1.0  # the paper's full table
EPOCHS = 3
MERGE_COEF = 256
# Table 3's tuples and features; 138 tuples fit a 32 KB page, so 4,211 pages;
# 9 chunks of at most 512 pages and 2,270 merge batches of 256 per epoch
EXPECT = {"geometry": (581_102, 54, 138, 4211),
          "launches": {"strider_decode": 27, "glm_sgd_chunk": 27, "glm_grad": 0}}
# the serve phase: mistral-nemo-12b at full width; the longest prompt (1024
# tokens) plus 64 new tokens fits max_seq
SERVE_ARCH = "mistral-nemo-12b"
# the depth of the serve and lm-predict phases (mistral-nemo-12b, 40 layers
# published) and of serve-mla (minicpm3-4b, 62), halved so that the smoke
# stays near half its time limit: every layer has the same shapes, and B5's
# checks and timings are per call; the launch phase serves all 40 layers
SERVE_LAYERS, MLA_SERVE_LAYERS = 20, 31
SERVE = {"batch_slots": 16, "kv": "paged", "block_size": 16, "step_mode": "tokens",
         "prefill_chunk": 16, "attn_impl": "kernel"}
SERVE_REQUESTS = 48
SERVE_MAX_NEW = 64
SERVE_MAX_SEQ = 1088
TEMPLATE_LEN = 256
TEMPLATE_ONLY = (4, 30)
# the serve-mla and train-mla phases: minicpm3-4b at full width and depth,
# (layers, d_model, heads, q_lora, kv_lora, rope, nope, v, d_ff, vocab) of
# configs/minicpm3_4b.py; its absorbed decode is one call a layer of B5's
# latent entry at G 40, Dc 256, Dr 32 (the latent body)
SERVE_MLA_ARCH = "minicpm3-4b"
MLA_FIELDS = ("n_layers", "d_model", "n_heads", "q_lora_rank", "kv_lora_rank",
              "qk_rope_head_dim", "qk_nope_head_dim", "v_head_dim", "d_ff", "vocab_size")
MLA_WIDTH = (62, 2560, 40, 768, 256, 32, 64, 64, 6400, 73448)
# train-mla: batch 4 (the rwkv6-3b phase's 8 halved: 4.07 B parameters take
# 65.2 GB of master, gradient and moments), 4 steps
MLA_TRAIN_BATCH, MLA_TRAIN_STEPS = 4, 4
# torch.cat's kernels in a profile: on the MLA kernel path, each layer's
# [q_lat ; qr] queries and rope halves (no pool)
CAT_KERNELS = "CatArrayBatchedCopy"
# the most that two sound computations' greedy logits may deviate (largest
# spread over the vocab of their difference, teacher-forced) before a
# divergence between them stops counting as a near-tie. Sound runs on an
# H100 spread 0.094-0.106 (kernel vs gather) and 0.146 (8 vs 64 tokens per
# call); a bf16 logit in [4, 8) moves in steps of 0.03125
DEVIATION_LIMIT = 0.25
B4_KERNEL = "glm_predict_kernel"  # B4 in profiles
KERNEL_SOURCES = ("strider_decode", "glm_grad", "strider_decode_projected", "glm_predict",
                  "paged_attn", "wkv", "wkv_bwd")
# the predict phase's statements (table 'remote_sensing', UDF 'rs_lr')
SQL = {
    "train": "SELECT * FROM dana.rs_lr('remote_sensing');",
    "rows": ("SELECT c0, c1 FROM dana.predict('rs_lr', 'remote_sensing') "
             "WHERE c2 > 0.0 OR c3 <= -0.5;"),
    "aggregates": ("SELECT COUNT(*), AVG(prediction), SUM(label) FROM "
                   "dana.predict('rs_lr', 'remote_sensing') WHERE NOT c1 > 0.5;"),
    "insert": ("INSERT OR REPLACE INTO scored SELECT c0 FROM "
               "dana.predict('rs_lr', 'remote_sensing') WHERE c2 > 0.0;"),
}


def emit(obj) -> None:
    if "phase" in obj:  # when each phase ended: the smoke's time by phase, across processes
        obj = dict(obj, ended_unix_s=time.time())
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(calls, reps=5):
    """Device time per call: the calls are captured into one CUDA graph and
    replayed between two CUDA events, so host launch overhead is left out.
    Median over ``reps`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:  # warm the allocator outside the capture
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def busy_ms(calls, reps=5):
    """Device time per call from the device's own events: the calls,
    launched eagerly ``reps`` times under the profiler, and the union of
    their kernels' intervals. Unlike ``device_ms`` it leaves out what
    another process runs on the card between them, so a phase that shares
    the card can time a call."""
    for call in calls:  # warm the allocator and the libraries
        call()

    def run():
        for _ in range(reps):
            for call in calls:
                call()

    _, busy_s, _ = _device_profile(run, cpu=False)
    return 1e3 * busy_s / (reps * len(calls))


def eager_ms(calls, reps=5):
    """Time per call launched eagerly from Python, as the engine's loop
    launches it: host overhead included. Median over ``reps`` runs."""
    import torch

    for call in calls:
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def phase_build():
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.wkv import kernel as wkv_kernel

    head, chunk = TRAIN_WIDTH[4:]
    t0 = time.perf_counter()
    report = build.build(*KERNEL_SOURCES)
    ptxas = {name: _ptxas_lines(log) for name, (_, log) in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v[0] for k, v in report.items()},
          "build_dir": os.path.relpath(build.BUILD_DIR, ROOT), "ptxas": ptxas,
          "wkv_forward_at_training_shape": {
              str(dt)[6:]: wkv_kernel.wkv_forward_info(head, head, chunk, dt)
              for dt in (torch.bfloat16, torch.float32)},
          "wkv_backward_at_training_shape": {
              str(dt)[6:]: wkv_kernel.wkv_backward_info(head, head, chunk, dt)
              for dt in (torch.bfloat16, torch.float32)}})


def _ptxas_lines(log):
    """ptxas's register, shared-memory and spill lines, each after the name
    of the kernel it reports on."""
    out, entry = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "Used" in ln or "spill" in ln:
            out.append(f"{entry}: {ln.replace('ptxas info    :', '').strip()}")
    return out


def phase_parity_strider():
    import numpy as np
    import torch

    from repro_torch.db.heap import write_token_table
    from repro_torch.db.page import PageLayout, build_pages
    from repro_torch.kernels.strider import kernel, ops, ref

    def check(pages_np, layout, what):
        cpu = ops.pages_tensor(pages_np)
        dev = cpu.cuda()
        got = kernel.strider_decode(dev, layout)
        plain = ref.decode_pages_ref(dev, layout)
        host = ref.decode_pages_ref(cpu, layout)
        torch.cuda.synchronize()
        for g, p, h in zip(got, plain, host):
            gi = g.view(torch.int32)
            if not (torch.equal(gi, p.view(torch.int32))
                    and torch.equal(gi.cpu(), h.view(torch.int32))):
                raise AssertionError(f"strider_decode differs from its plain version: {what}")
        return got

    rng = np.random.default_rng(0)
    cases = 0
    for quant in (False, True):
        for d in (1, 54, 520):
            for kb in (8, 32, 128):
                layout = PageLayout(n_features=d, page_bytes=kb * 1024, quantized=quant)
                t = layout.tuples_per_page
                n = 2 * t + t // 2 + 1  # two full pages and a partial last one
                feats = rng.normal(0, 2, (n, d)).astype(np.float32)
                labels = rng.normal(0, 2, n).astype(np.float32)
                got = check(build_pages(feats, labels, layout), layout,
                            f"d={d} page={kb}KB quantized={quant}")
                live = got[2].reshape(-1).bool()
                if int(live.sum()) != n:
                    raise AssertionError("live-slot count differs from the tuple count")
                if not quant and not torch.equal(
                    got[0].reshape(-1, d)[live].cpu(), torch.from_numpy(feats)
                ):
                    raise AssertionError("decoded f32 tuples differ from the table")
                cases += 1
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(os.path.join(SCRATCH, "tokens.heap"), seqs, page_bytes=8192)
    got = check(heap.read_all(), heap.layout, "token page (int32 as f32 denormals)")
    tokens = got[0].view(torch.int32).cpu()
    for i, s in enumerate(seqs):
        if tokens[0, i, : len(s)].tolist() != s:
            raise AssertionError("token ids changed in the decode")
    emit({"phase": "parity", "kernel": "strider_decode", "cases": cases + 1,
          "bit_exact": True})


def phase_parity_glm():
    import numpy as np
    import torch

    from repro_torch.kernels.engine import kernel, ref

    rng = np.random.default_rng(1)
    worst = 0.0
    cases = 0
    for act in ref.ACTS:
        for n, d in ((256, 54), (217, 31), (70_656, 54)):
            x = rng.normal(0, 1, (n, d)).astype(np.float32)
            y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
            if act == "logistic":
                y = (y > 0).astype(np.float32)
            w = rng.normal(0, 0.5, d).astype(np.float32)
            mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
            x[mask == 0] = 1e6  # dead rows must not contribute
            x, y, w, mask = (torch.from_numpy(a).cuda() for a in (x, y, w, mask))
            got = kernel.glm_grad(x, y, w, mask, act)
            again = kernel.glm_grad(x, y, w, mask, act)
            plain = ref.glm_grad_ref(x, y, w, mask, act)
            torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-4)
            if not torch.equal(got, again):
                raise AssertionError("glm_grad is not deterministic")
            worst = max(worst, float((got - plain).abs().max()))
            cases += 1
    emit({"phase": "parity", "kernel": "glm_grad", "cases": cases,
          "rtol": 2e-5, "atol": 2e-4, "max_abs_err": worst, "deterministic": True})


def phase_parity_sgd_chunk():
    """The SGD walk over merge batches against its plain version: every
    activation, widths from 1 to past the shared-memory limit, batches of
    1-256 rows, a ragged last batch and garbage in the dead rows."""
    import numpy as np
    import torch

    from repro_torch.kernels.engine import kernel, ref

    rng = np.random.default_rng(4)
    shapes = [(d, coef) for d in (1, 5, 54, 129, 520, 2000) for coef in (1, 7, 64, 256)]
    shapes += [(8192, 7), (9001, 7)]  # the widest in shared memory, the first past it
    worst = {"w": 0.0, "gnorms": 0.0}
    cases = 0
    for act in ref.ACTS:
        for d, coef in shapes:
            n = 5 * coef + coef // 2 + 1
            x = rng.normal(0, 1, (n, d)).astype(np.float32)
            if act == "linear":
                y = rng.normal(0, 1, n).astype(np.float32)
            else:
                y = np.sign(rng.normal(0, 1, n)).astype(np.float32)
                if act == "logistic":
                    y = (y > 0).astype(np.float32)
            w = rng.normal(0, 0.3, d).astype(np.float32)
            mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
            x[mask == 0] = 99.0  # dead rows must not contribute
            a, b = 1.0 - 1e-3, 0.5 / (coef * d)  # a contractive step at every width
            x, y, mask, w = (torch.from_numpy(v).cuda() for v in (x, y, mask, w))
            got = kernel.glm_sgd_chunk(x, y, mask, w, coef, act, a, b)
            again = kernel.glm_sgd_chunk(x, y, mask, w, coef, act, a, b)
            plain = ref.glm_sgd_chunk_ref(x, y, mask, w, coef, act, a, b)
            what = f"act={act} d={d} coef={coef} n={n}"
            if got[1].shape != (-(-n // coef),):
                raise AssertionError(f"glm_sgd_chunk norms shape {tuple(got[1].shape)}: {what}")
            for name, g, p_ in zip(("w", "gnorms"), got, plain):
                torch.testing.assert_close(g, p_, rtol=1e-4, atol=1e-4, msg=lambda m: f"{what}: {m}")
                worst[name] = max(worst[name], float((g - p_).abs().max()))
            if not all(torch.equal(g, h) for g, h in zip(got, again)):
                raise AssertionError(f"glm_sgd_chunk is not deterministic: {what}")
            cases += 1
    emit({"phase": "parity", "kernel": "glm_sgd_chunk", "cases": cases,
          "widths": sorted({d for d, _ in shapes}), "coefs": sorted({c for _, c in shapes}),
          "rtol": 1e-4, "atol": 1e-4, "max_abs_err": worst, "deterministic": True})


def phase_parity_projected():
    import numpy as np
    import torch

    from repro_torch.core import striders
    from repro_torch.db.heap import write_token_table
    from repro_torch.db.page import PageLayout, build_pages
    from repro_torch.kernels.strider import kernel, ops, ref

    def check(pages_np, layout, plan, what):
        cpu = ops.pages_tensor(pages_np)
        dev = cpu.cuda()
        got = kernel.strider_decode_projected(dev, layout, plan)
        plain = ref.decode_pages_projected_ref(dev, layout, plan)
        host = ref.decode_pages_projected_ref(cpu, layout, plan)
        torch.cuda.synchronize()
        if got[0].shape != (pages_np.shape[0], layout.tuples_per_page, plan.n_columns):
            raise AssertionError(f"strider_decode_projected shape: {what}")
        for g, p, h in zip(got, plain, host):
            gi = g.view(torch.int32)
            if not (torch.equal(gi, p.view(torch.int32))
                    and torch.equal(gi.cpu(), h.view(torch.int32))):
                raise AssertionError(
                    f"strider_decode_projected differs from its plain version: {what}")
        return got

    rng = np.random.default_rng(2)
    cases = 0
    for quant in (False, True):
        for d in (1, 54, 520):
            for kb in (8, 32, 128):
                layout = PageLayout(n_features=d, page_bytes=kb * 1024, quantized=quant)
                t = layout.tuples_per_page
                n = 2 * t + t // 2 + 1  # two full pages and a partial last one
                pages = build_pages(rng.normal(0, 2, (n, d)).astype(np.float32),
                                    rng.normal(0, 2, n).astype(np.float32), layout)
                # one column, scattered runs, all columns, label only
                plans = {"one": [d // 2], "all": range(d), "label_only": [],
                         "scattered": sorted({0, d // 3, d // 3 + 1, d - 1} & set(range(d)))}
                for name, cols in plans.items():
                    for label in (True, False) if cols else (True,):
                        plan = striders.projection_plan(layout, cols, include_label=label)
                        check(pages, layout, plan,
                              f"d={d} page={kb}KB quantized={quant} plan={name} label={label}")
                        cases += 1
    seqs = [[1, 2, 3, 4], [7, 0, 5], [2**31 - 1, 1, 2**20], [9]]
    heap = write_token_table(os.path.join(SCRATCH, "tokens_projected.heap"), seqs,
                             page_bytes=8192)
    got = check(heap.read_all(), heap.layout, striders.full_plan(heap.layout),
                "token page (int32 as f32 denormals), full plan")
    tokens = got[0].view(torch.int32).cpu()
    for i, s in enumerate(seqs):
        if tokens[0, i, : len(s)].tolist() != s:
            raise AssertionError("token ids changed in the projected decode")
    emit({"phase": "parity", "kernel": "strider_decode_projected", "cases": cases + 1,
          "bit_exact": True})


def phase_parity_predict():
    import torch

    from repro_torch.kernels.engine import kernel, ref
    from test_torch_predict_plan import CASES, make

    worst = 0.0
    cases = 0
    bodies = set()
    for act in ref.ACTS:
        for name, n, d, kind in CASES:
            buf, w, mask = (torch.from_numpy(a).cuda() for a in make(n, d, kind))
            x = buf[1:] if kind == "misaligned" else buf  # 4-byte aligned, not 16
            got = kernel.glm_predict(x, w, mask, act)
            again = kernel.glm_predict(x, w, mask, act)
            keep = kernel.glm_predict(x, w, mask > 0, act)
            plain = ref.glm_predict_ref(x, w, mask, act)
            torch.testing.assert_close(got, plain, rtol=0, atol=2e-6)
            if act == "svm" and not torch.equal(got, plain):
                raise AssertionError(f"glm_predict svm differs from its plain version ({name})")
            if not torch.equal(got, again):
                raise AssertionError(f"glm_predict is not deterministic ({name})")
            if not torch.equal(got.view(torch.int32), keep.view(torch.int32)):
                raise AssertionError(f"glm_predict with a bool mask differs ({name})")
            if not torch.isfinite(got).all() or got[mask == 0].any():
                raise AssertionError(f"glm_predict leaked a dead row ({name})")
            worst = max(worst, float((got - plain).abs().max()))
            bodies.add(kernel.glm_predict_plan(n, d).body)
            cases += 1
    emit({"phase": "parity", "kernel": "glm_predict", "cases": cases,
          "shapes": [c[0] for c in CASES], "bodies": sorted(bodies), "rtol": 0,
          "atol": 2e-6, "svm": "exact", "bool_mask": "bit-exact", "max_abs_err": worst,
          "deterministic": True})


def _wrappers():
    """Each kernel's wrapper by name: each counts the launches of its kernel."""
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.wkv import kernel as wkv_kernel

    return {"strider_decode": strider_kernel.strider_decode,
            "glm_sgd_chunk": glm_kernel.glm_sgd_chunk,
            "glm_grad": glm_kernel.glm_grad,
            "strider_decode_projected": strider_kernel.strider_decode_projected,
            "glm_predict": glm_kernel.glm_predict,
            "paged_attn": pa_kernel.paged_attention,
            "paged_latent_attn": pa_kernel.paged_latent_attention,
            "wkv": wkv_kernel.wkv_forward,
            "wkv_bwd": wkv_kernel.wkv_backward}


def zero_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _source_spans(objs):
    """(file, first line, last line) of each function, class or module."""
    spans = []
    for obj in objs:
        lines, first = inspect.getsourcelines(obj)
        spans.append((os.path.realpath(inspect.getsourcefile(obj)), first,
                      first + len(lines)))
    return spans


def _hot_loop_lines():
    """(file, first line, last line) of the code the engine runs per chunk."""
    from repro_torch.core import engine
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ops as glm_ops
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.strider import ops as strider_ops

    return _source_spans((
        engine.Engine.run_chunk, engine.Engine.run_epoch, engine.Engine.batch_step,
        engine.Engine._sgd_chunk, engine.PinnedStager.__call__, engine.batches_from_stream,
        glm_kernel, glm_ops,
        strider_kernel, strider_ops))


def _scan_loop_lines():
    """(file, first line, last line) of the code a PREDICT scan runs per chunk."""
    from repro_torch.core import engine
    from repro_torch.db import query, scoring
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ops as glm_ops
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.strider import ops as strider_ops

    return _source_spans((
        scoring.PredictScan.units, scoring._scan_units, scoring._ChunkDecoder.__call__,
        scoring._ChunkProgram.__call__, scoring._TokenChunkProgram.__call__,
        engine.PinnedStager.__call__, query.Predicate, query.And, query.Or, query.Not,
        glm_kernel, glm_ops, strider_kernel, strider_ops))


def _device_busy(events):
    """(busy seconds, {name: [ms, count]}) of the device's own events
    (kernels, copies, sets): busy time is the union of their intervals, so
    overlapping events count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += (e.time_range.end - e.time_range.start) / 1e3
        entry[1] += 1
    return busy_us / 1e6, by_name


def _device_profile(run, kernels=(), ranges=(), cpu=True):
    """Run ``run()`` under torch.profiler: (traced seconds, the card's busy
    seconds, the top device and host-self entries in ms totals). Only the
    device's own events are read for device time: an op's
    ``self_device_time_total`` holds the kernels it launched, which are also
    entries of their own. ``kernels`` names substrings whose device ms are
    reported under ``device_ms_of``; ``ranges`` names record_function ranges
    whose kernels' device ms (those launched inside them) are reported
    under ``device_ms_in``. ``cpu=False`` traces the device and the CUDA
    runtime only (no operator events, which the parse of a step of tens of
    thousands of launches spends most of its time on; no ``ranges``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        traced_s = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_s, by_name = _device_busy(device)
    stats = prof.key_averages()
    top = {"top_device": [[name, ms, n] for name, (ms, n) in
                          sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]],
           "top_host_self": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                             for e in sorted(stats, key=lambda e: e.self_cpu_time_total,
                                             reverse=True)[:8]]}
    top["launch_calls"] = sum(e.count for e in stats if "LaunchKernel" in e.key)
    if kernels:
        top["device_ms_of"] = {k: sum(ms for name, (ms, _) in by_name.items() if k in name)
                               for k in kernels}
        top["launches_of"] = {k: sum(n for name, (_, n) in by_name.items() if k in name)
                              for k in kernels}
    if ranges:
        top["device_ms_in"] = {r: sum(e.device_time_total for e in prof.events()
                                      if e.name == r and e.device_type == DeviceType.CPU) / 1e3
                               for r in ranges}
    return traced_s, busy_s, top


def _synchronizing_calls(run, spans):
    """Run ``run()`` under torch.cuda.set_sync_debug_mode("warn"): the
    synchronizing calls by file:line, and how many fell inside ``spans``."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where: dict[str, int] = {}
    inside = 0
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        path = os.path.realpath(w.filename)
        key = f"{os.path.relpath(path, ROOT)}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
        inside += any(path == f and a <= w.lineno < b for f, a, b in spans)
    return where, inside


def _staging_epoch(run, engine):
    """Run one epoch with the engine's pinned stager timed: the epoch's
    seconds, its exposed I/O (waits for the pool's fetch) and the seconds
    spent in the stager, whose host copy of each chunk's pages sets the
    pace once the card's work is one launch a chunk."""
    stage = engine._stage
    spent = []

    def timed(pages):
        t0 = time.perf_counter()
        out = stage(pages)
        spent.append(time.perf_counter() - t0)
        return out

    engine._stage = timed
    try:
        res = run()
    finally:
        engine._stage = stage
    return {"epoch_s": res.total_s, "exposed_io_s": res.exposed_io_s,
            "stager_s": sum(spent), "stager_calls": len(spent)}


def phase_e2e():
    import numpy as np
    import torch

    from repro_torch.algorithms import logistic_regression
    from repro_torch.core import solver
    from repro_torch.core.engine import make_engine
    from repro_torch.core.translator import trace
    from repro_torch.data.synthetic import WORKLOADS, generate
    from repro_torch.db.bufferpool import BufferPool
    from repro_torch.db.heap import write_table

    wl = WORKLOADS[WORKLOAD]
    t0 = time.perf_counter()
    X, y = generate(wl, scale=SCALE, seed=0)
    heap = write_table(os.path.join(SCRATCH, f"{WORKLOAD}.heap"), X, y,
                       page_bytes=wl.page_bytes)
    pool = BufferPool(pool_bytes=heap.n_pages * heap.layout.page_bytes,
                      page_bytes=heap.layout.page_bytes)
    pool.warm(heap)
    setup_s = time.perf_counter() - t0
    if (heap.n_tuples, heap.layout.n_features, heap.layout.tuples_per_page,
            heap.n_pages) != EXPECT["geometry"]:
        raise AssertionError("remote_sensing_lr geometry differs from the paper's table")
    n_chunks = -(-heap.n_pages // solver.MAX_RESIDENT_PAGES)
    batches = sum(
        -(-min(solver.MAX_RESIDENT_PAGES, heap.n_pages - s) * heap.layout.tuples_per_page
          // MERGE_COEF)
        for s in range(0, heap.n_pages, solver.MAX_RESIDENT_PAGES)
    )

    g, part = trace(lambda: logistic_regression(54, lr=0.1, merge_coef=MERGE_COEF,
                                                epochs=EPOCHS))
    engine = make_engine(g, part, device="cuda")
    if engine.glm_template != "logistic" or not engine.chunk_kernel:
        raise AssertionError("the engine did not take the SGD walk over merge batches")
    a, b = engine.fused_update
    if a != 1.0 or not math.isclose(b, 0.1 / MERGE_COEF, rel_tol=1e-6):
        raise AssertionError(f"affine update {engine.fused_update}, expected (1, 0.1/256)")

    sync_at = []
    real_sync = solver._device_sync

    def timed_sync(models, gnorm):
        out = real_sync(models, gnorm)
        sync_at.append(time.perf_counter())
        return out

    misses = pool.misses
    solver._device_sync = timed_sync
    try:
        zero_launches()
        t_start = time.perf_counter()
        res = solver.train(g, part, heap, pool=pool, mode="dana", engine=engine, seed=0)
        t_end = time.perf_counter()
        launches = read_launches()
    finally:
        solver._device_sync = real_sync
    epoch_s = [b - a for a, b in zip([t_start] + sync_at[:-1], sync_at)]

    want = {"strider_decode": EPOCHS * n_chunks, "glm_sgd_chunk": EPOCHS * n_chunks,
            "glm_grad": 0, "strider_decode_projected": 0, "glm_predict": 0, "paged_attn": 0,
            "paged_latent_attn": 0, "wkv": 0, "wkv_bwd": 0}
    if launches != want or want != dict(EXPECT["launches"], strider_decode_projected=0,
                                        glm_predict=0, paged_attn=0, paged_latent_attn=0,
                                        wkv=0, wkv_bwd=0):
        raise AssertionError(f"launches {launches}, expected {want}")
    if res.device_syncs != EPOCHS or res.epochs_run != EPOCHS or len(sync_at) != EPOCHS:
        raise AssertionError(f"device_syncs {res.device_syncs} != {EPOCHS}")
    if pool.misses != misses:
        raise AssertionError("the warm pool missed")
    w_gpu = res.models[0]
    if w_gpu.shape != (54,) or not np.isfinite(w_gpu).all():
        raise AssertionError("trained coefficients are not 54 finite values")

    t_cpu = time.perf_counter()
    cpu = solver.train(g, part, heap, pool=pool, mode="dana", seed=0, device="cpu")
    cpu_s = time.perf_counter() - t_cpu
    # both runs do the same f32 arithmetic and differ only in summation order
    # (warp shuffles against CPU BLAS) and expf's last bit; over 6,810
    # contractive SGD steps those stay orders below 1e-4
    np.testing.assert_allclose(w_gpu, cpu.models[0], rtol=1e-4, atol=1e-4)
    accuracy = float(((X @ w_gpu > 0).astype(np.float32) == y).mean())

    emit({"phase": "e2e", "workload": WORKLOAD, "algorithm": "logistic",
          "n_tuples": heap.n_tuples, "n_features": 54, "pages": heap.n_pages,
          "page_bytes": heap.layout.page_bytes, "heap_bytes": heap.n_pages * wl.page_bytes,
          "merge_coef": MERGE_COEF, "fused_update": engine.fused_update,
          "epochs": res.epochs_run, "chunks_per_epoch": n_chunks,
          "merge_batches_per_epoch": batches, "launches": launches,
          "device_syncs": res.device_syncs, "setup_s": setup_s,
          "total_s": t_end - t_start, "train_total_s": res.total_s, "epoch_s": epoch_s,
          "tuples_per_s": EPOCHS * heap.n_tuples / (t_end - t_start),
          "compute_s": res.compute_s, "exposed_io_s": res.exposed_io_s,
          "overlapped_io_s": res.overlapped_io_s, "grad_norms": res.grad_norms,
          "cpu_total_s": cpu_s, "max_abs_diff_vs_cpu": float(np.abs(w_gpu - cpu.models[0]).max()),
          "tolerance_vs_cpu": {"rtol": 1e-4, "atol": 1e-4},
          "train_accuracy": accuracy})

    # one more epoch with every synchronising CUDA call reported
    where, in_hot_loop = _synchronizing_calls(
        lambda: solver.train(g, part, heap, pool=pool, mode="dana", engine=engine,
                             max_epochs=1, seed=0),
        _hot_loop_lines())
    emit({"phase": "syncs", "epochs": 1, "synchronizing_calls": sum(where.values()),
          "where": where, "in_run_chunk": in_hot_loop})
    if in_hot_loop:
        raise AssertionError("the chunk loop synchronises with the host")

    # one more epoch under the profiler: the card's busy time over the epoch
    traced_s, busy_s, top = _device_profile(
        lambda: solver.train(g, part, heap, pool=pool, mode="dana", engine=engine,
                             max_epochs=1, seed=0))
    steady_s = statistics.median(epoch_s[1:])
    # one more epoch untraced, with the host's page staging timed: the pinned
    # stager's copy of each chunk (and its wait for the buffer's last send)
    staging = _staging_epoch(lambda: solver.train(g, part, heap, pool=pool, mode="dana",
                                                  engine=engine, max_epochs=1, seed=0),
                             engine)
    staging["chunk_bytes"] = solver.MAX_RESIDENT_PAGES * heap.layout.page_bytes
    emit({"phase": "profile", "epochs": 1, "traced_epoch_s": traced_s,
          "device_busy_s": busy_s if busy_s else None,
          "untraced_epoch_s": steady_s,
          "device_idle_share": 1.0 - busy_s / steady_s if busy_s else None,
          "staging": staging, **top, "units": "ms totals over the epoch"})
    return heap, engine, res, launches


def _kept_rows(res):
    """(projected columns, predictions) of a PREDICT's kept rows, read back
    from its result pages."""
    import numpy as np

    from repro_torch.db.page import parse_page

    parsed = [parse_page(p, res.result_layout) for p in res.result_pages]
    return (np.concatenate([f for f, _, _ in parsed]),
            np.concatenate([p for _, p, _ in parsed]))


def phase_predict(heap, res):
    from repro_torch.algorithms import logistic_regression
    from repro_torch.db import Database, scoring
    from repro_torch.db.query import register_udf_from_trace

    # the pool holds the whole table, warm, as in phase e2e: the scans
    # measure the scoring path, not the reads of the heap file
    db = Database(os.path.join(SCRATCH, "catalog"), page_bytes=heap.layout.page_bytes,
                  pool_bytes=heap.n_pages * heap.layout.page_bytes,
                  chunk_pages=scoring.CHUNK_PAGES, device="cuda")
    db.pool.warm(heap)
    db.catalog.register_table("remote_sensing", heap.path, {"n_features": 54})
    for udf in ("rs_lr", "rs_lr_bg"):  # rs_lr_bg: the background TRAIN below
        register_udf_from_trace(
            db.catalog, udf,
            lambda: logistic_regression(54, lr=0.1, merge_coef=MERGE_COEF, epochs=EPOCHS),
            layout=heap.layout)
    n_chunks = -(-heap.n_pages // scoring.CHUNK_PAGES)

    joins = []  # (chunks joined, seconds) per scan
    real_join = scoring._device_join

    def timed_join(outs, aggregate):
        t0 = time.perf_counter()
        out = real_join(outs, aggregate)
        joins.append((len(outs), time.perf_counter() - t0))
        return out

    scoring._device_join = timed_join
    try:
        return _predict_phase(heap, res, db, n_chunks, joins)
    finally:
        scoring._device_join = real_join


def _predict_phase(heap, res, db, n_chunks, joins):
    """phase_predict's body, with ``joins`` recording each scan's join."""
    import numpy as np
    import torch

    from repro_torch.db import Database, query, scoring
    from repro_torch.db.heap import HeapFile
    from repro_torch.db.page import parse_page

    sess = db.connect()
    scans, per_scan = {}, {}
    zero_launches()
    t0 = time.perf_counter()
    train = sess.sql(SQL["train"], max_epochs=EPOCHS, seed=0)
    for name in ("rows", "aggregates", "insert"):
        before = read_launches()
        scans[name] = sess.sql(SQL[name])
        per_scan[name] = {k: v - before[k] for k, v in read_launches().items()}
    main_s = time.perf_counter() - t0
    launches = read_launches()

    if train.coefficients[0].tobytes() != res.models[0].tobytes():
        raise AssertionError("the SQL TRAIN's coefficients differ from solver.train's")
    want = {"strider_decode": EXPECT["launches"]["strider_decode"],
            "glm_sgd_chunk": EXPECT["launches"]["glm_sgd_chunk"],
            "glm_grad": EXPECT["launches"]["glm_grad"],
            "strider_decode_projected": 3 * n_chunks, "glm_predict": 3 * n_chunks,
            "paged_attn": 0, "paged_latent_attn": 0, "wkv": 0, "wkv_bwd": 0}
    if launches != want:
        raise AssertionError(f"predict-path launches {launches}, expected {want}")
    if [n for n, _ in joins] != [n_chunks] * 3:
        raise AssertionError(f"joins per scan {joins}, expected one after {n_chunks} chunks")
    lines = {}
    for (name, r), (_, join_s) in zip(scans.items(), joins):
        kept = r.n_rows if r.aggregates is None else r.aggregates["count(*)"]
        if r.device_syncs != 1 or r.rows_scanned != heap.n_tuples:
            raise AssertionError(f"{name}: device_syncs {r.device_syncs}")
        if per_scan[name]["strider_decode_projected"] != n_chunks or \
                per_scan[name]["glm_predict"] != n_chunks:
            raise AssertionError(f"{name}: launches {per_scan[name]}")
        lines[name] = {
            "sql": SQL[name], "rows_scanned": r.rows_scanned, "rows_kept": kept,
            "decode_bytes_ratio": r.pushdown.decode_bytes_ratio,
            "columns_decoded": len(r.pushdown.columns_decoded),
            "include_label": r.pushdown.include_label, "seconds": r.total_s,
            "rows_per_s": r.rows_scanned / r.total_s, "exposed_io_s": r.exposed_io_s,
            "overlapped_io_s": r.overlapped_io_s, "compute_s": r.compute_s,
            "join_s": join_s, "device_syncs": r.device_syncs, "launches": per_scan[name],
        }
    rows = scans["rows"]
    if rows.predictions.shape != (rows.n_rows,) or not np.isfinite(rows.predictions).all() \
            or not ((rows.predictions >= 0) & (rows.predictions <= 1)).all():
        raise AssertionError("PREDICT rows: predictions are not finite probabilities")
    scored = HeapFile(db.catalog.table("scored")["heap"])
    labels = np.concatenate([parse_page(p, scored.layout)[1] for p in scored.read_all()])
    if scored.n_tuples != scans["insert"].n_rows or \
            labels.tobytes() != scans["insert"].predictions.tobytes():
        raise AssertionError("the INSERTed table differs from the scan's predictions")

    # statements 2 and 3 replayed on the CPU (the kernels' plain versions)
    cpu = Database(db.catalog, page_bytes=heap.layout.page_bytes, device="cpu").connect()
    t0 = time.perf_counter()
    cpu_rows = cpu.sql(SQL["rows"])
    cpu_agg = cpu.sql(SQL["aggregates"])
    cpu_s = time.perf_counter() - t0
    feats, preds = _kept_rows(rows)
    cpu_feats, cpu_preds = _kept_rows(cpu_rows)
    if feats.tobytes() != cpu_feats.tobytes():
        raise AssertionError("the card and the CPU kept different rows or columns")
    np.testing.assert_allclose(preds, cpu_preds, rtol=0, atol=2e-6)
    np.testing.assert_allclose(rows.predictions, cpu_rows.predictions, rtol=0, atol=2e-6)
    gpu_agg = scans["aggregates"].aggregates
    if gpu_agg["count(*)"] != cpu_agg.aggregates["count(*)"]:
        raise AssertionError("COUNT(*) differs between the card and the CPU")
    for k in ("avg(prediction)", "sum(label)"):
        np.testing.assert_allclose(gpu_agg[k], cpu_agg.aggregates[k], rtol=1e-4)

    # the concurrent executor: a background one-epoch TRAIN interleaved with
    # statements 2 and 3, against the serial run of the same three
    bg_sql = SQL["train"].replace("rs_lr(", "rs_lr_bg(")
    serial_bg = sess.sql(bg_sql, max_epochs=1, seed=0)
    h_bg = sess.submit(bg_sql, priority=2, max_epochs=1, seed=0)
    h_rows = sess.submit(SQL["rows"], priority=0)
    h_agg = sess.submit(SQL["aggregates"], priority=0)
    t0 = time.perf_counter()
    metrics = sess.drain()
    executor_s = time.perf_counter() - t0
    got_rows, got_agg, got_bg = h_rows.result(), h_agg.result(), h_bg.result()
    if (got_rows.predictions.tobytes() != rows.predictions.tobytes()
            or got_rows.result_pages.tobytes() != rows.result_pages.tobytes()
            or got_agg.aggregates != gpu_agg
            or got_bg.coefficients[0].tobytes() != serial_bg.coefficients[0].tobytes()):
        raise AssertionError("interleaved results differ from the serial run")
    if got_rows.device_syncs != 1 or got_agg.device_syncs != 1:
        raise AssertionError("an interleaved scan joined the card more than once")

    # one more scan with every synchronising CUDA call reported; one more
    # untraced (the first scan paid for its pinned buffers) and one under the
    # profiler: the card's busy time over a steady scan
    where, in_loop = _synchronizing_calls(lambda: sess.sql(SQL["rows"]), _scan_loop_lines())
    steady = sess.sql(SQL["rows"])
    steady_join_s = joins[-1][1]
    if steady.predictions.tobytes() != rows.predictions.tobytes():
        raise AssertionError("a second scan of the same statement differs")
    traced_s, busy_s, top = _device_profile(lambda: sess.sql(SQL["rows"]),
                                            kernels=(B4_KERNEL,))
    # the launches of one chunk's program (decode, WHERE, keep mask, scoring)
    scan = scoring.PredictScan(query.parse(SQL["rows"]), db.catalog, device="cuda")
    pages = heap.read_pages(np.arange(min(scoring.CHUNK_PAGES, heap.n_pages)))
    scan.run_chunk(pages)
    torch.cuda.synchronize()
    _, _, chunk_top = _device_profile(lambda: scan.run_chunk(pages))
    sess.close()
    emit({"phase": "predict", "workload": WORKLOAD, "chunk_pages": scoring.CHUNK_PAGES,
          "chunks_per_scan": n_chunks, "main_path_s": main_s, "launches": launches,
          "train": {"sql": SQL["train"], "seconds": train.total_s,
                    "device_syncs": train.device_syncs, "byte_identical_to_e2e": True},
          "scans": lines, "cpu_replay": {"seconds": cpu_s, "rows_kept": cpu_rows.n_rows,
                                         "max_abs_diff": float(np.abs(preds - cpu_preds).max()),
                                         "aggregates": cpu_agg.aggregates,
                                         "card_aggregates": gpu_agg},
          "executor": {"seconds": executor_s, "steps": metrics.steps,
                       "train_units": metrics.train_units,
                       "predict_units": metrics.predict_units,
                       "occupancy_pct": metrics.occupancy_pct,
                       "byte_identical_to_serial": True},
          "syncs": {"synchronizing_calls": sum(where.values()), "where": where,
                    "in_chunk_loop": in_loop},
          "profile": {"sql": SQL["rows"], "traced_scan_s": traced_s,
                      "device_busy_s": busy_s if busy_s else None,
                      "untraced_scan_s": steady.total_s, "untraced_join_s": steady_join_s,
                      "untraced_compute_s": steady.compute_s,
                      "device_idle_share": 1.0 - busy_s / steady.total_s if busy_s else None,
                      "b4_share_of_busy": (top["device_ms_of"][B4_KERNEL] / (1e3 * busy_s)
                                           if busy_s else None),
                      **top, "units": "ms totals over the scan"},
          "chunk_program": {"sql": SQL["rows"], "launch_calls": chunk_top["launch_calls"],
                            "top_device": chunk_top["top_device"]}})
    if in_loop:
        raise AssertionError("the scan's chunk loop synchronises with the host")
    return db, launches


def phase_kernels(heap, engine, res, launches, db, predict_launches):
    import numpy as np
    import torch

    from repro_torch.core.engine import batches_from_stream
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ref as glm_ref
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.strider import ops as strider_ops
    from repro_torch.kernels.strider import ref as strider_ref

    layout = heap.layout
    p = 512  # the main path's chunk of pages
    # four chunks in turn: 64 MB of pages, more than the 50 MB L2
    chunks = [
        strider_ops.pages_tensor(
            heap.read_pages(np.arange(k * p, (k + 1) * p) % heap.n_pages)
        ).cuda()
        for k in range(4)
    ]
    got = strider_kernel.strider_decode(chunks[0], layout)
    plain = strider_ref.decode_pages_ref(chunks[0], layout)
    b1_err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    b1_bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, plain))
    t, d = layout.tuples_per_page, layout.n_features
    b1_bytes = p * layout.page_bytes + 4 * p * t * (d + 2)
    b1_calls = [lambda c=c: strider_kernel.strider_decode(c, layout) for c in chunks] * 5
    b1_plain = [lambda c=c: strider_ref.decode_pages_ref(c, layout) for c in chunks] * 5
    b1 = {
        "name": "strider_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/strider_decode.cu",
        "replaces": "src/repro/kernels/strider/strider.py:44",
        "launches": launches["strider_decode"], "max_abs_err": b1_err,
        "bit_exact": b1_bits,
        "shape": f"pages ({p}, {layout.page_words}) int32 -> feats ({p}, {t}, {d})",
        "ms": device_ms(b1_calls), "host_ms": eager_ms(b1_calls),
        "plain_ms": device_ms(b1_plain),
        "bound_ms": 1e3 * b1_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "bound_bytes": b1_bytes, "library_ms": None,
    }
    del b1_calls, b1_plain

    feats, labels, mask = strider_kernel.strider_decode(chunks[0], layout)
    n = p * t
    X, Y, M = batches_from_stream(feats.reshape(n, d), labels.reshape(n),
                                  mask.reshape(n), engine.merge_coef)
    w = torch.from_numpy(res.models[0]).cuda()
    nb, rows = X.shape[0], X.shape[1]
    b2_err = max(
        float((glm_kernel.glm_grad(X[b], Y[b], w, M[b], "logistic")
               - glm_ref.glm_grad_ref(X[b], Y[b], w, M[b], "logistic")).abs().max())
        for b in range(nb)
    )
    b2_bytes = 4 * (rows * d + 2 * rows + 2 * d)
    b2_flops = 4 * rows * d
    b2_calls = [lambda b=b: glm_kernel.glm_grad(X[b], Y[b], w, M[b], "logistic")
                for b in range(nb)]
    b2_plain = [lambda b=b: glm_ref.glm_grad_ref(X[b], Y[b], w, M[b], "logistic")
                for b in range(nb)]
    b2_lib = [lambda b=b: torch.matmul((torch.sigmoid(torch.matmul(X[b], w)) - Y[b]) * M[b],
                                       X[b]) for b in range(nb)]
    b2 = {
        "name": "glm_grad", "route": "cuda", "source": "src/repro_torch/csrc/glm_grad.cu",
        "replaces": "src/repro/kernels/engine/engine.py:26",
        "launches": launches["glm_grad"], "max_abs_err": b2_err,
        "shape": f"x ({rows}, {d}) f32, logistic, one merge batch (the convergence check's)",
        "ms": device_ms(b2_calls), "host_ms": eager_ms(b2_calls),
        "plain_ms": device_ms(b2_plain),
        "bound_ms": 1e3 * max(b2_bytes / HBM_BYTES_PER_S, b2_flops / F32_FLOPS),
        "bound_by": "bytes" if b2_bytes / HBM_BYTES_PER_S >= b2_flops / F32_FLOPS
        else "operations",
        "bound_bytes": b2_bytes,
        "library_ms": device_ms(b2_lib),
        "library": "composite: torch.matmul, sigmoid, sub, mul, torch.matmul",
        "sharded": [_glm_grad_share(X, Y, M, w, rows) for rows in (64, 128)],
    }
    del X, Y, M, b2_calls, b2_plain, b2_lib
    b2_chunk = kernel_row_sgd_chunk(chunks, layout, engine, w, launches)

    # B3 and B4 at the predict phase's 512-page chunks: statement 2's plan
    # (54 columns, no label) over the same four chunks as B1
    from repro_torch.db import query, scoring

    scan = scoring.PredictScan(query.parse(SQL["rows"]), db.catalog, device="cuda")
    plan, prog = scan.plan, scan.run_chunk
    got = strider_kernel.strider_decode_projected(chunks[0], layout, plan, prog.decode.src)
    plain = strider_ref.decode_pages_projected_ref(chunks[0], layout, plan)
    b3_err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    b3_bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, plain))
    if not b3_bits:
        raise AssertionError("strider_decode_projected differs at the main path's chunk")
    live = int(got[2].sum())
    c = plan.n_columns
    b3_bytes = live * plan.bytes_per_tuple + 4 * p + 4 * p * t * (c + 2)
    b3_calls = [lambda ch=ch: strider_kernel.strider_decode_projected(ch, layout, plan, prog.decode.src)
                for ch in chunks] * 5
    b3_plain = [lambda ch=ch: strider_ref.decode_pages_projected_ref(ch, layout, plan)
                for ch in chunks] * 5
    b3 = {
        "name": "strider_decode_projected", "route": "cuda",
        "source": "src/repro_torch/csrc/strider_decode_projected.cu",
        "replaces": "src/repro/kernels/strider/strider.py:84",
        "launches": predict_launches["strider_decode_projected"], "max_abs_err": b3_err,
        "bit_exact": b3_bits,
        "shape": (f"pages ({p}, {layout.page_words}) int32 -> feats ({p}, {t}, {c}), "
                  f"plan of {c} columns, label {plan.include_label}"),
        "ms": device_ms(b3_calls), "host_ms": eager_ms(b3_calls),
        "plain_ms": device_ms(b3_plain),
        "bound_ms": 1e3 * b3_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "bound_bytes": b3_bytes, "library_ms": None,
        "full_decode_ms": b1["ms"],
    }
    del b3_calls, b3_plain

    # B4's inputs as the chunk program gives them: the model's columns of
    # the decoded chunk and statement 2's keep mask (bool), over four chunks
    inputs = []
    for k in range(4):
        _, keep, f2, _ = prog(heap.read_pages(np.arange(k * p, (k + 1) * p) % heap.n_pages))
        x = f2 if prog.model_pos is None else f2.index_select(1, prog.model_pos)
        inputs.append((x.contiguous(), keep))
    w4 = prog.w
    b4_err = max(
        float((glm_kernel.glm_predict(x, w4, m, "logistic")
               - glm_ref.glm_predict_ref(x, w4, m, "logistic")).abs().max())
        for x, m in inputs
    )
    x0, m0 = inputs[0]
    n4, d4 = x0.shape
    live4 = int(m0.sum())
    # live rows of X, the mask at its width, the output and w; beside it the
    # same with an f32 mask (the parent's input) and reading every row of X
    b4_bytes = 4 * live4 * d4 + m0.element_size() * n4 + 4 * n4 + 4 * d4
    b4_bytes_f32 = 4 * (live4 * d4 + 2 * n4 + d4)
    b4_bytes_all = 4 * (n4 * d4 + 2 * n4 + d4)
    b4_flops = 2 * live4 * d4
    b4_bound, b4_by = _bound_ms(b4_bytes, b4_flops)
    b4_calls = [lambda x=x, m=m: glm_kernel.glm_predict(x, w4, m, "logistic")
                for x, m in inputs] * 5
    b4_f32 = [lambda x=x, m=m.float(): glm_kernel.glm_predict(x, w4, m, "logistic")
              for x, m in inputs] * 5
    b4_plain = [lambda x=x, m=m: glm_ref.glm_predict_ref(x, w4, m, "logistic")
                for x, m in inputs] * 5
    b4_lib = [lambda x=x, m=m: torch.where(m, torch.sigmoid(torch.mv(x, w4)), 0.0)
              for x, m in inputs] * 5
    plan4 = glm_kernel.glm_predict_plan(
        n4, d4, torch.cuda.get_device_properties(0).multi_processor_count)
    b4 = {
        "name": "glm_predict", "route": "cuda", "source": "src/repro_torch/csrc/glm_predict.cu",
        "replaces": "src/repro/kernels/engine/engine.py:73",
        "launches": predict_launches["glm_predict"], "max_abs_err": b4_err,
        "shape": f"x ({n4}, {d4}) f32, {live4} live rows, bool keep mask, logistic",
        "plan": dataclasses.asdict(plan4),
        "ms": device_ms(b4_calls), "host_ms": eager_ms(b4_calls),
        "plain_ms": device_ms(b4_plain),
        "bound_ms": b4_bound, "bound_by": b4_by, "bound_bytes": b4_bytes,
        "library_ms": device_ms(b4_lib),
        "library": "torch.where(keep, torch.sigmoid(torch.mv(x, w)), 0)",
        "f32_mask_ms": device_ms(b4_f32),
        "f32_mask_bound_ms": 1e3 * b4_bytes_f32 / HBM_BYTES_PER_S,
        "every_row_bytes": b4_bytes_all,
        "every_row_bound_ms": 1e3 * b4_bytes_all / HBM_BYTES_PER_S,
        # floors of a streaming pass here: the first chunk again and again (X
        # stays in the 50 MB L2), and torch.sum reading the same rows of X
        "same_chunk_ms": device_ms([lambda: glm_kernel.glm_predict(x0, w4, m0, "logistic")] * 20),
        "sum_every_row_ms": device_ms([lambda x=x: x.sum() for x, _ in inputs] * 5),
    }
    if b4_err > 2e-6:
        raise AssertionError(f"glm_predict differs by {b4_err} at the main path's chunks")
    return [b1, b2_chunk, b2, b3, b4]


def _glm_grad_share(X, Y, M, w, rows):
    """B2's one-batch gradient at a rank's share of each merge batch of the
    chunk, ``rows`` of 256 (train-sharded: 64 on the 4 x 1 mesh, 128 where
    the data axis holds 2 ranks), against its plain version and the library
    composite x.T @ ((sigmoid(x @ w) - y) * mask)."""
    import torch

    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ref as glm_ref

    parts = [(X[b, :rows], Y[b, :rows], M[b, :rows]) for b in range(X.shape[0])]
    err = max(float((glm_kernel.glm_grad(x, y, w, m, "logistic")
                     - glm_ref.glm_grad_ref(x, y, w, m, "logistic")).abs().max())
              for x, y, m in parts)
    if err > 2e-4:
        raise AssertionError(f"glm_grad differs by {err} at ({rows}, 54)")
    d = X.shape[2]
    nbytes, flops = 4 * (rows * d + 2 * rows + 2 * d), 4 * rows * d
    bound, by = _bound_ms(nbytes, flops)
    calls = [lambda x=x, y=y, m=m: glm_kernel.glm_grad(x, y, w, m, "logistic")
             for x, y, m in parts]
    return {
        "shape": f"x ({rows}, {d}) f32, logistic, a rank's share of a merge batch",
        "max_abs_err": err, "ms": device_ms(calls), "host_ms": eager_ms(calls),
        "plain_ms": device_ms([lambda x=x, y=y, m=m: glm_ref.glm_grad_ref(x, y, w, m, "logistic")
                               for x, y, m in parts]),
        "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes,
        "library_ms": device_ms([lambda x=x, y=y, m=m: torch.matmul(
            (torch.sigmoid(torch.matmul(x, w)) - y) * m, x) for x, y, m in parts]),
    }


def _sgd_work(n, d, coef):
    """(bytes, f32 operations) of one SGD walk: x, y and mask read once, w
    read and written, a norm a batch; two multiply-adds an element of x."""
    nb = -(-n // coef)
    return 4 * (n * d + 2 * n + 2 * d + nb), 4 * n * d


def _bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_row_sgd_chunk(chunks, layout, engine, w, launches):
    """B2 as the main path launches it: the SGD walk over a decoded chunk's
    merge batches, per full chunk (276 batches) over four chunks in turn,
    per tail chunk (62 batches), at D = 2,000, beside its plain version and
    the per-batch composite of PyTorch calls captured in one CUDA graph."""
    import numpy as np
    import torch

    from repro_torch.core.solver import MAX_RESIDENT_PAGES
    from repro_torch.kernels.engine import kernel as glm_kernel
    from repro_torch.kernels.engine import ref as glm_ref
    from repro_torch.kernels.strider import kernel as strider_kernel

    coef, (a, b) = engine.merge_coef, engine.fused_update
    d = layout.n_features
    flat = []
    for c in chunks:
        f, lab, m = strider_kernel.strider_decode(c, layout)
        n = f.shape[0] * f.shape[1]
        flat.append((f.reshape(n, d), lab.reshape(n), m.reshape(n)))
    tail_rows = EXPECT["geometry"][3] % MAX_RESIDENT_PAGES * layout.tuples_per_page
    tail = tuple(t[:tail_rows] for t in flat[1])

    def walk(x, y, m):
        return glm_kernel.glm_sgd_chunk(x, y, m, w, coef, "logistic", a, b)

    def plain(x, y, m):
        return glm_ref.glm_sgd_chunk_ref(x, y, m, w, coef, "logistic", a, b)

    def composite(x, y, m):
        wv, norms = w, []
        for s in range(0, x.shape[0], coef):
            xb = x[s:s + coef]
            g = torch.matmul((torch.sigmoid(torch.matmul(xb, wv)) - y[s:s + coef])
                             * m[s:s + coef], xb)
            norms.append(torch.linalg.vector_norm(g))
            wv = wv * a - g * b
        return wv, torch.stack(norms)

    err = 0.0
    for x, y, m in flat + [tail]:
        got, want = walk(x, y, m), plain(x, y, m)
        if not all(torch.equal(g, h) for g, h in zip(got, walk(x, y, m))):
            raise AssertionError("glm_sgd_chunk is not deterministic at the main path's chunk")
        for g, p_ in zip(got, want):
            torch.testing.assert_close(g, p_, rtol=1e-4, atol=1e-4)
            err = max(err, float((g - p_).abs().max()))
    n_full, n_tail = flat[0][0].shape[0], tail_rows
    full_bytes, full_flops = _sgd_work(n_full, d, coef)
    tail_bytes, tail_flops = _sgd_work(n_tail, d, coef)
    bound, bound_by = _bound_ms(full_bytes, full_flops)
    ms = device_ms([lambda t=t: walk(*t) for t in flat])
    tail_ms = device_ms([lambda: walk(*tail)] * 4)
    plain_ms = device_ms([lambda: plain(*flat[0])], reps=3)
    library_ms = device_ms([lambda: composite(*flat[0])], reps=3)
    nb_full, nb_tail = -(-n_full // coef), -(-n_tail // coef)

    # wide: D = 2,000 and 256-row batches, 32 batches from a seed
    rng = np.random.default_rng(5)
    dw, nw = 2000, 32 * coef
    xw = torch.from_numpy(rng.normal(0, 1, (nw, dw)).astype(np.float32)).cuda()
    yw = torch.from_numpy((rng.uniform(size=nw) > 0.5).astype(np.float32)).cuda()
    mw = torch.ones(nw, device=xw.device)
    ww = torch.from_numpy(rng.normal(0, 0.01, dw).astype(np.float32)).cuda()
    wide_bytes, wide_flops = _sgd_work(nw, dw, coef)
    wide_bound, wide_by = _bound_ms(wide_bytes, wide_flops)
    wide_ms = device_ms([lambda: glm_kernel.glm_sgd_chunk(xw, yw, mw, ww, coef, "logistic",
                                                          a, b)] * 4)
    return {
        "name": "glm_sgd_chunk", "route": "cuda", "source": "src/repro_torch/csrc/glm_grad.cu",
        "replaces": "src/repro/kernels/engine/engine.py:26",
        "launches": launches["glm_sgd_chunk"], "max_abs_err": err,
        "shape": (f"x ({n_full}, {d}) f32, logistic, {nb_full} merge batches of {coef} "
                  "rows a call, four chunks in turn"),
        "ms": ms, "per_batch_ms": ms / nb_full, "host_ms": eager_ms(
            [lambda t=t: walk(*t) for t in flat]),
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "bound_bytes": full_bytes,
        "library_ms": library_ms,
        "library": ("composite, one CUDA graph of the chunk's batches: torch.matmul, "
                    "sigmoid, sub, mul, torch.matmul, vector_norm, then a*w - b*g"),
        "tail": {"rows": n_tail, "batches": nb_tail, "ms": tail_ms,
                 "per_batch_ms": tail_ms / nb_tail,
                 "bound_ms": _bound_ms(tail_bytes, tail_flops)[0], "bound_bytes": tail_bytes},
        "wide": {"shape": f"x ({nw}, {dw}) f32, {nw // coef} batches of {coef}",
                 "ms": wide_ms, "per_batch_ms": wide_ms / (nw // coef),
                 "bound_ms": wide_bound, "bound_by": wide_by, "bound_bytes": wide_bytes},
    }


def phase_parity_paged_attn():
    import numpy as np
    import torch

    from test_torch_paged_attn_cases import CASES, LATENT_CASES, make
    from repro_torch.kernels.paged_attn import kernel, ref

    cases = {name: fn() for name, fn in CASES.items()}
    # the absorbed-MLA call shapes through the generic entry (separate K and
    # V pools): one kv head, G = n_heads, Dk = kv_lora + rope, Dv = kv_lora
    for g, dk, dv in ((40, 288, 256), (128, 576, 512)):
        cases[f"mla_g{g}_dk{dk}_dv{dv}"] = make(t=7, kvh=1, g=g, dk=dk, dv=dv, nb_slot=8, bs=16,
                                               num_blocks=64, seed=g, bf16=True,
                                               scale=1 / np.sqrt(dk))
    worst, bodies = 0.0, {}

    def check(name, call, plain, args, kw, runs):
        # without runs (every row its own run), then with the case's runs
        for hint in (None, torch.from_numpy(runs).cuda()):
            got = call(*args, runs=hint, **kw)
            body = call.body
            again = call(*args, runs=hint, **kw)
            what = f"{name}, {'no runs' if hint is None else 'runs'}"
            torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5, msg=what)
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attn is not deterministic: {what}")
            bodies[what] = body
        return float((got - plain).abs().max())

    for name, (q, k, v, table, pos, kw, bf16, runs) in cases.items():
        dt = torch.bfloat16 if bf16 else torch.float32
        args = [torch.from_numpy(a).cuda().to(dt) for a in (q, k, v)]
        args += [torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()]
        worst = max(worst, check(name, kernel.paged_attention,
                                 ref.paged_attn_ref(*args, **kw), args, kw, runs))
    # the latent entry over the pools c and kr: minicpm3-4b's and
    # deepseek-v3's shapes among the cases
    for name, fn in LATENT_CASES.items():
        q, c, kr, table, pos, kw, _, runs = fn()
        args = [torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, c, kr)]
        args += [torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()]
        worst = max(worst, check(f"latent_{name}", kernel.paged_latent_attention,
                                 ref.paged_latent_attn_ref(*args, **kw), args, kw, runs))
    for what, body in bodies.items():
        want = "latent" if what.startswith("latent_") else \
            "tiled" if what.startswith("mla_") else None
        if want and body != want:
            raise AssertionError(f"{what} ran the {body} body, not the {want} body")
    emit({"phase": "parity", "kernel": "paged_attn", "cases": len(cases) + len(LATENT_CASES),
          "names": sorted(cases) + [f"latent_{n}" for n in sorted(LATENT_CASES)],
          "with_and_without_runs": True, "rtol": 2e-5, "atol": 2e-5,
          "max_abs_err": worst, "deterministic": True,
          "bodies": {b: sum(v == b for v in bodies.values()) for b in set(bodies.values())}})

def _serve_stream(vocab: int):
    """The serve phase's traffic, from seed 0: (rid, prompt, priority, arrival
    step) for 48 greedy requests. Prompt lengths are drawn over 128-1024;
    every even rid opens with one shared 256-token template (rids in
    TEMPLATE_ONLY are the template alone: their last prompt position lies in
    a shared block, which is copied before it is written); a quarter of the
    requests are priority 0, the rest priority 2; 16 arrive at step 0, then
    one every 3 steps, so priority-0 arrivals find the slots full."""
    import numpy as np

    rng = np.random.default_rng(0)
    template = rng.integers(1, vocab, TEMPLATE_LEN).tolist()
    stream = []
    for rid in range(SERVE_REQUESTS):
        n = int(rng.integers(128, 1025))
        if rid in TEMPLATE_ONLY:
            prompt = list(template)
        elif rid % 2 == 0:
            prompt = template + rng.integers(1, vocab, max(n - TEMPLATE_LEN, 16)).tolist()
        else:
            prompt = rng.integers(1, vocab, n).tolist()
        prio = 0 if rng.random() < 0.25 else 2
        stream.append((rid, prompt, prio, 0 if rid < 16 else 3 * (rid - 16)))
    return stream


class _Arrivals:
    """A stream replayed against a server's step clock: each request is
    submitted at its arrival step."""

    def __init__(self, server, stream, max_new=SERVE_MAX_NEW):
        self.server = server
        self.pending = sorted(stream, key=lambda r: (r[3], r[0]))
        self.i = 0
        self.max_new = max_new

    def run(self, max_steps=None):
        """Step until everything is terminal (or ``max_steps`` steps):
        {rid: request} of the terminal requests."""
        from repro_torch.serve.serving import Request

        srv, steps = self.server, 0
        while (self.i < len(self.pending) or srv.queue
               or any(r is not None for r in srv.active)) \
                and (max_steps is None or steps < max_steps):
            while self.i < len(self.pending) and self.pending[self.i][3] <= srv.step_no:
                rid, prompt, prio, _ = self.pending[self.i]
                srv.submit(Request(rid, list(prompt), self.max_new, priority=prio))
                self.i += 1
            srv.step()
            steps += 1
        return {r.rid: r for r in srv.finished}


def _count_forwards(server):
    """Count the server's fused decodes (each runs every layer's attention)."""
    calls = [0]
    real = server._forward

    def forward(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    server._forward = forward
    return calls


class _PlainCheck:
    """B5's calls on a main path, each held against its plain version at
    rtol=atol=2e-5 right after it runs. The errors stay on the card until
    ``result`` reads them, so the run makes no host read; CUDA events around
    each plain call give the device time the check adds to the run."""

    def __init__(self):
        self.errs, self.events = [], []

    def __call__(self, out, q, k_pool, v_pool, table, pos, kw):
        import torch

        from repro_torch.kernels.paged_attn import ref as pa_ref

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        plain = pa_ref.paged_attn_ref(q, k_pool, v_pool, table, pos, **kw)
        err = (out - plain).abs()
        self.errs.append(torch.stack([(err - 2e-5 - 2e-5 * plain.abs()).max(), err.max()]))
        end.record()
        self.events.append((start, end))

    def result(self, calls, which):
        """The check's record, read after the run; raises unless it held
        ``calls`` calls, each within the bound."""
        import torch

        worst = torch.stack(self.errs).amax(0).tolist() if self.errs else [float("inf")] * 2
        record = {"calls": len(self.errs), "max_abs_err": worst[1], "rtol": 2e-5,
                  "atol": 2e-5, "which": which,
                  "plain_device_s": sum(a.elapsed_time(b) for a, b in self.events) / 1e3}
        if worst[0] > 0 or len(self.errs) != calls:
            raise AssertionError(f"B5 against its plain version on the main path, {calls} "
                                 f"calls expected: {record}")
        return record


def _teacher_forced(cfg, params, seq, side, block):
    """Logits (f32, true vocab) of ``seq`` teacher-forced through one slot,
    ``block`` rows at a time. ``side`` is (impl, tokens per call) for the
    paged decode, optionally followed by a mesh (the cache placed on it as
    the sharded server places its own: every rank of the mesh calls this
    with the same arguments) and ``"dense"`` (a dense cache of as many slots
    as the mesh has data ranks, the sequence in slot 0)."""
    import torch

    from repro_torch.dist import meshes
    from repro_torch.models import model_zoo
    from repro_torch.serve import serving

    impl, chunk, mesh, kv = (tuple(side) + (None, "paged"))[:4]
    bs = SERVE["block_size"]
    nb = -(-len(seq) // bs)
    dev = params["embed"]["table"].device
    if kv == "dense":
        cache = model_zoo.make_cache(cfg, SERVE_SHARDED_MESH[0], len(seq), dev)
    else:
        cache = model_zoo.make_paged_cache(cfg, nb, bs, dev)
    if mesh is not None:
        cache = serving.place_cache(cache, mesh, paged=kv != "dense", kernel=impl == "kernel")
    row = torch.arange(nb, dtype=torch.int32, device=dev)
    decode = model_zoo.decode_fn(cfg)
    with meshes.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for b0 in range(0, len(seq), block):
            parts = []
            for s in range(b0, min(b0 + block, len(seq)), chunk):
                toks = seq[s:min(s + chunk, b0 + block, len(seq))]
                t = len(toks)
                live = torch.ones(t, dtype=torch.bool, device=dev)
                pos = torch.arange(s, s + t, dtype=torch.int32, device=dev)
                tok = torch.tensor(toks, dtype=torch.int32, device=dev)
                if kv == "dense":
                    logits, _ = decode(params, tok, cache, pos, write_ok=live,
                                       slot=torch.zeros(t, dtype=torch.int64, device=dev))
                else:
                    ctx = {"table": row.expand(t, nb).contiguous(), "block_size": bs,
                           "write_ok": live, "max_seq": len(seq), "impl": impl}
                    logits, _ = decode(params, tok, cache, pos, paged=ctx)
                parts.append(logits[:, :cfg.vocab_size].float())
            yield torch.cat(parts)


def _deviation(cfg, params, seq, side, ref_side):
    """The logits' measured deviation along ``seq``: the largest spread (max
    minus min over the vocab) of the difference between two computations
    (``side`` and ``ref_side``, each (impl, tokens per call[, mesh[,
    "dense"]]), see ``_teacher_forced``), teacher-forced; and the
    reference's logits at the last position."""
    block = max(side[1], ref_side[1])
    deviation, last = 0.0, None
    for a, b in zip(_teacher_forced(cfg, params, seq, side, block),
                    _teacher_forced(cfg, params, seq, ref_side, block)):
        d = a - b
        deviation = max(deviation, float((d.max(1).values - d.min(1).values).max()))
        last = b[-1]
    return deviation, last


def _divergence(cfg, params, rid, prompt, got, want, side, ref_side):
    """Where ``got`` first leaves ``want`` (the reference's tokens), the
    reference's top-2 logit margin and the logits' deviation along the common
    history. A margin can move by no more than that spread, so a divergence
    is a near-tie when the margin is below it."""
    import torch

    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    deviation, last = _deviation(cfg, params, list(prompt) + list(want[:k]), side, ref_side)
    top = torch.topk(last, 2).values
    margin = float(top[0] - top[1])
    return {"rid": rid, "index": k, "margin": margin, "deviation": deviation,
            "near_tie": margin < deviation}


def _limit_check(cfg, params, seq):
    """The deviation limit against two broken kernels, teacher-forced on
    ``seq`` beside the gather path: one that drops each token's own row
    (its position read as one less), which the limit must catch, and one
    whose softmax scale is 5% off, reported to show how fine an error the
    limit can see (the parity phase holds the kernel to 2e-5)."""
    from repro_torch.kernels.paged_attn import kernel, ops

    real = kernel.paged_attention
    mutants = {
        "drop_own_row": lambda q, k, v, t, p, **kw: real(q, k, v, t, (p - 1).clamp(min=0), **kw),
        "scale_x1.05": lambda q, k, v, t, p, **kw: real(q, k, v, t, p,
                                                        **dict(kw, scale=kw["scale"] * 1.05)),
    }
    got = {}
    try:
        for name, fn in mutants.items():
            ops.kernel = types.SimpleNamespace(paged_attention=fn)
            got[name] = _deviation(cfg, params, seq, ("kernel", 64), ("gather", 64))[0]
    finally:
        ops.kernel = kernel
    if got["drop_own_row"] <= DEVIATION_LIMIT:
        raise AssertionError(f"the deviation limit does not catch a kernel that drops each "
                             f"token's own row: {got}")
    return {"tokens": len(seq), **got}


def _near_ties(cfg, params, stream, got, want, side, ref_side, what):
    """Compare ``got`` with ``want`` token for token. A divergence passes only
    as a near-tie, and only while the deviation it is measured against stays
    within DEVIATION_LIMIT: the deviation comes from the computations under
    test, so a wrong one would otherwise excuse its own divergences. The
    deviation is also measured on one probe request (the longest compared),
    whether or not anything diverged. Returns (divergences, probe)."""
    prompts = {rid: prompt for rid, prompt, _, _ in stream}
    ties = []
    for rid, out in sorted(got.items()):
        if len(out) != len(want[rid]):
            raise AssertionError(f"{what}: request {rid} generated {len(out)} tokens, "
                                 f"the reference {len(want[rid])}")
        if out != want[rid]:
            ties.append(_divergence(cfg, params, rid, prompts[rid], out, want[rid], side,
                                    ref_side))
    rid = max(got, key=lambda r: (len(prompts[r]), r))
    probe = {"rid": rid, "deviation": _deviation(cfg, params, list(prompts[rid]) +
                                                 list(want[rid][:-1]), side, ref_side)[0]}
    wide = [t for t in ties + [probe] if t["deviation"] > DEVIATION_LIMIT]
    if wide:
        raise AssertionError(f"{what}: logits deviate by more than {DEVIATION_LIMIT}: {wide}")
    bad = [t for t in ties if not t["near_tie"]]
    if bad:
        raise AssertionError(f"{what}: divergences that are not near-ties: {bad}")
    return ties, probe


def phase_serve():
    """mistral-nemo-12b (GQA) served at full width on SERVE_LAYERS layers:
    the kernel path, the gather path, chunked stepping and the deviation
    limit's check."""
    from repro_torch.configs import get_config

    return _serve_phase(get_config(SERVE_ARCH), SERVE_LAYERS, "serve", compare_chunked=True)


def phase_serve_mla():
    """minicpm3-4b (MLA) served at full width on MLA_SERVE_LAYERS layers: the
    absorbed-latent decode through B5's latent entry (Dc 256, Dr 32, the
    latent body) and the gather path."""
    import gc

    import torch

    full = _published(SERVE_MLA_ARCH, MLA_FIELDS, MLA_WIDTH)
    gc.collect()
    torch.cuda.empty_cache()
    return _serve_phase(full, MLA_SERVE_LAYERS, "serve-mla", compare_chunked=False)


def _serve_phase(full, layers, phase, compare_chunked, check_plain=False, compared=0):
    """The model of config ``full`` at full width, its depth cut to
    ``layers``, bf16 weights from seed 0, serving
    the 48-request stream on the kernel path (every request FINISHED, B5
    once a layer a fused step on the body its attention kind takes, sharing
    ran; B5's first call at step 100 and its decode-only call with the most
    context captured), then the same
    stream on the gather path token for token up to near-ties, one host read
    per fused step over 24 steps, and 5 profiled steps. With
    ``compare_chunked``, also 8 requests through chunked stepping and the
    deviation limit against two broken kernels. With ``check_plain`` (GQA
    only), every B5 call of every fused step is held against its plain
    version at rtol=atol=2e-5 on the main path (``_PlainCheck``), and the
    phase's times come from a second run of the stream without the check,
    whose tokens must be the same. With ``compared``, the
    kernel and the gather path each serve only the ``compared`` shortest
    requests, alone on as many slots, in place of the gather path's run of
    the whole stream. Returns (the captured calls, the main path's
    launches)."""
    import torch

    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models import model_zoo
    from repro_torch.models.params import leaves
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.serving import BatchedServer

    arch = full.name
    cfg = dataclasses.replace(full, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    stream = _serve_stream(cfg.vocab_size)

    def server(**kw):
        return BatchedServer(cfg, params, max_seq=SERVE_MAX_SEQ, device="cuda",
                             **dict(SERVE, **kw))

    # the main path: tokens stepping through the kernel, with the kernel's
    # first call of step 100 captured for the kernels phase (a mixed step:
    # prefill chunks beside decode tokens, at contexts of hundreds of rows)
    main = server()
    if main.attn_impl != "kernel" or main.step_mode != "tokens" or not main.prefix_cache:
        raise AssertionError("the server did not take the kernel path with token stepping")
    forwards = _count_forwards(main)
    # GQA calls B5's generic entry (the split body), MLA its latent entry
    # (the latent body, over the cache's c and kr pools)
    latent = cfg.attn_kind == "mla"
    entry, want_body = ("paged_latent_attn", "latent") if latent else ("paged_attn", "split")
    real = pa_kernel.paged_latent_attention if latent else pa_kernel.paged_attention
    captured, decode = {}, {"ctx": -1, "seen": -1}
    calls = {"bodies": {}, "kernels": {}, "ctas": {}}
    if check_plain and latent:
        raise ValueError("the plain check holds GQA calls only")
    check = _PlainCheck()

    def keep(into, q, pools, table, pos, kw):
        into.update(q=q.clone(), pools=tuple(x.clone() for x in pools), latent=latent,
                    table=table.clone(), pos=pos.clone(), runs=kw["runs"].clone(),
                    kw={k: v for k, v in kw.items() if k != "runs"}, step=main.step_no)

    def capture(q, pool_a, pool_b, table, pos, **kw):
        if not captured and main.step_no >= 100:
            keep(captured, q, (pool_a, pool_b), table, pos, kw)
        # the decode-only step (every row a run of one) with the most context,
        # judged on the host at its first call, so the run makes no host read
        if kw["runs"].shape[0] == q.shape[0] and decode["seen"] != main.step_no:
            decode["seen"] = main.step_no
            ctx = sum(int(main._positions[i]) for i, r in enumerate(main.active) if r is not None)
            if ctx > decode["ctx"]:
                keep(decode, q, (pool_a, pool_b), table, pos, kw)
                decode["ctx"] = ctx
        out = real(q, pool_a, pool_b, table, pos, **kw)
        for key, value in (("bodies", real.body), ("kernels", real.kernels)) + (
                (("ctas", real.grid[0]),) if latent else ()):
            calls[key][value] = calls[key].get(value, 0) + 1
        if check_plain:
            check(out, q, pool_a, pool_b, table, pos, kw)
        return out

    zero_launches()
    # the wrapper counts its launches on itself, so the capture goes between
    # ops and the kernel module rather than in the module's place
    pa_ops.kernel = types.SimpleNamespace(**{real.__name__: capture})
    try:
        t0 = time.perf_counter()
        done = _Arrivals(main, stream).run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        pa_ops.kernel = pa_kernel
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    m = main.metrics
    if sorted(done) != list(range(SERVE_REQUESTS)) or \
            any(r.status != sched.FINISHED or len(r.out) != SERVE_MAX_NEW for r in done.values()):
        raise AssertionError("not every request FINISHED with its 64 tokens")
    if launches[entry] != cfg.n_layers * forwards[0] or forwards[0] == 0:
        raise AssertionError(f"{entry} launched {launches[entry]} times over "
                             f"{forwards[0]} fused decodes of {cfg.n_layers} layers")
    if any(v for k, v in launches.items() if k != entry):
        raise AssertionError(f"the serve path launched other kernels: {launches}")
    if set(calls["bodies"]) != {want_body}:
        raise AssertionError(f"B5's calls ran the bodies {calls['bodies']}, not {want_body}")
    if m.prefix_hits == 0 or m.cow_splits == 0:
        raise AssertionError(f"prefix hits {m.prefix_hits}, copy-on-write splits "
                             f"{m.cow_splits}: sharing did not run")
    if not captured or decode["ctx"] < 0:
        raise AssertionError("no mixed or no decode-only call of the kernel was captured")
    captured["decode_only"] = decode
    on_path = check.result(cfg.n_layers * forwards[0], "every call of every fused step") \
        if check_plain else None
    outs = {rid: r.out for rid, r in done.items()}
    for out in outs.values():
        if not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError("a token outside the true vocab")
    del main
    checked_wall_s = None
    if check_plain:
        # the stream again, without the check: the phase's times come from
        # this run. The check only reads, so the tokens are the same
        checked_wall_s, again = wall_s, server()
        t0 = time.perf_counter()
        tdone = _Arrivals(again, stream).run()
        torch.cuda.synchronize()
        wall_s, m = time.perf_counter() - t0, again.metrics
        del again
        if {rid: r.out for rid, r in tdone.items()} != outs:
            raise AssertionError("the run without the plain check gave other tokens")

    # the same requests through the gather path: token for token except at
    # near-ties (the two paths round the attention output differently). With
    # ``compared``, the shortest requests alone on both paths (a request's
    # tokens on the main path depend on its batch: the matmuls' rounding
    # follows their row count)
    subset = stream
    if compared:
        subset = [(rid, p, prio, 0) for rid, p, prio, _ in
                  sorted(stream, key=lambda r: (len(r[1]), r[0]))[:compared]]
        kdone = _Arrivals(server(batch_slots=compared), subset).run()
        outs = {r: q.out for r, q in kdone.items()}
    gather = server(attn_impl="gather", **({"batch_slots": compared} if compared else {}))
    t0 = time.perf_counter()
    gdone = _Arrivals(gather, subset).run()
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    g_steps = gather.metrics.steps
    del gather
    gather_ties, gather_probe = _near_ties(
        cfg, params, stream, outs, {r: q.out for r, q in gdone.items()},
        ("kernel", 64), ("gather", 64), "kernel vs gather")

    chunked_ties = chunked_probe = limit_check = cdone = None
    if compare_chunked:
        # 8 requests (the 4 shortest with the template, the 4 shortest
        # without) through chunked stepping: token for token except at
        # near-ties, where the deviation is that of 8 tokens per call (the
        # chunked step's 8 rows) against 64 (a token step's batch)
        by_len = sorted(stream, key=lambda r: len(r[1]))
        subset = [r for r in by_len if r[0] % 2 == 0][:4] + [r for r in by_len if r[0] % 2][:4]
        chunked = server(step_mode="chunked", batch_slots=8)
        cdone = _Arrivals(chunked, [(rid, p, prio, 0) for rid, p, prio, _ in subset]).run()
        del chunked
        chunked_ties, chunked_probe = _near_ties(
            cfg, params, stream, {r: q.out for r, q in cdone.items()},
            {r: outs[r] for r in cdone}, ("kernel", 8), ("kernel", 64), "chunked vs tokens")
        limit_check = _limit_check(cfg, params, stream[1][1][:512])

    # one host read per fused step, under the sync debug mode, over the first
    # 24 steps of the stream (admission, shared prefixes, prefill and decode)
    # (and the largest torch.cat of those steps against a layer's largest
    # cache pool: no call concatenates a pool)
    synced = _Arrivals(server(), stream)
    largest_cat, real_cat = [0], torch.cat

    def recording_cat(tensors, *args, **kw):
        out = real_cat(tensors, *args, **kw)
        largest_cat[0] = max(largest_cat[0], out.numel() * out.element_size())
        return out

    torch.cat = recording_cat
    try:
        where, _ = _synchronizing_calls(lambda: synced.run(max_steps=24), [])
    finally:
        torch.cat = real_cat
    reads = sum(where.values())
    if reads != 24 or len(where) != 1 or \
            not next(iter(where)).startswith("src/repro_torch/serve/serving.py:"):
        raise AssertionError(f"expected one host read per fused step over 24 steps: {where}")
    pool_bytes = max(x[0].numel() * x.element_size() for seg in synced.server.cache
                     for x in seg.values())
    if largest_cat[0] >= pool_bytes:
        raise AssertionError(f"a torch.cat of {largest_cat[0]} bytes on the serve path: a "
                             f"layer's largest pool holds {pool_bytes}")

    # the card's busy and idle share over 5 steps of the same server, after
    # 5 untraced steps timed alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synced.run(max_steps=5)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    traced_s, busy_s, top = _device_profile(lambda: synced.run(max_steps=5),
                                            kernels=("paged_attn", CAT_KERNELS))
    del synced

    emit({"phase": phase, "arch": arch, "layers": cfg.n_layers,
          "published_layers": full.n_layers, "d_model": cfg.d_model,
          "weights": "bf16 from seed 0, drawn on the card",
          "weight_bytes": weight_bytes, "init_s": init_s, "server": SERVE,
          "max_seq": SERVE_MAX_SEQ, "requests": SERVE_REQUESTS, "max_new_tokens": SERVE_MAX_NEW,
          "prompt_tokens_submitted": sum(len(p) for _, p, _, _ in stream),
          "finished": len(done), "wall_s": wall_s, "steps": m.steps,
          "fused_decodes": forwards[0], "launches": launches,
          "tokens_per_s": m.tokens_generated / wall_s, "metrics_tok_per_s": m.tok_per_s,
          "mean_ttft_s": m.mean_ttft_s, "mean_ttft_steps": m.mean_ttft_steps,
          "occupancy_pct": m.occupancy_pct, "prefix_hits": m.prefix_hits,
          "prefix_tokens": m.prefix_tokens, "cow_splits": m.cow_splits,
          "preemptions": m.preemptions, "recompute_tokens": m.recompute_tokens,
          "mean_step_s": m.wall_s / m.steps, "batched_tokens": m.batched_tokens,
          "kv_blocks_peak": m.kv_blocks_peak, "kv_blocks_total": m.kv_blocks_total,
          "peak_memory_bytes": peak,
          "deviation_limit": DEVIATION_LIMIT, "limit_check": limit_check,
          "gather": {"wall_s": gather_s, "steps": g_steps, "near_ties": len(gather_ties),
                     "divergences": gather_ties, "probe": gather_probe,
                     "rids": sorted(outs) if compared else "all"},
          "b5_against_plain_on_path": on_path,
          "times_from": ("a second run of the stream without the plain check (same tokens)"
                         if check_plain else "the main run"),
          "checked_run_wall_s": checked_wall_s,
          "chunked_subset": None if cdone is None else {
              "rids": sorted(cdone), "near_ties": len(chunked_ties),
              "divergences": chunked_ties, "probe": chunked_probe},
          "syncs": {"steps": 24, "synchronizing_calls": reads, "where": where},
          "largest_cat_bytes": largest_cat[0], "layer_pool_bytes": pool_bytes,
          "b5": {"entry": entry, "bodies": calls["bodies"],
                 "kernels_per_call": calls["kernels"], "ctas_launched": calls["ctas"] or None},
          "captures": {"mixed_step": captured["step"], "decode_only_step": decode["step"],
                       "decode_only_context": decode["ctx"]},
          "profile": {"steps": 5, "traced_s": traced_s, "untraced_s": untraced_s,
                      "device_busy_s": busy_s if busy_s else None,
                      "device_idle_share": 1.0 - busy_s / untraced_s if busy_s else None,
                      "paged_attn_share_of_busy": (top["device_ms_of"]["paged_attn"] / 1e3
                                                   / busy_s if busy_s else None),
                      "concat_ms": top["device_ms_of"][CAT_KERNELS],
                      "concat_launches": top["launches_of"][CAT_KERNELS],
                      **top, "units": "ms totals over the 5 steps"}})
    return captured, launches


def phase_launch_serve():
    import contextlib
    import io

    import torch

    from repro_torch.launch import serve as serve_cli

    argv = ["--arch", SERVE_ARCH, "--kv", "paged", "--attn-impl", "kernel", "--batch", "8",
            "--requests", "16", "--prefill-chunk", "16"]
    torch.cuda.empty_cache()
    zero_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        done = serve_cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    lines = out.getvalue().splitlines()
    rollup = [ln for ln in lines if ln.startswith(f"[serve] {SERVE_ARCH} on ")]
    if not rollup or len(done) != 16 or launches["paged_attn"] == 0:
        raise AssertionError(f"launch/serve.py: {lines[:3]}, {len(done)} requests, {launches}")
    print(rollup[0], flush=True)
    emit({"phase": "launch", "argv": argv, "seconds": seconds, "rollup": rollup[0],
          "lines": lines[:8], "launches": launches})


def _paged_attn_call(cap):
    """Kernel, plain and library times of one captured B5 call, with the
    call's runs and without (every row its own run), and its bounds: each
    distinct context row once (the bound), each run's context once (what the
    kernel reads with runs) and each token's rows (without). A latent call
    (the absorbed MLA through the latent entry: q (T, H, Dc + Dr) over the
    cache's pools c and kr, K = [c ; kr], V = c) also gives its body and its
    CTAs launched and live; its bound is on the latent's own bytes and on
    q·K plus P·V in three bf16 parts at the bf16 tensor rate (the tiled
    body's, with P·V at the f32 rate over the bytes of K and V, beside it as
    ``pv_f32_bound_ms``); its library yardstick is the gather path's
    composite, and the [c ; kr] concatenation of the pool that the call
    through the generic entry needed is timed as ``parent_concat_ms``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import kernel, ref

    q, table, pos, runs, kw = cap["q"], cap["table"], cap["pos"], cap["runs"], cap["kw"]
    latent = cap["latent"]
    call = kernel.paged_latent_attention if latent else kernel.paged_attention
    plain_fn = ref.paged_latent_attn_ref if latent else ref.paged_attn_ref
    pools = [cap["pools"]]
    # three more copies of the layer's pools, so each call in turn finds the
    # pools out of the 50 MB L2, as the next layer's call does
    pools += [tuple(x.clone() for x in pair) for pair in pools * 3]
    plain = plain_fn(q, *pools[0], table, pos, **kw)
    err, kernels, bodies, grids = 0.0, {}, {}, {}
    for name, hint in (("runs", runs), ("no_runs", None)):
        got = call(q, *pools[0], table, pos, runs=hint, **kw)
        kernels[name], bodies[name] = call.kernels, call.body
        if latent:
            grids[name] = call.grid
        e = float((got - plain).abs().max())
        if e > 2e-5 + 2e-5 * float(plain.abs().max()):
            raise AssertionError(f"paged_attn ({name}) differs by {e} at the captured call")
        err = max(err, e)
    if latent:
        t, g, dk = q.shape
        kvh, dv = 1, pools[0][0].shape[-1]
    else:
        t, kvh, g, dk = q.shape
        dv = pools[0][1].shape[-1]
    bs = kw["block_size"]
    elt = pools[0][0].element_size()
    # a ring's valid rows: rows <= pos while cold, all of its rows once warm
    cap_rows = kw.get("ring_width") or kw["max_rows"]
    last = torch.minimum(pos, torch.tensor(cap_rows - 1, device=pos.device))
    rows = int((last + 1).sum())
    # bytes a context row costs: K and V of every kv head; the latent's own
    # c and kr (V is c) for a latent call
    per_row = dk * elt if latent else kvh * (dk + dv) * elt
    io_bytes = (q.numel() * q.element_size() + t * kvh * g * dv * 4
                + (table.numel() + pos.numel() + runs.numel()) * 4)
    # the bound counts each context row once: the tokens of one slot, and the
    # slots that share the template, read the same rows
    tab, lst = table.tolist(), last.tolist()
    unique = {(tab[i][n // bs], n % bs) for i in range(t) for n in range(lst[i] + 1)}
    grouped = sum(max(lst[f:f + n]) + 1 for f, n in runs.tolist())
    unique_bytes = len(unique) * per_row + io_bytes
    qk_flops, pv_flops = 2 * rows * kvh * g * dk, 2 * rows * kvh * g * dv
    flops = qk_flops + pv_flops
    # q·K has bf16 operands (products exact in f32): the bf16 tensor rate.
    # P·V takes the f32 probabilities: the split body's at the f32 rate; the
    # latent body's on the tensor cores in three bf16 parts, 3 x its
    # operations at the bf16 rate. The two times add
    pv_f32_ops_ms = 1e3 * (qk_flops / BF16_FLOPS + pv_flops / F32_FLOPS)
    bound_ops_ms = 1e3 * (qk_flops + 3 * pv_flops) / BF16_FLOPS if latent else pv_f32_ops_ms
    bound_bytes_ms = 1e3 * unique_bytes / HBM_BYTES_PER_S

    def timed(fn):
        return device_ms([lambda a=a, b=b: fn(a, b) for a, b in pools] * 5)

    mask = (torch.arange(table.shape[1] * bs, device=q.device)[None, :] <= last[:, None])

    def library(k, v):
        gk = k[table.long()].reshape(t, -1, kvh, dk).transpose(1, 2)
        gv = v[table.long()].reshape(t, -1, kvh, dv).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.reshape(t, kvh * g, 1, dk), gk, gv, attn_mask=mask[:, None, None, :],
            scale=kw["scale"], enable_gqa=g > 1)

    def latent_library(c, kr):
        # the gather path's absorbed attention: c and kr gathered through
        # the table, the two score products in bf16, softmax, P·c in f32
        tl = table.long()
        gc = c[tl].reshape(t, -1, dv)
        gkr = kr[tl].reshape(t, -1, dk - dv)
        scores = (torch.einsum("thr,tsr->ths", q[..., :dv], gc)
                  + torch.einsum("thk,tsk->ths", q[..., dv:], gkr))
        scores = scores.float() * kw["scale"] + torch.where(mask, 0.0, -1e9)[:, None]
        return torch.einsum("ths,tsr->thr", torch.softmax(scores, -1), gc.float())

    if latent:
        library = latent_library
    torch.testing.assert_close(library(*pools[0]).float().reshape(plain.shape), plain,
                               rtol=2e-2, atol=2e-2)

    def with_runs(a, b):
        return call(q, a, b, table, pos, runs=runs, **kw)

    shape = (f"q {tuple(q.shape)}, pools {' and '.join(str(tuple(x.shape)) for x in pools[0])}"
             f" bf16, table {tuple(table.shape)}, positions {int(pos.min())}-{int(pos.max())}, "
             f"{runs.shape[0]} runs of {min(runs[:, 1].tolist())}-{max(runs[:, 1].tolist())} "
             f"rows, captured at step {cap['step']}")
    out = {
        "shape": shape,
        "max_abs_err": err,
        "ms": timed(with_runs),
        "no_runs_ms": timed(lambda a, b: call(q, a, b, table, pos, **kw)),
        "host_ms": eager_ms([lambda a=a, b=b: with_runs(a, b) for a, b in pools] * 5),
        "plain_ms": timed(lambda a, b: plain_fn(q, a, b, table, pos, **kw)),
        "library_ms": timed(library),
        "body": bodies, "kernels_per_call": kernels,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bound_bytes": unique_bytes, "unique_rows": len(unique), "flops": flops,
        "qk_flops": qk_flops, "pv_flops": pv_flops, "ops_bound_ms": bound_ops_ms,
        "f32_ops_bound_ms": 1e3 * flops / F32_FLOPS,
        "bytes_read_grouped": grouped * per_row + io_bytes, "grouped_rows": grouped,
        "grouped_bound_ms": max(1e3 * (grouped * per_row + io_bytes) / HBM_BYTES_PER_S,
                                bound_ops_ms),
        "per_token_bytes": rows * per_row + io_bytes, "valid_rows": rows,
        "per_token_bound_ms": max(1e3 * (rows * per_row + io_bytes) / HBM_BYTES_PER_S,
                                  bound_ops_ms),
    }
    if latent:
        kv_bytes = len(unique) * (dk + dv) * elt + io_bytes  # K and V handed over apart

        def items(split, groups):
            # the latent kernel's work: each run's live splits x its passes
            # of 64 query rows
            return sum(-(-(max(lst[f:f + n]) + 1) // split) * -(-n * g // 64)
                       for f, n in groups)

        out.update(
            pv_f32_bound_ms=max(1e3 * kv_bytes / HBM_BYTES_PER_S, pv_f32_ops_ms),
            pv_f32_ops_bound_ms=pv_f32_ops_ms, kv_bytes=kv_bytes,
            ctas={name: {"launched": grids[name][0], "split_rows": grids[name][1],
                         "items": n_items, "live": min(grids[name][0], n_items)}
                  for name in grids
                  for n_items in [items(grids[name][1], runs.tolist() if name == "runs"
                                        else [(i, 1) for i in range(t)])]},
            parent_concat_ms=device_ms([lambda c=c, r=r: torch.cat([c, r], dim=-1)
                                        for c, r in pools] * 5),
            parent_concat_bytes=sum(x.numel() * x.element_size() for x in pools[0]) * 2)
    return out


def kernel_row_paged_attn(captured, launches, mla_captured, mla_launches, hybrid_captured,
                          hybrid_launches, moe_captured, moe_launches, vlm_captured,
                          vlm_launches):
    """B5's row of the kernels line: the serve phase's step-100 call (prefill
    runs beside decode rows), and beside it its decode-only call with the
    most context (every row a run of one); under ``mla`` the same two calls
    of the serve-mla phase (the latent entry); under ``hybrid`` the
    serve-hybrid phase's two calls of one sub-step past position 1,040, a
    sliding-window layer's on the ring table (the bound on the ring's rows)
    and a global layer's; under ``moe`` the serve-moe phase's call of the
    first sub-step past position 1,040 (KVH 16, G 1, D 128); under ``vlm``
    the serve-vlm phase's two calls (internvl2-26b: KVH 8, G 6, D 128).
    ``launches`` counts the five phases' main paths."""
    mixed = _paged_attn_call(captured)
    decode = _paged_attn_call(captured["decode_only"])
    mla = _paged_attn_call(mla_captured)
    mla["decode_only"] = _paged_attn_call(mla_captured["decode_only"])
    mla["launches"] = mla_launches["paged_latent_attn"]
    mla["library"] = ("composite, no single call: c and kr gathered through the table, "
                      "the two score einsums in bf16, softmax, P·c")
    hybrid = _paged_attn_call(hybrid_captured["swa"])
    hybrid["global"] = _paged_attn_call(hybrid_captured["global"])
    hybrid["launches"] = hybrid_launches["paged_attn"]
    hybrid["launches_per_sub_step"] = HYBRID_WIDTH[0]
    hybrid["launches_per_fused_step"] = HYBRID_WIDTH[0] * SERVE["prefill_chunk"]
    hybrid["library"] = ("composite, no single call: gather k_pool[table], v_pool[table] + "
                         "F.scaled_dot_product_attention(attn_mask=valid ring rows, enable_gqa)")
    moe_entry = _paged_attn_call(moe_captured)
    moe_entry["launches"] = moe_launches["paged_attn"]
    moe_entry["launches_per_sub_step"] = MOE_WIDTH[0]
    moe_entry["library"] = ("composite, no single call: gather k_pool[table], v_pool[table] + "
                            "F.scaled_dot_product_attention(attn_mask=valid rows)")
    library = ("composite, no single call: gather k_pool[table], v_pool[table] + "
               "F.scaled_dot_product_attention(attn_mask=valid rows, enable_gqa)")
    vlm = _paged_attn_call(vlm_captured)
    vlm["decode_only"] = _paged_attn_call(vlm_captured["decode_only"])
    vlm.update(launches=vlm_launches["paged_attn"], launches_per_fused_step=VLM_SERVE_LAYERS,
               library=library)
    return {
        "name": "paged_attn", "route": "cuda", "source": "src/repro_torch/csrc/paged_attn.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:32",
        "launches": (launches["paged_attn"] + mla_launches["paged_latent_attn"]
                     + hybrid_launches["paged_attn"] + moe_entry["launches"]
                     + vlm["launches"]),
        "launches_serve": launches["paged_attn"], **mixed, "library": library,
        "decode_only": decode, "mla": mla, "hybrid": hybrid, "moe": moe_entry, "vlm": vlm,
    }


# the serve-hybrid, serve-rwkv and train-hybrid phases. hymba-1.5b at full
# width and depth: (layers, d_model, heads, kv heads, head dim, d_ff, vocab,
# ssm state, expand, window) of configs/hymba_1_5b.py, global layers 0, 16
# and 31; its 29 sliding-window layers read a ring of 1,024 rows through B5.
# It serves with SERVE's settings (token stepping asked for, chunked taken)
HYBRID_ARCH = "hymba-1.5b"
HYBRID_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                 "vocab_size", "ssm_state", "ssm_expand", "swa_window")
HYBRID_WIDTH = (32, 1600, 25, 5, 64, 5504, 32001, 16, 2, 1024)
HYBRID_GLOBALS = (0, 16, 31)
# 20 requests, 32 new tokens each: 4 prompts of 1,000-1,056 tokens (their
# positions pass 1,024, so their ring rows wrap), 12 of 64-1,056 and, queued
# behind them, 4 of 64-256; B5's calls captured at the first sub-step where a
# slot's position reaches HYBRID_CAPTURE_POS; the gather path on 2 wrapping
# and the 2 shortest requests; the sync debug mode over HYBRID_SYNC_STEPS
HYBRID_REQUESTS, HYBRID_LONG, HYBRID_MAX_NEW = 20, 4, 32
HYBRID_CAPTURE_POS = 1040
HYBRID_SYNC_STEPS = 4
# fused steps profiled (and timed untraced beside them): one, where the
# other serve phases profile 5, because a hybrid step launches about 74,000
# kernels and the profiler's parse of several such steps takes minutes
HYBRID_PROFILED_STEPS = 1
# hymba's greedy logits at random weights move far under perturbations that
# change nothing of substance (a 1e-6 relative noise on the attention
# outputs moves them by several units within a few tokens), so the deviation
# limit for its kernel-vs-gather comparison is measured in the run: the
# gather path serves each compared request twice, the copy (rid +
# HYBRID_COPY) with its attention outputs perturbed by HYBRID_NOISE
# (relative, above B5's error against its plain version), and the limit is
# HYBRID_SOUND_FACTOR times the largest spread that perturbation causes, or
# DEVIATION_LIMIT where that is larger
HYBRID_COPY, HYBRID_NOISE, HYBRID_SOUND_FACTOR = 100, 1e-6, 2.0
# the Mamba mixer in the training profile: a record_function range around
# each call
MAMBA_RANGE = "mamba_mix"
# serve-rwkv: rwkv6-3b (TRAIN_WIDTH) asked for paged KV and token stepping,
# served dense and chunked; 16 requests of 32-256 prompt tokens, 32 new
# tokens, each against generate_greedy (16 slots too, one-token prefill)
RWKV_SERVE = {"batch_slots": 16, "kv": "paged", "step_mode": "tokens", "prefill_chunk": 16}
RWKV_REQUESTS, RWKV_LENGTHS, RWKV_MAX_NEW = 16, (32, 256), 32
# train-hybrid: batch 8 x TRAIN_SEQ, 4 steps; then a 2-layer full-width
# model (one global, one sliding-window layer) prefills WINDOW_CHECK_TOKENS
# tokens, past the window, against as many decode steps
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_STEPS = 8, 4
WINDOW_CHECK_TOKENS = 1100


def _hybrid_stream(vocab: int):
    """serve-hybrid's traffic from seed 0: (rid, prompt, priority, arrival
    step), every request at step 0 and of one priority (FIFO)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = ([int(rng.integers(1000, 1057)) for _ in range(HYBRID_LONG)]
               + [int(rng.integers(64, 1057)) for _ in range(HYBRID_REQUESTS - HYBRID_LONG - 4)]
               + [int(rng.integers(64, 257)) for _ in range(4)])
    return [(rid, rng.integers(1, vocab, n).tolist(), 1, 0) for rid, n in enumerate(lengths)]


class _LogitTap:
    """Keeps the logits of every decode a chunked-stepping server makes and
    which request and position each row held, so that two runs of the same
    requests compare position by position along their common history, as a
    teacher-forced run would give them, without a second pass (a recurrent
    model decodes one token a call)."""

    def __init__(self, server, rids):
        self.calls, self.where = [], {}
        real_decode, real_program = server._decode, server._chunked_program

        def program():
            pos = server._positions.copy()
            rows = [(i, r.rid) for i, r in enumerate(server.active)
                    if r is not None and r.rid in rids]
            first = len(self.calls)
            out = real_program()
            for j in range(server.prefill_chunk):
                for i, rid in rows:
                    if pos[i] + j < server.max_seq:
                        self.where[(rid, int(pos[i]) + j)] = (first + j, i)
            return out

        def decode(*args, **kw):
            logits, cache = real_decode(*args, **kw)
            self.calls.append(logits)  # a fresh tensor each call: no copy
            return logits, cache

        server._decode, server._chunked_program = decode, program
        self.vocab = server.cfg.vocab_size

    def logits(self, rid, n):
        """(n, vocab) f32: the logits at positions 0..n-1 of request ``rid``."""
        import torch

        return torch.stack([self.calls[c][i] for c, i in
                            (self.where[(rid, p)] for p in range(n))])[:, :self.vocab].float()


def _common(prompt, got, want):
    """(index of the first differing token, or the last one; the positions
    of the common history up to it)."""
    k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(want) - 1)
    return k, len(prompt) + k


def _tap_spread(tap, ref_tap, rid, n, ref_rid=None):
    """The largest spread (max minus min over the vocab) of the two runs'
    logit difference over positions 0..n-1."""
    d = tap.logits(rid, n) - ref_tap.logits(rid if ref_rid is None else ref_rid, n)
    return float((d.amax(1) - d.amin(1)).max())


def _tap_ties(prompts, got, want, tap, ref_tap, what, limit=DEVIATION_LIMIT):
    """``_near_ties`` on two tapped runs: at each divergence the reference's
    top-2 margin against the largest spread of the logits' difference along
    the common history, which must stay within ``limit``; the probe is the
    longest compared request's whole common history. Returns (divergences,
    probe)."""
    import torch

    def common(rid):
        return _common(prompts[rid], got[rid], want[rid])

    def spread(rid, n):
        return _tap_spread(tap, ref_tap, rid, n)

    ties = []
    for rid in sorted(got):
        if len(got[rid]) != len(want[rid]):
            raise AssertionError(f"{what}: request {rid} generated {len(got[rid])} tokens, "
                                 f"the reference {len(want[rid])}")
        if got[rid] == want[rid]:
            continue
        k, n = common(rid)
        top = torch.topk(ref_tap.logits(rid, n)[-1], 2).values
        margin, deviation = float(top[0] - top[1]), spread(rid, n)
        ties.append({"rid": rid, "index": k, "margin": margin, "deviation": deviation,
                     "near_tie": margin < deviation})
    rid = max(got, key=lambda r: (len(prompts[r]), r))
    probe = {"rid": rid, "positions": common(rid)[1], "deviation": spread(rid, common(rid)[1])}
    wide = [t for t in ties + [probe] if t["deviation"] > limit]
    if wide:
        raise AssertionError(f"{what}: logits deviate by more than {limit}: {wide}")
    bad = [t for t in ties if not t["near_tie"]]
    if bad:
        raise AssertionError(f"{what}: divergences that are not near-ties: {bad}")
    return ties, probe


class _AttentionNoise:
    """Within ``with``, the attention outputs of the gather and dense decode
    paths (``attention._sdpa``) carry a relative Gaussian noise of
    HYBRID_NOISE from a seeded generator, on the batch rows where ``rows``
    ((B,) of 0 and 1; None: every row) is 1: a perturbation of the size of
    B5's own error against its plain version, to measure how far a model's
    logits move under a change of no substance."""

    def __init__(self, device):
        import torch

        self.rows = None
        self.gen = torch.Generator(device=device).manual_seed(11)

    def __enter__(self):
        import torch

        from repro_torch.models import attention

        self.real = real = attention._sdpa

        def noisy(q, k, v, mask, scale):
            out = real(q, k, v, mask, scale)
            eps = HYBRID_NOISE * torch.randn(out.shape, generator=self.gen, device=out.device)
            if self.rows is not None:
                eps = eps * self.rows.view(-1, *[1] * (out.dim() - 1))
            return out * (1 + eps)

        attention._sdpa = noisy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention

        attention._sdpa = self.real


def _fallback_recorded(kind):
    from repro_torch.dist import meshes

    return any(t == kind for t, _, _ in meshes.fallbacks())


def _mamba_decode_ms(server):
    """Device ms of one layer's Mamba mixer at the server's decode shape (its
    slots, one token, bf16), from the device's own events (``busy_ms``: the
    phase shares the card), over 4 layers' weights in turn, so that each
    call finds its weights out of the 50 MB L2 as the next layer's call
    does."""
    import torch

    from repro_torch.models import ssm, transformer

    cfg, dev = server.cfg, server.device
    layers = [transformer._layer(sp, i)["mamba"]
              for sp, seg in zip(server.params["segments"], transformer.segments_for(cfg))
              if seg.kind in transformer.HYBRID for i in range(seg.n_layers)][:4]
    di = cfg.ssm_expand * cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((server.slots, 1, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    state = torch.zeros((server.slots, di, cfg.ssm_state), device=dev)
    conv = torch.zeros((server.slots, cfg.ssm_conv - 1, di), dtype=torch.bfloat16, device=dev)
    return busy_ms([lambda p=p: ssm.mamba_mix(p, h, cfg, state=state, conv_prev=conv)
                    for p in layers])


def _chunked_profile(server, arrivals, steps, kernels):
    """One host read a fused step under the sync debug mode over HYBRID_SYNC_STEPS
    steps, then ``steps`` steps untraced and ``steps`` under the profiler
    (the device and the CUDA runtime), and the Mamba mixer's share of the
    busy time from its device time at the decode shape (``_mamba_decode_ms``)
    times its calls a step. Returns (the sync record, the profile record)."""
    import torch

    from repro_torch.models import transformer

    t0 = time.perf_counter()
    where, _ = _synchronizing_calls(lambda: arrivals.run(max_steps=HYBRID_SYNC_STEPS), [])
    sync_s = time.perf_counter() - t0
    reads = sum(where.values())
    if reads != HYBRID_SYNC_STEPS or len(where) != 1 or \
            not next(iter(where)).startswith("src/repro_torch/serve/serving.py:"):
        raise AssertionError(f"expected one host read per fused step over "
                             f"{HYBRID_SYNC_STEPS} steps: {where}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrivals.run(max_steps=steps)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    traced_s, busy_s, top = _device_profile(lambda: arrivals.run(max_steps=steps),
                                            kernels=kernels, cpu=False)
    profile_s = time.perf_counter() - t0  # the traced run and the profiler's parse
    shares = {f"{k}_share_of_busy": (top["device_ms_of"][k] / 1e3 / busy_s if busy_s else None)
              for k in kernels}
    mamba_ms = _mamba_decode_ms(server)
    calls = sum(s.n_layers for s in transformer.segments_for(server.cfg)
                if s.kind in transformer.HYBRID) * server.prefill_chunk * steps
    return ({"steps": HYBRID_SYNC_STEPS, "synchronizing_calls": reads, "where": where,
             "seconds": sync_s},
            {"steps": steps, "traced_s": traced_s, "untraced_s": untraced_s,
             "profile_s": profile_s,
             "device_busy_s": busy_s if busy_s else None,
             "device_idle_share": 1.0 - busy_s / untraced_s if busy_s else None,
             "launches_per_step": top["launch_calls"] / steps, **shares,
             "mamba_ms_per_call": mamba_ms, "mamba_calls": calls,
             "mamba_share_of_busy": mamba_ms * calls / 1e3 / busy_s if busy_s else None,
             **top, "units": f"ms totals over the {steps} steps"})


def _hybrid_setup(device="cuda"):
    """serve-hybrid's model and traffic: (config, bf16 weights from seed 0,
    stream, prompts by rid, the rids whose positions wrap the ring, the
    compared rids: 2 wrapping and the 2 shortest)."""
    from repro_torch.models import model_zoo

    cfg = _published(HYBRID_ARCH, HYBRID_FIELDS, HYBRID_WIDTH)
    if tuple(cfg.global_layer_ids()) != HYBRID_GLOBALS:
        raise AssertionError(f"global layers {cfg.global_layer_ids()}, not {HYBRID_GLOBALS}")
    params, _ = model_zoo.init_params(cfg, seed=0, device=device)
    stream = _hybrid_stream(cfg.vocab_size)
    prompts = {rid: p for rid, p, _, _ in stream}
    wrapping = [rid for rid, p in prompts.items() if len(p) + HYBRID_MAX_NEW - 2 >= cfg.swa_window]
    by_len = sorted(prompts, key=lambda r: (len(prompts[r]), r))
    return cfg, params, stream, prompts, wrapping, sorted(wrapping[:2] + by_len[:2])


def hybrid_gather_child(path):
    """serve-hybrid's gather run, in a process of its own beside the main
    run (both are bound by their host's launches, and the card idles most
    of the time): the compared requests on the gather path, and a copy of
    each (rid + HYBRID_COPY) with its attention outputs perturbed
    (``_AttentionNoise``). Saves to ``path`` each request's tokens, its
    logits at every position it ran (bf16, as the model gives them) and the
    run's seconds."""
    import torch

    from repro_torch.serve.serving import BatchedServer

    cfg, params, stream, prompts, _, compared = _hybrid_setup()
    gather = BatchedServer(cfg, params, max_seq=SERVE_MAX_SEQ, device="cuda",
                           **dict(SERVE, attn_impl="gather"))
    copies = {r + HYBRID_COPY: r for r in compared}
    tap = _LogitTap(gather, set(compared) | set(copies))
    real_program = gather._chunked_program
    with _AttentionNoise(gather.device) as noise:
        def program():
            noise.rows = torch.tensor([float(r is not None and r.rid in copies)
                                       for r in gather.active], device=gather.device)
            return real_program()

        gather._chunked_program = program
        t0 = time.perf_counter()
        done = _Arrivals(gather, [r for r in stream if r[0] in compared] +
                         [(c, prompts[r], 1, 0) for c, r in copies.items()],
                         HYBRID_MAX_NEW).run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    outs = {rid: r.out for rid, r in done.items()}
    n = {rid: len(prompts[copies.get(rid, rid)]) + len(out) - 1 for rid, out in outs.items()}
    torch.save({"outs": outs, "seconds": seconds,
                "logits": {rid: tap.logits(rid, n[rid]).to(torch.bfloat16).cpu() for rid in outs}},
               path)
    return 0


def phase_serve_hybrid():
    """hymba-1.5b at full width and depth, bf16 weights from seed 0, serving
    HYBRID_REQUESTS greedy requests through BatchedServer(SERVE): token
    stepping falls back to chunked stepping (recorded), prefix sharing is
    off, every request FINISHED, B5 32 times a sub-step (29 calls on the
    ring table, 3 on the full table) on the split body, rings that wrap;
    every B5 call of each fused step's first sub-step held against its
    plain version at rtol=atol=2e-5; the gather path on 4 requests token for
    token except at reported near-ties, within a deviation limit measured
    in the run (HYBRID_NOISE); one host read per fused step; a profiled
    fused step (HYBRID_PROFILED_STEPS) with B5's and the Mamba mixer's
    shares. The gather run goes on beside the main run in a process of its
    own (``hybrid_gather_child``). Returns (the captured calls, the
    launches)."""
    import gc

    import torch

    phase_t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the gather run starts first, in its own process, and runs beside the
    # main run
    gather_path = os.path.join(SCRATCH, "hybrid_gather.pt")
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--hybrid-gather",
                              gather_path], stdout=subprocess.DEVNULL)
    try:
        return _serve_hybrid(phase_t0, child, gather_path)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()


def _serve_hybrid(phase_t0, child, gather_path):
    """phase_serve_hybrid's body, beside the gather run in ``child``."""
    import gc

    import torch

    from repro_torch.dist import meshes
    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models.params import leaves
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.serving import BatchedServer

    t0 = time.perf_counter()
    cfg, params, stream, prompts, wrapping, compared = _hybrid_setup()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))

    def server(**kw):
        return BatchedServer(cfg, params, max_seq=SERVE_MAX_SEQ, device="cuda",
                             **dict(SERVE, **kw))

    meshes.clear_fallbacks()
    main = server()
    if main.step_mode != "chunked" or not _fallback_recorded("serve_step") or \
            main.prefix_cache or main.attn_impl != "kernel" or \
            main._paged.ring_width != cfg.swa_window:
        raise AssertionError("the hybrid server did not fall back to chunked stepping on the "
                             "kernel path with the ring pool and no prefix sharing")
    forwards = _count_forwards(main)
    tap = _LogitTap(main, set(compared))
    real = pa_kernel.paged_attention
    sub = {"step": -1, "calls": 0}
    captured, calls = {}, {"bodies": {}, "kernels": {}, "ring": 0, "full": 0}
    check = _PlainCheck()

    def capture(q, k_pool, v_pool, table, pos, **kw):
        if sub["step"] != main.step_no:
            sub.update(step=main.step_no, calls=0)
        j = sub["calls"] // cfg.n_layers  # the sub-step of this call
        sub["calls"] += 1
        ring = kw["ring_width"] > 0
        calls["ring" if ring else "full"] += 1
        name = "swa" if ring else "global"
        # the first sub-step where a running slot's position (its position
        # at the step's start, plus the sub-step) reaches the capture point,
        # judged on the host: a global layer's call (layer 0 comes first),
        # then a sliding-window layer's of the same sub-step
        if name not in captured and captured.get("global", {}).get(
                "step", (main.step_no, j)) == (main.step_no, j) and any(
                r is not None and HYBRID_CAPTURE_POS <= main._positions[i] + j < main.max_seq
                for i, r in enumerate(main.active)):
            t = q.shape[0]  # every row its own run, as chunked stepping calls it
            runs = torch.stack([torch.arange(t, device=q.device),
                                torch.ones(t, dtype=torch.long, device=q.device)], 1)
            captured[name] = dict(q=q.clone(), pools=(k_pool.clone(), v_pool.clone()),
                                  latent=False, table=table.clone(), pos=pos.clone(),
                                  runs=runs.to(torch.int32),
                                  kw={k: v for k, v in kw.items() if k != "runs"},
                                  step=(main.step_no, j))
        out = real(q, k_pool, v_pool, table, pos, **kw)
        for key, value in (("bodies", real.body), ("kernels", real.kernels)):
            calls[key][value] = calls[key].get(value, 0) + 1
        if j == 0:
            check(out, q, k_pool, v_pool, table, pos, kw)
        return out

    zero_launches()
    pa_ops.kernel = types.SimpleNamespace(paged_attention=capture)
    try:
        t0 = time.perf_counter()
        done = _Arrivals(main, stream, HYBRID_MAX_NEW).run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        pa_ops.kernel = pa_kernel
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    m = main.metrics
    if sorted(done) != list(range(HYBRID_REQUESTS)) or any(
            r.status != sched.FINISHED or len(r.out) != HYBRID_MAX_NEW for r in done.values()):
        raise AssertionError(f"not every request FINISHED with its {HYBRID_MAX_NEW} tokens")
    per_substep = cfg.n_layers
    if forwards[0] != m.steps * SERVE["prefill_chunk"] or \
            launches["paged_attn"] != per_substep * forwards[0] or \
            calls["ring"] != (cfg.n_layers - len(HYBRID_GLOBALS)) * forwards[0]:
        raise AssertionError(f"B5 launched {launches['paged_attn']} times ({calls['ring']} on "
                             f"the ring) over {forwards[0]} sub-steps of {m.steps} fused steps")
    if any(v for k, v in launches.items() if k != "paged_attn"):
        raise AssertionError(f"the serve path launched other kernels: {launches}")
    if set(calls["bodies"]) != {"split"}:
        raise AssertionError(f"B5's calls ran the bodies {calls['bodies']}, not the split body")
    on_path = check.result(cfg.n_layers * m.steps, "every call of each fused step's first "
                                                    "sub-step")
    if len(wrapping) < 2 or set(captured) != {"swa", "global"} or \
            captured["swa"]["step"] != captured["global"]["step"]:
        raise AssertionError(f"requests that wrap: {wrapping}; captures "
                             f"{ {k: v['step'] for k, v in captured.items()} }")
    outs = {rid: r.out for rid, r in done.items()}
    if not all(0 <= t < cfg.vocab_size for out in outs.values() for t in out):
        raise AssertionError("a token outside the true vocab")
    del main

    # the gather path on 2 wrapping and the 2 shortest requests, and on a
    # copy of each whose attention outputs are perturbed (the child's run):
    # token for token except at near-ties, compared along the runs' own
    # logits, within the deviation the perturbation causes
    if child.wait(timeout=900) != 0:
        raise AssertionError(f"the gather run's process failed ({child.returncode})")
    gres = torch.load(gather_path)
    gouts = gres["outs"]
    gtap = types.SimpleNamespace(logits=lambda rid, n: gres["logits"][rid][:n].cuda().float())
    copies = {r + HYBRID_COPY: r for r in compared}
    sensitivity = {r: _tap_spread(gtap, gtap, c, _common(prompts[r], gouts[c], gouts[r])[1],
                                  ref_rid=r)
                   for c, r in copies.items()}
    limit = max(DEVIATION_LIMIT, HYBRID_SOUND_FACTOR * max(sensitivity.values()))
    gather_ties, gather_probe = _tap_ties(prompts, {r: outs[r] for r in compared},
                                          {r: gouts[r] for r in compared}, tap, gtap,
                                          "kernel vs gather", limit=limit)
    copy_diverged = {r: _common(prompts[r], gouts[c], gouts[r])[0]
                     for c, r in copies.items() if gouts[c] != gouts[r]}
    gather_s = gres["seconds"]
    del gres, gtap, tap
    gc.collect()

    synced = _Arrivals(server(), stream, HYBRID_MAX_NEW)
    syncs, profile = _chunked_profile(synced.server, synced, HYBRID_PROFILED_STEPS,
                                      kernels=("paged_attn",))
    del synced

    emit({"phase": "serve-hybrid", "seconds": time.perf_counter() - phase_t0,
          "arch": HYBRID_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "global_layers": list(HYBRID_GLOBALS),
          "window": cfg.swa_window, "weights": "bf16 from seed 0, drawn on the card",
          "weight_bytes": weight_bytes, "init_s": init_s, "server": SERVE,
          "step_mode": "chunked (token stepping asked for; serve_step fallback recorded)",
          "prefix_cache": False, "max_seq": SERVE_MAX_SEQ, "requests": HYBRID_REQUESTS,
          "max_new_tokens": HYBRID_MAX_NEW,
          "prompt_lengths": [len(p) for _, p, _, _ in stream], "wrapping": wrapping,
          "finished": len(done), "wall_s": wall_s, "steps": m.steps,
          "sub_steps": forwards[0], "launches": launches,
          "b5": {"per_sub_step": per_substep, "ring_calls": calls["ring"],
                 "full_calls": calls["full"], "bodies": calls["bodies"],
                 "kernels_per_call": calls["kernels"]},
          "tokens_per_s": m.tokens_generated / wall_s, "metrics_tok_per_s": m.tok_per_s,
          "mean_ttft_s": m.mean_ttft_s, "mean_ttft_steps": m.mean_ttft_steps,
          "occupancy_pct": m.occupancy_pct, "mean_step_s": m.wall_s / m.steps,
          "batched_tokens": m.batched_tokens, "kv_blocks_peak": m.kv_blocks_peak,
          "kv_blocks_total": m.kv_blocks_total, "peak_memory_bytes": peak,
          "b5_against_plain_on_path": on_path,
          "gather": {"rids": compared, "wall_s": gather_s, "near_ties": len(gather_ties),
                     "ran": "in a process of its own, beside the main run",
                     "divergences": gather_ties, "probe": gather_probe,
                     "deviation_limit": limit, "noise": HYBRID_NOISE,
                     "perturbed_copy_spread": sensitivity,
                     "perturbed_copy_diverged_at": copy_diverged},
          "captures": {k: v["step"] for k, v in captured.items()},
          "syncs": syncs, "profile": profile})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return captured, launches


def _beside_phases():
    """The phases that may run in a process of their own beside another
    phase, by name."""
    return {"serve-moe": phase_serve_moe, "serve-rwkv": phase_serve_rwkv,
            "serve-hybrid": phase_serve_hybrid, "lm-predict": phase_lm_predict,
            "serve-vlm": phase_serve_vlm, "train-sharded": phase_train_sharded,
            "train-elastic": phase_train_elastic, "serve-sharded": phase_serve_sharded,
            "roofline-host": phase_roofline_host, "examples": phase_examples}


def _beside_result(name):
    return os.path.join(SCRATCH, f"{name}.result.pt")


def run_beside(name):
    """``chip_smoke.py --beside NAME``: the phase ``name``, its result saved
    to ``_beside_result(name)``."""
    import torch

    torch.save(_beside_phases()[name](), _beside_result(name))
    return 0


def _phase_beside(name):
    """Start the phase ``name`` in a process of its own, its standard output
    to a file under SCRATCH: a host-bound phase that runs beside another one
    (the card idles most of the time in each). Returns a handle for
    ``_join_beside``."""
    path = os.path.join(SCRATCH, name + ".out")
    out = open(path, "w")
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--beside", name],
                             stdout=out)
    return child, out, path, name


def _stop_beside(*handles):
    """Kill the processes of ``handles`` that still run (a phase failed)."""
    for child, out, _, _ in handles:
        if child.poll() is None:
            child.kill()
        child.wait()
        out.close()


def _join_beside(handle, timeout=900):
    """Wait for the process started by ``_phase_beside``, print its lines,
    fail where it failed, and return its phase's result."""
    import torch

    child, out, path, name = handle
    try:
        rc = child.wait(timeout=timeout)
    finally:
        _stop_beside(handle)
    with open(path) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    if rc != 0:
        raise AssertionError(f"the phase {name} in its own process failed: {rc}")
    return torch.load(_beside_result(name), weights_only=False)


# ---------------------------------------------------------------------------
# train-sharded: the TRAIN path on a mesh of gloo ranks sharing the card
# ---------------------------------------------------------------------------
SHARDED_WORLD = 4
# mesh name -> (data, model, shard_model); the LRMF case runs on "model"
SHARDED_MESHES = {"data": (4, 1, False), "model": (2, 2, True)}
SHARDED_TIMEOUT_S = 600  # the ranks' limit; the process group's is below it
SHARDED_PG_TIMEOUT_S = 300
B2_TOL = dict(rtol=2e-5, atol=2e-4)  # B2's parity tolerance, as the parity phase
# tests/test_shard_map_engine.py's LRMF case, at its size: 24 items, rank 4,
# merge_coef 8, 256 rows
LRMF_CASE = {"items": 24, "rank": 4, "coef": 8, "rows": 256, "lr": 1e-2}


def _sharded_inputs():
    """The table's heap (e2e wrote it; made again when this phase runs alone)
    and the LRMF case's rows and starting factors, from seeds."""
    import numpy as np

    from repro_torch.data.synthetic import WORKLOADS, generate
    from repro_torch.db.heap import HeapFile, write_table

    path = os.path.join(SCRATCH, f"{WORKLOAD}.heap")
    if not os.path.exists(path):
        wl = WORKLOADS[WORKLOAD]
        X, y = generate(wl, scale=SCALE, seed=0)
        write_table(path, X, y, page_bytes=wl.page_bytes)
    rng = np.random.default_rng(0)
    R = rng.normal(0, 1, (LRMF_CASE["rows"], LRMF_CASE["items"])).astype(np.float32)
    m0 = np.random.default_rng(1).normal(0, 0.05, (LRMF_CASE["items"], LRMF_CASE["rank"]))
    return HeapFile(path), R, m0.astype(np.float32)


def _lrmf_batches(R, device):
    import torch

    Rb = torch.from_numpy(R).reshape(-1, LRMF_CASE["coef"], R.shape[1]).to(device)
    return Rb, torch.zeros(Rb.shape[:2], device=device), torch.ones(Rb.shape[:2], device=device)


def _lrmf_graph():
    from repro_torch.algorithms import lrmf
    from repro_torch.core.translator import trace

    return trace(lambda: lrmf(LRMF_CASE["items"], rank=LRMF_CASE["rank"], lr=LRMF_CASE["lr"],
                              merge_coef=LRMF_CASE["coef"]))


def _sharded_graph():
    from repro_torch.algorithms import logistic_regression
    from repro_torch.core.translator import trace

    return trace(lambda: logistic_regression(54, lr=0.1, merge_coef=MERGE_COEF, epochs=EPOCHS))


def phase_train_sharded():
    """The parent of the ranks: the kernels built here, the unsharded
    solver.train on the card as the baseline (and the LRMF case's unsharded
    epoch), then SHARDED_WORLD gloo ranks on the one card
    (``chip_smoke.py --sharded-rank``), each failing the phase if it fails;
    one line per mesh. Returns the ranks' launches and B2's parity error for
    the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core import solver
    from repro_torch.core.engine import make_engine, models_from_numpy
    from repro_torch.db.bufferpool import BufferPool
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    build.build(*KERNEL_SOURCES)  # a hash hit after the build phase: nvcc stays out of the ranks
    heap, R, m0 = _sharded_inputs()
    pool = BufferPool(pool_bytes=heap.n_pages * heap.layout.page_bytes,
                      page_bytes=heap.layout.page_bytes)
    pool.warm(heap)
    g, part = _sharded_graph()
    t0 = time.perf_counter()
    base = solver.train(g, part, heap, pool=pool, mode="dana", seed=0)
    base_s = time.perf_counter() - t0
    gm, pm = _lrmf_graph()
    engm = make_engine(gm, pm)
    want_m, _ = engm.run_epoch(models_from_numpy([m0]), *_lrmf_batches(R, engm.device))
    work = os.path.join(SCRATCH, "sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = []
    try:
        for rank in range(SHARDED_WORLD):
            out = open(os.path.join(work, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(rank),
                 str(SHARDED_WORLD), work], stdout=out, stderr=subprocess.STDOUT, env=env),
                out))
        deadline = time.monotonic() + SHARDED_TIMEOUT_S
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                raise AssertionError(f"train-sharded: rank {rank} ended with {rc}")
    except BaseException:
        for rank in range(SHARDED_WORLD):
            path = os.path.join(work, f"rank{rank}.log")
            if os.path.exists(path):
                with open(path) as f:
                    sys.stderr.write(f"--- rank {rank} ---\n{f.read()[-4000:]}\n")
        raise
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            out.close()
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(SHARDED_WORLD)]

    w_base = base.models[0]
    for name in SHARDED_MESHES:
        got = [r[name] for r in ranks]
        w = got[0]["w"]
        same = all(np.array_equal(r["w"], w) for r in got)
        diff = float(np.abs(w - w_base).max())
        epoch_s = [r["epoch_s"] for r in got]
        busy = [r["busy_s"] for r in got]
        run_s = [r["total_s"] for r in got]
        emit({"phase": "train-sharded", "mesh": name, "shape": got[0]["mesh"],
              "shard_model": SHARDED_MESHES[name][2], "ranks": SHARDED_WORLD,
              "backend": got[0]["backend"], "path": got[0]["path"],
              "model_placements": got[0]["placements"],
              "launches_per_rank": [r["launches"] for r in got],
              "device_syncs": [r["device_syncs"] for r in got],
              "epoch_s_per_rank": epoch_s, "total_s_per_rank": [r["total_s"] for r in got],
              "tuples_per_s": EPOCHS * heap.n_tuples / max(r["total_s"] for r in got),
              "collectives_per_epoch": {k: v / EPOCHS for k, v in got[0]["collectives"].items()},
              "device_busy_s_per_rank": busy,
              "device_idle_share_per_rank": [1.0 - b / s for b, s in zip(busy, run_s)],
              "device_busy_share_all_ranks": sum(busy) / max(run_s),
              "unsharded_total_s": base_s, "unsharded_epoch_s": base.total_s / EPOCHS,
              "max_abs_diff_vs_unsharded": diff, "tolerance": 1e-4,
              "same_bits_on_every_rank": same,
              **({"glm_grad_parity": got[0]["parity"]} if "parity" in got[0] else {})})
        if not same:
            raise AssertionError(f"train-sharded {name}: the ranks' coefficients differ")
        if diff > 1e-4:
            raise AssertionError(f"train-sharded {name}: {diff} from the unsharded card run")
    got = [r["lrmf"] for r in ranks]
    m_diff = float(np.abs(got[0]["M"] - want_m[0].cpu().numpy()).max())
    emit({"phase": "train-sharded", "mesh": "model", "case": "lrmf", "path": got[0]["path"],
          "model_placements": got[0]["placements"], "collectives": got[0]["collectives"],
          "max_abs_diff_vs_unsharded": m_diff, "tolerance": {"rtol": 1e-4, "atol": 1e-5},
          "same_bits_on_every_rank": all(np.array_equal(r["M"], got[0]["M"]) for r in got),
          "seconds": time.perf_counter() - t_phase})
    np.testing.assert_allclose(got[0]["M"], want_m[0].cpu().numpy(), rtol=1e-4, atol=1e-5)
    if not all(np.array_equal(r["M"], got[0]["M"]) for r in got):
        raise AssertionError("train-sharded lrmf: the ranks' factors differ")
    return {"glm_grad_launches_per_rank": [r["data"]["launches"]["glm_grad"] for r in ranks],
            "parity": ranks[0]["data"]["parity"]}


class _FirstCalls:
    """Stands in for a kernel's wrapper on its module while installed (a
    context manager): every call launches the kernel, and the first
    ``calls`` are held against ``plain`` on the same inputs, output by
    output, by ``compare`` (output, plain) -> (excess, max |error|), the
    excess over the tolerance above 0 where a value falls outside. The
    errors stay on the card until ``result``. ``launches`` is the wrapper's
    own count, and the plain calls launch nothing."""

    def __init__(self, module, name, plain, compare, tolerance, calls=1):
        self.module, self.name, self.real = module, name, getattr(module, name)
        self.plain, self.compare, self.tolerance = plain, compare, tolerance
        self.left, self.errs = calls, []

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n

    def __call__(self, *args):
        import torch

        out = self.real(*args)
        if self.left > 0:
            self.left -= 1
            outs, plains = (x if isinstance(x, tuple) else (x,) for x in (out, self.plain(*args)))
            errs = [torch.stack(self.compare(o, p)) for o, p in zip(outs, plains)]
            self.errs.append(torch.stack(errs).amax(0))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def result(self, calls):
        """The check's record, read after the run; raises unless it held
        ``calls`` calls, each within the tolerance."""
        import torch

        worst = torch.stack(self.errs).amax(0).tolist() if self.errs else [float("inf")] * 2
        record = {"calls": len(self.errs), "max_abs_err": worst[1], **self.tolerance}
        if worst[0] > 0 or len(self.errs) != calls:
            raise AssertionError(f"{self.name} against its plain version on the main path, "
                                 f"{calls} calls expected: {record}")
        return record


def _b1_first_calls():
    """B1's first call held bit for bit against decode_pages_ref."""
    import torch

    from repro_torch.kernels.strider import kernel, ref

    def bits(out, plain):
        return ((out.view(torch.int32) != plain.view(torch.int32)).sum().float(),
                (out - plain).abs().max())

    return _FirstCalls(kernel, "strider_decode", ref.decode_pages_ref, bits, {"bit_exact": True})


def _b2_first_calls(name="glm_sgd_chunk", calls=1):
    """B2's first ``calls`` calls of ``name`` (the chunk walk: the new
    weights and every batch's gradient norm; or ``glm_grad``, one batch)
    held against its ``ref`` at B2_TOL."""
    from repro_torch.kernels.engine import kernel, ref

    def within(out, plain):
        err = (out - plain).abs()
        return (err - B2_TOL["atol"] - B2_TOL["rtol"] * plain.abs()).max(), err.max()

    return _FirstCalls(kernel, name, getattr(ref, name + "_ref"), within, B2_TOL, calls)


def sharded_rank(rank: int, world: int, work: str) -> int:
    """``chip_smoke.py --sharded-rank RANK WORLD DIR``: one gloo rank of
    train-sharded on cuda:0. For each mesh: solver.train over the whole heap
    with the vmap thread path poisoned, the launches and collectives counted
    from zero just before it, traced (the device's events only) for the
    rank's busy time, one join an epoch, the path and the model's placement
    checked; then the LRMF case on the model mesh. Saves its results to
    DIR/rank{RANK}.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import solver
    from repro_torch.core.engine import make_engine, models_from_numpy
    from repro_torch.db.bufferpool import BufferPool
    from repro_torch.dist import meshes
    from test_torch_dist_util import placements

    parent = os.getppid()

    def watch():  # a rank whose parent is gone (killed with its phase) ends
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARDED_PG_TIMEOUT_S))
    heap, R, m0 = _sharded_inputs()
    pool = BufferPool(pool_bytes=heap.n_pages * heap.layout.page_bytes,
                      page_bytes=heap.layout.page_bytes)
    pool.warm(heap)
    g, part = _sharded_graph()
    n_chunks = -(-heap.n_pages // solver.MAX_RESIDENT_PAGES)
    batches = sum(-(-min(solver.MAX_RESIDENT_PAGES, heap.n_pages - s)
                    * heap.layout.tuples_per_page // MERGE_COEF)
                  for s in range(0, heap.n_pages, solver.MAX_RESIDENT_PAGES))
    first_chunk = -(-min(solver.MAX_RESIDENT_PAGES, heap.n_pages) * heap.layout.tuples_per_page
                    // MERGE_COEF)
    out = {}

    def poisoned(*a, **kw):
        raise AssertionError("the sharded epoch took the vmap thread path")

    for name, (dp, mp, shard_model) in SHARDED_MESHES.items():
        mesh = meshes.make_mesh((dp, mp), ("data", "model"))
        engine = make_engine(g, part, mesh=mesh, shard_model=shard_model)
        engine._pre = poisoned
        sync_at, seen = [], []
        real_sync = solver._device_sync

        def timed_sync(models, gnorm):
            res = real_sync(models, gnorm)
            sync_at.append(time.perf_counter())
            seen.append(placements(models[0]))
            return res

        check = _b2_first_calls("glm_grad", first_chunk if (rank == 0 and not shard_model) else 0)
        box = {}

        def run():
            box["res"] = solver.train(g, part, heap, pool=pool, mode="dana", engine=engine,
                                      seed=0, mesh=mesh, shard_model=shard_model)

        solver._device_sync = timed_sync
        try:
            with meshes.use_mesh(mesh), check:
                dist.barrier()
                zero_launches()
                meshes.reset_collectives()
                t0 = time.perf_counter()
                # the run itself traced (the device's events only): its busy time
                _, busy_s, _ = _device_profile(run, cpu=False)
                launches = read_launches()
                collectives = dict(meshes.COLLECTIVES)
        finally:
            solver._device_sync = real_sync
        res, total_s = box["res"], sync_at[-1] - t0
        want = {k: 0 for k in launches}
        want["strider_decode"] = EPOCHS * n_chunks  # each rank's Strider, once a chunk
        want["glm_grad"] = 0 if shard_model else EPOCHS * batches
        if launches != want:
            raise AssertionError(f"{name} mesh, rank {rank}: launches {launches}, "
                                 f"expected {want}")
        if res.device_syncs != res.epochs_run or res.epochs_run != EPOCHS:
            raise AssertionError(f"{name} mesh: device_syncs {res.device_syncs}")
        path = engine.last_sharded_path
        want_path = ("shard_map", ("data",), "model" if shard_model else None)
        if path != want_path:
            raise AssertionError(f"{name} mesh: path {path}, expected {want_path}")
        want_place = ["R", "S(0)"] if shard_model else None
        if any(p != want_place for p in seen):
            raise AssertionError(f"{name} mesh: w placed {seen}, expected {want_place}")
        out[name] = {"mesh": {"data": dp, "model": mp}, "path": path, "placements": seen[-1],
                     "launches": launches, "collectives": collectives,
                     "device_syncs": res.device_syncs, "total_s": total_s,
                     "epoch_s": [b - a for a, b in zip([t0] + sync_at[:-1], sync_at)],
                     "busy_s": busy_s, "w": res.models[0], "backend": dist.get_backend()}
        if check.errs:
            out[name]["parity"] = check.result(first_chunk)

    # the LRMF case on the model mesh: the gspmd path, items Shard(0)
    mesh = meshes.make_mesh(SHARDED_MESHES["model"][:2], ("data", "model"))
    gm, pm = _lrmf_graph()
    engm = make_engine(gm, pm, shard_model=True)
    meshes.reset_collectives()
    with meshes.use_mesh(mesh):
        got, _ = engm.run_epoch(models_from_numpy([m0]), *_lrmf_batches(R, engm.device))
        whole = meshes.full_tensor(got[0]).cpu().numpy()
    out["lrmf"] = {"path": engm.last_sharded_path, "placements": placements(got[0]),
                   "collectives": dict(meshes.COLLECTIVES), "M": whole}
    if out["lrmf"]["path"] != ("gspmd", ("data",), None) or out["lrmf"]["placements"] != [
            "R", "S(0)"]:
        raise AssertionError(f"lrmf: {out['lrmf']['path']}, {out['lrmf']['placements']}")
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    return 0


# ---------------------------------------------------------------------------
# serve-sharded: the sharded server on a mesh of gloo ranks sharing the card
# ---------------------------------------------------------------------------
SERVE_SHARDED_WORLD = 4
# (data, model): the kernel path keeps the block pool replicated over data
# (repro's SERVE_KERNEL_CACHE_RULES), and nemo's 8 KV heads go over model,
# so each rank calls B5 at KVH 4, G 4, D 128
SERVE_SHARDED_MESH = (2, 2)
# mistral-nemo-12b at full width on 2 of its 40 layers, for the smoke's
# time: the phase runs alone after train-elastic (every rank holds the whole
# weights, 3.8 GB at 2 layers, and its 4 ranks peak at 5.6 GB each, which
# beside train-elastic's 4 ranks and its snapshots would pass the 72 GB
# budget), each layer adds a join over gloo to every fused step, and every
# layer has the same shapes
SERVE_SHARDED_LAYERS = 2
# the serve phase's first 16 requests (all arriving at step 0), 32 new
# tokens each; the dense check serves the 4 shortest of them
SERVE_SHARDED_REQUESTS, SERVE_SHARDED_MAX_NEW, SERVE_SHARDED_DENSE = 16, 32, 4
# rank 0's first B5 call of this fused step is kept for the kernels line (a
# mixed step: prefill runs beside decode rows)
SERVE_SHARDED_CAPTURE_STEP = 20
SERVE_SHARDED_TIMEOUT_S = 600  # the ranks' limit; the process group's is below it
SERVE_SHARDED_PG_TIMEOUT_S = 300


def _serve_sharded_setup():
    """The phase's model (full width, SERVE_SHARDED_LAYERS layers), its
    stream and the dense check's."""
    from repro_torch.configs import get_config

    full = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_SHARDED_LAYERS)
    stream = _serve_stream(cfg.vocab_size)[:SERVE_SHARDED_REQUESTS]
    dense = [(rid, p, prio, 0) for rid, p, prio, _ in
             sorted(stream, key=lambda r: (len(r[1]), r[0]))[:SERVE_SHARDED_DENSE]]
    return full, cfg, stream, dense


_SERVE_SHARDED_DENSE_KW = {"batch_slots": SERVE_SHARDED_DENSE, "kv": "dense",
                           "attn_impl": "gather"}


def phase_serve_sharded():
    """The sharded server (A19c). The baselines: the unsharded server on the
    card, mistral-nemo-12b at full width on SERVE_SHARDED_LAYERS layers,
    bf16 weights from seed 0, SERVE's settings (paged, token stepping, the
    kernel), the serve phase's first 16 requests with 32 new tokens each;
    and the 4 shortest on dense caches through the gather path. Then
    SERVE_SHARDED_WORLD gloo ranks on the one card (``chip_smoke.py
    --serve-rank``) serve the same on a (2 data x 2 model) mesh, each
    checking its own run (see ``serve_rank``). One line of the baselines and
    one of the ranks. Returns rank 0's captured B5 call and each rank's
    launches for the kernels line."""
    import gc

    import torch

    from repro_torch.kernels import build
    from repro_torch.models import model_zoo
    from repro_torch.serve.serving import BatchedServer

    build.build(*KERNEL_SOURCES)  # a hash hit after the build phase: nvcc stays out of the ranks
    full, cfg, stream, dense = _serve_sharded_setup()
    work = os.path.join(SCRATCH, "serve-sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda")
    base, seconds = {}, {}
    for name, kw, sub in (("paged", {}, stream), ("dense", _SERVE_SHARDED_DENSE_KW, dense)):
        srv = BatchedServer(cfg, params, max_seq=SERVE_MAX_SEQ, device="cuda",
                            **dict(SERVE, **kw))
        t0 = time.perf_counter()
        done = _Arrivals(srv, sub, SERVE_SHARDED_MAX_NEW).run()
        seconds[name] = {"wall_s": time.perf_counter() - t0, "steps": srv.metrics.steps,
                         "tokens": srv.metrics.tokens_generated}
        base[name] = {rid: r.out for rid, r in done.items()}
        del srv
    torch.save(base, os.path.join(work, "baseline.pt"))
    emit({"phase": "serve-sharded", "run": "unsharded baselines", "arch": SERVE_ARCH,
          "layers": cfg.n_layers, "published_layers": full.n_layers,
          "depth_cut": "the smoke's time: each layer adds a join over gloo a fused step",
          "d_model": cfg.d_model, "requests": len(stream), "dense_requests": len(dense),
          "max_new_tokens": SERVE_SHARDED_MAX_NEW, "server": SERVE,
          "dense_server": dict(SERVE, **_SERVE_SHARDED_DENSE_KW), "runs": seconds})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = []
    t_ranks = time.perf_counter()
    try:
        for rank in range(SERVE_SHARDED_WORLD):
            out = open(os.path.join(work, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--serve-rank", str(rank),
                 str(SERVE_SHARDED_WORLD), work], stdout=out, stderr=subprocess.STDOUT,
                env=env), out))
        deadline = time.monotonic() + SERVE_SHARDED_TIMEOUT_S
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                raise AssertionError(f"serve-sharded: rank {rank} ended with {rc}")
    except BaseException:
        for rank in range(SERVE_SHARDED_WORLD):
            path = os.path.join(work, f"rank{rank}.log")
            if os.path.exists(path):
                with open(path) as f:
                    sys.stderr.write(f"--- rank {rank} ---\n{f.read()[-4000:]}\n")
        raise
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            out.close()
    ranks_s = time.perf_counter() - t_ranks
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(SERVE_SHARDED_WORLD)]
    capture = torch.load(os.path.join(work, "capture.pt"), weights_only=False)
    main = [r["paged"] for r in ranks]
    if any(r["outs"] != main[0]["outs"] for r in main):
        raise AssertionError("the ranks hold different tokens")
    emit({"phase": "serve-sharded", "run": "sharded", "arch": SERVE_ARCH,
          "layers": cfg.n_layers, "mesh": dict(zip(("data", "model"), SERVE_SHARDED_MESH)),
          "ranks": SERVE_SHARDED_WORLD, "backend": ranks[0]["backend"], "ranks_s": ranks_s,
          "path": main[0]["path"], "fallbacks": main[0]["fallbacks"],
          "k_pool": main[0]["k_pool"], "b5_call": main[0]["b5_call"],
          "finished": main[0]["finished"], "steps": main[0]["steps"],
          "fused_decodes": main[0]["fused_decodes"],
          "near_ties": main[0]["near_ties"], "probe": main[0]["probe"],
          "b5_against_plain_first_step": [r["plain_check"] for r in main],
          "launches_per_rank": [r["launches"] for r in main],
          "launches_expected_per_rank": main[0]["launches_expected"],
          "rank_disagreements": [r["disagreements"] for r in main],
          "seconds_per_fused_step": [r["wall_s"] / r["steps"] for r in main],
          "tokens_per_s": [r["tokens"] / r["wall_s"] for r in main],
          "collectives_per_fused_step": [{k: v / r["steps"] for k, v in r["collectives"].items()}
                                         for r in main],
          "collective_bytes_per_fused_step": [
              {k: v / r["steps"] for k, v in r["collective_bytes"].items()} for r in main],
          "device_busy_share": [r["busy_s"] / r["wall_s"] for r in main],
          "device_idle_share": [1.0 - r["busy_s"] / r["wall_s"] for r in main],
          "peak_memory_bytes": [r["peak_memory_bytes"] for r in main],
          "wall_s": [r["wall_s"] for r in main],
          "dense_check": {k: ranks[0]["dense"][k] for k in
                          ("path", "fallbacks", "finished", "near_ties", "probe", "steps")}})
    return {"capture": capture, "launches_per_rank": [r["launches"]["paged_attn"] for r in main]}


def serve_rank(rank: int, world: int, work: str) -> int:
    """``chip_smoke.py --serve-rank RANK WORLD DIR``: one gloo rank of
    serve-sharded on cuda:0. Draws the weights (seed 0, whole), builds the
    (2 x 2) mesh and serves the phase's stream through
    ``BatchedServer(mesh=, param_specs=)`` on the kernel path, the launches
    and collectives counted from zero just before and the run traced (the
    device's events only) for its busy time. Checks: the decision and its
    recorded fallback (the pool replicated), the pool's placement (heads
    over model, contiguous), B5's shape (KVH 4, G 4, D 128), every call of
    the first fused step against its plain version (``_PlainCheck``), B5
    launched once a layer a fused decode and nothing else, every request
    FINISHED with its tokens, the tokens the baseline's up to near-ties
    within DEVIATION_LIMIT (the sharded decode teacher-forced against the
    unsharded one), no disagreement with rank 0; then the dense check (4
    requests, slots over data, heads over model) the same way. Saves its
    results to DIR/rank{RANK}.pt, rank 0 its captured call to
    DIR/capture.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.dist import meshes
    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.serving import BatchedServer
    from test_torch_dist_util import placements

    parent = os.getppid()

    def watch():  # a rank whose parent is gone (killed with its phase) ends
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SERVE_SHARDED_PG_TIMEOUT_S))
    _, cfg, stream, dense = _serve_sharded_setup()
    base = torch.load(os.path.join(work, "baseline.pt"), weights_only=False)
    params, specs = model_zoo.init_params(cfg, seed=0, device="cuda")
    mesh = meshes.make_mesh(SERVE_SHARDED_MESH, ("data", "model"))
    out = {"backend": dist.get_backend()}

    box = {}

    def serve(name, kw, sub):
        meshes.clear_fallbacks()
        srv = box["server"] = BatchedServer(cfg, params, max_seq=SERVE_MAX_SEQ, device="cuda",
                                            mesh=mesh, param_specs=specs, **dict(SERVE, **kw))
        res = {"path": srv.last_sharded_path, "fallbacks": meshes.fallbacks()}
        forwards = _count_forwards(srv)
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        zero_launches()
        meshes.reset_collectives()
        t0 = time.perf_counter()
        _, busy_s, _ = _device_profile(
            lambda: box.update(done=_Arrivals(srv, sub, SERVE_SHARDED_MAX_NEW).run()), cpu=False)
        torch.cuda.synchronize()
        m = srv.metrics
        res.update(wall_s=time.perf_counter() - t0, busy_s=busy_s, launches=read_launches(),
                   collectives=dict(meshes.COLLECTIVES),
                   collective_bytes=dict(meshes.COLLECTIVE_BYTES),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(), steps=m.steps,
                   tokens=m.tokens_generated, fused_decodes=forwards[0],
                   disagreements=srv.rank_disagreements, attn_impl=srv.attn_impl,
                   layout={k: (placements(c), tuple(meshes.local(c).shape),
                               meshes.local(c).is_contiguous())
                           for k, c in srv.cache[0].items()})
        done = box["done"]
        if sorted(done) != sorted(r[0] for r in sub) or any(
                r.status != sched.FINISHED or len(r.out) != SERVE_SHARDED_MAX_NEW
                for r in done.values()):
            raise AssertionError(f"{name}: not every request FINISHED with its tokens")
        res["finished"] = len(done)
        res["outs"] = {rid: r.out for rid, r in done.items()}
        if res["disagreements"]:
            raise AssertionError(f"{name}: rank {rank} disagreed with rank 0 "
                                 f"{res['disagreements']} times")
        return res

    def near_ties(res, name, sub, side):
        """The tokens against the baseline's, up to near-ties: the sharded
        decode (``side`` on the mesh) teacher-forced against the unsharded
        one, every rank the same calls."""
        kv = ("dense",) if name == "dense" else ()
        res["near_ties"], res["probe"] = _near_ties(
            cfg, params, sub, res["outs"], base[name], side + (mesh,) + kv,
            side + (None,) + kv, f"{name}: sharded vs unsharded")

    # the main path: paged, token stepping, B5 over this rank's heads
    check, shapes, kept = _PlainCheck(), set(), {}
    real = pa_kernel.paged_attention

    def capture(q, k_pool, v_pool, table, pos, **kw):
        srv = box["server"]
        out = real(q, k_pool, v_pool, table, pos, **kw)
        shapes.add((tuple(q.shape[1:]), tuple(k_pool.shape), k_pool.is_contiguous()))
        if srv.step_no == 0:
            check(out, q, k_pool, v_pool, table, pos, kw)
        if rank == 0 and not kept and srv.step_no >= SERVE_SHARDED_CAPTURE_STEP:
            kept.update(q=q.clone(), pools=(k_pool.clone(), v_pool.clone()), latent=False,
                        table=table.clone(), pos=pos.clone(), runs=kw["runs"].clone(),
                        kw={k: v for k, v in kw.items() if k != "runs"}, step=srv.step_no)
        return out

    pa_ops.kernel = types.SimpleNamespace(paged_attention=capture)
    try:
        main = serve("paged", {}, stream)
    finally:
        pa_ops.kernel = pa_kernel
    near_ties(main, "paged", stream, ("kernel", 64))
    kvh, g = cfg.n_kv_heads // SERVE_SHARDED_MESH[1], cfg.n_heads // cfg.n_kv_heads
    want_path = ("gspmd", (), "model")
    if main["path"] != want_path or [(t, ax) for t, (ax, _), _ in main["fallbacks"]] != [
            ("serve_cache", "kv_blocks")]:
        raise AssertionError(f"path {main['path']}, fallbacks {main['fallbacks']}")
    pool = main["layout"]["k"]
    if pool[0] != ["R", "S(3)"] or pool[1][3] != kvh or not pool[2]:
        raise AssertionError(f"the pool's placement {pool}")
    if {sh[0] for sh in shapes} != {(kvh, g, cfg.hd)} or not all(c for _, _, c in shapes):
        raise AssertionError(f"B5's per-rank calls {shapes}")
    main["k_pool"] = {"placements": pool[0], "local_shape": pool[1], "contiguous": pool[2]}
    main["b5_call"] = {"kv_heads": kvh, "group": g, "head_dim": cfg.hd}
    want = {k: 0 for k in main["launches"]}
    want["paged_attn"] = cfg.n_layers * main["fused_decodes"]
    if main["launches"] != want or main["fused_decodes"] == 0:
        raise AssertionError(f"launches {main['launches']}, expected {want}")
    main["launches_expected"] = want
    main["plain_check"] = check.result(cfg.n_layers, "every call of the first fused step")
    out["paged"] = main

    # the dense check: slots over data, heads over model, the gather path
    out["dense"] = serve("dense", _SERVE_SHARDED_DENSE_KW, dense)
    near_ties(out["dense"], "dense", dense, ("gather", 64))
    if out["dense"]["path"] != ("gspmd", ("data",), "model"):
        raise AssertionError(f"dense path {out['dense']['path']}")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        torch.save(kept, os.path.join(work, "capture.pt"))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    return 0


def phase_serve_rwkv():
    """rwkv6-3b at full width and depth, bf16 weights from seed 0, asked for
    paged KV and token stepping: served dense and chunked (both recorded or
    checked), every request FINISHED, no WKV kernel launched (decode runs
    the per-token recurrence), one host read per fused step, and every
    request against generate_greedy (dense, one-token prefill) token for
    token except at reported near-ties."""
    import gc

    import numpy as np
    import torch

    from repro_torch.dist import meshes
    from repro_torch.models import model_zoo
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve import serving

    cfg = _published(TRAIN_ARCH, TRAIN_FIELDS, TRAIN_WIDTH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    stream = [(rid, rng.integers(1, cfg.vocab_size, int(rng.integers(*RWKV_LENGTHS) + 1))
               .tolist(), 1, 0) for rid in range(RWKV_REQUESTS)]
    prompts = {rid: p for rid, p, _, _ in stream}
    max_seq = RWKV_LENGTHS[1] + RWKV_MAX_NEW + 1
    compared = sorted(prompts)

    meshes.clear_fallbacks()
    main = serving.BatchedServer(cfg, params, max_seq=max_seq, device="cuda", **RWKV_SERVE)
    if main.kv_mode != "dense" or main.step_mode != "chunked" or \
            not _fallback_recorded("serve_step"):
        raise AssertionError(f"kv_mode {main.kv_mode}, step_mode {main.step_mode}: rwkv6-3b "
                             "must serve dense and chunked")
    tap = _LogitTap(main, set(compared))
    zero_launches()
    t0 = time.perf_counter()
    done = _Arrivals(main, stream, RWKV_MAX_NEW).run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    m = main.metrics
    if sorted(done) != list(range(RWKV_REQUESTS)) or any(
            r.status != sched.FINISHED or len(r.out) != RWKV_MAX_NEW for r in done.values()):
        raise AssertionError(f"not every request FINISHED with its {RWKV_MAX_NEW} tokens")
    if any(launches.values()):
        raise AssertionError(f"the rwkv serve path launched kernels: {launches}")
    del main

    # generate_greedy on the compared prompts (its own server: dense,
    # one-token prefill), tapped
    taps = []

    class Tapped(serving.BatchedServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            taps.append(_LogitTap(self, set(range(len(compared)))))

    real_server = serving.BatchedServer
    serving.BatchedServer = Tapped
    try:
        t0 = time.perf_counter()
        greedy = serving.generate_greedy(cfg, params, [prompts[r] for r in compared],
                                         RWKV_MAX_NEW, device="cuda")
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    finally:
        serving.BatchedServer = real_server
    # the greedy run's rids are the compared requests' indices
    idx = {rid: i for i, rid in enumerate(compared)}
    ref_tap = types.SimpleNamespace(logits=lambda rid, n: taps[0].logits(idx[rid], n))
    ties, probe = _tap_ties(prompts, {r: done[r].out for r in compared},
                            {r: greedy[idx[r]] for r in compared}, tap, ref_tap,
                            "chunked vs generate_greedy")
    del taps, tap

    synced = _Arrivals(serving.BatchedServer(cfg, params, max_seq=max_seq, device="cuda",
                                             **RWKV_SERVE), stream, RWKV_MAX_NEW)
    where, _ = _synchronizing_calls(lambda: synced.run(max_steps=HYBRID_SYNC_STEPS), [])
    reads = sum(where.values())
    if reads != HYBRID_SYNC_STEPS or len(where) != 1:
        raise AssertionError(f"expected one host read per fused step: {where}")
    del synced, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve-rwkv", "arch": TRAIN_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "weights": "bf16 from seed 0, drawn on the card",
          "server": RWKV_SERVE, "kv_mode": "dense (paged asked for)",
          "step_mode": "chunked (token stepping asked for; serve_step fallback recorded)",
          "max_seq": max_seq, "requests": RWKV_REQUESTS, "max_new_tokens": RWKV_MAX_NEW,
          "prompt_tokens_submitted": sum(len(p) for p in prompts.values()),
          "finished": len(done), "wall_s": wall_s, "steps": m.steps,
          "tokens_per_s": m.tokens_generated / wall_s, "mean_step_s": m.wall_s / m.steps,
          "mean_ttft_steps": m.mean_ttft_steps, "launches": launches,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "generate_greedy": {"rids": compared, "wall_s": greedy_s, "near_ties": len(ties),
                              "divergences": ties, "probe": probe},
          "syncs": {"steps": HYBRID_SYNC_STEPS, "synchronizing_calls": reads, "where": where}})


def phase_train_hybrid():
    """hymba-1.5b at full width and depth trained for HYBRID_TRAIN_STEPS
    steps of HYBRID_TRAIN_BATCH x TRAIN_SEQ tokens by ``_train_phase`` (B1
    the one kernel: the sliding-window attention and the Mamba scan are
    plain PyTorch, as in the reference), with the Mamba mixer's share of the
    profiled step; then a 2-layer full-width model (one global, one
    sliding-window layer) prefills WINDOW_CHECK_TOKENS tokens, past the
    window, against as many decode steps on the dense ring cache."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import record_function

    from repro_torch.models import model_zoo, ssm

    cfg = _published(HYBRID_ARCH, HYBRID_FIELDS, HYBRID_WIDTH)
    real = ssm.mamba_mix

    def ranged(*args, **kw):
        with record_function(MAMBA_RANGE):
            return real(*args, **kw)

    # the range costs one host call a layer and launches nothing
    ssm.mamba_mix = ranged
    try:
            record, run = _train_phase(cfg, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_STEPS,
                                   {"strider_decode": 1}, "hymba_tokens.heap",
                                   kernels=("strider_decode",), ranges=(MAMBA_RANGE,))
    finally:
        ssm.mamba_mix = real
    prof = record["profile"]
    prof["mamba_ms"] = prof["device_ms_in"][MAMBA_RANGE]
    prof["mamba_share_of_busy"] = (prof["mamba_ms"] / 1e3 / prof["device_busy_s"]
                                   if prof["device_busy_s"] else None)
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # prefill (gqa_train over the window, the chunked Mamba scan) against
    # WINDOW_CHECK_TOKENS dense decode steps (the ring of 1,024 rows wraps,
    # the Mamba state carried token by token), bf16 weights; beside it the
    # same decode with its attention outputs perturbed (HYBRID_NOISE): the
    # logits' deviation must stay within 3e-2, or within HYBRID_SOUND_FACTOR
    # times what that perturbation moves where that is larger
    small = dataclasses.replace(cfg, n_layers=2, n_global_layers=1)
    params, _ = model_zoo.init_params(small, seed=1, device="cuda")
    rng = np.random.default_rng(3)
    n = WINDOW_CHECK_TOKENS
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, n)).astype(np.int32)).cuda()
    step = model_zoo.decode_fn(small)

    def decode():
        cache = model_zoo.make_cache(small, 2, n + 1, "cuda")
        for t in range(n):
            logits, cache = step(params, tokens[:, t], cache, t)
        return logits.float(), cache

    t0 = time.perf_counter()
    with torch.no_grad():
        pre = model_zoo.prefill_fn(small)(params, {"tokens": tokens}).float()
        dec, cache = decode()
        with _AttentionNoise(tokens.device):
            noisy, _ = decode()
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    ring_rows = int(cache[1]["k"].shape[2])
    dev = float((pre - dec).abs().max())
    floor = float((noisy - dec).abs().max())
    tol = max(3e-2, HYBRID_SOUND_FACTOR * floor)
    agree = int((pre.argmax(-1) == dec.argmax(-1)).sum())
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train-hybrid", "arch": HYBRID_ARCH, "global_layers": list(HYBRID_GLOBALS),
          "window": cfg.swa_window, **record,
          "prefill_vs_decode": {"layers": 2, "kinds": ["hybrid_global", "hybrid_swa"],
                                "tokens": [2, n], "ring_rows": ring_rows, "seconds": check_s,
                                "max_abs_dev": dev, "perturbed_decode_dev": floor,
                                "noise": HYBRID_NOISE, "tolerance": tol,
                                "argmax_agree": agree}})
    _check_train(record)
    if ring_rows != cfg.swa_window or dev > tol or agree != 2:
        raise AssertionError(f"prefill vs decode: ring {ring_rows}, deviation {dev}, "
                             f"argmax agree {agree} of 2")


# the serve-moe and train-moe phases. olmoe-1b-7b at full width and depth:
# (layers, d_model, heads, kv heads, experts, top-k, expert d_ff, vocab,
# capacity factor) of configs/olmoe_1b_7b.py; its attention is GQA at KVH 16,
# G 1, D 128, one B5 call a layer a sub-step. It serves with SERVE's settings
# (token stepping asked for, chunked taken: MoE capacity groups would see
# padding rows), in a process of its own beside the serve phase
MOE_ARCH = "olmoe-1b-7b"
MOE_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "n_experts",
              "experts_per_token", "moe_d_ff", "vocab_size", "capacity_factor")
MOE_WIDTH = (16, 2048, 16, 16, 64, 8, 1024, 50304, 1.25)
# 24 greedy requests of 64-1,024 prompt tokens (the first of 1,024, so that
# a position passes MOE_CAPTURE_POS), 32 new tokens: 16 at step 0, then one
# every 4 steps into the slots that free up (idle rows meanwhile)
MOE_REQUESTS, MOE_MAX_NEW, MOE_LENGTHS = 24, 32, (64, 1025)
MOE_CAPTURE_POS = 1040
# the kernel and gather paths compared on the MOE_COMPARED shortest requests,
# each path serving them alone (a decode sub-step routes the whole batch as
# one group, so a comparison needs the same batch on both sides); beside
# them the gather path with HYBRID_NOISE on its attention outputs, the noise
# floor. A route flips where a token's k-th and (k+1)-th router
# probabilities lie within MOE_ROUTE_TIE (tests/test_torch_serving_moe.py)
MOE_COMPARED, MOE_ROUTE_TIE = 4, 1e-3
# the MoE block in the training profile: a record_function range a call
MOE_RANGE = "moe_block"
# train-moe: 16 layers take 110.7 GB at 16 bytes a parameter (6.92 B
# parameters: f32 master, gradient, two moments), so the depth is cut to
# MOE_TRAIN_LAYERS (63.7 GB); batch 8 x TRAIN_SEQ, 4 steps
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 9, 8, 4


def _moe_stream(vocab: int):
    """serve-moe's traffic from seed 2: (rid, prompt, priority, arrival
    step)."""
    import numpy as np

    rng = np.random.default_rng(2)
    lengths = [MOE_LENGTHS[1] - 1] + [int(rng.integers(*MOE_LENGTHS))
                                      for _ in range(MOE_REQUESTS - 1)]
    return [(rid, rng.integers(1, vocab, n).tolist(), 1, 0 if rid < 16 else 4 * (rid - 15))
            for rid, n in enumerate(lengths)]


class _RowTap:
    """A chunked-stepping server's logits at every sub-step, its run mask,
    which rows emit a token, which request each row holds, and each row's
    smallest margin between its token's k-th and (k+1)-th router
    probability over the MoE layers (with the layer): what two runs of the
    same requests compare row by row, sub-step by sub-step."""

    def __init__(self, server):
        import torch

        from repro_torch.models import moe

        self.logits, self.run, self.emit, self.rids, self.route = [], [], [], [], []
        real_forward, real_decode, real_route = server._forward, server._decode, moe.route

        def forward(tok, pos, write_ok, **kw):
            self.run.append(write_ok)
            self.emit.append(write_ok & (pos + 1 >= torch.from_numpy(server._prompt_len)
                                         .to(pos.device)))
            self.rids.append([None if r is None else r.rid for r in server.active])
            self.route.append([])
            return real_forward(tok, pos, write_ok, **kw)

        def decode(*args, **kw):
            logits, cache = real_decode(*args, **kw)
            self.logits.append(logits[:, :server.cfg.vocab_size].float())
            return logits, cache

        def route(x, router, k):
            out = real_route(x, router, k)
            top = torch.sort(out[0].detach(), dim=-1, descending=True).values
            self.route[-1].append((top[..., k - 1] - top[..., k]).reshape(-1))  # read later
            return out

        server._forward, server._decode = forward, decode
        self.hook = (moe, real_route, route)

    def __enter__(self):
        self.hook[0].route = self.hook[2]
        return self

    def __exit__(self, *exc):
        self.hook[0].route = self.hook[1]


def _row_divergences(tap, ref, limit):
    """Each request of two runs of the same requests on the same schedule,
    row by row: the spread over the vocab of the logits' difference and the
    emitted token at every sub-step it runs, up to its first sub-step where
    the spread passes ``limit`` or the token differs. There: its tokens
    emitted so far, ``ref``'s top-2 margin where the token differs, the
    row's smallest router margin in either run (and its layer), and whether
    that is a near-tie (the margin below the deviation so far) or a route
    flip (a router margin below MOE_ROUTE_TIE). Returns {rid: record}, the
    first divergence None where the request never diverges."""
    import torch

    out = {}
    n = min(len(tap.logits), len(ref.logits))
    for rid in sorted({r for rows in tap.rids for r in rows if r is not None}):
        deviation, emitted, first = 0.0, 0, None
        for j in range(n):
            if rid not in tap.rids[j]:
                continue
            i = tap.rids[j].index(rid)
            if not bool(tap.run[j][i]):
                continue
            delta = tap.logits[j][i] - ref.logits[j][i]
            spread = float(delta.max() - delta.min())
            emits = bool(tap.emit[j][i])
            differ = emits and int(tap.logits[j][i].argmax()) != int(ref.logits[j][i].argmax())
            if spread <= limit and not differ:
                deviation = max(deviation, spread)
                emitted += emits
                continue
            margin = None
            if differ:
                top = torch.topk(ref.logits[j][i], 2).values
                margin = float(top[0] - top[1])
            routes = torch.stack([torch.stack(tap.route[j]), torch.stack(ref.route[j])])[:, :, i]
            layer = int(routes.min(0).values.argmin())
            router = float(routes.min())
            first = {"sub_step": j, "token_index": emitted, "spread": spread,
                     "logit_margin": margin, "router_margin": router, "router_layer": layer,
                     "near_tie": margin is not None and spread <= limit
                     and margin < max(spread, deviation),
                     "route_flip": router < MOE_ROUTE_TIE}
            break
        out[rid] = {"deviation_before": deviation, "first": first}
    return out


def _moe_decode_ms(server):
    """Device ms of one layer's MoE block at the server's decode shape (its
    slots, one token, bf16: one routing group), from the device's own
    events (``busy_ms``: the phase shares the card), over 4 layers' weights
    in turn, so that each call finds its experts out of the 50 MB L2 as the
    next layer's call does."""
    import torch

    from repro_torch.models import moe, transformer

    cfg, dev = server.cfg, server.device
    layers = [transformer._layer(sp, i)["moe"]
              for sp, seg in zip(server.params["segments"], transformer.segments_for(cfg))
              if seg.kind == "attn_moe" for i in range(seg.n_layers)][:4]
    gen = torch.Generator(device=dev).manual_seed(5)
    h = torch.randn((server.slots, 1, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    return busy_ms([lambda p=p: moe.apply_moe(p, h, cfg) for p in layers])


def _moe_dropped(cfg, inputs, routers, run):
    """The share of (token, expert) choices that capacity dropped in one
    captured sub-step, from the port's routing on each MoE layer's captured
    input (B, 1, d) and router: over every row, and over the rows that ran
    (idle rows claim capacity ahead of the live rows below them)."""
    import torch

    from repro_torch.models import moe

    cap = moe.capacity(cfg, inputs[0].shape[0])
    kept, kept_live = [], []
    for x, router in zip(inputs, routers):
        _, _, topi = moe.route(x.reshape(1, -1, cfg.d_model), router, cfg.experts_per_token)
        ok = moe.Routing(topi, cap, cfg.n_experts).choice_ok
        kept.append(ok.float().mean())
        kept_live.append(ok[run].float().mean())
    return {"capacity": cap, "rows": int(inputs[0].shape[0]), "live_rows": int(run.sum()),
            "dropped_share": 1.0 - float(torch.stack(kept).mean()),
            "dropped_share_live": 1.0 - float(torch.stack(kept_live).mean()),
            "dropped_share_by_layer": [1.0 - float(k) for k in kept]}


def phase_serve_moe():
    """olmoe-1b-7b at full width and depth, bf16 weights from seed 0,
    serving MOE_REQUESTS greedy requests through BatchedServer(SERVE): token
    stepping falls back to chunked stepping (recorded), prefix sharing is
    off, every request FINISHED, B5 16 times a sub-step on the split body,
    every B5 call of each fused step's first sub-step against its plain
    version at rtol=atol=2e-5, one host read per fused step, a profiled
    fused step (B5's and the MoE block's shares), and the share of choices
    capacity dropped in the captured sub-step; then the kernel and the
    gather path (and the gather path under HYBRID_NOISE) each on the
    MOE_COMPARED shortest requests, compared sub-step by sub-step. Returns
    (B5's call of the first sub-step past MOE_CAPTURE_POS, the launches)."""
    import contextlib
    import gc

    import torch

    from repro_torch.dist import meshes
    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models import model_zoo, moe
    from repro_torch.models.params import leaves
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.serving import BatchedServer

    phase_t0 = time.perf_counter()
    cfg = _published(MOE_ARCH, MOE_FIELDS, MOE_WIDTH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    stream = _moe_stream(cfg.vocab_size)
    prompts = {rid: p for rid, p, _, _ in stream}

    def server(**kw):
        return BatchedServer(cfg, params, max_seq=SERVE_MAX_SEQ, device="cuda",
                             **dict(SERVE, **kw))

    meshes.clear_fallbacks()
    main = server()
    if main.step_mode != "chunked" or not _fallback_recorded("serve_step") or \
            main.prefix_cache or main.attn_impl != "kernel":
        raise AssertionError("the MoE server did not fall back to chunked stepping on the "
                             "kernel path with no prefix sharing")
    forwards = _count_forwards(main)
    real_forward = main._forward
    run_mask = []

    def forward(tok, pos, write_ok, **kw):
        run_mask[:] = [write_ok]
        return real_forward(tok, pos, write_ok, **kw)

    main._forward = forward
    real = pa_kernel.paged_attention
    real_moe = moe.apply_moe
    sub = {"step": -1, "calls": 0}
    captured, calls = {}, {"bodies": {}, "kernels": {}}
    moe_inputs = []
    check = _PlainCheck()

    def capture(q, k_pool, v_pool, table, pos, **kw):
        if sub["step"] != main.step_no:
            sub.update(step=main.step_no, calls=0)
        j = sub["calls"] // cfg.n_layers  # the sub-step of this call
        sub["calls"] += 1
        if "call" not in captured and any(
                r is not None and MOE_CAPTURE_POS <= main._positions[i] + j < main.max_seq
                for i, r in enumerate(main.active)):
            t = q.shape[0]  # every row its own run, as chunked stepping calls it
            runs = torch.stack([torch.arange(t, device=q.device),
                                torch.ones(t, dtype=torch.long, device=q.device)], 1)
            captured["call"] = dict(q=q.clone(), pools=(k_pool.clone(), v_pool.clone()),
                                    latent=False, table=table.clone(), pos=pos.clone(),
                                    runs=runs.to(torch.int32),
                                    kw={k: v for k, v in kw.items() if k != "runs"},
                                    step=(main.step_no, j))
            captured["run"] = run_mask[0].clone()
        out = real(q, k_pool, v_pool, table, pos, **kw)
        for key, value in (("bodies", real.body), ("kernels", real.kernels)):
            calls[key][value] = calls[key].get(value, 0) + 1
        if j == 0:
            check(out, q, k_pool, v_pool, table, pos, kw)
        return out

    def moe_capture(p, x, c, **kw):
        # the MoE blocks' inputs of the captured sub-step (layer i's call
        # follows its attention's)
        if captured.get("call", {}).get("step") == (main.step_no, (sub["calls"] - 1)
                                                     // cfg.n_layers):
            moe_inputs.append((x.clone(), p["router"]))
        return real_moe(p, x, c, **kw)

    zero_launches()
    pa_ops.kernel = types.SimpleNamespace(paged_attention=capture)
    moe.apply_moe = moe_capture
    try:
        t0 = time.perf_counter()
        done = _Arrivals(main, stream, MOE_MAX_NEW).run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        pa_ops.kernel = pa_kernel
        moe.apply_moe = real_moe
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    m = main.metrics
    if sorted(done) != list(range(MOE_REQUESTS)) or any(
            r.status != sched.FINISHED or len(r.out) != MOE_MAX_NEW for r in done.values()):
        raise AssertionError(f"not every request FINISHED with its {MOE_MAX_NEW} tokens")
    if forwards[0] != m.steps * SERVE["prefill_chunk"] or \
            launches["paged_attn"] != cfg.n_layers * forwards[0]:
        raise AssertionError(f"B5 launched {launches['paged_attn']} times over {forwards[0]} "
                             f"sub-steps of {m.steps} fused steps")
    if any(v for k, v in launches.items() if k != "paged_attn"):
        raise AssertionError(f"the serve path launched other kernels: {launches}")
    if set(calls["bodies"]) != {"split"}:
        raise AssertionError(f"B5's calls ran the bodies {calls['bodies']}, not the split body")
    on_path = check.result(cfg.n_layers * m.steps, "every call of each fused step's first "
                                                    "sub-step")
    if "call" not in captured or len(moe_inputs) != cfg.n_layers:
        raise AssertionError(f"no capture past position {MOE_CAPTURE_POS}: "
                             f"{len(moe_inputs)} MoE inputs")
    dropped = _moe_dropped(cfg, [x for x, _ in moe_inputs], [r for _, r in moe_inputs],
                           captured["run"])
    outs = {rid: r.out for rid, r in done.items()}
    if not all(0 <= t < cfg.vocab_size for out in outs.values() for t in out):
        raise AssertionError("a token outside the true vocab")
    del main, moe_inputs

    # the kernel and the gather path on the shortest requests, each serving
    # them alone on as many slots (so that no row idles while they run),
    # and the gather path again with its attention outputs perturbed:
    # compared row by row
    compared = sorted(prompts, key=lambda r: (len(prompts[r]), r))[:MOE_COMPARED]
    few = [(rid, prompts[rid], 1, 0) for rid in compared]
    runs, taps = {}, {}
    for name, impl in (("kernel", "kernel"), ("gather", "gather"), ("noisy", "gather")):
        srv = server(attn_impl=impl, batch_slots=MOE_COMPARED)
        taps[name] = _RowTap(srv)
        t0 = time.perf_counter()
        with taps[name], (_AttentionNoise(srv.device) if name == "noisy"
                          else contextlib.nullcontext()):
            got = _Arrivals(srv, few, MOE_MAX_NEW).run()
        torch.cuda.synchronize()
        runs[name] = {"outs": {r: got[r].out for r in compared},
                      "wall_s": time.perf_counter() - t0, "steps": srv.metrics.steps}
        del srv
    # the noise floor: the spread the perturbation causes before each row's
    # own first discontinuity (a route flip moves a row's logits by units)
    noise = _row_divergences(taps["noisy"], taps["gather"], DEVIATION_LIMIT)
    floor = max(r["deviation_before"] for r in noise.values())
    limit = max(DEVIATION_LIMIT, HYBRID_SOUND_FACTOR * floor)
    vs_gather = _row_divergences(taps["kernel"], taps["gather"], limit)
    bad = {r: d for r, d in vs_gather.items()
           if d["first"] is not None and not (d["first"]["near_tie"] or d["first"]["route_flip"])}
    if bad:
        raise AssertionError(f"kernel vs gather: divergences that are neither near-ties nor "
                             f"route flips: {bad}")
    del taps
    gc.collect()

    synced = _Arrivals(server(), stream, MOE_MAX_NEW)
    syncs, profile = _moe_profile(synced.server, synced)
    del synced
    emit({"phase": "serve-moe", "seconds": time.perf_counter() - phase_t0, "arch": MOE_ARCH,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "experts": cfg.n_experts,
          "top_k": cfg.experts_per_token, "moe_d_ff": cfg.moe_d_ff,
          "capacity_factor": cfg.capacity_factor,
          "weights": "bf16 from seed 0, drawn on the card", "weight_bytes": weight_bytes,
          "init_s": init_s, "server": SERVE,
          "step_mode": "chunked (token stepping asked for; serve_step fallback recorded)",
          "prefix_cache": False, "max_seq": SERVE_MAX_SEQ, "requests": MOE_REQUESTS,
          "max_new_tokens": MOE_MAX_NEW, "prompt_lengths": [len(p) for p in prompts.values()],
          "arrivals": [a for _, _, _, a in stream], "finished": len(done), "wall_s": wall_s,
          "steps": m.steps, "sub_steps": forwards[0], "launches": launches,
          "b5": {"per_sub_step": cfg.n_layers, "bodies": calls["bodies"],
                 "kernels_per_call": calls["kernels"]},
          "tokens_per_s": m.tokens_generated / wall_s, "metrics_tok_per_s": m.tok_per_s,
          "mean_ttft_s": m.mean_ttft_s, "mean_ttft_steps": m.mean_ttft_steps,
          "occupancy_pct": m.occupancy_pct, "mean_step_s": m.wall_s / m.steps,
          "batched_tokens": m.batched_tokens, "kv_blocks_peak": m.kv_blocks_peak,
          "peak_memory_bytes": peak,
          "b5_against_plain_on_path": on_path,
          "capacity_drops": dict(dropped, sub_step=captured["call"]["step"]),
          "kernel_vs_gather": {"rids": compared, "deviation_limit": limit,
                               "noise": HYBRID_NOISE, "noise_floor": floor,
                               "runs": runs, "divergence": vs_gather,
                               "noisy_vs_gather": noise},
          "syncs": syncs, "profile": profile})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return captured["call"], launches


def _moe_profile(server, arrivals):
    """One host read a fused step under the sync debug mode over
    HYBRID_SYNC_STEPS steps, then one step untraced and one under the
    profiler (device and CUDA runtime), with B5's share of the busy time
    and the MoE block's from its device time at the decode shape
    (``_moe_decode_ms``) times its calls a step."""
    import torch

    where, _ = _synchronizing_calls(lambda: arrivals.run(max_steps=HYBRID_SYNC_STEPS), [])
    reads = sum(where.values())
    if reads != HYBRID_SYNC_STEPS or len(where) != 1 or \
            not next(iter(where)).startswith("src/repro_torch/serve/serving.py:"):
        raise AssertionError(f"expected one host read per fused step over "
                             f"{HYBRID_SYNC_STEPS} steps: {where}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrivals.run(max_steps=1)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    traced_s, busy_s, top = _device_profile(lambda: arrivals.run(max_steps=1),
                                            kernels=("paged_attn",), cpu=False)
    moe_ms = _moe_decode_ms(server)
    calls = server.cfg.n_layers * server.prefill_chunk
    return ({"steps": HYBRID_SYNC_STEPS, "synchronizing_calls": reads, "where": where},
            {"steps": 1, "traced_s": traced_s, "untraced_s": untraced_s,
             "device_busy_s": busy_s if busy_s else None,
             "device_idle_share": 1.0 - busy_s / untraced_s if busy_s else None,
             "launches_per_step": top["launch_calls"],
             "launches_per_sub_step": top["launch_calls"] / server.prefill_chunk,
             "paged_attn_share_of_busy": (top["device_ms_of"]["paged_attn"] / 1e3 / busy_s
                                          if busy_s else None),
             "moe_ms_per_call": moe_ms, "moe_calls": calls,
             "moe_share_of_busy": moe_ms * calls / 1e3 / busy_s if busy_s else None,
             **top, "units": "ms totals over the step"})


def phase_train_moe():
    """olmoe-1b-7b at full width, its depth cut to MOE_TRAIN_LAYERS, trained
    for MOE_TRAIN_STEPS steps of MOE_TRAIN_BATCH x TRAIN_SEQ tokens by
    ``_train_phase`` (B1 the one kernel: routing and the expert products are
    plain PyTorch, as in the reference), with the MoE block's share of the
    profiled step; then the loss and every gradient of one step computed
    twice from the same state: the same bits."""
    import gc

    import torch
    from torch.profiler import record_function

    from repro_torch.models import moe

    full = _published(MOE_ARCH, MOE_FIELDS, MOE_WIDTH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    real = moe.apply_moe

    def ranged(*args, **kw):
        with record_function(MOE_RANGE):
            return real(*args, **kw)

    moe.apply_moe = ranged  # one host call a layer; launches nothing
    try:
        record, run = _train_phase(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS,
                                   {"strider_decode": 1}, "olmoe_tokens.heap",
                                   kernels=("strider_decode",), ranges=(MOE_RANGE,))
    finally:
        moe.apply_moe = real
    prof = record["profile"]
    prof["moe_ms"] = prof["device_ms_in"][MOE_RANGE]
    prof["moe_share_of_busy"] = (prof["moe_ms"] / 1e3 / prof["device_busy_s"]
                                 if prof["device_busy_s"] else None)

    twice = _same_bits_twice(run, MOE_TRAIN_STEPS + 2)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train-moe", "arch": MOE_ARCH, "experts": cfg.n_experts,
          "top_k": cfg.experts_per_token, "capacity_factor": cfg.capacity_factor,
          "reduced": _depth_cut(full, cfg), **record, "same_bits_twice": twice})
    _check_train(record)
    _check_twice(twice)


def _depth_cut(full, cfg):
    """A training phase's depth cut, with its arithmetic."""
    return {"n_layers": [full.n_layers, cfg.n_layers],
            "why": "16 bytes a parameter (f32 master, gradient, two moments): "
                   f"{16 * full.n_params() / 1e9:.1f} GB at {full.n_layers} layers, "
                   f"{16 * cfg.n_params() / 1e9:.1f} GB at {cfg.n_layers}"}


def _same_bits_twice(run, step):
    """One step's loss and every gradient computed twice from the trained
    state on the batch of ``step``: each gradient's bits summed as integers
    in pieces (exact, so any changed bit shows), the loss's bits as they
    are."""
    import torch

    from repro_torch.models.params import leaves

    batch = run.batch(step)
    flat = list(leaves(run.params))
    prints = []
    t0 = time.perf_counter()
    for _ in range(2):
        loss = run.loss_fn(run.params, batch)
        grads = torch.autograd.grad(loss, flat)
        prints.append(torch.stack([loss.detach().view(torch.int32).long()]
                                  + [_bit_sum(g) for g in grads]))
        del loss, grads
    return {"same": bool(torch.equal(prints[0], prints[1])), "leaves": len(flat),
            "seconds": time.perf_counter() - t0,
            "what": "one step's loss and every gradient from the same state, twice"}


def _check_twice(twice):
    if not twice["same"]:
        raise AssertionError("one training step's loss or gradients differ between two runs "
                             "from the same state")


def _bit_sum(t, piece=1 << 26):
    """The sum of a float32 tensor's bits read as int32, in int64, piece by
    piece (exact: no order of summation changes it)."""
    import torch

    flat = t.reshape(-1).view(torch.int32)
    return sum(flat[i:i + piece].sum(dtype=torch.int64) for i in range(0, flat.numel(), piece))


# the enc-dec phases: seamless-m4t-medium at full width and depth,
# (decoder layers, encoder layers, d_model, heads, kv heads, d_ff, vocab) of
# configs/seamless_m4t_medium.py; 0.665 B parameters, 10.6 GB at 16 bytes a
# parameter, so nothing is cut. train-encdec: 8 x 512 tokens (and 512 source
# frames), 4 steps. decode-encdec: 4 sources of 512 frames and 32 target
# tokens through prefill and through decode, then 64 greedy tokens twice
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_FIELDS = ("n_layers", "enc_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size")
ENCDEC_WIDTH = (12, 12, 1024, 16, 16, 4096, 256206)
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_STEPS = 8, 4
ENCDEC_SOURCES, ENCDEC_SRC, ENCDEC_TARGET, ENCDEC_GREEDY = 4, 512, 32, 64
# the VLM phases: internvl2-26b, (layers, d_model, heads, kv heads, d_ff,
# vocab, patches) of configs/internvl2_26b.py; its decode is B5 at KVH 8,
# G 6, D 128. train-vlm: 4 x 2,048 positions (1,024 patches, 1,024 text), 4
# steps, the depth cut to VLM_TRAIN_LAYERS: the untied embedding and
# unembedding take 18.2 GB at 16 bytes a parameter and each layer 6.2 GB,
# so 7 layers hold 61.9 GB, and the backward of one layer's f32 attention
# scores over 2,048 positions (4 x 48 x 2,048 x 2,048, 3.2 GB a tensor,
# about four alive) needs about 13 GB beside them: 6 layers, 55.7 GB.
# serve-vlm: 16 of 48 layers (14.8 GB of bf16 weights) beside serve-mla,
# lm-predict and serve-rwkv, every B5 call of every fused step against its
# plain version, the kernel and the gather path compared on the
# VLM_COMPARED shortest requests
VLM_ARCH = "internvl2-26b"
VLM_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
              "vis_tokens")
VLM_WIDTH = (48, 6144, 48, 8, 16384, 92553, 1024)
VLM_TRAIN_LAYERS, VLM_TRAIN_BATCH, VLM_TRAIN_POSITIONS, VLM_TRAIN_STEPS = 6, 4, 2048, 4
VLM_SERVE_LAYERS, VLM_COMPARED = 16, 4


def phase_train_encdec():
    """seamless-m4t-medium at full width and depth trained for
    ENCDEC_TRAIN_STEPS steps of ENCDEC_TRAIN_BATCH x TRAIN_SEQ target
    tokens by ``_train_phase`` (B1 the one kernel: the encoder, the decoder
    and the cross attention are plain PyTorch, as in the reference). The
    target tokens come from the token heap through B1; the source frames
    (f32 (batch, TRAIN_SEQ, d_model)) are drawn per step by
    ``synthetic_data_fn``, and this phase adds them to each page batch: the
    smoke composing two of the port's sources, as the package's page path
    gives no frames (nor does the reference's). Then one step's loss and
    every gradient twice from one state: the same bits."""
    import gc

    import torch

    from repro_torch.data.pipeline import synthetic_data_fn

    cfg = _published(ENCDEC_ARCH, ENCDEC_FIELDS, ENCDEC_WIDTH)
    draw = synthetic_data_fn(cfg, ENCDEC_TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    record, run = _train_phase(cfg, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_STEPS,
                               {"strider_decode": 1}, "encdec_tokens.heap",
                               kernels=("strider_decode",),
                               extra=lambda step: {"frames": draw(step)["frames"]})
    twice = _same_bits_twice(run, ENCDEC_TRAIN_STEPS + 2)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train-encdec", "arch": ENCDEC_ARCH, "enc_layers": cfg.enc_layers,
          "source_frames": TRAIN_SEQ,
          "frames": "synthetic_data_fn's draws (default_rng(step + 7)), added to each page "
                    "batch by the smoke", **record, "same_bits_twice": twice})
    _check_train(record)
    _check_twice(twice)


def phase_decode_encdec():
    """seamless-m4t-medium at full width and depth, bf16 weights from seed 0:
    ENCDEC_SOURCES sources of ENCDEC_SRC frames and ENCDEC_TARGET target
    tokens, ``prefill_fn``'s last logits against as many steps of
    ``decode_fn`` on a ``make_cache`` cache holding ``precompute_cross_kv``'s
    K and V (the reference's tolerance: rtol=atol=3e-2, every argmax equal);
    then a greedy generation of ENCDEC_GREEDY tokens from each source, twice:
    the same tokens."""
    import gc

    import numpy as np
    import torch

    from repro_torch.models import encdec, model_zoo

    cfg = _published(ENCDEC_ARCH, ENCDEC_FIELDS, ENCDEC_WIDTH)
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda")
    dev = params["frame_proj"].device
    rng = np.random.default_rng(5)
    b = ENCDEC_SOURCES
    frames = torch.from_numpy(rng.normal(0, 1, (b, ENCDEC_SRC, cfg.d_model))
                              .astype(np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, ENCDEC_TARGET))
                              .astype(np.int32)).to(dev)
    step = model_zoo.decode_fn(cfg)

    def source_cache():
        cache = model_zoo.make_cache(cfg, b, ENCDEC_SRC, dev)
        enc_out = encdec.encode(params, frames, cfg, remat="none")
        cache["xk"][:], cache["xv"][:] = encdec.precompute_cross_kv(params, enc_out, cfg)
        return cache

    def greedy():
        cache, tok = source_cache(), tokens[:, 0]
        out = torch.empty((b, ENCDEC_GREEDY), dtype=torch.int32, device=dev)
        for t in range(ENCDEC_GREEDY):
            logits, cache = step(params, tok, cache, t)
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            out[:, t] = tok
        return out

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = model_zoo.prefill_fn(cfg)(params, {"tokens": tokens, "frames": frames}).float()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = source_cache()
        for t in range(ENCDEC_TARGET):
            logits, cache = step(params, tokens[:, t], cache, t)
        dec = logits.float()
        del cache
        runs, seconds = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(greedy())
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    excess = float(((pre - dec).abs() - 3e-2 - 3e-2 * pre.abs()).max())
    dev = float((pre - dec).abs().max())
    agree = int((pre.argmax(-1) == dec.argmax(-1)).sum())
    same = bool(torch.equal(runs[0], runs[1]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "decode-encdec", "arch": ENCDEC_ARCH, "layers": cfg.n_layers,
          "enc_layers": cfg.enc_layers, "weights": "bf16 from seed 0, drawn on the card",
          "sources": b, "source_frames": ENCDEC_SRC, "target_tokens": ENCDEC_TARGET,
          "prefill_s": prefill_s,
          "prefill_vs_decode": {"max_abs_dev": dev, "rtol": 3e-2, "atol": 3e-2,
                                "excess": excess, "argmax_agree": agree},
          "greedy": {"tokens": ENCDEC_GREEDY, "same_twice": same, "seconds": seconds,
                     "tokens_per_s": [b * ENCDEC_GREEDY / x for x in seconds],
                     "first_tokens": runs[0][:, :8].tolist()}})
    if excess > 0 or agree != b:
        raise AssertionError(f"enc-dec prefill vs decode: deviation {dev}, argmax agree "
                             f"{agree} of {b}")
    if not same:
        raise AssertionError("two greedy enc-dec generations from the same sources differ")


def phase_train_vlm():
    """internvl2-26b at full width, its depth cut to VLM_TRAIN_LAYERS,
    trained for VLM_TRAIN_STEPS steps of VLM_TRAIN_BATCH x
    VLM_TRAIN_POSITIONS positions (its 1,024 patches, then the text) by
    ``_train_phase`` (B1 the one kernel): the text tokens from the token
    heap through B1, the patches drawn per step by ``synthetic_data_fn``
    and added to each page batch by this phase (the page path gives no
    patches, as the reference's gives none); then one step's loss and every
    gradient twice from one state: the same bits."""
    import gc

    import torch

    from repro_torch.data.pipeline import synthetic_data_fn

    full = _published(VLM_ARCH, VLM_FIELDS, VLM_WIDTH)
    cfg = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS)
    draw = synthetic_data_fn(cfg, VLM_TRAIN_BATCH, VLM_TRAIN_POSITIONS, device="cuda")
    record, run = _train_phase(cfg, VLM_TRAIN_BATCH, VLM_TRAIN_STEPS, {"strider_decode": 1},
                               "vlm_tokens.heap", kernels=("strider_decode",),
                               seq=VLM_TRAIN_POSITIONS - cfg.vis_tokens,
                               extra=lambda step: {"patches": draw(step)["patches"]})
    twice = _same_bits_twice(run, VLM_TRAIN_STEPS + 2)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    positions = VLM_TRAIN_BATCH * VLM_TRAIN_POSITIONS
    emit({"phase": "train-vlm", "arch": VLM_ARCH, "patches": cfg.vis_tokens,
          "positions_per_step": positions, "positions_per_s": positions / record["s_per_step"],
          "reduced": dict(_depth_cut(full, cfg),
                          attention="the backward of one layer's f32 scores over "
                                    f"{VLM_TRAIN_POSITIONS} positions needs about 13 GB "
                                    "beside the state"),
          **record, "same_bits_twice": twice})
    _check_train(record)
    _check_twice(twice)


def phase_serve_vlm():
    """internvl2-26b at full width on VLM_SERVE_LAYERS of its layers, bf16
    weights from seed 0, serving the serve phase's stream through
    BatchedServer(SERVE) as ``_serve_phase`` does: B5 at KVH 8, G 6, D 128
    once a layer a fused step on the split body, every call of every fused
    step against its plain version (the times from a second run without
    the check), the kernel and
    the gather path on the VLM_COMPARED shortest requests token for token
    except at near-ties. Its prompts are text: the server has no patch
    inputs, as the reference's has none. Returns (the captured calls, the
    launches)."""
    import gc

    import torch

    full = _published(VLM_ARCH, VLM_FIELDS, VLM_WIDTH)
    gc.collect()
    torch.cuda.empty_cache()
    return _serve_phase(full, VLM_SERVE_LAYERS, "serve-vlm", compare_chunked=False,
                        check_plain=True, compared=VLM_COMPARED)


# the lm-predict phase: mistral-nemo-12b (SERVE_ARCH) registered as an LM UDF
# and called from SQL over a token table of 40,960 prompts of 32-256 tokens in
# 32 KB pages (1,322 pages, 3 chunks of at most 512); the first token is 7 in
# 32 rows and nowhere else
LM_TABLE = {"prompts": 40_960, "lengths": (32, 256), "marked": 32, "page_bytes": 32 * 1024}
LM_SQL = "SELECT * FROM dana.predict('nemo', 'prompts') WHERE c0 = 7 AND label >= 64;"
LM_INSERT = "INSERT INTO nemo_out " + LM_SQL
LM_SERVE = {"max_new_tokens": 32, "batch_slots": 16}
LM_REJECTED = ("SELECT SUM(label) FROM dana.predict('nemo', 'prompts');",
               "SELECT c0 FROM dana.predict('nemo', 'prompts');")


def _lm_prompts(vocab: int):
    """The lm-predict phase's prompts, from seed 1: token ids drawn from
    8 and up, the first set to 7 in LM_TABLE["marked"] rows."""
    import numpy as np

    rng = np.random.default_rng(1)
    n, (lo, hi) = LM_TABLE["prompts"], LM_TABLE["lengths"]
    lengths = rng.integers(lo, hi + 1, n)
    tokens = rng.integers(8, vocab, (n, hi))
    tokens[rng.choice(n, LM_TABLE["marked"], replace=False), 0] = 7
    return [tokens[i, :lengths[i]].tolist() for i in range(n)]


def _token_rows(feats, labels, mask):
    """A decoded token table's live rows as token lists (int32 views)."""
    import torch

    tokens = feats.view(torch.int32).reshape(-1, feats.shape[-1]).cpu()
    lengths = labels.reshape(-1).cpu().int()
    live = (mask.reshape(-1) > 0).cpu()
    return [tokens[i, :lengths[i]].tolist() for i in range(tokens.shape[0]) if live[i]]


def phase_lm_predict():
    """LM PREDICT through Session.sql at mistral-nemo-12b's full width on
    SERVE_LAYERS layers: returns B3's launches on this path, its sub-row for the kernels
    line (the token table's chunks) and what ``lm_scan_times`` times."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import striders
    from repro_torch.db import Database, scoring
    from repro_torch.db.heap import HeapFile, write_token_table
    from repro_torch.db.query import register_lm_udf
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.strider import ops as strider_ops
    from repro_torch.kernels.strider import ref as strider_ref
    from repro_torch.models import model_zoo
    from repro_torch.models.params import leaves
    from repro_torch.serve.serving import generate_greedy, score_tokens

    root = os.path.join(SCRATCH, "lm_catalog")
    os.makedirs(root, exist_ok=True)
    emit({"phase": "lm-predict", "step": "start", "dir": os.path.relpath(root, ROOT),
          "disk_free_bytes": shutil.disk_usage(root).free})
    full = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda")
    prompts = _lm_prompts(cfg.vocab_size)
    page_bytes = LM_TABLE["page_bytes"]
    heap = write_token_table(os.path.join(root, "prompts.heap"), prompts, page_bytes=page_bytes)
    n_chunks = -(-heap.n_pages // scoring.CHUNK_PAGES)
    # the pool holds the whole table, warm: the scan measures decode and filter
    db = Database(root, page_bytes=page_bytes, pool_bytes=heap.n_pages * page_bytes,
                  device="cuda")
    db.pool.warm(heap)
    db.catalog.register_table("prompts", heap.path, {"kind": "tokens"})

    # the weights file: written, loaded back onto the card, bit for bit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = register_lm_udf(db.catalog, "nemo", cfg, params)["params"]
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = db.catalog.load_weights(ref, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = list(zip(leaves(back), leaves(params)))
    weight_bytes = sum(b.numel() * b.element_size() for _, b in pairs)
    if len(pairs) != ref.n_leaves or not all(
            a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in pairs):
        raise AssertionError("the weights file does not give the weights back bit for bit")
    del params, back, pairs
    torch.cuda.empty_cache()
    emit({"phase": "lm-predict", "step": "weights", "file_bytes": ref.nbytes,
          "weight_bytes": weight_bytes, "leaves": ref.n_leaves, "write_s": write_s,
          "load_s": load_s, "round_trip": "bit-exact"})

    # the main path: the statement, then the same with INSERT INTO, the latter
    # under the sync debug mode; each scan's join counted, each load timed
    joins, loads = [], []
    real_join, real_load = scoring._device_join, db.catalog.load_weights

    def counted_join(outs, aggregate):
        joins.append(len(outs))
        return real_join(outs, aggregate)

    def timed_load(*args):
        t0 = time.perf_counter()
        out = real_load(*args)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return out

    sess = db.connect()
    scoring._device_join, db.catalog.load_weights = counted_join, timed_load
    inserted = []
    try:
        zero_launches()
        res = sess.sql(LM_SQL, **LM_SERVE)
        first = read_launches()
        where, in_scan = _synchronizing_calls(
            lambda: inserted.append(sess.sql(LM_INSERT, **LM_SERVE)), _scan_loop_lines())
        launches = read_launches()
    finally:
        scoring._device_join, db.catalog.load_weights = real_join, real_load
    ins = inserted[0]
    want = {k: 0 for k in launches}
    if first != dict(want, strider_decode_projected=n_chunks) or \
            launches != dict(want, strider_decode_projected=2 * n_chunks):
        raise AssertionError(f"lm-predict launches {first} then {launches}: expected B3 "
                             f"once a chunk ({n_chunks}) and nothing else")
    if joins != [n_chunks, n_chunks] or in_scan:
        raise AssertionError(f"joins {joins} (one a scan after {n_chunks} chunks), "
                             f"{in_scan} synchronising calls in the scan's code: {where}")
    kept = [p for p in prompts if p[0] == 7 and len(p) >= 64]
    for r in (res, ins):
        if (r.n_rows, r.rows_scanned, r.rows_filtered, r.device_syncs) != \
                (len(kept), len(prompts), len(prompts) - len(kept), 1) or not kept:
            raise AssertionError(f"kept {r.n_rows} of {r.rows_scanned} rows, filtered "
                                 f"{r.rows_filtered}; expected {len(kept)} of {len(prompts)}")
        if any(len(g) != LM_SERVE["max_new_tokens"] or not all(0 <= t < cfg.vocab_size
                                                               for t in g)
               for g in r.predictions):
            raise AssertionError("a prediction of the wrong length or outside the vocab")
    rejected = []
    for sql in LM_REJECTED:
        try:
            sess.sql(sql)
        except ValueError as e:
            rejected.append(str(e))
        else:
            raise AssertionError(f"not rejected: {sql}")

    # nemo_out read back through B1 and through B3's full plan
    out = HeapFile(db.catalog.table("nemo_out")["heap"])
    pages = strider_ops.pages_tensor(out.read_all()).cuda()
    for decoded in (strider_kernel.strider_decode(pages, out.layout),
                    strider_kernel.strider_decode_projected(pages, out.layout,
                                                            striders.full_plan(out.layout))):
        if _token_rows(*decoded) != ins.predictions:
            raise AssertionError("nemo_out's pages do not give the INSERT's predictions back")

    # B3 on the token table's chunks, against its plain version
    plan = striders.full_plan(heap.layout)
    src = torch.tensor(strider_kernel.plan_sources(plan), dtype=torch.int32).cuda()
    p = scoring.CHUNK_PAGES
    chunks = [strider_ops.pages_tensor(heap.read_pages(np.arange(s, min(s + p, heap.n_pages))))
              .cuda() for s in range(0, heap.n_pages, p)]
    err = 0.0
    for ch in chunks:
        got = strider_kernel.strider_decode_projected(ch, heap.layout, plan, src)
        plain = strider_ref.decode_pages_projected_ref(ch, heap.layout, plan)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, plain)):
            raise AssertionError("strider_decode_projected differs on the token table")
        err = max([err] + [float((a - b).abs().max()) for a, b in zip(got, plain)])
    t, c = heap.layout.tuples_per_page, plan.n_columns
    live = int(strider_kernel.strider_decode_projected(chunks[0], heap.layout, plan, src)[2].sum())
    b3_bytes = live * plan.bytes_per_tuple + 4 * p + 4 * p * t * (c + 2)
    b3 = {"shape": (f"pages ({p}, {heap.layout.page_words}) int32 -> tokens ({p}, {t}, {c}), "
                    f"full plan, label True"),
          "chunks": len(chunks), "max_abs_err": err, "bit_exact": True,
          "bound_ms": 1e3 * b3_bytes / HBM_BYTES_PER_S, "bound_by": "bytes",
          "bound_bytes": b3_bytes, "library_ms": None}
    # the first two chunks (512 full pages each), timed by lm_scan_times
    timing = {"chunks": chunks[:2], "layout": heap.layout, "plan": plan, "src": src}
    del chunks, pages

    # beside the statement: a direct score_tokens with the same slots, and the
    # reference, generate_greedy (one slot a prompt), on the same weights
    params = db.catalog.load_weights(ref, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct, dm = score_tokens(cfg, params, kept, device="cuda", **LM_SERVE)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    greedy = generate_greedy(cfg, params, kept, LM_SERVE["max_new_tokens"], device="cuda")
    stream = [(i, q, 0, 0) for i, q in enumerate(kept)]
    ties, probe = _near_ties(cfg, params, stream, dict(enumerate(res.predictions)),
                             dict(enumerate(greedy)), ("gather", LM_SERVE["batch_slots"]),
                             ("gather", len(kept)), "lm-predict vs generate_greedy")
    peak = torch.cuda.max_memory_allocated()
    del params
    sess.close()
    db.close()
    shutil.rmtree(root)
    torch.cuda.empty_cache()

    def stmt(r, load_s):
        scan_s = r.exposed_io_s + r.compute_s
        gen = sum(len(g) for g in r.predictions)
        return {"seconds": r.total_s, "generated_tokens": gen,
                "tokens_per_s": gen / r.total_s, "scan_s": scan_s,
                "rows_scanned": r.rows_scanned, "rows_per_s": r.rows_scanned / scan_s,
                "rows_kept": r.n_rows, "rows_filtered": r.rows_filtered,
                "exposed_io_s": r.exposed_io_s, "overlapped_io_s": r.overlapped_io_s,
                "compute_s": r.compute_s, "weights_load_s": load_s,
                "serve_steps": r.serve_metrics.steps,
                "serve_tok_per_s": r.serve_metrics.tok_per_s}

    emit({"phase": "lm-predict", "arch": SERVE_ARCH, "layers": cfg.n_layers,
          "published_layers": full.n_layers, "d_model": cfg.d_model,
          "weights": "bf16 from seed 0, drawn on the card",
          "table": dict(LM_TABLE, pages=heap.n_pages, chunks=n_chunks,
                        tuples_per_page=heap.layout.tuples_per_page),
          "sql": LM_SQL, "server": dict(LM_SERVE, kv="dense", attn_impl="gather",
                                        step_mode="chunked", prefill_chunk=1),
          "launches": launches, "joins": joins,
          "statement": stmt(res, loads[0]), "insert": stmt(ins, loads[1]),
          "insert_equal_to_statement": ins.predictions == res.predictions,
          "direct_score_tokens": {"seconds": direct_s, "tokens_per_s":
                                  sum(len(g) for g in direct) / direct_s,
                                  "steps": dm.steps,
                                  "equal_to_statement": direct == res.predictions},
          "generate_greedy": {"near_ties": len(ties), "divergences": ties, "probe": probe,
                              "deviation_limit": DEVIATION_LIMIT},
          "syncs": {"synchronizing_calls": sum(where.values()), "in_scan": in_scan,
                    "where": where},
          "rejected": rejected, "nemo_out_read_back": "B1 and B3 equal to the INSERT",
          "peak_memory_bytes": peak})
    return launches["strider_decode_projected"], b3, timing


def lm_scan_times(timing):
    """B3's and its plain version's device times on lm-predict's first two
    token chunks, taken in turn: the ``ms`` and ``plain_ms`` of B3's
    ``lm_scan`` entry."""
    from repro_torch.kernels.strider import kernel as strider_kernel
    from repro_torch.kernels.strider import ref as strider_ref

    chunks, layout, plan, src = (timing[k] for k in ("chunks", "layout", "plan", "src"))
    return {"ms": device_ms([lambda ch=ch: strider_kernel.strider_decode_projected(
                ch, layout, plan, src) for ch in chunks] * 5),
            "plain_ms": device_ms([lambda ch=ch: strider_ref.decode_pages_projected_ref(
                ch, layout, plan) for ch in chunks] * 5)}


# the train phase: rwkv6-3b at full width and depth from f32 masters, on the
# paper's page data path, with full rematerialisation (each layer's input
# kept, its forward run again in the backward)
TRAIN_ARCH = "rwkv6-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_REMAT = 8, 512, 6, "full"
# (layers, d_model, d_ff, vocab, head size, chunk) of configs/rwkv6_3b.py
TRAIN_FIELDS = ("n_layers", "d_model", "d_ff", "vocab_size", "rwkv_head_size", "chunk_len")
TRAIN_WIDTH = (32, 2560, 8960, 65536, 64, 32)
WKV_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 outputs of the WKV kernels: theirs and the plain version's f32 results
# round to bf16 one step (2^-7 of the value) apart at most
WKV_BF16_TOL = dict(rtol=8e-3, atol=2e-4)
# the training shape with half the log-decays at -1e-4: the state and its
# gradient sum 512 tokens with almost no decay, terms of order 10^2 that
# cancel to order 1. There f32 cannot reach 2e-4: on an H100 the plain
# version in f32 is 6.3e-4 (y, state) and 1.09e-3 (gradients) from the same
# computation in f64, in units of rtol = atol, and the kernels 6.2e-4 and
# 1.10e-3. So the kernels are held against the f64 plain version at those
# readings of the f32 plain version, rounded up by a third
LONG_MEMORY_CASES = ("full_clip_mixed",)
WKV_LONG_MEMORY_TOL = {"wkv": dict(rtol=8e-4, atol=8e-4),
                       "wkv_bwd": dict(rtol=1.5e-3, atol=1.5e-3)}
# in the long-memory case B6 and B6-bwd may be no further from f64 than this
# many times the f32 plain version (B6 and its plain version both 1.98e-3 to
# 1.99e-3 on an H100)
WITNESS_SLACK = 1.1
# the substring of B6's two kernel names (wkv_fwd_state_kernel,
# wkv_fwd_output_kernel) in a profile, in none of B6-bwd's
WKV_FWD_KERNELS = "wkv_fwd_"
# B6-bwd's three kernels, and the prefix they share in a profile
WKV_BWD_KERNEL_NAMES = ("wkv_bwd_dstate_kernel", "wkv_bwd_grad_kernel",
                        "wkv_bwd_du_reduce_kernel")
WKV_BWD_KERNELS = "wkv_bwd_"
# ||got - want|| / ||want|| of each WKV output on the training path's own
# tensors: two bf16 roundings of nearly equal values are one step (at most
# 2^-8 of the value in the root mean square) apart; f32 outputs at WKV_TOL
WKV_REL_NORM_TOL = {"bf16": 4e-3, "f32": 2e-4}
# the kernel path against the plain WKV on the card: bf16 activations, so
# the two y's round apart in a few elements. The 2-layer model's loss (about
# 11) and gradient norm move by far less than the first two; gradient
# leaves read up to 1.1% on an H100 (leaf_grad_rel twice that). The 6-step
# full-depth runs: the first loss within loss_abs, then the trajectories
# drift apart after the loss spike, up to 3.3% at step 6 on an H100
TRAIN_PARITY_TOL = {"loss_abs": 1e-3, "grad_norm_rel": 1e-2, "leaf_grad_rel": 2e-2,
                    "trajectory_rel": 5e-2}


def _tol_ratio(got, want, tol):
    """max |got - want| / (atol + rtol |want|): at most 1 within ``tol``."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())).max())


def _rel_norm_err(got, want):
    """||got - want|| / ||want|| (||got - want|| where ``want`` is 0)."""
    import torch

    g, w = got.double(), want.double()
    diff, norm = float(torch.linalg.vector_norm(g - w)), float(torch.linalg.vector_norm(w))
    return diff / norm if norm > 0 else diff


def _wkv_case_on_card(case, dtype=None, seed=7):
    """A WKV case's inputs on the card (r, k, v in ``dtype`` when given) and
    f32 cotangents for y and the final state."""
    import numpy as np
    import torch

    from test_torch_wkv_cases import make

    *arrs, chunk = make(case)
    ins = [torch.from_numpy(a).cuda() for a in arrs]
    if dtype is not None:
        ins[:3] = [x.to(dtype) for x in ins[:3]]
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.normal(0, 1, (*arrs[0].shape[:3], arrs[2].shape[-1]))
                          .astype(np.float32)).cuda().to(ins[0].dtype)
    ds = torch.from_numpy(rng.normal(0, 1, arrs[5].shape).astype(np.float32)).cuda()
    return ins, chunk, dy, ds


def phase_parity_wkv():
    """B6 and B6-bwd against their plain versions on the same CUDA tensors:
    the CPU tests' cases, the training shape, and the training shape with
    log-decays at the clip bounds, at rtol=atol=2e-4 in f32 (the long-memory
    case against the plain version in f64); the training shape in bf16 at
    one bf16 step; B6's chunk states and B6-bwd's state gradients against
    their plain versions in every case; the same bits on a second call.
    Every f32 case also reads the kernels' and the f32 plain version's
    distance to f64. Then both on the shapes that take their general paths
    (odd chunks, widths off the 16-byte grid, inputs off 16-byte alignment).
    Returns B6's two kernels and B6-bwd's three as profiled at the training
    shape (bf16)."""
    import torch

    from test_torch_wkv_cases import CASES, FULL
    from repro_torch.kernels.wkv import kernel, ref

    cases = dict(CASES, full=FULL, full_clip_mixed=FULL[:-1] + ("mixed",),
                 full_clip_low=FULL[:-1] + ("low",))
    outs = ("y", "state", "states", "dr", "dk", "dv", "dlw", "du", "dstate", "dstates")
    n_fwd = 3  # outputs of B6; the rest are B6-bwd's
    groups = ("f32", "long_memory", "bf16")
    worst = {(kname, g): 0.0 for kname in ("wkv", "wkv_bwd") for g in groups}
    # (kernel, group) -> max |x - f64| and the tolerance ratio at WKV_TOL of
    # the kernel and of the f32 plain version
    witness = {(kname, g): {"kernel": 0.0, "plain_f32": 0.0, "kernel_tol_ratio": 0.0,
                            "plain_f32_tol_ratio": 0.0}
               for kname in ("wkv", "wkv_bwd") for g in ("f32", "long_memory")}
    failures, nondeterministic = [], []
    runs = [(name, case, torch.float32) for name, case in cases.items()]
    runs.append(("full_bf16", FULL, torch.bfloat16))

    def plain_of(ins, chunk, dy, ds):
        return (*ref.wkv_chunked_ref(*ins, chunk),
                ref.wkv_chunk_states_ref(*ins[1:4], ins[5], chunk)[0],
                *ref.wkv_bwd_ref(*ins, chunk, dy, ds),
                ref.wkv_chunk_dstates_ref(ins[0], ins[3], dy, ds, chunk)[0])

    for name, case, dtype in runs:
        ins, chunk, dy, ds = _wkv_case_on_card(case, dtype)
        group = "bf16" if dtype == torch.bfloat16 else \
            "long_memory" if name in LONG_MEMORY_CASES else "f32"
        y, s, states = kernel.wkv_forward(*ins, chunk, save_states=True)
        got = (y, s, states,
               *kernel.wkv_backward(*ins, states, s, dy, ds, chunk, save_dstates=True))
        plain = plain_of(ins, chunk, dy, ds)
        y2, s2, states2 = kernel.wkv_forward(*ins, chunk, save_states=True)
        again = kernel.wkv_backward(*ins, states2, s2, dy, ds, chunk, save_dstates=True)
        if not (torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(states, states2)):
            nondeterministic.append(f"wkv {name}")
        if not all(torch.equal(x, x2) for x, x2 in zip(got[n_fwd:], again)):
            nondeterministic.append(f"wkv_bwd {name}")
        b, _, h, kd = ins[0].shape
        if not torch.equal(states[:, 0], ins[5].reshape(b * h, kd, -1)):
            failures.append(f"{name} states[:, 0] is not s0 bit for bit")
        if name == "full_bf16":
            b6_kernels = _wkv_fwd_kernel_times(ins, chunk)
            # as the training path calls it: no state cotangent
            b6_bwd_kernels = _wkv_bwd_kernel_times(ins, chunk, states, s, dy, None)
        want = plain
        if group != "bf16":
            ins64 = [x.double() for x in ins]
            exact = plain_of(ins64, chunk, dy.double(), ds.double())
            for i, (g, p, e) in enumerate(zip(got, plain, exact)):
                w = witness["wkv" if i < n_fwd else "wkv_bwd", group]
                w["kernel"] = max(w["kernel"], float((g.double() - e).abs().max()))
                w["plain_f32"] = max(w["plain_f32"], float((p.double() - e).abs().max()))
                w["kernel_tol_ratio"] = max(w["kernel_tol_ratio"], _tol_ratio(g, e, WKV_TOL))
                w["plain_f32_tol_ratio"] = max(w["plain_f32_tol_ratio"],
                                               _tol_ratio(p, e, WKV_TOL))
            if group == "long_memory":
                want = exact
            del exact
        for i, (oname, g, w) in enumerate(zip(outs, got, want)):
            kname = "wkv" if i < n_fwd else "wkv_bwd"
            worst[kname, group] = max(worst[kname, group],
                                      float((g.double() - w.double()).abs().max()))
            tol = WKV_BF16_TOL if g.dtype == torch.bfloat16 else \
                WKV_LONG_MEMORY_TOL[kname] if group == "long_memory" else WKV_TOL
            if _tol_ratio(g, w, tol) > 1.0:
                failures.append(f"{name} {oname}: {_tol_ratio(g, w, tol)} of {tol}")
        del got, plain, want, again, states, states2
    # each kernel's distance to f64 where f32 itself is the limit: no
    # further than WITNESS_SLACK times the f32 plain version's
    for kname, label in (("wkv", "B6"), ("wkv_bwd", "B6-bwd")):
        lm = witness[kname, "long_memory"]
        if lm["kernel"] > WITNESS_SLACK * lm["plain_f32"]:
            failures.append(f"long memory: {label} {lm['kernel']} from f64, the f32 plain "
                            f"version {lm['plain_f32']}")
    general = _wkv_general_shapes(failures, nondeterministic)
    names = [name for name, _, _ in runs]
    for kname in ("wkv", "wkv_bwd"):
        line = {"phase": "parity", "kernel": kname, "cases": len(runs), "names": names,
                "outputs": list(outs[:n_fwd] if kname == "wkv" else outs[n_fwd:]),
                "rtol": 2e-4, "atol": 2e-4, "bf16_outputs": WKV_BF16_TOL,
                "max_abs_err": worst[kname, "f32"],
                "max_abs_err_bf16": worst[kname, "bf16"],
                "long_memory": {"cases": list(LONG_MEMORY_CASES),
                                "held_against": "the plain version in f64",
                                "tolerance": WKV_LONG_MEMORY_TOL[kname],
                                "max_abs_err": worst[kname, "long_memory"],
                                "f64_witness": witness[kname, "long_memory"]},
                "f64_witness_other_f32_cases": witness[kname, "f32"],
                "deterministic": not any(n.startswith(kname + " ") for n in nondeterministic)}
        line["long_memory"]["witness_slack"] = WITNESS_SLACK
        line["general_paths"] = general[kname]
        emit(line)
    if failures or nondeterministic:
        raise AssertionError(f"WKV parity: {failures}; not deterministic: {nondeterministic}")
    return b6_kernels, b6_bwd_kernels


def _wkv_fwd_kernel_times(ins, chunk, calls=8):
    """B6's two kernels in one profiled run of ``calls`` calls: kernels a
    call and each kernel's device ms a launch. The profiler may miss the
    first launch of a session, so the counts are read as a mean."""
    import torch

    from repro_torch.kernels.wkv import kernel

    def run():
        for _ in range(calls):
            kernel.wkv_forward(*ins, chunk, save_states=True)
        torch.cuda.synchronize()  # the device's events end inside the trace

    run()
    _, _, prof = _device_profile(run, kernels=("wkv_fwd_state_kernel", "wkv_fwd_output_kernel"))
    n = prof["launches_of"]
    out = {"kernels_per_call": round(sum(n.values()) / calls),
           "kernel_ms": {k: ms / n[k] if n[k] else None
                         for k, ms in prof["device_ms_of"].items()},
           "profiled_launches": n, "calls": calls}
    if out["kernels_per_call"] != 2 or min(n.values()) < calls - 1:
        raise AssertionError(f"B6 launched {n} in {calls} calls, not 2 kernels a call")
    return out


def _wkv_bwd_kernel_times(ins, chunk, states, s_out, dy, dstate, calls=8):
    """B6-bwd's three kernels in one profiled run of ``calls`` calls: kernels
    a call and each kernel's device ms a launch, read as
    ``_wkv_fwd_kernel_times`` reads B6's."""
    import torch

    from repro_torch.kernels.wkv import kernel

    def run():
        for _ in range(calls):
            kernel.wkv_backward(*ins, states, s_out, dy, dstate, chunk)
        torch.cuda.synchronize()

    run()
    _, _, prof = _device_profile(run, kernels=WKV_BWD_KERNEL_NAMES)
    n = prof["launches_of"]
    out = {"kernels_per_call": round(sum(n.values()) / calls),
           "kernel_ms": {k: ms / n[k] if n[k] else None
                         for k, ms in prof["device_ms_of"].items()},
           "profiled_launches": n, "calls": calls}
    if out["kernels_per_call"] != 3 or min(n.values()) < calls - 1:
        raise AssertionError(f"B6-bwd launched {n} in {calls} calls, not 3 kernels a call")
    return out


def _wkv_general_shapes(failures, nondeterministic):
    """B6 and B6-bwd on test_torch_wkv_cases.GENERAL (chunk and width off the
    training shape's grid), in f32 and bf16, and on the chunk8 case with
    every input one element off its 16-byte alignment: y, the final state,
    the chunk states, the six gradients and the state gradients against
    their plain versions, twice. Returns each kernel's worst errors."""
    import torch

    from test_torch_wkv_cases import GENERAL
    from repro_torch.kernels.wkv import kernel, ref

    def misaligned(x):  # the same values, contiguous, 4 or 2 bytes off
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    runs = [(f"{n}_{str(dt)[6:]}", c, dt, False) for n, c in GENERAL.items()
            for dt in (torch.float32, torch.bfloat16)]
    runs += [(f"chunk8_misaligned_{str(dt)[6:]}", "chunk8", dt, True)
             for dt in (torch.float32, torch.bfloat16)]
    worst = {"wkv": 0.0, "wkv_bwd": 0.0}
    for name, case, dtype, shift in runs:
        ins, chunk, dy, ds = _wkv_case_on_card(case, dtype)
        if shift:
            ins, dy, ds = [misaligned(x) for x in ins], misaligned(dy), misaligned(ds)
        fwd = kernel.wkv_forward(*ins, chunk, save_states=True)
        again = kernel.wkv_forward(*ins, chunk, save_states=True)
        _, s, states = fwd
        if shift:
            states = misaligned(states)
        bwd = kernel.wkv_backward(*ins, states, s, dy, ds, chunk, save_dstates=True)
        bwd_again = kernel.wkv_backward(*ins, states, s, dy, ds, chunk, save_dstates=True)
        want = (*ref.wkv_chunked_ref(*ins, chunk),
                ref.wkv_chunk_states_ref(*ins[1:4], ins[5], chunk)[0])
        bwd_want = (*ref.wkv_bwd_ref(*ins, chunk, dy, ds),
                    ref.wkv_chunk_dstates_ref(ins[0], ins[3], dy, ds, chunk)[0])
        if not all(torch.equal(a, b) for a, b in zip(fwd, again)):
            nondeterministic.append(f"wkv {name}")
        if not all(torch.equal(a, b) for a, b in zip(bwd, bwd_again)):
            nondeterministic.append(f"wkv_bwd {name}")
        for kname, onames, gots, wants in (
                ("wkv", ("y", "state", "states"), fwd, want),
                ("wkv_bwd", ("dr", "dk", "dv", "dlw", "du", "dstate", "dstates"), bwd,
                 bwd_want)):
            for oname, g, w in zip(onames, gots, wants):
                tol = WKV_BF16_TOL if g.dtype == torch.bfloat16 else WKV_TOL
                worst[kname] = max(worst[kname], float((g.double() - w.double()).abs().max()))
                if _tol_ratio(g, w, tol) > 1.0:
                    failures.append(f"{name} {kname} {oname}: {_tol_ratio(g, w, tol)} of {tol}")
    cases = [name for name, *_ in runs]
    return {kname: {"cases": cases, "max_abs_err": err} for kname, err in worst.items()}


def _sync_lines(module, needles):
    """{needle: 'path:line'} of the lines of ``module`` holding each needle."""
    lines, _ = inspect.getsourcelines(module)  # a module's lines start at 1
    path = os.path.relpath(os.path.realpath(inspect.getsourcefile(module)), ROOT)
    return {n: f"{path}:{i + 1}" for i, ln in enumerate(lines) for n in needles if n in ln}


def _published(arch, fields, width):
    """``arch``'s config, checked at its published width and depth: the
    values of ``fields`` equal ``width``."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if tuple(getattr(cfg, f) for f in fields) != width:
        raise AssertionError(f"{arch} is not at its published width and depth")
    return cfg


def _train_phase(cfg, batch, steps, per_step, heap, kernels=(), around=None, ranges=(),
                 seq=None, extra=None):
    """``cfg`` trained from f32 masters drawn on the card from seed 0 by
    train_loop.run for ``steps`` steps of ``batch`` x ``seq`` (TRAIN_SEQ by
    default) tokens from
    the page data path (B1 each step), full rematerialisation, AdamW (lr
    3e-4, warmup steps // 4 + 1, as launch/train.py), with the sync debug
    mode on; then one step untraced, one under the profiler (device ms of
    ``kernels`` and of the record_function ``ranges``) and the AdamW update
    alone. ``per_step`` gives the launches
    a step of each kernel; ``around`` wraps the training run (a context
    manager); ``extra(step)`` gives the inputs that a step's batch takes
    beside the page path's tokens (a VLM's patches, an enc-dec model's
    frames), drawn for every step before the run. Returns (the record, the
    run: params, optimizer state, loss function, dataset, ``batch(step)``,
    loop and optimizer configs). ``_check_train`` holds the record to its
    expectations."""
    import contextlib
    import gc

    import torch

    from repro_torch.data.pipeline import PageTokenDataset
    from repro_torch.models import model_zoo
    from repro_torch.models.params import count_params, leaves
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.optimizer import OptConfig, make_train_step

    seq = seq or TRAIN_SEQ
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda",
                                      dtype=getattr(torch, cfg.param_dtype))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    t0 = time.perf_counter()
    ds = PageTokenDataset(os.path.join(SCRATCH, heap), n_seqs=max(batch * 8, 64),
                          seq_len=seq, vocab=cfg.vocab_size, seed=0, device="cuda")
    # the extra inputs of the run's steps, the untraced and the profiled
    # step, and one more
    extras = {step: extra(step) for step in range(steps + 3)} if extra else {}
    torch.cuda.synchronize()
    data_setup_s = time.perf_counter() - t0

    def batch_at(step):
        return dict(ds.batch(step, batch), **extras.get(step, {}))

    loss_fn = model_zoo.loss_fn(cfg, remat=TRAIN_REMAT)
    losses, starts = [], []

    def recording_loss(p, b):
        loss = loss_fn(p, b)
        losses.append(loss.detach())  # read after the run: no host read here
        return loss

    def data_fn(step):
        starts.append(time.perf_counter())
        return batch_at(step)

    loop_cfg = train_loop.TrainLoopConfig(total_steps=steps, ckpt_every=10**9,
                                          ckpt_dir=os.path.join(SCRATCH, heap + ".ckpt"))
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=steps // 4 + 1)  # as launch/train.py
    out = {}
    zero_launches()
    with around if around is not None else contextlib.nullcontext():
        where, _ = _synchronizing_calls(
            lambda: out.update(zip(("params", "opt", "history"), train_loop.run(
                recording_loss, params, data_fn, loop_cfg, opt_cfg))), [])
        torch.cuda.synchronize()
        end = time.perf_counter()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    loss_values = [float(x) for x in losses]
    step_s = [b - a for a, b in zip(starts, starts[1:] + [end])]
    steady_s = statistics.median(step_s[1:])
    reads = _sync_lines(train_loop, ('float(metrics["loss"])', 'float(metrics["grad_norm"])',
                                     'float(metrics["lr"])'))
    want_reads = {reads['float(metrics["loss"])']: steps,
                  reads['float(metrics["grad_norm"])']: 1, reads['float(metrics["lr"])']: 1}

    # one more step untraced, then one under the profiler
    step_fn = make_train_step(loss_fn, opt_cfg)
    p, o = out["params"], out["opt"]
    b = batch_at(steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step_fn(p, o, b)[2]["loss"])
    untraced_s = time.perf_counter() - t0
    b = batch_at(steps + 1)
    traced_s, busy_s, top = _device_profile(
        lambda: float(step_fn(p, o, b)[2]["loss"]), kernels=kernels, ranges=ranges)

    # the AdamW update alone: in pieces of UPDATE_PIECE elements, as the step
    # runs it, and each leaf in one pass. The parameters stand in for the
    # gradients (the update reads each once; its time does not depend on
    # their values)
    update = [lambda: optimizer.adamw_update(p, p, o, opt_cfg)]
    largest = max(x.numel() for x in leaves(p))
    pieced_ms = eager_ms(update, reps=3)
    saved, optimizer.UPDATE_PIECE = optimizer.UPDATE_PIECE, largest
    try:
        one_pass_ms = eager_ms(update, reps=3)
    finally:
        optimizer.UPDATE_PIECE = saved

    tokens = batch * seq
    record = {
        "layers": cfg.n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "params": n_params,
        "weights": "f32 masters from seed 0, drawn on the card", "remat": TRAIN_REMAT,
        "batch": batch, "seq": seq, "tokens_per_step": tokens,
        "data_path": "pages (B1 on 32 KB token pages)",
        "extra_inputs": sorted(extras[0]) if extras else [],
        "optimizer": {"lr": opt_cfg.lr, "warmup_steps": opt_cfg.warmup_steps},
        "init_s": init_s, "data_setup_s": data_setup_s, "steps": steps,
        "losses": loss_values, "finite": all(math.isfinite(x) for x in loss_values),
        "loss_fell": loss_values[-1] < loss_values[0], "step_s": step_s,
        "s_per_step": steady_s, "tokens_per_s": tokens / steady_s,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_expected": {k: per_step.get(k, 0) * steps for k in launches},
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "syncs": {"steps": steps, "synchronizing_calls": sum(where.values()),
                  "where": where, "expected": want_reads},
        "adamw": {"pieced_ms": pieced_ms, "one_pass_ms": one_pass_ms,
                  "piece_elements": saved, "largest_leaf": largest,
                  "pieces_of_largest": -(-largest // saved),
                  "note": "eager, CUDA events, median of 3; parameters as gradients"},
        "profile": {"steps": 1, "traced_s": traced_s, "untraced_s": untraced_s,
                    "device_busy_s": busy_s if busy_s else None,
                    "device_idle_share": 1.0 - busy_s / untraced_s if busy_s else None,
                    **top, "units": "ms totals over the step"},
    }
    return record, types.SimpleNamespace(params=p, opt=o, loss_fn=loss_fn, ds=ds,
                                         batch=batch_at, loop_cfg=loop_cfg, opt_cfg=opt_cfg)


def _check_train(record):
    """Every loss finite, each kernel launched as expected, and the host
    read once a step (the loss) and once more each for the logged gradient
    norm and learning rate."""
    losses = record["losses"]
    if len(losses) != record["steps"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses {losses}")
    if record["launches"] != record["launches_expected"]:
        raise AssertionError(f"training launches {record['launches']}, "
                             f"expected {record['launches_expected']}")
    if record["syncs"]["where"] != record["syncs"]["expected"]:
        raise AssertionError(f"host reads {record['syncs']['where']}, "
                             f"expected {record['syncs']['expected']}")


def phase_train():
    """rwkv6-3b at full width and depth trained for TRAIN_STEPS steps by
    train_loop.run on the page data path; returns (the captured first calls
    of B6 and B6-bwd, the launches of the run)."""
    import contextlib
    import gc

    import torch

    from repro_torch.kernels.wkv import kernel as wkv_kernel
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.models import model_zoo
    from repro_torch.train import train_loop

    cfg = _published(TRAIN_ARCH, TRAIN_FIELDS, TRAIN_WIDTH)
    captured = {}

    def fwd(*args, **kw):
        if "fwd" not in captured:
            captured["fwd"] = ([a.clone() if torch.is_tensor(a) else a for a in args], kw)
        return wkv_kernel.wkv_forward(*args, **kw)

    def bwd(*args):
        if "bwd" not in captured:
            captured["bwd"] = [a.clone() if torch.is_tensor(a) else a for a in args]
        return wkv_kernel.wkv_backward(*args)

    @contextlib.contextmanager
    def capturing():
        # the wrappers count on themselves, so the capture sits between ops
        # and the kernel module
        wkv_ops.kernel = types.SimpleNamespace(wkv_forward=fwd, wkv_backward=bwd)
        try:
            yield
        finally:
            wkv_ops.kernel = wkv_kernel

    record, run = _train_phase(
        cfg, TRAIN_BATCH, TRAIN_STEPS,
        {"strider_decode": 1, "wkv": 2 * cfg.n_layers, "wkv_bwd": cfg.n_layers},
        "tokens.heap", kernels=(WKV_FWD_KERNELS, WKV_BWD_KERNELS, "strider_decode"),
        around=capturing())
    ds, loop_cfg, opt_cfg = run.ds, run.loop_cfg, run.opt_cfg
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # the same run with the plain WKV (wkv_impl="plain") from the same
    # weights and batches: whether the path the loss takes is the model's
    # and the optimizer's, or the kernels'
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda",
                                      dtype=getattr(torch, cfg.param_dtype))
    plain_fn = model_zoo.loss_fn(cfg, remat=TRAIN_REMAT, wkv_impl="plain")
    plain = []

    def plain_loss(p, b):
        loss = plain_fn(p, b)
        plain.append(loss.detach())
        return loss

    t0 = time.perf_counter()
    train_loop.run(plain_loss, params, lambda step: ds.batch(step, TRAIN_BATCH),
                   dataclasses.replace(loop_cfg, ckpt_dir=os.path.join(SCRATCH, "plain_ckpt")),
                   opt_cfg)
    plain_s = time.perf_counter() - t0
    plain_values = [float(x) for x in plain]
    del params, plain
    gc.collect()
    torch.cuda.empty_cache()
    loss_values = record["losses"]
    traj_rel = [abs(a - b) / abs(b) for a, b in zip(loss_values, plain_values)]

    prof = record["profile"]
    busy_s, b6 = prof["device_busy_s"], prof["device_ms_of"]
    prof["wkv_share_of_busy"] = b6[WKV_FWD_KERNELS] / 1e3 / busy_s if busy_s else None
    prof["wkv_bwd_share_of_busy"] = b6[WKV_BWD_KERNELS] / 1e3 / busy_s if busy_s else None
    emit({"phase": "train", "arch": TRAIN_ARCH, **record,
          "plain_wkv_run": {"losses": plain_values, "rel_diff": traj_rel, "seconds": plain_s,
                            "tolerance": {k: TRAIN_PARITY_TOL[k]
                                          for k in ("loss_abs", "trajectory_rel")}}})
    _check_train(record)
    if abs(loss_values[0] - plain_values[0]) > TRAIN_PARITY_TOL["loss_abs"] or \
            max(traj_rel) > TRAIN_PARITY_TOL["trajectory_rel"]:
        raise AssertionError(f"losses {loss_values}, with the plain WKV {plain_values}")
    if "fwd" not in captured or "bwd" not in captured:
        raise AssertionError("no call of the WKV kernels was captured")
    return captured, record["launches"]


def _named_leaves(tree, prefix=""):
    """('a/b/0/c', tensor) for the leaves of a nested dict/list tree, depth
    first (the order of ``params.leaves``)."""
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, list) else None
    if items is None:
        yield prefix[:-1], tree
        return
    for key, sub in items:
        yield from _named_leaves(sub, f"{prefix}{key}/")


def phase_train_parity():
    """The same batch through a 2-layer full-width rwkv6-3b twice: the
    kernels B6 and B6-bwd, and the plain WKV on the card. Then prefill
    (the chunked path, B6) against token-by-token decode on 64 tokens."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    params, _ = model_zoo.init_params(cfg, seed=1, device="cuda", dtype=torch.float32)
    names, flat = zip(*_named_leaves(params))
    for t in flat:
        t.requires_grad_(True)
    batch = model_zoo.demo_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, np.random.default_rng(0),
                                 device="cuda")
    out = {}
    for impl in ("kernel", "plain"):
        zero_launches()
        loss = model_zoo.loss_fn(cfg, "none", wkv_impl=impl)(params, batch)
        grads = torch.autograd.grad(loss, flat)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        out[impl] = (float(loss.detach()), float(norm), grads, read_launches())
    (lk, nk, gk, launch_k), (lp, np_, gp, launch_p) = out["kernel"], out["plain"]
    # each leaf (stacked leaves layer by layer) against the plain path,
    # relative to the plain path's norm of that leaf; bf16 activations put
    # leaves up to 1.1% apart on an H100, a wrong dlw or du moves the
    # decay's or u's leaves by their whole error
    leaf_rel = {}
    for name, a, b in zip(names, gk, gp):
        if name.startswith("segments/"):
            leaf_rel.update((f"{name}[{i}]", _rel_norm_err(x, y))
                            for i, (x, y) in enumerate(zip(a, b)))
        else:
            leaf_rel[name] = _rel_norm_err(a, b)
    worst_leaves = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:5]
    del gk, gp, out, grads
    for t in flat:
        t.requires_grad_(False)

    # prefill (64 tokens: two WKV chunks) against 64 decode steps
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 64)).astype(np.int32)).cuda()
    with torch.no_grad():
        zero_launches()
        pre = model_zoo.prefill_fn(cfg)(params, {"tokens": tokens}).float()
        pre_launches = read_launches()
        step = model_zoo.decode_fn(cfg)
        cache = model_zoo.make_cache(cfg, 4, 65, "cuda")
        for t in range(64):
            logits, cache = step(params, tokens[:, t], cache, t)
    dec = logits.float()
    dev = (pre - dec).abs().amax(dim=-1)
    top2 = pre.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = pre.argmax(-1) == dec.argmax(-1)
    ties = [{"row": i, "margin": float(margin[i]), "deviation": float(dev[i])}
            for i in range(4) if not bool(agree[i])]
    del params, flat, cache
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train-parity", "arch": TRAIN_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "loss": {"kernel": lk, "plain": lp}, "grad_norm": {"kernel": nk, "plain": np_},
          "max_leaf_grad_rel_diff": worst_leaves[0][1], "worst_leaves": worst_leaves,
          "leaf_grad_rel_diff": leaf_rel, "tolerance": TRAIN_PARITY_TOL,
          "launches": {"kernel": launch_k, "plain": launch_p},
          "prefill_vs_decode": {"tokens": [4, 64], "max_abs_dev": float(dev.max()),
                                "deviation_limit": DEVIATION_LIMIT,
                                "argmax_agree": int(agree.sum()), "near_ties": ties,
                                "prefill_launches": pre_launches}})
    if abs(lk - lp) > TRAIN_PARITY_TOL["loss_abs"] or \
            abs(nk - np_) > TRAIN_PARITY_TOL["grad_norm_rel"] * np_ or \
            worst_leaves[0][1] > TRAIN_PARITY_TOL["leaf_grad_rel"]:
        raise AssertionError(f"kernel path loss {lk} / grad norm {nk} vs plain {lp} / {np_}, "
                             f"leaves {worst_leaves}")
    if (launch_k["wkv"], launch_k["wkv_bwd"]) != (2, 2) or launch_p["wkv"] or \
            launch_p["wkv_bwd"] or pre_launches["wkv"] != 2:
        raise AssertionError(f"WKV launches: kernel {launch_k}, plain {launch_p}, "
                             f"prefill {pre_launches}")
    if float(dev.max()) > DEVIATION_LIMIT or any(t["margin"] > t["deviation"] for t in ties):
        raise AssertionError(f"prefill vs decode: deviation {float(dev.max())}, ties {ties}")


def phase_train_mla():
    """minicpm3-4b at full width and depth trained for MLA_TRAIN_STEPS steps
    of MLA_TRAIN_BATCH x TRAIN_SEQ tokens by ``_train_phase`` (B1 the one
    kernel: the attention training forward is plain PyTorch); then a
    2-layer full-width model's prefill (the MLA training forward) against
    32 decode steps."""
    import gc

    import numpy as np
    import torch

    from repro_torch.models import model_zoo

    cfg = _published(SERVE_MLA_ARCH, MLA_FIELDS, MLA_WIDTH)
    record, run = _train_phase(cfg, MLA_TRAIN_BATCH, MLA_TRAIN_STEPS, {"strider_decode": 1},
                               "mla_tokens.heap", kernels=("strider_decode",))
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # prefill (the training forward: mla_train) against 32 dense decode
    # steps (mla_decode) of a 2-layer full-width model, bf16 weights
    small = dataclasses.replace(cfg, n_layers=2)
    params, _ = model_zoo.init_params(small, seed=1, device="cuda")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, 32)).astype(np.int32)).cuda()
    with torch.no_grad():
        pre = model_zoo.prefill_fn(small)(params, {"tokens": tokens}).float()
        step = model_zoo.decode_fn(small)
        cache = model_zoo.make_cache(small, 4, 33, "cuda")
        for t in range(32):
            logits, cache = step(params, tokens[:, t], cache, t)
    dec = logits.float()
    dev = float((pre - dec).abs().max())
    agree = int((pre.argmax(-1) == dec.argmax(-1)).sum())
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": "train-mla", "arch": SERVE_MLA_ARCH, "heads": cfg.n_heads,
          "kv_lora": cfg.kv_lora_rank, **record,
          "prefill_vs_decode": {"layers": 2, "tokens": [4, 32], "max_abs_dev": dev,
                                "tolerance": 3e-2, "argmax_agree": agree}})
    _check_train(record)
    if dev > 3e-2 or agree != 4:
        raise AssertionError(f"prefill vs decode: deviation {dev}, argmax agree {agree} of 4")


def phase_launch_train():
    import contextlib
    import gc
    import io

    import torch

    from repro_torch.launch import train as train_cli

    argv = ["--arch", TRAIN_ARCH, "--steps", "2", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--remat", TRAIN_REMAT, "--data-path", "pages",
            "--ckpt-dir", os.path.join(SCRATCH, "launch_train"), "--ckpt-every", "1000"]
    gc.collect()
    torch.cuda.empty_cache()
    zero_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        hist = train_cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    lines = out.getvalue().splitlines()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "launch-train", "argv": argv, "seconds": seconds, "lines": lines[:6],
          "history": hist, "launches": launches})
    layers = TRAIN_WIDTH[0]
    want = {k: 0 for k in launches}
    want.update(strider_decode=2, wkv=2 * 2 * layers, wkv_bwd=2 * layers)
    if not hist or not math.isfinite(hist[0]["loss"]) or launches != want:
        raise AssertionError(f"launch/train.py: {lines[:3]}, {hist}, {launches}")


# ---------------------------------------------------------------------------
# examples: the four example drivers as the port's launch modules
# ---------------------------------------------------------------------------
# serve_lm's full-width run: internlm2-20b at its published width (6,144, 48/8
# heads of 128), its depth cut to EXAMPLES_SERVE_LAYERS, paged KV through B5 at
# KVH 8, G 6, D 128 (1.9 B parameters, 3.8 GB in bf16)
EXAMPLES_SERVE_ARGV = ["--arch", "internlm2-20b", "--full-width", "--layers", "2",
                       "--kv", "paged", "--attn-impl", "kernel"]
EXAMPLES_SERVE_B5 = (8, 6, 128)  # (KV heads, group, head dim) of its B5 calls
# the quickstart's TRAIN converges in this many epochs on the card: one chunk
# of its 37 pages an epoch (B1 and B2's chunk walk once each), and the
# convergence check's batch (decoded by B1 once a statement, its gradient by
# B2's glm_grad once an epoch); each of the three scans (one chunk of the
# scoring table) runs B3 and B4 once
EXAMPLES_QUICKSTART_EPOCHS = 1
# dana_vs_madlib: each mode's coefficients against dana's at repro's own
# tolerances (tests/test_system.py:39 and :47). The MADlib analogue batches
# the tuples of each page (138 here) where the engine batches the stream
# (256), so it is held against dana run with merge batches of a page's tuples
EXAMPLES_MODE_TOL = {"dana-nostrider": dict(rtol=1e-5, atol=1e-6),
                     "madlib": dict(rtol=1e-4, atol=1e-5)}
# its Fig. 11 ablation at Table 3's full size (EXPECT's geometry), dana and
# dana-nostrider only: repro's bench_speedup.py:14 runs MADlib to 6,000 tuples
EXAMPLES_FULL_MODES = ("dana", "dana-nostrider")
# the kernels line's rows that the drivers' launches add to (B1-B5)
EXAMPLES_ROWS = ("strider_decode", "glm_sgd_chunk", "glm_grad", "strider_decode_projected",
                 "glm_predict", "paged_attn")


def _run_driver(module, argv):
    """``module.main(argv)`` on the card with its standard output captured,
    between zero_launches and read_launches: (its result, its lines, its
    seconds, the launches)."""
    import contextlib
    import gc
    import io

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    zero_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    lines = out.getvalue().splitlines()
    if not lines or lines[-1] != "OK":
        raise AssertionError(f"{module.__name__} {argv}: {lines[-5:]}")
    return result, lines, seconds, launches


def phase_examples():
    """The three example drivers through their launch modules' ``main`` on
    the card, each printing OK: quickstart (B1 and B2's chunk walk once an
    epoch, B3 and B4 once a scan, the convergence check's batch through B1
    once and B2's one-batch gradient once an epoch; B1's first call held bit
    for bit against its plain version and B2's first chunk walk at B2_TOL,
    B3 and B4 by the driver's own check of the predictions), serve_lm at
    the example's own settings (no kernel) and at internlm2-20b's full width
    on EXAMPLES_SERVE_LAYERS layers through B5 (once a layer a fused step,
    every call of the first fused step against its plain version at 2e-5,
    the call of the last fused step kept for the kernels line), and
    train_lm at its defaults (B1 once a step run, no other kernel; its
    first call held bit for bit against its plain version), and
    dana_vs_madlib (``_dana_vs_madlib``). A line per driver; returns the
    launches and B5's captured call. It runs at a lower priority than the
    serving phases beside it, which are bound by the host's cores."""
    import types

    import torch

    from repro_torch.kernels.paged_attn import kernel as pa_kernel
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.launch import quickstart, serve_lm, train_lm
    from repro_torch.serve import serving

    os.nice(10)
    work = os.path.join(SCRATCH, "examples")
    shutil.rmtree(work, ignore_errors=True)
    result = {"launches": {}}

    def line(driver, argv, lines, seconds, launches, key=None, **extra):
        result["launches"][key or driver] = launches
        emit(dict({"phase": "examples", "driver": driver, "argv": argv, "seconds": seconds,
                   "lines": lines[:6], "launches": launches}, **extra))

    def only(launches, want):
        full = {k: 0 for k in launches}
        full.update(want)
        return launches == full, full

    # quickstart: TRAIN, then the three scans
    argv = ["--workdir", os.path.join(work, "quickstart")]
    with _b1_first_calls() as b1, _b2_first_calls() as b2:
        qs, lines, seconds, launches = _run_driver(quickstart, argv)
    plain = {"strider_decode": b1.result(1), "glm_sgd_chunk": b2.result(1)}
    epochs = qs["epochs_run"]
    held, want = only(launches, {"strider_decode": epochs + 1, "glm_sgd_chunk": epochs,
                                 "glm_grad": epochs, "strider_decode_projected": 3,
                                 "glm_predict": 3})
    line("quickstart", argv, lines, seconds, launches, epochs=epochs, syncs=qs["syncs"],
         err=qs["err"], launches_expected=want, plain_check=plain)
    if not held or (EXAMPLES_QUICKSTART_EPOCHS is not None
                    and epochs != EXAMPLES_QUICKSTART_EPOCHS):
        raise AssertionError(f"quickstart: launches {launches}, expected {want}; "
                             f"{epochs} epochs")

    # serve_lm at the example's settings: dense KV, the gather path
    served, lines, seconds, launches = _run_driver(serve_lm, [])
    tok_s = {arch: run["tok_s"] for arch, run in served["archs"].items()}
    line("serve_lm", [], lines, seconds, launches, tok_s=tok_s)
    if list(served["archs"]) != list(serve_lm.ARCHS) or any(launches.values()):
        raise AssertionError(f"serve_lm: {list(served['archs'])}, launches {launches}")

    # serve_lm at internlm2-20b's full width through B5: the fused steps
    # counted, the first one's calls held to the plain version, the last
    # one's first call kept
    forwards, check, kept = [0], _PlainCheck(), {}
    real_forward, real_call = serving.BatchedServer._forward, pa_kernel.paged_attention

    def forward(self, *args, **kw):
        forwards[0] += 1
        return real_forward(self, *args, **kw)

    def capture(q, k_pool, v_pool, table, pos, **kw):
        out = real_call(q, k_pool, v_pool, table, pos, **kw)
        if len(check.errs) < layers:
            check(out, q, k_pool, v_pool, table, pos, kw)
        if calls[0] % layers == 0:  # a fused step's first layer
            kept.update(q=q.clone(), pools=(k_pool.clone(), v_pool.clone()), latent=False,
                        table=table.clone(), pos=pos.clone(), runs=kw.get("runs"),
                        kw={k: v for k, v in kw.items() if k != "runs"}, step=forwards[0])
        calls[0] += 1
        return out

    layers, calls = int(EXAMPLES_SERVE_ARGV[EXAMPLES_SERVE_ARGV.index("--layers") + 1]), [0]
    serving.BatchedServer._forward = forward
    pa_ops.kernel = types.SimpleNamespace(paged_attention=capture)
    try:
        torch.cuda.reset_peak_memory_stats()
        full, lines, seconds, launches = _run_driver(serve_lm, EXAMPLES_SERVE_ARGV)
    finally:
        serving.BatchedServer._forward = real_forward
        pa_ops.kernel = pa_kernel
    run = full["archs"]["internlm2-20b"]
    held, want = only(launches, {"paged_attn": layers * forwards[0]})
    b5 = tuple(kept["q"].shape[1:]) if kept else None
    line("serve_lm", EXAMPLES_SERVE_ARGV, lines, seconds, launches, key="serve_lm_full_width",
         tok_s=run["tok_s"],
         fused_steps=forwards[0], launches_expected=want, b5_call=b5,
         plain_check=check.result(layers, "every call of the first fused step"),
         peak_bytes=torch.cuda.max_memory_allocated(), attn_impl=run["attn_impl"])
    if not held or forwards[0] == 0 or run["attn_impl"] != "kernel" or \
            b5 != EXAMPLES_SERVE_B5:
        raise AssertionError(f"serve_lm at full width: launches {launches}, expected {want}, "
                             f"B5 at {b5}, attn {run['attn_impl']}")
    if kept["runs"] is None:  # chunked stepping passes none: each row its own run
        kept["runs"] = torch.tensor([[i, 1] for i in range(kept["q"].shape[0])],
                                    dtype=torch.int32, device=kept["q"].device)
    result["b5_capture"] = kept
    result["b5_launches"] = launches["paged_attn"]

    # train_lm at its defaults: 60% of the steps, the resume from the last
    # checkpoint, the rest; B1 once a step run
    argv = ["--workdir", os.path.join(work, "train_lm")]
    with _b1_first_calls() as b1:
        trained, lines, seconds, launches = _run_driver(train_lm, argv)
    plain = {"strider_decode": b1.result(1)}
    steps_run = trained["preempted_at"] + trained["step"] - trained["resumed_at"]
    held, want = only(launches, {"strider_decode": steps_run})
    line("train_lm", argv, lines, seconds, launches, steps_run=steps_run,
         preempted_at=trained["preempted_at"], resumed_at=trained["resumed_at"],
         losses=[r["loss"] for r in trained["history"]], launches_expected=want,
         plain_check=plain)
    if not held:
        raise AssertionError(f"train_lm: launches {launches}, expected {want}")
    _dana_vs_madlib(os.path.join(work, "dana_vs_madlib"), line, only, result)
    shutil.rmtree(work, ignore_errors=True)
    return result


def _mode_parity(coefficients, reference, tolerances):
    """Each mode's coefficients against ``reference``'s at its tolerance:
    (whether all held, a record per mode)."""
    import numpy as np

    record = {mode: dict(tolerances[mode], max_abs_err=float(
        np.abs(coefficients[mode] - reference[mode]).max()),
        held=bool(np.allclose(coefficients[mode], reference[mode], **tolerances[mode])))
        for mode in tolerances}
    return all(r["held"] for r in record.values()), record


def _dana_vs_madlib(work, line, only, result):
    """The paper's comparison through ``dana_vs_madlib.main`` at the
    example's scale (one 43-page chunk): B1 in dana's untimed and timed
    runs, B2's chunk walk in those and in dana-nostrider's (the engine on
    host-parsed tuples), none in madlib (the host); B1's first call bit for
    bit, B2's first walk at B2_TOL; dana-nostrider's coefficients against
    dana's, madlib's against dana with merge batches of a page's tuples (a
    run after the driver's, uncounted). Then the Fig. 11 ablation through
    ``workloads.time_mode`` at Table 3's full size, each mode after its
    untimed run: B1 and B2 once a 512-page chunk a run in dana, B2 alone in
    dana-nostrider. Each run's host load and torch's threads on its line:
    the MADlib analogue and the host decode share the host's cores with the
    serving phases beside this process."""
    import numpy as np
    import torch

    from repro_torch.core import solver
    from repro_torch.core.engine import make_engine
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.launch import dana_vs_madlib, workloads

    w = WORKLOADS[dana_vs_madlib.WORKLOAD]

    def chunks(heap):
        return -(-heap.n_pages // solver.MAX_RESIDENT_PAGES)

    argv = ["--workdir", work]
    loadavg = os.getloadavg()
    with _b1_first_calls() as b1, _b2_first_calls() as b2:
        ran, lines, seconds, launches = _run_driver(dana_vs_madlib, argv)
    plain = {"strider_decode": b1.result(1), "glm_sgd_chunk": b2.result(1)}
    heap = workloads.build_heap(w, dana_vs_madlib.SCALE, directory=work)
    n = chunks(heap)
    held, want = only(launches, {"strider_decode": 2 * n, "glm_sgd_chunk": 4 * n})
    coefficients = {mode: r["models"][0] for mode, r in ran["results"].items()}
    g, part = workloads.traced(w)
    engine = make_engine(g, part, merge_coef=heap.layout.tuples_per_page, device="cuda")
    on_pages = solver.train(g, part, heap, mode="dana", engine=engine,
                            max_epochs=dana_vs_madlib.EPOCHS).models[0]
    agree, parity = _mode_parity(
        coefficients, {"dana-nostrider": coefficients["dana"], "madlib": on_pages},
        EXAMPLES_MODE_TOL)
    parity["madlib"]["against"] = (f"dana, merge batches of a page's "
                                   f"{heap.layout.tuples_per_page} tuples")
    parity["madlib"]["max_abs_err_vs_dana"] = float(
        np.abs(coefficients["madlib"] - coefficients["dana"]).max())
    fpga = {k: ran["fpga_point"][k] for k in ("n_threads", "acs_per_thread", "n_striders",
                                              "cycles_per_batch", "est_epoch_cycles")}
    line("dana_vs_madlib", argv, lines, seconds, launches, mode_seconds=ran["seconds"],
         ratios=ran["ratios"], n_tuples=ran["n_tuples"], pages=ran["n_pages"],
         epochs_run={m: r["epochs_run"] for m, r in ran["results"].items()},
         device_syncs={m: r["device_syncs"] for m, r in ran["results"].items()},
         launches_expected=want, plain_check=plain, coefficients=parity,
         fpga_model=dict(fpga, **ran["fpga_rt"]), loadavg=loadavg,
         torch_threads=torch.get_num_threads())
    bad = [m for m, r in ran["results"].items() if r["epochs_run"] != dana_vs_madlib.EPOCHS
           or not np.isfinite(coefficients[m]).all()]
    if not held or not agree or bad:
        raise AssertionError(f"dana_vs_madlib: launches {launches}, expected {want}; "
                             f"coefficients {parity}; modes {bad}")

    # the Fig. 11 ablation at Table 3's full size
    t0 = time.perf_counter()
    heap = workloads.build_heap(w, 1.0, directory=work)
    build_s = time.perf_counter() - t0
    geometry = (heap.n_tuples, heap.layout.n_features, heap.layout.tuples_per_page,
                heap.n_pages)
    n = chunks(heap)
    runs, coefficients, total = {}, {}, {}
    expected = {"dana": {"strider_decode": 2 * n, "glm_sgd_chunk": 2 * n},
                "dana-nostrider": {"glm_sgd_chunk": 2 * n}}
    held = geometry == EXPECT["geometry"]
    for mode in EXAMPLES_FULL_MODES:
        loadavg = os.getloadavg()
        zero_launches()
        seconds, res = workloads.time_mode(w, heap, mode, epochs=1, device="cuda")
        launches = read_launches()
        ok, want = only(launches, expected[mode])
        held = held and ok and res.epochs_run == 1 and res.device_syncs == 1
        coefficients[mode] = res.models[0]
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        runs[mode] = {"seconds": seconds, "tuples_per_s": heap.n_tuples / seconds,
                      "epochs_run": res.epochs_run, "device_syncs": res.device_syncs,
                      "launches": launches, "launches_expected": want, "loadavg": loadavg}
    result["launches"]["dana_vs_madlib_full_size"] = total
    agree, parity = _mode_parity(coefficients, {"dana-nostrider": coefficients["dana"]},
                                 {"dana-nostrider": EXAMPLES_MODE_TOL["dana-nostrider"]})
    emit({"phase": "examples", "driver": "dana_vs_madlib_full_size",
          "seconds": time.perf_counter() - t0, "workload": w.name, "geometry": geometry,
          "heap_bytes": heap.n_pages * heap.layout.page_bytes, "chunks": n,
          "build_s": build_s, "modes": runs,
          "nostrider_over_dana": runs["dana-nostrider"]["seconds"] / runs["dana"]["seconds"],
          "coefficients": parity, "torch_threads": torch.get_num_threads()})
    if not held or not agree or not np.isfinite(coefficients["dana"]).all():
        raise AssertionError(f"dana_vs_madlib at full size: geometry {geometry}, "
                             f"runs {runs}, coefficients {parity}")


# ---------------------------------------------------------------------------
# train-elastic: LM training on a mesh of gloo ranks sharing the card
# ---------------------------------------------------------------------------
# rwkv6-3b at its published width, its depth cut to ELASTIC_LAYERS: in a step
# each of the ELASTIC_WORLD ranks holds the whole weights and their gradient
# (f32), besides its slices of the weights and the moments
ELASTIC_WORLD = 4
# 4 layers took 196 s of the phase and 830 s of the whole smoke on an H100
# (gloo moves every byte of the weights and the gradient through the host);
# at 2 the phase fits the smoke's time
ELASTIC_LAYERS = 2
# the first mesh (data x model) and its steps; then save, the second mesh
# over the same ranks, restore(shardings=) and its steps
ELASTIC_MESHES = {"a": ((2, 2), 3), "b": ((4, 1), 2)}
ELASTIC_TIMEOUT_S = 600  # the ranks' limit; the process group's is below it
ELASTIC_PG_TIMEOUT_S = 300
# against unsharded card runs from the same seed and batches. On the whole
# batch: each loss (relative) and each leaf of the first step's summed
# gradient (relative norm, the bound of tests/test_torch_attention.py's bf16
# gradients: bf16 activations round apart where a rank's matmuls see fewer
# rows), and each leaf's change over a mesh's steps (relative norm). AdamW's
# first steps move each element by about lr whatever its gradient's size, so
# an element whose tiny gradient the rounding flips moves 2 lr the other
# way: a leaf whose change is off by more is held instead by the share of
# its elements whose change has the other sign (at most ELASTIC_FLIP_SHARE)
# and by the relative norm over the elements whose sign agrees. On the
# meshes' own row splits (each step in as many microbatches as the mesh has
# data ranks): each leaf's change. The witness that the whole-batch gap is
# bf16's rounding of a row split: the whole-batch and the split run again
# with every activation in f32 (the tables uncast), their changes within
# ELASTIC_F32_SPLIT_REL, a tenth of the change's bound
ELASTIC_LOSS_REL, ELASTIC_GRAD_REL, ELASTIC_UPDATE_REL = 2e-2, 5e-2, 5e-2
ELASTIC_FLIP_SHARE, ELASTIC_F32_SPLIT_REL = 1e-3, 5e-3


def _elastic_args(work):
    """The arguments of ``launch/elastic_restart.py``'s flow for this phase:
    rwkv6-3b at full width on ELASTIC_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ
    tokens from pages, full remat, AdamW (lr 3e-4, warmup 2)."""
    from repro_torch.launch import elastic_restart

    (ma, sa), (mb, sb) = ELASTIC_MESHES["a"], ELASTIC_MESHES["b"]
    return elastic_restart.build_parser().parse_args([
        "--device", "cuda", "--ranks", str(ELASTIC_WORLD), "--arch", TRAIN_ARCH,
        "--full-width", "--layers", str(ELASTIC_LAYERS), "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), "--steps", str(sa), "--steps-after", str(sb), "--lr", "3e-4",
        "--remat", TRAIN_REMAT, "--data-path", "pages",
        "--mesh-a", f"{ma[0]}x{ma[1]}", "--mesh-b", f"{mb[0]}x{mb[1]}", "--workdir", work])


def _leaf_copies(tree):
    """{path: a copy on its device} of a tree's (whole) tensors: the
    snapshots the phase compares on the card."""
    return {name: t.detach().clone() for name, t in _named_leaves(tree)}


def _placement_names(x):
    """A tensor's or a NamedSharding's placements as "R" / "S(dim)", None
    for a whole (replicated) tensor."""
    from repro_torch.dist import meshes

    if isinstance(x, meshes.NamedSharding):
        if x.is_replicated:
            return None
        return ["R" if not hasattr(p, "dim") else f"S({p.dim})" for p in x.placements]
    if not meshes.is_dtensor(x):
        return None
    return ["R" if not hasattr(p, "dim") else f"S({p.dim})" for p in x.placements]


@contextlib.contextmanager
def _f32_activations():
    """The embedding and the unembedding uncast (as the CPU tests'
    ``uncast``): the table's rows enter the stack in f32, so every
    activation and the logits stay in f32."""
    from repro_torch.models import layers, model_zoo, transformer

    saved = (transformer.embed, transformer.unembed, layers.unembed, model_zoo.unembed)
    transformer.embed = lambda p, t, cfg: p["table"][t]
    transformer.unembed = layers.unembed = model_zoo.unembed = \
        lambda p, x, cfg: x @ p["unembed"]
    try:
        yield
    finally:
        transformer.embed, transformer.unembed, layers.unembed, model_zoo.unembed = saved


def _elastic_unsharded(cfg, args, work, name, micro, split):
    """``len(micro)`` steps unsharded on the card from the flow's seed, step
    ``s`` in ``micro[s]`` microbatches: losses, seconds, peak memory,
    launches, the first step's gradients and the weights at steps 0,
    ``split`` and the last (copies on the card), and the state's manifest."""
    import gc

    import torch

    from repro_torch.data.pipeline import PageTokenDataset
    from repro_torch.launch import elastic_restart
    from repro_torch.models import model_zoo
    from repro_torch.models.params import count_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, adamw_init, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, _ = model_zoo.init_params(cfg, elastic_restart.SEED, "cuda", dtype=torch.float32)
    out = {"params": count_params(params), "snaps": {0: _leaf_copies(params)}, "grads": {}}
    ds = PageTokenDataset(os.path.join(work, f"tokens.{name}.heap"),
                          n_seqs=max(args.batch * 8, 64), seq_len=args.seq,
                          vocab=cfg.vocab_size, seed=elastic_restart.SEED, device="cuda")
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=elastic_restart.WARMUP_STEPS)

    def keep_first(grads, error_fb):  # the first step's gradients, to the host
        if not out["grads"]:
            out["grads"] = _leaf_copies(grads)
        return grads, error_fb

    loss_fn = model_zoo.loss_fn(cfg, remat=args.remat)
    step_fns = {m: make_train_step(loss_fn, opt_cfg, compress=keep_first, microbatches=m)
                for m in set(micro)}
    opt = adamw_init(params, opt_cfg)
    losses, step_s = [], []
    zero_launches()
    for s, m in enumerate(micro):
        t0 = time.perf_counter()
        params, opt, _, metrics = step_fns[m](params, opt, ds.batch(s, args.batch), None)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if s + 1 == split:
            out["snaps"][split] = _leaf_copies(params)
    out["snaps"][len(micro)] = _leaf_copies(params)
    out.update(losses=losses, step_s=step_s, launches=read_launches(),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               manifest=ckpt.manifest({"params": params, "opt": opt}))
    del params, opt, ds, step_fns, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_elastic():
    """LM training on a mesh: the baselines, the same steps unsharded on the
    card from seed 0 on the same page batches (whole, and split as the
    meshes split the rows; both also with f32 activations, the witness of
    the split's rounding), then ELASTIC_WORLD gloo ranks
    on the one card (``chip_smoke.py --elastic-rank``) run
    ``elastic_restart.flow``: the first mesh's steps, save, the second
    mesh, ``restore(shardings=)``, its steps. One line for each baseline,
    one per mesh and one of the checks. Returns the ranks' B1, B6 and B6-bwd
    launches and their WKV parity for the kernels line."""
    import torch

    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    build.build(*KERNEL_SOURCES)  # a hash hit after the build phase: nvcc stays out of the ranks
    full = _published(TRAIN_ARCH, TRAIN_FIELDS, TRAIN_WIDTH)
    cfg = dataclasses.replace(full, n_layers=ELASTIC_LAYERS)
    work = os.path.join(SCRATCH, "elastic")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    args = _elastic_args(work)
    split, steps = args.steps, args.steps + args.steps_after

    spans = {"a": (0, split), "b": (split, steps)}

    def changes(got, want, first, last):
        """Each leaf's change over steps first..last against ``want``'s: the
        relative norm of the difference, the share of elements whose change
        has the other sign, and the relative norm over the others."""
        rel, flipped, unflipped = {}, {}, {}
        for name, d in got.items():
            w = want[last][name] - want[first][name]
            rel[name] = _rel_norm_err(d, w)
            agree = (d.float() * w) >= 0
            flipped[name] = 1.0 - float(agree.sum()) / max(w.numel(), 1)
            unflipped[name] = _rel_norm_err(d.float() * agree, w * agree)
        return rel, flipped, unflipped

    # the baseline: the same steps unsharded on the card, on the whole batch
    # (the yardstick) and on the meshes' own row splits (each step in as many
    # microbatches as the mesh has data ranks: the same rows a rank takes,
    # summed in f32); first the witness, both again in f32 activations
    whole_micro = [1] * steps
    split_micro = ([ELASTIC_MESHES["a"][0][0]] * split
                   + [ELASTIC_MESHES["b"][0][0]] * (steps - split))
    runs, witness = {}, {}
    for name, micro in (("baseline_f32", whole_micro), ("same_split_f32", split_micro),
                        ("baseline", whole_micro), ("same_split", split_micro)):
        with _f32_activations() if name.endswith("_f32") else contextlib.nullcontext():
            runs[name] = _elastic_unsharded(cfg, args, work, name, micro, split)
        emit({"phase": "train-elastic", "run": f"unsharded {name}", "arch": TRAIN_ARCH,
              "layers": cfg.n_layers, "depth_cut": _depth_cut(full, cfg),
              "d_model": cfg.d_model, "params": runs[name]["params"], "batch": args.batch,
              "seq": args.seq, "steps": steps, "microbatches": micro,
              **{k: runs[name][k] for k in ("losses", "step_s", "peak_memory_bytes",
                                            "launches")}})
        if name == "same_split_f32":
            whole32, split32 = runs.pop("baseline_f32")["snaps"], runs.pop(name)["snaps"]
            for phase, (lo, hi) in spans.items():
                witness[phase] = changes({k: split32[hi][k] - split32[lo][k]
                                          for k in split32[hi]}, whole32, lo, hi)
            del whole32, split32
            torch.cuda.empty_cache()
    base_losses, first = runs["baseline"]["losses"], runs["baseline"]["grads"]
    snaps, split_snaps = runs["baseline"]["snaps"], runs["same_split"]["snaps"]
    want_manifest = runs["baseline"]["manifest"]

    # the ranks
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = []
    t_ranks = time.perf_counter()
    try:
        for rank in range(ELASTIC_WORLD):
            out = open(os.path.join(work, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--elastic-rank", str(rank),
                 str(ELASTIC_WORLD), work], stdout=out, stderr=subprocess.STDOUT, env=env),
                out))
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                raise AssertionError(f"train-elastic: rank {rank} ended with {rc}")
    except BaseException:
        for rank in range(ELASTIC_WORLD):
            path = os.path.join(work, f"rank{rank}.log")
            if os.path.exists(path):
                with open(path) as f:
                    sys.stderr.write(f"--- rank {rank} ---\n{f.read()[-4000:]}\n")
        raise
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            out.close()
    ranks_s = time.perf_counter() - t_ranks
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(ELASTIC_WORLD)]
    deltas = torch.load(os.path.join(work, "deltas.pt"), map_location="cuda",
                        weights_only=False)
    grads = deltas.pop("grads")
    grad_rel = {name: _rel_norm_err(g, first[name]) for name, g in grads.items()}
    split_grad_rel = {name: _rel_norm_err(g, runs["same_split"]["grads"][name])
                      for name, g in grads.items()}

    failures = []
    first_step = {"a": grad_rel, "b": None}
    summary = {"launches_per_rank": {}, "parity": {}}
    for phase, (first, last) in spans.items():
        shape = dict(zip(("data", "model"), ELASTIC_MESHES[phase][0]))
        got = [r["phases"][phase] for r in ranks]
        losses = got[0]["losses"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, base_losses[first:last])]
        update, _, _ = changes(deltas[phase], split_snaps, first, last)
        update_base, flipped, unflipped = changes(deltas[phase], snaps, first, last)
        # a leaf off the whole batch's change by more than the bound: held
        # by its flipped share and the rest
        held_whole = {k: v <= ELASTIC_UPDATE_REL or (flipped[k] <= ELASTIC_FLIP_SHARE
                                                     and unflipped[k] <= ELASTIC_UPDATE_REL)
                      for k, v in update_base.items()}
        # the same-split run's own distance from the whole-batch one: what
        # the rounding of the row split alone moves
        floor, floor_flipped, _ = changes(
            {k: (split_snaps[last][k] - split_snaps[first][k]).to(torch.bfloat16)
             for k in deltas[phase]}, snaps, first, last)
        f32_rel, f32_flipped, _ = witness[phase]
        # each (leaf, region)'s bits: the ranks that hold the same region agree
        held = {}
        for r in ranks:
            for name, (region, bits) in r["phases"][phase]["bits"].items():
                held.setdefault((name, region), set()).add(bits)
        same_bits = all(len(v) == 1 for v in held.values())
        launches = [r["phases"][phase]["launches"] for r in ranks]
        n = last - first
        want_launches = {k: 0 for k in launches[0]}
        want_launches.update(strider_decode=n, wkv=2 * cfg.n_layers * n,
                             wkv_bwd=cfg.n_layers * n)
        placed_ok = all(r["phases"][phase]["placements"] == r["phases"][phase]["resolved"]
                        for r in ranks)
        parity = [r["parity"][phase] for r in ranks]
        summary["launches_per_rank"][f"{shape['data']}x{shape['model']}"] = {
            k: [x[k] for x in launches] for k in ("strider_decode", "wkv", "wkv_bwd")}
        summary["parity"][f"{shape['data']}x{shape['model']}"] = parity
        steps_of = [r["phases"][phase]["steps"] for r in ranks]
        emit({"phase": "train-elastic", "mesh": shape, "ranks": ELASTIC_WORLD,
              "steps": list(range(first + 1, last + 1)), "backend": ranks[0]["backend"],
              "losses": losses, "baseline_losses": base_losses[first:last],
              "loss_rel_gap": gaps, "loss_tolerance": ELASTIC_LOSS_REL,
              "same_split_losses": runs["same_split"]["losses"][first:last],
              "same_losses_on_every_rank": all(g["losses"] == losses for g in got),
              "grad_norms": got[0]["grad_norms"],
              **({"first_step_grad_rel_norm_max": max(first_step[phase].values()),
                  "first_step_grad_rel_norm": first_step[phase],
                  "first_step_grad_rel_norm_same_split_max": max(split_grad_rel.values()),
                  "grad_tolerance": ELASTIC_GRAD_REL} if first_step[phase] else {}),
              "update_rel_norm_max": max(update.values()), "update_rel_norm": update,
              "update_tolerance": ELASTIC_UPDATE_REL,
              "update_vs_baseline_rel_norm": update_base, "flipped_share": flipped,
              "update_vs_baseline_unflipped_rel_norm": unflipped,
              "flipped_share_tolerance": ELASTIC_FLIP_SHARE,
              "update_vs_baseline_held": all(held_whole.values()),
              "same_split_vs_baseline_rel_norm": floor,
              "same_split_vs_baseline_flipped_share": floor_flipped,
              "f32_same_split_vs_baseline_rel_norm": f32_rel,
              "f32_same_split_vs_baseline_rel_norm_max": max(f32_rel.values()),
              "f32_same_split_vs_baseline_flipped_share": f32_flipped,
              "f32_tolerance": ELASTIC_F32_SPLIT_REL,
              "same_bits_on_every_rank": same_bits, "regions_compared": len(held),
              "opt_step": [r["phases"][phase]["opt_step"] for r in ranks],
              "placements": got[0]["placements"], "placed_as_resolved": placed_ok,
              "launches_per_rank": launches, "launches_expected": want_launches,
              "per_step_per_rank": steps_of,
              "seconds_per_rank": [g["seconds"] for g in got],
              "collectives_per_rank": [g["collectives"] for g in got],
              "collective_bytes_per_rank": [g["collective_bytes"] for g in got],
              "barriers_per_rank": [g["barriers"] for g in got],
              "wkv_parity_per_rank": parity})
        if max(gaps) > ELASTIC_LOSS_REL:
            failures.append(f"mesh {shape}: loss gaps {gaps}")
        if max(update.values()) > ELASTIC_UPDATE_REL:
            bad = {k: v for k, v in update.items() if v > ELASTIC_UPDATE_REL}
            failures.append(f"mesh {shape}: updates {bad}")
        if not all(held_whole.values()):
            bad = {k: (update_base[k], flipped[k], unflipped[k])
                   for k, ok in held_whole.items() if not ok}
            failures.append(f"mesh {shape}: updates against the whole batch "
                            f"(rel, flipped share, rel unflipped) {bad}")
        if max(f32_rel.values()) > ELASTIC_F32_SPLIT_REL:
            bad = {k: v for k, v in f32_rel.items() if v > ELASTIC_F32_SPLIT_REL}
            failures.append(f"mesh {shape}: the f32 split run's changes {bad}")
        if first_step[phase] and max(first_step[phase].values()) > ELASTIC_GRAD_REL:
            bad = {k: v for k, v in first_step[phase].items() if v > ELASTIC_GRAD_REL}
            failures.append(f"mesh {shape}: first step's gradients {bad}")
        if not same_bits:
            failures.append(f"mesh {shape}: the ranks' bits differ")
        if not placed_ok:
            failures.append(f"mesh {shape}: placements differ from the resolution")
        if any(x != want_launches for x in launches):
            failures.append(f"mesh {shape}: launches {launches}, expected {want_launches}")
        if not all(p["within"] for p in parity):
            failures.append(f"mesh {shape}: WKV parity {parity}")
    r0 = ranks[0]
    checks = {
        "restored_step": [r["restored_step"] for r in ranks], "opt_step": [r["step"] for r in ranks],
        "manifest_as_unsharded": r0["manifest"]["arrays"] == want_manifest
        and r0["manifest"]["step"] == split,
        "manifest_leaves": len(want_manifest), "save_s": [r["save_s"] for r in ranks],
        "restore_s": [r["restore_s"] for r in ranks],
        "forbidden_collectives": [r["forbidden"] for r in ranks],
        "fallbacks": r0["fallbacks"], "ranks_s": ranks_s,
        "seconds": time.perf_counter() - t_phase}
    emit({"phase": "train-elastic", "checks": checks})
    if any(r["step"] != steps or r["restored_step"] != split for r in ranks):
        failures.append(f"opt steps {checks['opt_step']}, restored {checks['restored_step']}")
    if not checks["manifest_as_unsharded"]:
        failures.append("the mesh checkpoint's manifest differs from an unsharded save's")
    if any(checks["forbidden_collectives"]):
        failures.append(f"forbidden collectives {checks['forbidden_collectives']}")
    if failures:
        raise AssertionError("train-elastic: " + "; ".join(failures))
    return summary


class _ElasticHooks:
    """What one rank of train-elastic watches in ``elastic_restart.flow``:
    per step its seconds, the card's busy time (the device's own events),
    peak memory, and the collectives' counts and bytes; on rank 0 the first
    step's gradients; per mesh the
    launches of every kernel (counted from zero at the mesh's first step),
    the first B6 and B6-bwd calls, the placements beside their resolution,
    and each leaf's local bits; on rank 0 the whole weights' change over
    each mesh's steps."""

    def __init__(self, rank):
        self.rank = rank
        self.phases = {}
        self.captured = {}
        self.before = None
        self.deltas = {}

    def start(self, params, specs, opt_cfg):
        self.specs, self.opt_cfg = specs, opt_cfg
        if self.rank == 0:
            self.before = _leaf_copies(params)

    def grads(self, grads):
        # the first step's gradients (whole, summed over the ranks), bf16 on
        # the host: every rank holds the same bits, rank 0 keeps them
        import torch

        if self.rank == 0 and "grads" not in self.deltas:
            self.deltas["grads"] = {n: g.detach().to("cpu", torch.bfloat16)
                                    for n, g in _named_leaves(grads)}

    @contextlib.contextmanager
    def phase(self, phase, mesh):
        import torch
        import torch.distributed as dist

        from repro_torch.dist import meshes
        from repro_torch.kernels.wkv import kernel as wkv_kernel
        from repro_torch.kernels.wkv import ops as wkv_ops

        captured = self.captured.setdefault(phase, {})

        def fwd(*a, **kw):
            if "fwd" not in captured:
                captured["fwd"] = ([x.clone() if torch.is_tensor(x) else x for x in a], kw)
            return wkv_kernel.wkv_forward(*a, **kw)

        def bwd(*a):
            if "bwd" not in captured:
                captured["bwd"] = [x.clone() if torch.is_tensor(x) else x for x in a]
            return wkv_kernel.wkv_backward(*a)

        rec = self.phases[phase] = {"steps": []}
        dist.barrier()
        torch.cuda.synchronize()
        zero_launches()
        meshes.reset_collectives()
        # the capture sits between ops and the kernel module: the wrappers
        # count on themselves
        wkv_ops.kernel = types.SimpleNamespace(wkv_forward=fwd, wkv_backward=bwd)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wkv_ops.kernel = wkv_kernel
        torch.cuda.synchronize()
        rec.update(seconds=time.perf_counter() - t0, launches=read_launches(),
                   collectives=dict(meshes.COLLECTIVES),
                   collective_bytes=dict(meshes.COLLECTIVE_BYTES),
                   barriers=dict(meshes.BARRIERS))

    @contextlib.contextmanager
    def step(self, phase, step):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.dist import meshes

        counts, nbytes = dict(meshes.COLLECTIVES), dict(meshes.COLLECTIVE_BYTES)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            seconds = time.perf_counter() - t0
        busy_s, _ = _device_busy([e for e in prof.events() if e.device_type == DeviceType.CUDA
                                  and not getattr(e, "is_user_annotation", False)])
        self.phases[phase]["steps"].append({
            "step": step + 1, "seconds": seconds, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / seconds,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "collectives": {k: v - counts[k] for k, v in meshes.COLLECTIVES.items()},
            "collective_bytes": {k: v - nbytes[k] for k, v in meshes.COLLECTIVE_BYTES.items()}})

    def end(self, phase, mesh, params, opt):
        import torch

        from repro_torch.dist import meshes
        from repro_torch.train.optimizer import param_shardings, state_shardings

        rec = self.phases[phase]
        state = {"params": params, "opt": opt}
        want = {"params": param_shardings(params, mesh, self.specs),
                "opt": state_shardings(params, self.opt_cfg, mesh, self.specs)}
        rec["placements"] = {n: _placement_names(x) for n, x in _named_leaves(state)}
        rec["resolved"] = {n: _placement_names(x) for n, x in _named_leaves(want)}
        rec["bits"] = {n: (tuple((s.start, s.stop) for s in meshes.region(x)),
                           int(_bit_sum(meshes.local(x).detach())))
                       for n, x in _named_leaves(state)}
        rec["opt_step"] = int(opt["step"])
        whole = {}
        for name, x in _named_leaves(params):
            w = meshes.whole(x)  # every rank gathers; rank 0 keeps a copy
            if self.rank == 0:
                whole[name] = w.detach().clone()
            del w
        if self.rank == 0:
            self.deltas[phase] = {k: (v - self.before[k]).to("cpu", torch.bfloat16)
                                  for k, v in whole.items()}
            self.before = whole

    def wkv_parity(self):
        """Each mesh's first B6 and B6-bwd calls against their plain versions
        on the same tensors with r, k and v in f32, at WKV_TOL (the tolerance
        ratio at most 1), and as captured (bf16 r, k, v; the parity phase's
        tolerances by output type)."""
        import torch

        from repro_torch.kernels.wkv import kernel, ref

        out = {}
        for phase, cap in self.captured.items():
            fargs, fkw = cap["fwd"]
            r, k, v, lw, u, state, chunk = fargs
            res = {"shape": list(r.shape), "dtype": str(r.dtype)[6:]}
            y, s_out, _ = kernel.wkv_forward(*fargs, **fkw)
            y_ref, s_ref = ref.wkv_chunked_ref(r, k, v, lw, u, state, chunk)
            bargs = cap["bwd"]
            br, bk, bv, blw, bu, bstate, _, _, dy, dstate, _ = bargs
            got = kernel.wkv_backward(*bargs)
            want = ref.wkv_bwd_ref(br, bk, bv, blw, bu, bstate, chunk, dy, dstate)
            tol = lambda x: WKV_BF16_TOL if x.dtype == torch.bfloat16 else WKV_TOL
            res["as_captured_tol_ratio"] = max(
                _tol_ratio(g.float(), w.float(), tol(g))
                for g, w in zip((y, s_out, *got), (y_ref, s_ref, *want)))
            # f32 r, k, v: the forward and its chunk states again, then the
            # backward of the captured cotangent
            f32 = [x.float() for x in (r, k, v)]
            y32, s32, states32 = kernel.wkv_forward(*f32, lw, u, state, chunk, save_states=True)
            y32_ref, s32_ref = ref.wkv_chunked_ref(*f32, lw, u, state, chunk)
            b32 = [x.float() for x in (br, bk, bv)]
            dy32 = dy.float()
            _, sb_out, states_b = kernel.wkv_forward(*b32, blw, bu, bstate, chunk,
                                                     save_states=True)
            got32 = kernel.wkv_backward(*b32, blw, bu, bstate, states_b, sb_out, dy32, dstate,
                                        chunk)
            want32 = ref.wkv_bwd_ref(*b32, blw, bu, bstate, chunk, dy32, dstate)
            ratios = [_tol_ratio(g, w, WKV_TOL) for g, w in
                      zip((y32, s32, *got32), (y32_ref, s32_ref, *want32))]
            res["f32_tol_ratio"] = max(ratios)
            res["f32_max_abs_err"] = max(float((g.double() - w.double()).abs().max())
                                         for g, w in zip((y32, s32, *got32),
                                                         (y32_ref, s32_ref, *want32)))
            res["within"] = res["f32_tol_ratio"] <= 1.0 and res["as_captured_tol_ratio"] <= 1.0
            res["tolerance"] = {"f32": WKV_TOL, "bf16_outputs": WKV_BF16_TOL}
            out[phase] = res
        return out


def elastic_rank(rank: int, world: int, work: str) -> int:
    """``chip_smoke.py --elastic-rank RANK WORLD DIR``: one gloo rank of
    train-elastic on cuda:0, through ``elastic_restart.flow`` with
    ``_ElasticHooks``; every collective gloo cannot run on CUDA tensors made
    to raise. Saves its results to DIR/rank{RANK}.pt (rank 0 also its whole
    weights' changes, DIR/deltas.pt)."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch import elastic_restart
    from test_torch_dist_util import _guard_collectives

    parent = os.getppid()

    def watch():  # a rank whose parent is gone (killed with its phase) ends
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    torch.cuda.set_device(0)
    forbidden = _guard_collectives()
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=ELASTIC_PG_TIMEOUT_S))
    hooks = _ElasticHooks(rank)
    args = _elastic_args(work)
    res = elastic_restart.flow(args, rank, torch.device("cuda"), hooks=hooks)
    out = {"phases": hooks.phases, "parity": hooks.wkv_parity(), "step": res["step"],
           "restored_step": res["restored_step"], "save_s": res["save_s"],
           "restore_s": res["restore_s"], "fallbacks": res["fallbacks"],
           "backend": dist.get_backend(), "forbidden": list(forbidden)}
    for phase, losses in res["losses"].items():
        out["phases"][phase].update(losses=losses, grad_norms=res["grad_norms"][phase])
    if rank == 0:
        with open(os.path.join(work, "ck", f"step_{args.steps:08d}", "manifest.json")) as f:
            out["manifest"] = json.load(f)
        torch.save(hooks.deltas, os.path.join(work, "deltas.pt"))
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    return 0


def _wkv_work(b, t, h, kd, vd, c, bwd):
    """(f32 operations, exponentials) a WKV call does at these shapes: a
    multiply-add counts 2, every other arithmetic operation 1."""
    nc, pairs = t // c, c * (c - 1) // 2
    if not bwd:
        per_chunk = (pairs * kd * 3 + c * vd * (2 * kd + (c - 1) + 2) + kd * vd * (2 * c + 1)
                     + 3 * c * kd + 2 * c * kd)
        exps = pairs * kd + 2 * c * kd + kd
    else:
        per_chunk = (pairs * kd * 3 + 2 * (pairs + c) * vd + c * vd * (2 * kd + (c - 1) + 2)
                     + 2 * c * kd * (2 * vd + 3 * (c - 1) / 2 + 3) + kd * vd * (2 * c + 3)
                     + 8 * c * kd + 4 * c * kd)
        exps = 3 * pairs * kd + 4 * c * kd + kd
    return b * h * nc * per_chunk, b * h * nc * exps


def kernel_rows_wkv(captured, launches, b6_kernels, b6_bwd_kernels):
    """B6's and B6-bwd's rows of the kernels line, at the first calls the
    train phase made (the training shape, bf16 r/k/v), with their kernels as
    the parity phase profiled them."""
    import torch

    from repro_torch.kernels.wkv import kernel, ref

    fargs, fkw = captured["fwd"]
    r, k, v, lw, u, state, chunk = fargs
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    y, s, states = kernel.wkv_forward(*fargs, **fkw)
    y_ref, s_ref = ref.wkv_chunked_ref(r, k, v, lw, u, state, chunk)
    # the first backward call is the last layer's: its own inputs
    bargs = captured["bwd"]
    br, bk, bv, blw, bu, bstate, _, _, dy, dstate, _ = bargs
    got = kernel.wkv_backward(*bargs)
    want = ref.wkv_bwd_ref(br, bk, bv, blw, bu, bstate, chunk, dy, dstate)
    # each output against its plain version relative to the plain version's
    # norm: the gradients here are of order 1e-6, below any absolute limit
    rel = {name: _rel_norm_err(g, w) for name, g, w in zip(
        ("y", "state", "dr", "dk", "dv", "dlw", "du", "dstate"),
        (y, s, *got), (y_ref, s_ref, *want))}
    kinds = {name: "bf16" if x.dtype == torch.bfloat16 else "f32"
             for name, x in zip(rel, (y, s, *got))}
    f_err = max(float((y.float() - y_ref.float()).abs().max()), float((s - s_ref).abs().max()))
    f_rel = float(((y.float() - y_ref.float()).abs() / y_ref.float().abs().clamp(min=1.0)).max())
    b_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    bad = {n: e for n, e in rel.items() if e > WKV_REL_NORM_TOL[kinds[n]]}
    if bad:
        raise AssertionError(f"WKV on the training path's tensors, relative norm errors {bad}")

    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs if x is not None)

    # what the functions must move: their inputs and outputs; the chunk
    # states B6 writes for B6-bwd are this design's choice (B6-bwd could
    # compute them again) and are counted apart
    states_bytes = nbytes(states)
    f_bytes = nbytes(r, k, v, lw, u, state, y, s)
    b_bytes = nbytes(br, bk, bv, blw, bu, bstate, dy, dstate, *got)
    f_ops, f_exps = _wkv_work(b, t, h, kd, vd, chunk, bwd=False)
    b_ops, b_exps = _wkv_work(b, t, h, kd, vd, chunk, bwd=True)
    shape = (f"r/k/v ({b}, {t}, {h}, {kd}) {str(r.dtype)[6:]}, lw f32, state f32, "
             f"chunk {chunk}")
    rows = []
    for name, src, replaces, calls, plain, err, nb, ops, exps in (
            ("wkv", "src/repro_torch/csrc/wkv.cu", "src/repro/kernels/wkv/wkv.py:26",
             [lambda: kernel.wkv_forward(*fargs, **fkw)] * 8,
             [lambda: ref.wkv_chunked_ref(r, k, v, lw, u, state, chunk)] * 2,
             f_err, f_bytes, f_ops, f_exps),
            ("wkv_bwd", "src/repro_torch/csrc/wkv_bwd.cu", "src/repro/models/ssm.py:86",
             [lambda: kernel.wkv_backward(*bargs)] * 8,
             [lambda: ref.wkv_bwd_ref(br, bk, bv, blw, bu, bstate, chunk, dy, dstate)] * 2,
             b_err, b_bytes, b_ops, b_exps)):
        bytes_ms = 1e3 * nb / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / F32_FLOPS
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "launches_per_step": launches[name] / TRAIN_STEPS,
            "max_abs_err": err, "shape": shape + (", save_states" if name == "wkv" else ""),
            "tolerance": {"rel_norm": WKV_REL_NORM_TOL},
            "ms": device_ms(calls), "host_ms": eager_ms(calls),
            "plain_ms": device_ms(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": nb, "bound_bytes_ms": bytes_ms, "f32_ops": ops,
            "bound_ops_ms": ops_ms, "exponentials": exps,
            "states_bytes": states_bytes,
            "bound_with_states_ms": max(1e3 * (nb + states_bytes) / HBM_BYTES_PER_S, ops_ms),
            "rel_norm_err": {n: e for n, e in rel.items()
                             if (n in ("y", "state")) == (name == "wkv")},
            "library_ms": None, "library": "none: no single PyTorch call computes WKV6",
        })
    rows[0]["max_rel_err_y"] = f_rel  # y is bf16: one rounding step is 2^-8 to 2^-7
    # B6 is two kernels a call: their device times from one profiled run of
    # 8 calls at the training shape (the parity phase's full_bf16 case; the
    # kernels' work does not depend on the values), the bytes this design
    # moves (the state pass reads k, v, lw and s0 and writes the chunk
    # states and s_out; the output pass reads r, k, v, lw, u and the chunk
    # states and writes y), and the build's registers and CTAs per SM
    design = nbytes(k, v, lw, state, states, s) + nbytes(r, k, v, lw, u, states, y)
    rows[0].update({
        **b6_kernels,
        "kernel_ms_shape": "the parity phase's full_bf16 case (the training shape)",
        "design_bytes": design,
        "design_bytes_ms": 1e3 * design / HBM_BYTES_PER_S,
        "build": kernel.wkv_forward_info(kd, vd, chunk, r.dtype),
    })
    # B6-bwd is three kernels a call, timed and counted as B6's; the bytes
    # its design moves: the state-gradient pass reads r and lw once and dy
    # once per 32 rows of K, the state cotangent, and writes the state
    # gradients (the chunk states' size) and ds0; the gradient pass reads r,
    # k, v, lw, dy, u, the chunk states twice (each chunk's start, and its
    # end for g_last: the next chunk's start or the final state) and the
    # state gradients, and writes dr, dk, dv, dlw and du's partials (one f32
    # a chunk and column of K), which du's sum reads once to write du
    ds0 = got[5]
    partials = 4 * b * h * (t // chunk) * kd
    k_blocks = -(-kd // 32)
    design = (nbytes(br, blw, dstate, ds0) + states_bytes + k_blocks * nbytes(dy)
              + nbytes(br, bk, bv, blw, dy, bu, *got[:4]) + 3 * states_bytes
              + 2 * partials + nbytes(got[4]))
    rows[1].update({
        **b6_bwd_kernels,
        "kernel_ms_shape": "the parity phase's full_bf16 case (the training shape), "
                           "no state cotangent",
        "design_bytes": design,
        "design_bytes_ms": 1e3 * design / HBM_BYTES_PER_S,
        "build": kernel.wkv_backward_info(kd, vd, chunk, r.dtype),
        "replaces_note": ("no TPU kernel: jax.grad cannot enter wkv_pallas, so the "
                          "reference trains through the jnp wkv_chunked"),
    })
    return rows


# ---------------------------------------------------------------------------
# roofline: the dry-run on the host, and its prediction of a step on the card
# ---------------------------------------------------------------------------
# (arch, shape, mesh) cells of the host part: a train, a prefill and a decode
# cell, rwkv6-3b's train_4k on both meshes
ROOFLINE_CELLS = (("rwkv6-3b", "train_4k", "single"), ("rwkv6-3b", "train_4k", "multi"),
                  ("olmoe-1b-7b", "prefill_32k", "single"),
                  ("mistral-nemo-12b", "decode_32k", "single"))
ROOFLINE_BATCH, ROOFLINE_LAYERS, ROOFLINE_STEPS = 4, 2, 3  # the card part's cuts
ROOFLINE_MEMORY_RATIO = (0.5, 2.0)  # (predicted args + temp) / measured peak
CARD_BYTES = 80e9


def phase_roofline_host():
    """The dry-run on ROOFLINE_CELLS on this host's CPU (meta tensors, a
    fake process group of 256 or 512 ranks, nothing on the card), each
    cell's record under SCRATCH/dryrun; a line per cell with the H100
    roofline's terms. Returns the lines. It runs at a lower priority than
    the serving phases beside it: they are bound by the host, it is not
    timed."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import H100, roofline_terms

    os.nice(10)

    out_dir = os.path.join(SCRATCH, "dryrun")
    lines = []
    for arch, shape, mesh in ROOFLINE_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_and_save(arch, shape, mesh, out_dir=out_dir)
        if rec["status"] != "ok":
            raise AssertionError(f"the dry-run of {arch} {shape} {mesh}: {rec.get('error')}")
        mem, terms = rec["memory"], roofline_terms(rec, H100)
        per_device = mem["argument_bytes"] + mem["temp_bytes"]
        line = {"arch": arch, "shape": shape, "mesh": rec["mesh"], "status": rec["status"],
                "n_devices": rec["n_devices"], "seconds": time.perf_counter() - t0,
                "gib_per_device": per_device / 2**30, "fits_80gb": per_device <= CARD_BYTES,
                "flops_per_device": rec["cost"]["flops"],
                "bytes_accessed_per_device": rec["cost"]["bytes_accessed"],
                "wire_bytes": rec["collectives"]["total_wire_bytes"],
                "hw": H100.name, **{k: terms[k] for k in (
                    "compute_s", "memory_s", "collective_s", "bound", "useful_flops_ratio",
                    "roofline_fraction")}}
        emit({"phase": "roofline-host", **line})
        lines.append(line)
    return lines


def _storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors of ``tree``."""
    import torch
    from torch.utils._pytree import tree_leaves

    seen = {}
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            st = t.untyped_storage()
            seen[st.data_ptr(), st.device] = st.nbytes()
    return sum(seen.values())


def phase_roofline(host_cells):
    """rwkv6-3b's train step at full width on a one-rank mesh on the card,
    held against the dry-run's prediction of the same step on meta
    (``dryrun._lower_and_measure``); returns B6's and B6-bwd's launches."""
    import gc

    import torch

    from repro_torch.dist import meshes
    from repro_torch.launch import dryrun
    from repro_torch.models import model_zoo
    from repro_torch.roofline.analysis import H100
    from repro_torch.train.optimizer import OptConfig, adamw_init, make_train_step

    full = _published(TRAIN_ARCH, TRAIN_FIELDS, TRAIN_WIDTH)
    cfg = dataclasses.replace(full, n_layers=ROOFLINE_LAYERS)
    cell = model_zoo.SHAPES["train_4k"]
    shape = dataclasses.replace(cell, global_batch=ROOFLINE_BATCH)
    cuts = {"global_batch": [cell.global_batch, shape.global_batch],
            "n_layers": [full.n_layers, cfg.n_layers]}
    print(f"roofline: {TRAIN_ARCH} train_4k cut: batch {cell.global_batch} -> "
          f"{shape.global_batch} rows, depth {full.n_layers} -> {cfg.n_layers} layers, "
          f"{shape.seq_len} positions", flush=True)

    t0 = time.perf_counter()
    pred = dryrun._lower_and_measure(cfg, shape, meshes.AbstractMesh((1, 1), ("data", "model")),
                                     remat=TRAIN_REMAT)
    predict_s = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    mesh = meshes.make_host_mesh(device="cuda")
    if mesh.size() != 1:
        raise AssertionError(f"the roofline step needs a one-rank mesh, got {mesh.shape}")
    ocfg = OptConfig()
    params, _ = model_zoo.init_params(cfg, seed=0, device="cuda",
                                      dtype=getattr(torch, cfg.param_dtype))
    opt = adamw_init(params, ocfg)
    batch = model_zoo.demo_batch(cfg, shape.global_batch, shape.seq_len, device="cuda")
    card_args = _storage_bytes((params, opt, batch))
    step = make_train_step(model_zoo.loss_fn(cfg, remat=TRAIN_REMAT, wkv_impl="kernel"), ocfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    times, losses = [], []
    with meshes.use_mesh(mesh):
        for _ in range(1 + ROOFLINE_STEPS):
            t = time.perf_counter()
            _, _, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(metrics["loss"])
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    del params, opt, batch, step, metrics
    gc.collect()
    torch.cuda.empty_cache()

    step_s = statistics.median(times[1:])
    mem = pred["memory"]
    compute_s = pred["cost"]["flops"] / H100.peak_flops
    memory_s = pred["cost"]["bytes_accessed"] / H100.hbm_bw
    # MODEL_FLOPS (analysis.model_flops) of the cut step, at the bf16 peak
    model_s = 6.0 * cfg.n_active_params() * shape.global_batch * shape.seq_len / H100.peak_flops
    ratio = (mem["argument_bytes"] + mem["temp_bytes"]) / (peak - base)
    record = {
        "phase": "roofline", "arch": TRAIN_ARCH, "shape": "train_4k", "cuts": cuts,
        "mesh": list(mesh.shape), "hw": H100.name, "nvidia_smi": nvidia_smi(),
        "predicted": {**pred["memory"], **pred["cost"], "seconds_on_meta": predict_s},
        "card": {"argument_bytes": card_args, "peak_bytes": peak - base,
                 "max_memory_allocated": peak, "allocated_before": base,
                 "step_s": times[1:], "warm_step_s": times[0], "median_step_s": step_s,
                 "losses": losses},
        "compute_s": compute_s, "memory_s": memory_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        # analysis.roofline_terms' fraction at the modeled step (the larger
        # term), and at the measured one; the larger term over the step
        "roofline_fraction": model_s / max(compute_s, memory_s),
        "measured_fraction": model_s / step_s,
        "bound_over_step": max(compute_s, memory_s) / step_s,
        "memory_ratio": ratio, "memory_ratio_limits": list(ROOFLINE_MEMORY_RATIO),
        "launches": {k: launches[k] for k in ("wkv", "wkv_bwd")},
        "host_cells": host_cells,
    }
    emit(record)
    if mem["argument_bytes"] != card_args:
        raise AssertionError(f"predicted argument bytes {mem['argument_bytes']}, "
                             f"the card's {card_args}")
    if not ROOFLINE_MEMORY_RATIO[0] <= ratio <= ROOFLINE_MEMORY_RATIO[1]:
        raise AssertionError(f"predicted args + temp over the measured peak: {ratio}")
    if step_s < compute_s:
        raise AssertionError(f"a step of {step_s} s is shorter than the compute term "
                             f"{compute_s} s: the flop count is wrong")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    want = {"wkv": 2 * cfg.n_layers * len(times), "wkv_bwd": cfg.n_layers * len(times)}
    if record["launches"] != want:
        raise AssertionError(f"B6/B6-bwd launches {record['launches']}, expected {want}")
    return record["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))  # the paged-attention parity cases
    import repro_torch  # noqa: F401  (fails where the repository is absent)

    if sys.argv[1:2] == ["--hybrid-gather"]:  # serve-hybrid's gather run
        return hybrid_gather_child(sys.argv[2])
    if sys.argv[1:2] == ["--beside"]:  # a phase in a process of its own
        return run_beside(sys.argv[2])
    if sys.argv[1:2] == ["--sharded-rank"]:  # one gloo rank of train-sharded
        return sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--elastic-rank"]:  # one gloo rank of train-elastic
        return elastic_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--serve-rank"]:  # one gloo rank of serve-sharded
        return serve_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})
    os.makedirs(SCRATCH, exist_ok=True)
    try:
        phase_build()
        phase_parity_strider()
        phase_parity_glm()
        phase_parity_sgd_chunk()
        phase_parity_projected()
        phase_parity_predict()
        phase_parity_paged_attn()
        wkv_kernels = phase_parity_wkv()
        heap, engine, res, launches = phase_e2e()
        db, predict_launches = phase_predict(heap, res)
        rows = phase_kernels(heap, engine, res, launches, db, predict_launches)
        del heap, engine, res, db
        # train-sharded (its 4 ranks, ~3 GB) runs through both serving
        # stages: bound by gloo's latency, it takes about as long as they do.
        # lm-predict (30 GB at its peak), serve-rwkv (9 GB), serve-vlm (17 GB)
        # and the examples (5 GB) beside serve-mla (5 GB)
        sharded = _phase_beside("train-sharded")
        lm, rwkv, vlm, examples = (_phase_beside(name) for name in (
            "lm-predict", "serve-rwkv", "serve-vlm", "examples"))
        try:
            mla_captured, mla_launches = phase_serve_mla()
            lm_launches, lm_b3, lm_timing = _join_beside(lm)
            _join_beside(rwkv)
            vlm_captured, vlm_launches = _join_beside(vlm)
            examples_result = _join_beside(examples)
        except BaseException:
            _stop_beside(lm, rwkv, vlm, examples, sharded)
            raise
        # serve-moe (17 GB) and serve-hybrid (6 GB and its gather run's 5)
        # beside serve and launch (16 and 25 GB)
        # and the dry-run on the host's CPU (no card)
        try:
            moe, hybrid = _phase_beside("serve-moe"), _phase_beside("serve-hybrid")
            roof = _phase_beside("roofline-host")
        except BaseException:
            _stop_beside(sharded)
            raise
        try:
            captured, serve_launches = phase_serve()
            phase_launch_serve()
            moe_captured, moe_launches = _join_beside(moe)
            hybrid_captured, hybrid_launches = _join_beside(hybrid)
            roofline_cells = _join_beside(roof)
            sharded_result = _join_beside(sharded)
        except BaseException:
            _stop_beside(moe, hybrid, roof, sharded)
            raise
        # B2's one-batch gradient is on the sharded path: its launches there
        b2_row = next(r for r in rows if r["name"] == "glm_grad")
        b2_row["e2e_launches"] = b2_row["launches"]
        b2_row["launches_per_rank"] = sharded_result["glm_grad_launches_per_rank"]
        b2_row["launches"] = sum(b2_row["launches_per_rank"])
        b2_row["sharded_parity"] = sharded_result["parity"]
        # the kernels line's times, with no other process on the card
        rows.append(kernel_row_paged_attn(captured, serve_launches, mla_captured, mla_launches,
                                          hybrid_captured, hybrid_launches, moe_captured,
                                          moe_launches, vlm_captured, vlm_launches))
        del captured, mla_captured, hybrid_captured, moe_captured, vlm_captured
        b3_row = next(r for r in rows if r["name"] == "strider_decode_projected")
        b3_row["launches"] += lm_launches
        b3_row["lm_scan"] = dict(lm_b3, **lm_scan_times(lm_timing), launches=lm_launches)
        del lm_timing
        wkv_calls, train_launches = phase_train()
        phase_train_parity()
        phase_train_mla()
        phase_train_hybrid()
        phase_train_moe()
        phase_train_encdec()
        phase_decode_encdec()
        phase_train_vlm()
        phase_launch_train()
        roofline_launches = phase_roofline(roofline_cells)
        # LM training on a mesh of 4 gloo ranks, then the sharded server's 4
        # ranks, each alone on the card
        elastic = phase_train_elastic()
        sharded_serve = phase_serve_sharded()
        # B5 at the sharded server's per-rank call, timed alone on the card
        b5_row = next(r for r in rows if r["name"] == "paged_attn")
        b5_row["sharded"] = _paged_attn_call(sharded_serve["capture"])
        b5_row["sharded"].update(
            launches_per_rank=sharded_serve["launches_per_rank"],
            library=("composite, no single call: gather k_pool[table], v_pool[table] + "
                     "F.scaled_dot_product_attention(attn_mask=valid rows, enable_gqa)"))
        b5_row["launches"] += sum(sharded_serve["launches_per_rank"])
        del sharded_serve
        # B5 at internlm2-20b's full width (serve_lm), timed alone on the card
        b5_row["examples"] = _paged_attn_call(examples_result["b5_capture"])
        b5_row["examples"].update(
            launches=examples_result["b5_launches"], argv=EXAMPLES_SERVE_ARGV,
            library=("composite, no single call: gather k_pool[table], v_pool[table] + "
                     "F.scaled_dot_product_attention(attn_mask=valid rows, enable_gqa)"))
        del examples_result["b5_capture"]
        rows.extend(kernel_rows_wkv(wkv_calls, train_launches, *wkv_kernels))
        # B6 and B6-bwd on the mesh path: each rank's launches and its calls'
        # parity at its own shape
        for row in rows:
            if row["name"] in ("wkv", "wkv_bwd"):
                row["roofline_launches"] = roofline_launches[row["name"]]
                row["elastic"] = {
                    "launches_per_rank": {mesh: per[row["name"]] for mesh, per in
                                          elastic["launches_per_rank"].items()},
                    "parity_per_rank": elastic["parity"]}
            if row["name"] == "strider_decode":
                row["elastic_launches_per_rank"] = {
                    mesh: per["strider_decode"]
                    for mesh, per in elastic["launches_per_rank"].items()}
            # the example drivers' launches, by driver (serve_lm's full-width run
            # under its argv's own key)
            if row["name"] in EXAMPLES_ROWS:
                per = {driver: launches[row["name"]]
                       for driver, launches in examples_result["launches"].items()}
                row["examples_launches"] = per
                row["launches"] += sum(per.values())
        emit({"kernels": rows})
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
