#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mapdit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the final line:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc for sm_90a of every CUDA source, from this checkout;
  3. kernels: every kernel wrapper against its plain PyTorch version at the
     DiT-S/2 sampling shapes in bf16 (64 CFG rows x 64 tokens, D=384,
     6 heads, H=1536, depth 12), with times, bounds and a library yardstick;
     then the attention half-block's wrappers and sub-kernels (rows 3, 4
     and 5, one launch each of csrc/attn_branch.cu, beside their launch
     sequences at S/2 and XL/2, row 5 on draws of its own, and checked at
     BRANCH_BWD_SHAPES, T=48 taking the sequence route, its backward held
     to the plain version; the dW pair against
     the f32 pair; the A.W products, the out product with the residual
     backward as its epilogue, the residual-mode attention, the backward's
     other kernels) and fused_dit_block's gradient at the DiT-S/2 training
     shapes (256 samples x 64 tokens, bf16);
  4. forward: DiT-S/2 forward_with_cfg, kernel paths against the plain path;
  5. chain: a short CFG chain, kernel path against the plain path; then the
     headline chain (build_sample_fn, block_kernel="auto" with a batch hint,
     250 DDPM steps, batch 32 x 2, CFG 1.5), launch counts read around it:
     exactly one dit_stack launch a model call (STEPS) and no mp_gemm or
     cosine_attention launch; then the per-block path (no batch hint), one
     dit_stack launch a block;
 5b. samplers: on the same weights, short chains of ddim (eta 0 and 1),
     dpm++ (karras10), unipc, ddpm with limited-interval guidance (its
     guided and cond-only calls counted apart) and dpm++ with dynamic
     thresholding, each through auto with a batch hint, and the ddpm chain
     with span caching (per block), each held to the float32 plain chain
     with exact launch counts; then ddim 50, dpm++ 20 and unipc 20 timed
     (three chains each, after a warm-up) beside the headline;
 5c. parallel-in-time ddim (build_pit_sample_fn) on the same weights at 8 x
     2 CFG rows, clipped ddim 50, window 10, through auto (one dit_stack
     launch a sweep over 160 rows, exact counts 50 / 59 / 25 / 29): the
     exact schedules (block J=10, slide S=1) held to the f32 plain
     sequential ddim chain by check_paths' rule and to the kernels' own
     sequential chain within phase 8c's bucket limit (same bits
     reported); the accelerated ones (block J=5, slide S=2) held to the
     f32 plain chain of their schedule, their distance from the sequential
     chain printed; each chain's ms beside sequential ddim 50 at the same
     rows, the dit_stack workspace of a sweep (stack_plan) and the
     allocation peak;
 5d. bench: mapdit_tpu_torch.bench.main in process for ddim 50, dpm++ 20,
     unipc 20, dpm++ 20 karras, ddpm 250 with the cfg interval 0.3-3.0,
     the span cache at interval 2 in both modes, --input-size 32 (auto
     resolves to the plain path; and again with --block-kernel
     mega_stack, T = 256 on dit_stack) and train mode with --grad-accum 4
     at batch 256 on mega_attn: each JSON line, exact launch counts (phase
     5b's one dit_stack a model call; the cached chain one a block it
     runs; none at 32 x 32 on auto, one dit_stack a model call on
     mega_stack; phase 6's a micro-batch);
  6. train: DiT-S/2 train steps at batch 256 on synthetic latents, the plain
     path and block_kernel="mega_attn" with attn_bwd "pallas" (rows 3 and 4
     one launch each a block, and again as their launch sequences) and
     "residual" (row 5 one launch a block, and again as its launch
     sequence): the first step's loss and gradients against the float32
     plain path, then timed steps with the launch counts read around them;
 6b. remat and scan_blocks: DiT-XL/2 (depth 28, width 1152, 16 heads,
     nothing cut) at batch 256, bf16, block_kernel="mega_attn" with
     attn_bwd "pallas": a train step with remat off and one with remat on,
     on the same weights and draws, loss and every gradient bit for bit;
     per side the allocation peak, ms a step and launches a step over three
     timed steps after the checked one (exact counts: under remat each
     block's forward kernels run twice); the remat kernel path held to the
     float32 plain path by check_paths' rule at XL_CHECK_BATCH rows (the
     float32 path at 256 rows does not fit beside the others). Then DiT-S/2
     at batch 256 in the scan_blocks layout on the per-block weights
     stacked: the step's loss and gradients (unstacked) bit for bit against
     the per-block layout, wrapper launches (exact) and device launches (the
     profiler) a step for both; the clipped 10-step chain through auto with
     a batch hint, one dit_stack launch a block and no whole-stack launch,
     bit for bit against the per-block layout's per-block chain; an explicit
     mega_stack under scan_blocks raises;
 6c. 32 x 32: DiT-S/2 at 32 x 32 latents (T = 256), batch 32, 3 timed
     steps a path after the checked one: the plain path, mega_attn with
     attn_bwd "pallas" (rows 3 and 4 past their one-launch kernels'
     T <= 64 run their launch sequences, with attention_bwd's form past
     T = 128 and out_gate_residual_bwd's tile-order sums) and mega (one
     dit_stack launch a block, the gradient recomputed through the
     reference math), each held to the float32 plain step by check_paths'
     rule, exact launch counts;
 6d. float32 on the whole-block kernels (f32_phase): a checked step on f32
     mega against bf16 mega (F32_CLOSER), the train CLI on mega at its
     default float32, sample on mega_stack, ddim chains, the f32 launch
     sequence as the stack's route, the f32 bench in turns;
 6e. float32 on the attention half-block kernels (f32_attn_phase): a
     checked step on f32 mega_attn with attn_bwd pallas and residual, each
     also as its launch sequences, against bf16 mega_attn (F32_CLOSER), the
     train CLI on mega_attn, sample on mega_attn, a checked step at 32 x 32;
 6f. float32 on row 9 (f32_pallas_phase): a checked step on f32 pallas with
     attention_impl pallas (mlp_branch_f32 and fused_attention's f32 form)
     against bf16 pallas (F32_CLOSER), the train CLI at its default float32
     on pallas, sample on pallas;
  7. families: DiT-B/2 (depth 12, width 768, 12 heads, nothing cut) on the
     generic block path, twice: P1, MaP adaln with block_kernel="pallas" and
     attention_impl="pallas" (fused_mlp_branch and fused_attention in every
     block), and P2, modulation="rotation_scale" with
     attention_impl="pallas" (fused_attention). Each: the first model call
     and a clipped 10-step chain against the float32 plain path, the
     100-step chain through build_sample_fn, and train steps at batch 256
     through make_train_step (first step's loss and gradients against the
     float32 plain path), launch counts read around each;
  8. train CLI: mapdit_tpu_torch.train.main at full DiT-S/2, batch 256, bf16,
     block_kernel="mega_attn", attn_bwd="pallas", on synthetic:1024, 12 steps
     with a checkpoint and EMA snapshots at step 8: run A uninterrupted; run
     B to step 8 and resumed to 12 (restored state bit for bit, losses of
     steps 9-12 against A's); run C as A with the dW products through
     dw_gemm (DW_IN_KERNEL_BUDGET raised; launch counts exact, losses
     against A's, steps/s of both); 4 steps with --grad-accum 4 --grad-clip
     1.0 (step-1 grad_norm against A's); the artifacts on disk;
 8b. sampling CLIs: on run A's experiment directory, with a random-weight
     VAE of the port's init written as .safetensors by the port's writer,
     mapdit_tpu_torch.sample (ddim 50 steps; ddpm 50 with
     --save-trajectory), sample_ema (dpm++ 20) and sample_fid (64 images,
     batch 32, 250 steps, CFG 1.5) in process with exact dit_stack launch
     counts; every PNG's chunks decoded, arr_0 uint8 NHWC; the VAE decode
     on the card held to the same module's f32 decode on the CPU (TF32 off,
     1e-4; then TF32 on, as the CLIs run outside the smoke, 1e-2);
 8c. serve: the server (mapdit_tpu_torch.serve, buckets 1, 4, 8, 32) on
     run A's experiment (its latent statistics set to mean 0, std 2**-24 in
     a copy, so the untrained chains' latents come back exactly scaled and
     unclipped), over real HTTP on an ephemeral port: the headline protocol
     (ddpm 250, CFG 1.5, 32 samples) with exactly one dit_stack launch a
     model call (its unclipped chain on untrained weights is non-finite, so
     its bits are not compared); the same request at ddpm 2, whose chain
     stays finite, bit for bit against build_sample_fn on the same z and
     generator; dpm++ 20 at CFG 4.0 (the default protocol), cached ddpm 2
     and cached dpm++ 20 at interval 2 bit for bit against their chain
     functions and held to the float32 plain chain by check_paths' rule,
     exact launch counts a batch; every compared output finite and inside
     (-1, 1); coalescing within a bucket bit for bit; bucket 1 against
     bucket 4 within dpm++ 20's limit; the device memory after the first
     program and after every program (growth below one folded weight
     copy); a VAE-decoded PNG from a server on run A itself; then 1, 4 and
     16 concurrent clients of 64 seeded one-sample requests each
     (requests/s, latency percentiles, batches, rows a batch, chain ms a
     batch, coalesced share, dit_stack launches a batch);
  8d. distill: progressive distillation of run A (mega_attn + pallas, the
     teacher its post-hoc EMA): one distill step at batch 256, CFG 1.5, 8 ->
     4 steps, on the kernel path against the float32 plain path (loss and
     gradients, check_paths' rule) on the same draws, its launch counts
     exact and printed beside phase 6's train step, ms a step (three runs
     after a warm-up), the teacher's tensors unchanged; then
     mapdit_tpu_torch.distill.main in process (2 stages of 4 steps, batch
     256, base 8, CFG 1.5, synthetic:1024): the stage directories' distill_*
     fields, the stage-1 teacher unchanged, the stage-2 teacher stage 1's
     raw student, steps/s from the log, exact launch counts; the 2-step
     student through mapdit_tpu_torch.sample at the requested ddpm 250
     (forced to ddim 2, cfg 1: two dit_stack launches on the 4 undoubled
     rows, finite, held to the float32 plain chain) and sample_fid (64
     images, exact counts); then served (buckets 1 and 4, statistics as in
     8c): a default-protocol request normalised onto ddim 2 at cfg 1, /info's
     distilled block, two dit_stack launches a batch, the served latents
     bit for bit against build_sample_fn on the student diffusion, finite;
  8e. data and the learning loop: download_data's encode (encode_batches)
     of 256 synthetic uint8 128 x 128 images at batch 128 through phase
     8b's random-weight VAE on the card, its first images held to the same
     module's f32 encode on the CPU (TF32 off 1e-4, then on 1e-2), images/s,
     the dataset written by save_dataset and read back by LatentDataset;
     the distribution probe (mapdit_tpu_torch.tools.distribution_probe) at
     the JAX package's CPU test budget (DiT-XS/4, input 8, 4 classes, 1024
     examples, 600 steps at batch 64, trained by the train CLI in a
     subprocess, bf16, mega_attn; 16 samples a class, dpm++ 10 through auto
     and dit_stack, exact launch counts for the trained and the init chain)
     at seeds 0, 1 and 2, each seed and its init baseline printed, the
     means over the seeds held to label_acc >= 0.5, mean_err <= 3.0,
     std_ratio <= 30 (one 600-step run's mean_err spreads over seeds across
     that limit, on the float32 plain path as on the kernels: PERF.md);
     the guidance sweep on run A (CFG 1.5; CFG 4.0
     with the interval 0.3:3.0; 64 samples, dpm++ 20, random-proj features,
     each point a sample_fid subprocess) against a cfg-1 reference set,
     every row finite; run_fid50k at 256 samples;
  9. XL: DiT-XL/2 (depth 28, width 1152, 16 heads, nothing cut) in bf16 on
     folded weights: the first model call (one dit_stack launch a block)
     and a clipped 10-step chain (one a model call) at batch 4 x 2 through
     block_kernel="auto" (the whole-block kernels) against the float32
     plain path;
 10. TP: two spawned ranks on the one card form a (1, 2) mesh over gloo
     (ranks sharing a card cannot use NCCL) and run the same clipped chain
     through build_sample_fn(mesh=) with block_kernel="mega_tp" and then
     "mega_attn_tp", each against the float32 plain chain, with exact launch
     counts per rank, each chain then run again warm and timed, and again
     for a float32 model on each island (the f32 instances of
     csrc/dit_block_tp.cu), each at least F32_CLOSER times closer to the
     float32 plain chain than the bf16 island's; then one
     gloo all-reduce of a (8, 64, 1152) f32 partial. The all-reduces pass
     through host memory: these are not NCCL tensor-parallel latencies.
     Then the same ranks as a (2, 1) mesh at DiT-S/2: the dp-sharded
     clipped ddpm chain (build_dp_sharded_sample_fn), each rank's rows the
     same bits as the one-device chain on them under its stream; PIT
     (block, full sweeps, one sample, window 10) with its rows split over
     the ranks against the unsharded PIT chain within phase 5c's limit;
     sample_fid in process on phase 8's run A with --kernel-sharding
     shard_map and with --pit-window 10, 16 images each, rank 0's npz;
     exact dit_stack launches per rank;
 10b. data-parallel training on the same two ranks as a (2, 1) mesh, on
     mega_attn + pallas: DiT-S/2 at the global batch 256, the 2-rank step
     against the one-card step from one seed (the float32 plain path at the
     CPU test's tolerances, the kernel path by check_paths' rule against the
     float32 one-card step), each rank's launches a step the one-card
     step's, every rank's weights, EMA copies and generator the same after
     3 steps; DiT-XL/2 at the global batch 64, DP and FSDP 3 steps each,
     FSDP's loss and grad_norm held to DP's, each rank's allocation peak and
     resident state beside the prediction; ms a step per rank and the gloo
     collectives' ms (through host memory: not NCCL); then the train CLI
     under torchrun (2 ranks, --fsdp true --checkpointer torch-sharded) at
     S/2, resumed on one process and sampled from its EMA snapshot;
 10c. multi-device serving on the same two ranks, each rank building the
     service through the entry point's build_service / build_server (rank 0
     serves HTTP and samples in process, rank 1 follows the lead's batch
     descriptors): (2, 1) on phase 8c's copy of run A (DiT-S/2, buckets 1, 2,
     4): /info's mesh, the default protocol (dpm++ 20, CFG 4.0) at 4 rows
     (each rank the one-device chain on two rows) and at 1 row (the whole
     batch on both ranks) held to the float32 plain chain by check_paths'
     rule, a dpm++ 20 request over HTTP, a cached ddpm 2 request on the data
     axis, 1 and 4 clients of 64 seeded one-sample requests (requests/s, p50,
     p95); (1, 2) on a DiT-XL/2 experiment written from phase 9's weights
     (auto -> mega_tp): a dpm++ 20 request at 4 x 2 rows held to the float32
     plain chain, a timed request, a cached request answered 400; every
     batch's launches on each rank exact and equal across the ranks; then
     build_sample_fn(mesh=) at DiT-B/2 rotation_scale with attention_impl
     pallas (the plain path, fused_attention on each rank's heads): the model
     call and a clipped 10-step chain against the float32 plain path, exact
     launches a rank; then the server's entry point under torchrun (2 ranks,
     --shard true): /info, a request, SIGTERM to the lead worker, every
     process exits 0. Gloo passes through host memory: not NCCL figures;
 10d. tensor-parallel training on the same two ranks as a (1, 2) mesh:
     DiT-XL/2 at full width, 16 global rows, 3 steps a path, the plain path
     on each rank's shards of the raw weights (the row norm of out-proj and
     fc2 summed over the ranks): the float32 step held against rank 0's
     one-card float32 step from the same weights (loss and grad_norm rtol
     1e-5, every parameter after step 1 at rtol 5e-4 / atol 5e-5 where its
     gradient settled), the bf16 step with attention_impl pallas
     (fused_attention on each rank's heads, exact launches) held by
     check_paths' rule against the float32 one-card step; resident GB a
     rank, ms a step, all-reduces a step; then the train CLI under torchrun
     (4 ranks, --n-model 2 --fsdp true --checkpointer torch-sharded, DiT-S/2)
     with a checkpoint mid-run, resumed on one process in process;
 11. the kernels JSON line, the device line again, and the ok line.
Phase 3 holds dit_stack (csrc/dit_stack.cu: the one persistent kernel of
fused_dit_stack and, at depth 1, fused_dit_block) at STACK_SHAPES (the S/2
headline call and fused_dit_block's on phase 3's S/2 draws, B/2 at 64 rows,
XL/2 at 8 rows and depth 28, T = 16, T = 4 at the XL head, an odd N, then
T = 256: S/2 at 64 rows and depth 12, its block at 32 rows, XL/2 at 8 rows
and depth 2, and a ragged T = 144)
against its plain version at 5e-2 + 5e-2 relative (S/2 at T = 64 and 256
also against float64, stack_witness), the same bits on two
runs, and, at S/2 and XL/2, the stack against a chain of depth-1
fused_dit_block calls bit for bit with every call of the chain held to
the plain block on the same stream; its rows are device times of CUDA-graph
replays with host ms and eager ms beside, and, at the chain shapes, the
launch sequence it replaced (stack_launch_sequence: mp_gemm and
cosine_attention, nine launches a block) graph-captured and eager, its
errors against the same plain version printed beside.
Phase 3 holds mp_gemm at the shapes of every path besides the S/2 sampling
sites (GEMM_SHAPES: the S/2 training backward's products with W read as
(K, N), row 9's pair at B/2, DiT-XL/2 on one card with its M=8 modulation
product, a ragged shape off every tile edge), each split-K shape run twice
for the same bits, its times the device time of CUDA-graph replays with the
wrapper's host time beside; the gradients of fused_dit_block,
fused_attention and fused_mlp_branch are held to autograd of the float32
reference (GRAD_TOL) and, bit for bit, to autograd of the reference they
recompute in the inputs' types. Phase 3 also holds attention_bwd at
ATTN_BWD_SHAPES (S/2 on the backward's own inputs, B/2's 12 heads, the XL
head of 72, odd N, the ragged T=16 and T=4, T=96, and the form past
T = 128 at T=256 (hd 64 and 72) and T=144; the same bits on two runs;
T=257 must raise), the passes around the backward's products
(modulate_fwd, modulate_bwd) at MODULATE_SHAPES (S/2 on the backward's own
tensors, the B/2 and XL/2 widths, odd N, T=16, T=4; every output the same
bits on two runs; D=388 must raise), the out product with the residual
backward as its epilogue (out_gate_residual_bwd, csrc/mp_gemm.cu) at
OUT_GATE_SHAPES (the same shapes, the split-K ones among them, and tiles
holding T=16, 128, 4 and a last partial tile, then T = 256, 48 and 144,
whose samples span row tiles; dout and dgate against the plain version,
the same bits on two runs; T=6 must raise) and attn_bwd at
BRANCH_BWD_SHAPES (the B/2 and XL/2 widths, odd N, T=16, T=4), dw_gemm
(the S/2 and B/2 training shapes and a
ragged M, the same bits on two runs) and attn_bwd with the dW switch on
(seven cotangents, no f32 matmul left), and fused_attention at FUSED_SHAPES (B/2
sampling and training shapes on the model's strided views, the XL head
width 72, T=256, without the cosine normalisation at logits past 88 in f32
and bf16, the ragged T=16 and T=4) and fused_mlp_branch (row 9: one launch
of mlp_branch, csrc/dit_block_tp.cu; N=64 and 256 timed beside its former
two-launch route mlp_launch_sequence and the library pair, graph, host and
eager ms, one device operation a call (the nodes of a captured CUDA graph);
T=4, 16, 256, the S/2 and XL/2 widths and an odd count of row tiles
checked, the same bits twice) and their gradients against
their plain versions, and the three tensor-parallel partial kernels
(attn_tp_partial, block_tp_attn, mlp_tp_partial) at the DiT-XL/2 shard
shapes of tp=2 and tp=4 (8 rows x 64 tokens); last, cosine_attention at
COSINE_SHAPES (DiT-XL/2 heads of 72, its tensor-parallel shards, an odd N,
T=256 in both modes, the ragged T=16 and T=4). The attention rows are device times of CUDA-graph
replays. Then the f32 forms, each held to its f32 plain version at F32_TOL
with TF32 off: mp_gemm_f32, cosine_attention_f32 and dit_stack's f32
instances; rows 3, 5 and 4's f32 instances and their sequences' kernels;
and the f32 instances of csrc/dit_block_tp.cu (f32_tp_rows: rows 6-8 at
the XL/2 shards, row 9 at B/2, each one launch and one device operation a
call, timed beside its f32 launch sequence).
Weights are random, drawn from a seed. Needs no network and one card.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
MODEL = "DiT-S/2"
BATCH = 32  # pre-CFG samples; 64 rows per model call
STEPS = 250
CFG_SCALE = 1.5
TRAIN_BATCH = 256
TRAIN_STEPS = 10  # timed train steps per path, after the checked first step
FAMILY_MODEL = "DiT-B/2"
FAMILY_TRAIN_STEPS = 3  # timed DiT-B/2 train steps per path
FAMILY_STEPS = 100  # DDPM steps of each DiT-B/2 chain
CLI_STEPS = 12  # steps of each full run of the train CLI
CLI_CKPT_STEP = 8  # its checkpoint and EMA snapshots; run B stops and resumes here
# tag: (the family's flags, the kernels its blocks run)
FAMILIES = {
    "P1": (dict(), dict(block_kernel="pallas", attention_impl="pallas")),
    "P2": (dict(modulation="rotation_scale"), dict(block_kernel="off", attention_impl="pallas")),
}
XL_MODEL = "DiT-XL/2"
XL_BATCH = 4  # pre-CFG samples; 8 rows per model call
XL_CHECK_STEPS = 10  # clipped chain held to the float32 plain path, then run again warm and timed
# phase 5b: each sampler's short chain held to the float32 plain path:
# name -> (respacing, build_sample_fn arguments)
SAMPLER_CHECKS = {
    "ddim-eta0": ("ddim10", dict(sampler="ddim", eta=0.0, clip_denoised=True)),
    "ddim-eta1": ("ddim10", dict(sampler="ddim", eta=1.0, clip_denoised=True)),
    "dpm++": ("karras10", dict(sampler="dpm++", clip_denoised=True)),
    "unipc": ("10", dict(sampler="unipc", clip_denoised=True)),
    "ddpm-cfg-interval": ("10", dict(sampler="ddpm", cfg_interval=(0.3, 3.0), clip_denoised=True)),
    "dpm++-threshold": ("10", dict(sampler="dpm++", dynamic_threshold=0.995)),
}
CACHE_INTERVAL = 2  # the cached ddpm chain of phase 5b (forecast mode, the default span)
# the timed chains of phase 5b: name -> (respacing, sampler)
SAMPLER_TIMES = {"ddim-50": ("ddim50", "ddim"), "dpm++-20": ("karras20", "dpm++"), "unipc-20": ("20", "unipc")}
SAMPLER_TIME_RUNS = 3  # timed chains of each (steps/s from the fastest; all printed)
# phase 5c: parallel-in-time ddim on the headline's weights: PIT_BATCH x 2
# CFG rows, clipped ddim PIT_STEPS, window PIT_WINDOW; name -> (schedule,
# model calls, exact). The exact schedules are held to the sequential chain,
# the accelerated ones to the f32 plain chain of their own schedule.
PIT_BATCH, PIT_STEPS, PIT_WINDOW = 8, 50, 10
PIT_SCHEDULES = {
    "block-J10": (dict(sweeps=10), 50, True),
    "slide-S1": (dict(shift=1), 59, True),
    "block-J5": (dict(sweeps=5), 25, False),
    "slide-S2": (dict(shift=2), 29, False),
}
PIT_TIME_RUNS = 2  # timed chains of each, after a warm-up
PIT_FID_BATCH = 128  # sample_fid's default batch: the workspace its PIT sweeps take is printed
# phase 5d: mapdit_tpu_torch.bench in process; tag -> flags (each sample
# chain runs once to warm up and BENCH_REPEATS times timed)
BENCH_REPEATS = 2
BENCH_RUNS = {
    "ddim-50": ["--sampler", "ddim", "--steps", "50"],
    "dpm++-20": ["--sampler", "dpm++", "--steps", "20"],
    "unipc-20": ["--sampler", "unipc", "--steps", "20"],
    "dpm++-20-karras": ["--sampler", "dpm++", "--steps", "20", "--time-schedule", "karras"],
    "ddpm-250-cfg-interval": ["--cfg-interval", "0.3", "3.0"],
    "ddpm-250-cache-2-forecast": ["--cache-interval", "2"],
    "ddpm-250-cache-2-hold": ["--cache-interval", "2", "--cache-mode", "hold"],
    "ddpm-50-input-32": ["--input-size", "32", "--steps", "50"],
    "ddpm-50-input-32-mega-stack": ["--input-size", "32", "--steps", "50", "--block-kernel", "mega_stack"],
    "train-accum-4": ["--mode", "train", "--grad-accum", "4", "--batch", "256", "--resident-data", "--steps", "10",
                      "--block-kernel", "mega_attn"],
}
# phase 10's data-parallel part on a (2, 1) mesh: the dp-sharded clipped
# ddpm chain over DP_BATCH un-doubled samples, PIT (block, full sweeps) on
# one sample, and sample_fid's two layouts at DP_FID_IMAGES images each
DP_BATCH, DP_STEPS, DP_FID_IMAGES = 16, 10, 16
# phase 10b: data-parallel training on the (2, 1) mesh of two ranks sharing
# the card, mega_attn + pallas: DiT-S/2 at the global batch TRAIN_BATCH
# against the one-card step, DP_TRAIN_STEPS steps; DiT-XL/2 DP and FSDP at
# DP_XL_BATCH rows, DP_TRAIN_STEPS steps each; the train CLI under torchrun
# at S/2 (--fsdp true --checkpointer torch-sharded), DP_CLI_STEPS steps with
# a checkpoint at DP_CLI_CKPT, then resumed on one process to DP_CLI_RESUMED
DP_TRAIN_STEPS, DP_XL_BATCH = 3, 64
DP_CLI_STEPS, DP_CLI_CKPT, DP_CLI_RESUMED = 6, 4, 8
# a rank's resident state (f32 params, two Adam moments, two EMA copies) at
# XL/2's 674,364,745 parameters on two ranks: 5 x 2.697 GB, halved under FSDP
DP_XL_RESIDENT_GB = {"dp": 13.49, "fsdp": 6.74}
# the 2-rank step against the one-card step on the float32 plain path: the
# CPU test's tolerances (tests/torch_dp_train_ranks.py), the same sums in
# another order (on the bf16 kernel path the kernels' roundings differ at 128
# rows and 256, so that path is held by check_paths' rule against the
# float32 one-card step); FSDP's later steps against DP's on parameters that
# differ by those sums
DP_METRIC_RTOL, DP_GRAD_ATOL, DP_PARAM_ATOL, DP_LATER_RTOL = 1e-5, 1e-5, 1e-5, 1e-4
# phase 10d: tensor-parallel training on the (1, 2) mesh of two ranks sharing
# the card: DiT-XL/2 at TP_TRAIN_ROWS global rows, TP_TRAIN_STEPS steps a path
# (float32 plain, bf16 with attention_impl pallas), each against rank 0's
# one-card step; then the train CLI under torchrun at S/2 on four ranks
# (--n-model 2 --fsdp true --checkpointer torch-sharded) at TP_CLI_BATCH rows,
# DP_CLI_STEPS steps with a checkpoint at DP_CLI_CKPT, resumed on one process
# to DP_CLI_RESUMED
TP_TRAIN_ROWS, TP_TRAIN_STEPS, TP_CLI_BATCH = 16, 3, 64
# a rank's resident state (f32 params, two Adam moments, two EMA copies) at
# tp=2: the replicated 228,457,801 parameters and half of the 12 D^2 of each
# of 28 blocks (445,906,944), 451,411,273 a rank, x 5 x 4 bytes
TP_XL_RESIDENT_GB = 9.03
# JAX tests/test_parallel.py:87: every parameter after step 1 at rtol 5e-4 /
# atol 5e-5, on the elements whose one-card gradient lies above the float32
# noise of its sums (DP_GRAD_ATOL of the tensor's largest); every element
# within TP_LR_BOUND learning rates (Adam's first step is lr * g / (|g| +
# eps): a gradient within that noise of 0 moves its element up to 2 lr)
TP_PARAM_RTOL, TP_PARAM_ATOL, TP_METRIC_RTOL, TP_LR_BOUND = 5e-4, 5e-5, 1e-5, 2.1
# the all-reduces a step counts apart: activation-sized (the partial sums and
# the input gradients, 16 x 64 x 1152 x 4 bytes at XL/2) and the rest (row
# norms, grad_norm, the projection, the metrics)
TP_LARGE_ALL_REDUCE_BYTES = 1 << 20
# phase 10c: the server on two ranks sharing the card: (2, 1) on phase 8c's
# copy of run A with buckets MESH_SERVE_BUCKETS (the default protocol held at
# 4 and 1 rows, the timed loads of MESH_SERVE_LOADS clients), then (1, 2) at
# DiT-XL/2 with MESH_TP_BATCH rows (one held request, MESH_TP_TIMED timed),
# and the plain path's TP at DiT-B/2 rotation_scale on MESH_TP_BATCH x 2 rows
MESH_SERVE_SEED = 500
MESH_SERVE_BUCKETS = (1, 2, 4)
MESH_SERVE_LOADS = (1, 4)
MESH_TP_BATCH, MESH_TP_TIMED = 4, 3
FID_SAMPLES, FID_BATCH = 64, 32  # phase 8b's sample_fid run (250 steps, CFG 1.5)
VAE_CHECK_IMAGES = 8  # latents decoded on the card and on the CPU in phase 8b
# phase 8c: the server's buckets and --seed, the chains it is held on
# (name -> request fields), and the timed loads (concurrent clients, each
# sending SERVE_REQUESTS seeded one-sample requests of the default protocol)
SERVE_BUCKETS = (1, 4, 8, 32)
SERVE_SEED = 0
SERVE_DEFAULTS = {"steps": 20, "sampler": "dpm++", "cfg_scale": 4.0}  # the JAX server's default protocol
SERVE_CHECKS = {
    "dpm++-20": dict(steps=20, sampler="dpm++", cfg_scale=4.0),
    "cached-ddpm-2": dict(steps=2, sampler="ddpm", cfg_scale=4.0, cache_interval=2),
    "cached-dpm++-20": dict(steps=20, sampler="dpm++", cfg_scale=4.0, cache_interval=2),
}
# the headline request's bits (and the cached ddpm chain's) are held on a
# ddpm chain this short: the server does not clip, and an untrained model's
# learned variance grows with the latent, so its unclipped ddpm chain
# overflows from a few steps on (run A: non-finite at 4, 10 and 250 steps)
SERVE_HEADLINE_CHECK_STEPS = 2
SERVE_LOADS = (1, 4, 16)
SERVE_REQUESTS = 64  # a client: the one-client window is a few seconds
# the served experiment's latent statistics: mean 0, std 2**-SERVE_STATS_EXP,
# so the untrained chains' latents (up to about 1e6 in magnitude at dpm++
# 20) come back scaled by a power of two (exact) and inside the image range
# the server clips to; every compared output is checked to lie inside it
SERVE_STATS_EXP = 24
# phase 8d: the distill step's batch and protocol (run A's teacher, 8 -> 4
# steps, guidance baked at CFG 1.5), its timed runs, the CLI's stages, and
# the student's sample_fid run
DISTILL_BATCH = 256
DISTILL_BASE_STEPS = 8
DISTILL_CFG_SCALE = 1.5
DISTILL_TIMED_RUNS = 3
DISTILL_STAGES, DISTILL_STEPS_PER_STAGE = 2, 4
DISTILL_FID_SAMPLES, DISTILL_FID_BATCH = 64, 32
# phase 6b: DiT-XL/2 training with remat off and on (batch 256; its float32
# plain path, which does not fit beside the others at 256 rows on an 80 GB
# card, is held at XL_CHECK_BATCH rows), timed steps a side, and the S/2
# step and chain in the scan_blocks layout
XL_TRAIN_BATCH = 256
XL_CHECK_BATCH = 64
REMAT_TIMED_STEPS = 3
SCAN_PROFILED_STEPS = 2
# phase 8e: download_data's encode (synthetic uint8 images at the dataset's
# 128 x 128, batch 128; the CPU holds the first ENCODE_CHECK_IMAGES), the
# distribution probe at the JAX package's CPU test budget
# (tests/test_distribution_probe.py) and its limits, the guidance sweep's two
# points and run_fid50k's sample count
ENCODE_IMAGES, ENCODE_BATCH, ENCODE_SIDE, ENCODE_CHECK_IMAGES = 256, 128, 128, 8
PROBE_ARGS = ["--model", "DiT-XS/4", "--input-size", "8", "--classes", "4", "--examples", "1024", "--train-steps",
              "600", "--batch-size", "64", "--samples-per-class", "16", "--num-sampling-steps", "10",
              "--compute-dtype", "bfloat16", "--train-args", "--block-kernel mega_attn", "--block-kernel", "auto"]
PROBE_LIMITS = {"label_acc_trained": (">=", 0.5), "mean_err_trained": ("<=", 3.0), "std_ratio_trained": ("<=", 30.0)}
PROBE_SEEDS = (0, 1, 2)
SWEEP_POINTS = (("1.5", "none"), ("4.0", "0.3:3.0"))
SWEEP_SAMPLES, SWEEP_STEPS = 64, 20
FID_PROTOCOL_SAMPLES = 256
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM data sheet
PALLAS = "mapdit_tpu/ops/pallas/dit_block.py"


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Eager ms a call (mapdit_tpu_torch/utils/timing.py eager_ms)."""
    from mapdit_tpu_torch.utils.timing import eager_ms

    return eager_ms(fn, iters, warmup)


def graph_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms a call from CUDA graph replays (timing.graph_ms)."""
    from mapdit_tpu_torch.utils import timing

    return timing.graph_ms(fn, iters, replays)


def host_ms(torch, fn, iters: int = 200) -> float:
    """Host ms a call, launched without synchronisation (timing.host_ms)."""
    from mapdit_tpu_torch.utils import timing

    return timing.host_ms(fn, iters)


def bound_ms(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    """The least ms: operations at ``peak`` (the bf16 tensor cores, or
    H100_F32_FLOPS for the f32 forms, whose products run on the f32 pipes)
    or bytes at the HBM rate, whichever is larger, and which."""
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare(torch, got, want, atol: float, rtol: float, what: str):
    """Max/mean abs error; fails unless |got - want| <= atol + rtol*|want|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    max_err, mean_err = float(err.max()), float(err.mean())
    phase("check", what=what, max_abs_err=f"{max_err:.3e}", mean_abs_err=f"{mean_err:.3e}",
          tol=f"atol{atol:g}+rtol{rtol:g}", ok=ok)
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max abs err {max_err})")
    return max_err


def compare_scalar(torch, got, want, rtol: float, what: str):
    """One value (dgain, a sum over the whole batch) within ``rtol`` of
    |want|; both values are printed. Returns the abs error."""
    g, w = float(got.reshape(())), float(want.reshape(()))
    err = abs(g - w)
    ok = math.isfinite(g) and err <= rtol * abs(w)
    phase("check", what=what, got=f"{g:.6e}", want=f"{w:.6e}", abs_err=f"{err:.3e}", tol=f"rtol{rtol:g}*|want|",
          ok=ok)
    if not ok:
        raise AssertionError(f"{what}: {g} is off its plain version {w}")
    return err


def compare_sum(torch, got, want, terms, what: str):
    """One value that sums ``terms`` (the attention half-block's dgain, a
    sum over the whole batch whose terms cancel) against its plain version:
    |got - want| at most 2^-8 of the terms' root-sum-square, the spread of
    a sum of the same terms when each carries its own bf16 rounding. A
    limit relative to the sum fails where the terms cancel: on the H100 the
    kernels land 0.137 and 0.2025 from the plain version on sums of 2088.7
    and -1484.6 (the earlier WMMA form of mp_gemm gives the same bits), and
    0.1697 from it on a sum of 19.92, where 2^-8 of the root-sum-square is
    ~2.0 (tools/attn_bwd_witness.py; PERF.md). Returns the abs error."""
    g, w = float(got.reshape(())), float(want.reshape(()))
    err, limit = abs(g - w), 2.0**-8 * float(terms.double().square().sum().sqrt())
    ok = math.isfinite(g) and err <= limit
    phase("check", what=what, got=f"{g:.6e}", want=f"{w:.6e}", abs_err=f"{err:.3e}",
          tol=f"{limit:.3e}=2^-8*rss(terms)", ok=ok)
    if not ok:
        raise AssertionError(f"{what}: {g} is off its plain version {w}")
    return err


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def compare_rel(torch, got, want, tol: float, what: str):
    """Relative L2 error at most ``tol`` (for outputs that several bf16
    roundings upstream separate from the plain version); returns the max
    abs error."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err, max_err = rel_l2(got, want), float((got.float() - want.float()).abs().max())
    phase("check", what=what, rel_l2_err=f"{err:.3e}", max_abs_err=f"{max_err:.3e}", tol=f"rel_l2<={tol:g}",
          ok=err <= tol)
    if err > tol:
        raise AssertionError(f"{what}: kernel disagrees with its plain version (rel L2 err {err})")
    return max_err


def check_paths(torch, what: str, outs: dict, kernel_paths) -> None:
    """Hold each kernel path against the float32 plain path ``outs['f32']``:
    its relative L2 error may be at most twice that of the bf16 plain path
    ``outs['off']`` (floor 1e-2). Both paths round to bf16 at other places,
    so they are compared through the f32 reference, not with each other."""
    ref = outs["f32"]

    def rel(v):
        return rel_l2(v, ref)

    limit = max(2 * rel(outs["off"]), 1e-2)
    phase(what, path="off", rel_l2_err_vs_f32=f"{rel(outs['off']):.3e}")
    for name in kernel_paths:
        got = outs[name]
        err = rel(got)
        phase(what, path=name, shape=tuple(got.shape), rel_l2_err_vs_f32=f"{err:.3e}", tol=f"{limit:.3e}",
              max_abs_err_vs_off=f"{float((got - outs['off']).abs().max()):.3e}")
        if not bool(torch.isfinite(got).all()) or err > limit:
            raise AssertionError(f"{what}/{name}: kernel path off the f32 reference (rel err {err} > {limit})")


# mp_gemm at the main paths' shapes: name -> (M, N, K, A type, modulate
# prologue, epilogue, C type, W read as (K, N), tokens a sample). The S/2
# sampling sites (64 rows x 64 tokens, D=384, H=1536; the kernels line
# reports them with the headline chain's launches), the S/2 training
# backward's products (256 x 64), row 9's pair at DiT-B/2 (64 x 64), DiT-XL/2
# on one card (8 x 64) and a ragged shape with M, N and K off the 128 x 128
# x 64 tile, 8 tokens a sample.
GEMM_SHAPES = {
    "modulation": (64, 2304, 384, "bf16", False, None, "f32", False, 1),
    "qkv": (4096, 1152, 384, "bf16", True, None, "f32", False, 64),
    "out": (4096, 384, 384, "bf16", False, "residual-bf16", "f32", False, 64),
    "fc1": (4096, 1536, 384, "f32", True, "silu", "bf16", False, 64),
    "fc2": (4096, 384, 1536, "bf16", False, "residual-f32", "bf16", False, 64),
    "train:dattn": (16384, 384, 384, "bf16", False, None, "f32", True, 64),
    "train:dh": (16384, 384, 1152, "bf16", False, None, "f32", True, 64),
    "B2:fc1": (4096, 3072, 768, "bf16", True, "silu", "bf16", False, 64),
    "B2:fc2": (4096, 768, 3072, "bf16", False, "residual-bf16", "bf16", False, 64),
    "XL:modulation": (8, 6912, 1152, "bf16", False, None, "f32", False, 1),
    "XL:qkv": (512, 3456, 1152, "bf16", True, None, "f32", False, 64),
    "XL:out": (512, 1152, 1152, "bf16", False, "residual-bf16", "f32", False, 64),
    "XL:fc1": (512, 4608, 1152, "f32", True, "silu", "bf16", False, 64),
    "XL:fc2": (512, 1152, 4608, "bf16", False, "residual-f32", "bf16", False, 64),
    "ragged": (200, 328, 392, "f32", True, "residual-f32", "f32", False, 8),
    "ragged:w_kn": (200, 328, 392, "bf16", False, "silu", "bf16", True, 8),
}


def gemm_case(torch, gen, dev, spec):
    """Random inputs of one GEMM_SHAPES entry: (mp_gemm keyword arguments,
    FLOPs, bytes each input read once and C written once, the bf16
    torch.matmul yardstick)."""
    from mapdit_tpu_torch.ops.mp import normalize

    m, n, k, a_dt, modulated, epilogue, c_dt, w_kn, tokens = spec
    types = {"bf16": torch.bfloat16, "f32": torch.float32}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    a = randn(m, k).to(types[a_dt])
    w = normalize(randn(n, k)).to(torch.bfloat16)
    w = w.t().contiguous() if w_kn else w
    kw = dict(a=a, w=w, alpha=1 / math.sqrt(k), out_dtype=types[c_dt], tokens=tokens, w_kn=w_kn)
    nbytes = a.numel() * a.element_size() + w.numel() * 2 + m * n * (4 if c_dt == "f32" else 2)
    # one f32 row a sample: [shift (K) | scale (K) | gate (N)]
    mods = randn(m // tokens, 2 * k + n)
    if modulated:
        kw["modulate"] = (mods, 0, k, torch.tensor([0.37], device=dev))
        nbytes += (m // tokens) * 2 * k * 4 + 4
    if epilogue == "silu":
        kw["silu"] = True
    elif epilogue is not None:
        x = randn(m, n).to(types[epilogue.split("-")[1]])
        kw["residual"] = (x, mods, 2 * k)
        nbytes += x.numel() * x.element_size() + (m // tokens) * n * 4
    a_bf, w_op = a.to(torch.bfloat16), (w if w_kn else w.t())
    return kw, 2 * m * n * k, nbytes, lambda: torch.matmul(a_bf, w_op)


def gemm_row(torch, k, name, kw, shape, flops, nbytes, library, site) -> dict:
    """mp_gemm against mp_gemm_plain on the keyword arguments ``kw`` (bf16
    results: 1e-2 relative is ~2.5 bf16 ulps; the sums differ only in order,
    and a prologue value can round to the neighbouring bf16), a split-K shape
    also against its own second run, bit for bit; the report row, timed
    beside the plain version and the yardstick."""
    from mapdit_tpu_torch.ops.cuda import build

    got = k.mp_gemm(**kw, site=site)
    err = compare(torch, got, k.mp_gemm_plain(**kw), 1e-2, 1e-2, f"mp_gemm/{name}")
    splits = build.library("mp_gemm").mp_gemm_splits(*shape)
    if splits > 1:
        same = bool(torch.equal(got, k.mp_gemm(**kw, site=site)))
        phase("check", what=f"mp_gemm/{name}:same-bits-twice", splits=splits, ok=same)
        if not same:
            raise AssertionError(f"mp_gemm/{name}: the split-K sum differs between two runs")
    b, by = bound_ms(flops, nbytes)
    # device times from CUDA graphs; the wrapper's host side (checks, tensor
    # maps, ctypes, launches) is timed apart, as host_ms a call
    row = dict(
        source="mapdit_tpu_torch/csrc/mp_gemm.cu", replaces=f"{PALLAS}:279", max_abs_err=err,
        ms=graph_ms(torch, lambda: k.mp_gemm(**kw, site=site)),
        plain_ms=graph_ms(torch, lambda: k.mp_gemm_plain(**kw)),
        bound_ms=b, bound_by=by, library_ms=graph_ms(torch, library),
    )
    phase("time", kernel=f"mp_gemm/{name}", shape="x".join(map(str, shape)), splits=splits, ms=f"{row['ms']:.4f}",
          plain_ms=f"{row['plain_ms']:.4f}", bound_ms=f"{b:.4f}", library_ms=f"{row['library_ms']:.4f}",
          host_ms=f"{host_ms(torch, lambda: k.mp_gemm(**kw, site=site)):.4f}")
    return row


def mp_gemm_rows(torch, k, gen, dev, names) -> dict:
    """gemm_row at the GEMM_SHAPES entries ``names``, on inputs drawn from
    ``gen``."""
    rows = {}
    for name in names:
        spec = GEMM_SHAPES[name]
        kw, flops, nbytes, library = gemm_case(torch, gen, dev, spec)
        site = name.split(":")[-1] if name.split(":")[-1] in k.GEMM_SITES else "qkv"
        rows[name] = gemm_row(torch, k, name, kw, spec[:3], flops, nbytes, library, site)
    return rows


# dit_stack (csrc/dit_stack.cu, the kernel of fused_dit_stack and, at
# depth 1, fused_dit_block) at the chain shapes and the domain's edges:
# name -> (registry model whose width, heads and MLP width it takes, samples
# N, depth, tokens T). S2 is the headline chain's call (64 CFG rows x 64
# tokens, depth 12) and S2:block fused_dit_block's (its first block), both
# on phase 3's S/2 draws (generator SEED: the inputs these two rows have
# always been held on); B2 is the S2 call at DiT-B/2, XL2 DiT-XL/2 at 4 x 2
# (8 rows, depth 28: its out and fc2 products split K); then T = 16
# (DiT-B/4's tokens), T = 4 at the XL head of 72 (DiT-XL/8) and an odd N,
# then 32 x 32 latents (T = 256): the S/2 call of the 32 x 32 bench chain
# (64 rows, depth 12), fused_dit_block at the 32 x 32 train batch (32 rows),
# DiT-XL/2 at 8 rows (head width 72, depth cut to 2) and an even T that
# crosses row tiles (144, a query tile across a row tile's edge), drawn in
# this order from generator SEED + 20.
STACK_SHAPES = {
    "S2": ("DiT-S/2", 64, 12, 64),
    "S2:block": ("DiT-S/2", 64, 12, 64),
    "B2": ("DiT-B/2", 64, 12, 64),
    "XL2": ("DiT-XL/2", 8, 28, 64),
    "B4:T16": ("DiT-B/4", 32, 2, 16),
    "XL8:T4": ("DiT-XL/8", 16, 2, 4),
    "S2:N3": ("DiT-S/2", 3, 2, 64),
    "S2:T256": ("DiT-S/2", 64, 12, 256),
    "S2:T256:block": ("DiT-S/2", 32, 12, 256),
    "XL2:T256": ("DiT-XL/2", 8, 2, 256),
    "S2:T144": ("DiT-S/2", 3, 2, 144),
}
# the launch sequence is timed beside the kernel, and held to the plain
# version beside it, at the chain shapes
STACK_YARDSTICK = ("S2", "S2:block", "B2", "XL2", "S2:T256")
# the stack is held to the float64 witness (stack_witness) at these
STACK_WITNESSED = ("S2", "S2:T256")
# the stack must equal a chain of depth-1 calls bit for bit at these, and
# each call of the chain is held to the plain block on the same stream
STACK_CHAINED = ("S2", "XL2")
STACK_SRC = "mapdit_tpu_torch/csrc/dit_stack.cu"
# the S2 stack's float64 witness runs on phase 3's draw and on this many
# other draws, from the generators tools/bench_dit_stack.py --draws takes
# (seeds SEED + 20 on)
STACK_WITNESS_DRAWS = 3
# the witness rule's bound on the kernel's mean distance from float64
# against the plain version's (1.005-1.009 on nine draws; PERF.md)
STACK_WITNESS_MEAN_RATIO = 1.05


def stack_case(torch, gen, dev, name, dtype=None, spec=None):
    """The inputs of a STACK_SHAPES entry (x, a, gains, weights, heads), in
    the order phase 3 draws its S/2 inputs, and its flops and bytes (each
    input read once, the output written once; S2:block's of one block).
    ``dtype`` (default bf16) is the inputs' type, ``spec`` the entry's
    (model, N, depth, T) where it is not STACK_SHAPES[name]."""
    from mapdit_tpu_torch.models.registry import DIT_MODELS
    from mapdit_tpu_torch.ops.mp import mp_silu, normalize

    dtype = dtype or torch.bfloat16
    model, n, depth, t = spec or STACK_SHAPES[name]
    d, heads = DIT_MODELS[model]["hidden_size"], DIT_MODELS[model]["num_heads"]
    hid, hd = 4 * d, d // heads

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = randn(n, t, d).to(dtype)
    a = mp_silu(randn(n, d)).to(dtype)
    gains = torch.rand(depth, 2, generator=gen, device=dev) * 0.6 + 0.2
    ws = [normalize(randn(depth, r, c)).to(dtype).contiguous()
          for r, c in ((6 * d, d), (3 * d, d), (d, d), (hid, d), (d, hid))]
    blocks = 1 if name.endswith(":block") else depth
    eb = x.element_size()
    flops = blocks * (2 * n * d * 6 * d + 2 * n * t * d * (3 * d + d + 2 * hid) + 4 * n * heads * t * t * hd)
    nbytes = 2 * n * t * d * eb + n * d * eb + blocks * ((10 * d * d + 2 * d * hid) * eb + 8)
    return (x, a, gains, ws, heads), flops, nbytes


def stack_cases(torch):
    """(name, stack_case) for every STACK_SHAPES entry, each drawn from the
    generator its comment names."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    for name in STACK_SHAPES:
        phase3 = name in ("S2", "S2:block")
        yield name, stack_case(torch, torch.Generator(device=dev).manual_seed(SEED) if phase3 else gen, dev, name)


def stack_draw(torch, dev, i):
    """The S2 stack case of other draw i: generator SEED + 20 + i, as
    tools/bench_dit_stack.py --draws draws it."""
    return stack_case(torch, torch.Generator(device=dev).manual_seed(SEED + 20 + i), dev, "S2")


def stack_witness(torch, k, what, case, got, want, seq_out) -> dict:
    """The S2 stack's kernel output ``got``, its plain version's ``want``
    and the launch sequence's ``seq_out`` against the float64 witness
    (fused_dit_stack_plain at sum_dtype=float64: the plain version's bf16
    rounding points, every sum in float64): the max and mean abs distance
    of each. bf16 roundings compound through 12 blocks, so on some draws
    kernel and plain version land past phase 3's limit (5e-2 + 5e-2
    |plain|) from each other while both sit as close to float64 (ROADMAP
    C, the closed dit_stack:S2 entry). The rule, ``ok``: where the two lie
    apart past that limit, each lies within the same limit of float64
    (5e-2 + 5e-2 |f64|), and the
    kernel's mean distance from float64 is at most STACK_WITNESS_MEAN_RATIO
    times the plain version's, which a faulty stage would break. Prints
    the distances, the count of elements apart, the rule's margins
    (``*_apart_margin``: the worst distance minus the limit there; negative
    holds) and ``ok``; returns them."""
    x, a, gains, ws, heads = case
    ref = k.fused_dit_stack_plain(x, a, gains, *ws, heads, sum_dtype=torch.float64).double()
    row = {}
    dists = {name: (v.double() - ref).abs() for name, v in (("kernel", got), ("plain", want), ("sequence", seq_out))}
    for name, e in dists.items():
        row[f"{name}_vs_f64_max"], row[f"{name}_vs_f64_mean"] = float(e.max()), float(e.mean())
    apart = (got.double() - want.double()).abs() > 5e-2 + 5e-2 * want.double().abs()
    near = 5e-2 + 5e-2 * ref.abs()
    row["apart"] = int(apart.sum())
    for name in ("kernel", "plain"):
        row[f"{name}_apart_margin"] = float((dists[name] - near)[apart].max()) if row["apart"] else 0.0
    row["mean_ratio"] = row["kernel_vs_f64_mean"] / row["plain_vs_f64_mean"]
    row["ok"] = (row["kernel_apart_margin"] <= 0 and row["plain_apart_margin"] <= 0
                 and row["mean_ratio"] <= STACK_WITNESS_MEAN_RATIO)
    phase("check", what=f"{what}:f64-witness", **{key: (f"{v:.4e}" if isinstance(v, float) else v)
                                                  for key, v in row.items()},
          tol=f"apart:5e-2+5e-2|f64|,mean_ratio<={STACK_WITNESS_MEAN_RATIO:g}")
    if not row["ok"]:
        raise AssertionError(f"{what}: the kernel or the plain version lies past the float64 witness rule: {row}")
    return row


def stack_calls(k, name, x, a, gains, ws, heads):
    """The kernel, its plain version and the launch sequence on one case:
    fused_dit_block on the first block for a ":block" entry, else
    fused_dit_stack."""
    if name.endswith(":block"):
        w0 = [w[0] for w in ws]
        return ((lambda: k.fused_dit_block(x, a, gains[0], *w0, heads)),
                (lambda: k.fused_dit_block_plain(x, a, gains[0], *w0, heads)),
                (lambda: k.stack_launch_sequence(x, a, gains[:1], *(w[:1] for w in ws), heads)))
    return ((lambda: k.fused_dit_stack(x, a, gains, *ws, heads)),
            (lambda: k.fused_dit_stack_plain(x, a, gains, *ws, heads)),
            (lambda: k.stack_launch_sequence(x, a, gains, *ws, heads)))


def stack_rows(torch, k) -> dict:
    """dit_stack at every STACK_SHAPES entry against its plain version
    (errors of single bf16 roundings compound through the stages and
    blocks: max at 5e-2 + 5e-2 relative, the mean printed beside; at the
    chain shapes the launch sequence's errors are printed beside, the same
    rule's numbers for the route the kernel replaced; at S2 and on
    STACK_WITNESS_DRAWS other draws, stack_witness's float64 rule), the same bits on two
    runs, and at STACK_CHAINED the stack against a chain of depth-1
    fused_dit_block calls bit for bit, each call of the chain held to
    fused_dit_block_plain on the same input stream at the same limits (no
    compounding: the worst block is printed). Then the times: device ms
    from CUDA graph replays, the wrapper's host ms a call and eager ms
    (host-launched calls, synchronised at the end), beside the launch
    sequence (stack_launch_sequence: mp_gemm and cosine_attention, nine
    launches a block) captured in a CUDA graph and eager (STACK_YARDSTICK).
    Returns a report row for each shape."""
    from mapdit_tpu_torch.ops.cuda import build

    smem = build.library("dit_stack").dit_stack_smem_bytes()
    phase("check", what="dit_stack:shared-memory", kernel_bytes=smem, plan_bytes=k.STACK_SMEM_BYTES,
          ok=smem == k.STACK_SMEM_BYTES)
    if smem != k.STACK_SMEM_BYTES:
        raise AssertionError("dit_stack's shared memory differs from the plan's (ops/cuda/dit_block.py)")
    rows = {}
    for name, ((x, a, gains, ws, heads), flops, nbytes) in stack_cases(torch):
        kernel, plain, seq = stack_calls(k, name, x, a, gains, ws, heads)
        before = k.LAUNCHES["dit_stack"]
        got = kernel()
        if k.LAUNCHES["dit_stack"] != before + 1:
            raise AssertionError(f"dit_stack:{name}: the call did not launch the kernel once")
        want = plain()
        if name in STACK_YARDSTICK:
            seq_out = seq()
            e = (seq_out.float() - want.float()).abs()
            phase("check", what=f"dit_stack:{name}:launch-sequence", max_abs_err=f"{float(e.max()):.3e}",
                  mean_abs_err=f"{float(e.mean()):.3e}", note="the replaced route, against the same plain version")
        err = compare(torch, got, want, 5e-2, 5e-2, f"dit_stack:{name}")
        if name in STACK_WITNESSED:
            stack_witness(torch, k, f"dit_stack:{name}", (x, a, gains, ws, heads), got, want, seq_out)
        same = bool(torch.equal(got, kernel()))
        phase("check", what=f"dit_stack:{name}:same-bits-twice", ok=same)
        if not same:
            raise AssertionError(f"dit_stack:{name}: two runs differ")
        if name in STACK_CHAINED:
            step, worst = x, 0.0
            for b in range(ws[0].shape[0]):
                wb = [w[b] for w in ws]
                nxt = k.fused_dit_block(step, a, gains[b], *wb, heads)
                e = (nxt.float() - k.fused_dit_block_plain(step, a, gains[b], *wb, heads).float()).abs()
                worst = max(worst, float(e.max()))
                step = nxt
            same = bool(torch.equal(got, step))
            phase("check", what=f"dit_stack:{name}:stack-equals-chained-blocks", ok=same,
                  worst_block_max_abs_err=f"{worst:.3e}", tol="atol0.05+rtol0.05 a block")
            if not same:
                raise AssertionError(f"dit_stack:{name}: the stack differs from a chain of depth-1 calls")
            if worst > 5e-2:
                raise AssertionError(f"dit_stack:{name}: a block of the chain is off its plain version by {worst}")
        b, by = bound_ms(flops, nbytes)
        row = dict(source=STACK_SRC, replaces=f"{PALLAS}:476" if name.endswith(":block") else f"{PALLAS}:1980",
                   max_abs_err=err, ms=graph_ms(torch, kernel, iters=10),
                   plain_ms=time_ms(torch, plain, iters=3, warmup=1), bound_ms=b, bound_by=by, library_ms=None,
                   host_ms=host_ms(torch, kernel, iters=100), eager_ms=time_ms(torch, kernel, iters=10))
        if name in STACK_YARDSTICK:
            row.update(sequence_ms=graph_ms(torch, seq, iters=5), sequence_eager_ms=time_ms(torch, seq, iters=5))
        phase("time", kernel=f"dit_stack:{name}", shape=f"{x.shape[0]}x{x.shape[1]}x{x.shape[2]}",
              depth=1 if name.endswith(":block") else ws[0].shape[0],
              **{key: (f"{v:.4f}" if isinstance(v, float) else v) for key, v in row.items()
                 if key not in ("source", "replaces")})
        rows[name] = row
    # the S2 stack on other draws, under the float64 witness rule
    dev = torch.device("cuda")
    for i in range(STACK_WITNESS_DRAWS):
        case, _, _ = stack_draw(torch, dev, i)
        kernel, plain, seq = stack_calls(k, "S2", *case)
        got, want = kernel(), plain()
        e = (got.float() - want.float()).abs()
        what = f"dit_stack:S2:seed{SEED + 20 + i}"
        phase("check", what=what, max_abs_err=f"{float(e.max()):.3e}", mean_abs_err=f"{float(e.mean()):.3e}",
              past_phase3_limit=int((e > 5e-2 + 5e-2 * want.float().abs()).sum()), note="held by the witness rule")
        stack_witness(torch, k, what, case, got, want, seq())
    return rows


# The f32 forms: mp_gemm_f32, cosine_attention_f32 and dit_stack's f32
# instances, the kernels of a float32 model (the JAX package's kernels at
# dtype = float32). Each is held to its f32 plain version with TF32 off
# (main sets it; tools/bench_f32 too) at the JAX package's own f32 kernel
# tolerance, rtol = atol = 2e-4 (tests/test_pallas.py:180), and bounded on
# the f32 pipes (H100_F32_FLOPS: the products run there, not on the tensor
# cores). The depth-12 stack is also held to its float64 witness.
F32_TOL = 2e-4
# dit_stack f32: name -> (model, N, depth, T), drawn in f32 in this order
# from generator SEED + 40: fused_dit_block's call at S/2 (64 rows x 64
# tokens), the S/2 chain's stack (depth 12), the 32 x 32 stack (64 x 256,
# depth 12) and DiT-XL/2's block at 8 rows (head width 72; its qkv, out and
# fc2 split K); then the domain's edges, as STACK_SHAPES has them: T = 16,
# T = 4 at the head of 72, and an odd N at a T whose query tiles cross row
# tiles (144)
F32_STACK_SHAPES = {
    "S2:block": ("DiT-S/2", 64, 1, 64),
    "S2": ("DiT-S/2", 64, 12, 64),
    "S2:T256": ("DiT-S/2", 64, 12, 256),
    "XL2:block": ("DiT-XL/2", 8, 1, 64),
    "B4:T16": ("DiT-B/4", 32, 2, 16),
    "XL8:T4": ("DiT-XL/8", 16, 2, 4),
    "S2:N3:T144": ("DiT-S/2", 3, 2, 144),
}
# its float64 witness rule: the kernel's rel L2 from the witness at most
# F32_WITNESS_RATIO times the f32 plain version's (floor 1e-6)
F32_WITNESSED = ("S2",)
F32_WITNESS_RATIO, F32_WITNESS_FLOOR = 4.0, 1e-6
# cosine_attention f32: name -> (N, T, heads, hd, residual mode): the S/2
# sampling call in both modes (the residual mode writes p), 32 x 32 latents
# in both, the XL head of 72, and T = 4 at the XL head with an odd N in the
# residual mode (a ragged 16-row tile, ragged key tiles)
F32_COSINE_SHAPES = {
    "cosine_attention:f32": (64, 64, 6, 64, False),
    "cosine_attention:f32/residual": (64, 64, 6, 64, True),
    "cosine_attention:f32:t256": (16, 256, 6, 64, False),
    "cosine_attention:f32:t256/residual": (16, 256, 6, 64, True),
    "cosine_attention:f32:xl": (8, 64, 16, 72, False),
    "cosine_attention:f32:t4/residual": (5, 4, 16, 72, True),
}


def f32_gemm_rows(torch, k, gen, dev) -> dict:
    """The five products of an S/2 block (64 rows x 64 tokens, D=384,
    H=1536) in the f32 form, each with its prologue and epilogue as
    dit_stack's f32 instance and the f32 launch sequence run them (f32 A,
    W, C and stream), against mp_gemm_plain at F32_TOL, a split-K product
    also against its second run bit for bit; timed (device ms from CUDA
    graphs, host ms, eager ms) beside the plain version and one f32
    torch.matmul (TF32 off) of the same product; then a ragged product
    (M, N, K off the tiles, split K), checked only. Returns a row a product
    and the five together ("block")."""
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.mp import mp_silu, normalize

    n, t, d, hid = 64, 64, 384, 1536
    f32 = torch.float32

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    a, x, x1 = mp_silu(randn(n, d)), randn(n * t, d), randn(n * t, d)
    attn, h = randn(n * t, d), mp_silu(randn(n * t, hid))
    w = {site: normalize(randn(r, c)).contiguous()
         for site, (r, c) in (("modulation", (6 * d, d)), ("qkv", (3 * d, d)), ("out", (d, d)), ("fc1", (hid, d)),
                              ("fc2", (d, hid)))}
    mods = k.mp_gemm_plain(a, w["modulation"], alpha=1 / math.sqrt(d), out_dtype=f32)
    gains = torch.tensor([0.37, 0.61], device=dev)
    inv_d = 1 / math.sqrt(d)
    cases = {
        # site: (kwargs, M, K, extra bytes read)
        "modulation": (dict(a=a, alpha=inv_d), n, d, 0),
        "qkv": (dict(a=x, alpha=inv_d, modulate=(mods, 0, d, gains[0:1]), tokens=t), n * t, d, n * 2 * d * 4),
        "out": (dict(a=attn, alpha=inv_d, residual=(x, mods, 2 * d), tokens=t), n * t, d, n * d * 4 + n * t * d * 4),
        "fc1": (dict(a=x1, alpha=inv_d, modulate=(mods, 3 * d, 4 * d, gains[1:2]), silu=True, tokens=t), n * t, d,
                n * 2 * d * 4),
        "fc2": (dict(a=h, alpha=1 / math.sqrt(hid), residual=(x1, mods, 5 * d), tokens=t), n * t, hid,
                n * d * 4 + n * t * d * 4),
    }
    rows, flops, nbytes = {}, 0, 0
    for site, (kw, m_, k_, extra) in cases.items():
        kw = dict(kw, w=w[site], out_dtype=f32)
        n_ = w[site].shape[0]
        before = k.LAUNCHES[f"mp_gemm/{site}"]
        got = k.mp_gemm(**kw, site=site)
        if k.LAUNCHES[f"mp_gemm/{site}"] != before + 1:
            raise AssertionError(f"mp_gemm:f32/{site}: the call did not launch the kernel once")
        err = compare(torch, got, k.mp_gemm_plain(**kw), F32_TOL, F32_TOL, f"mp_gemm:f32/{site}")
        splits = build.library("mp_gemm").mp_gemm_f32_splits(m_, n_, k_)
        if splits > 1:
            same = bool(torch.equal(got, k.mp_gemm(**kw, site=site)))
            phase("check", what=f"mp_gemm:f32/{site}:same-bits-twice", splits=splits, ok=same)
            if not same:
                raise AssertionError(f"mp_gemm:f32/{site}: the split-K sum differs between two runs")
        flops, nbytes = flops + 2 * m_ * n_ * k_, nbytes + 4 * (m_ * k_ + n_ * k_ + m_ * n_) + extra
        b, by = bound_ms(2 * m_ * n_ * k_, 4 * (m_ * k_ + n_ * k_ + m_ * n_) + extra, H100_F32_FLOPS)
        a_op, w_op = kw["a"], w[site].t()
        row = dict(source=GEMM_SRC, replaces=f"{PALLAS}:279", max_abs_err=err,
                   ms=graph_ms(torch, lambda kw=kw, site=site: k.mp_gemm(**kw, site=site)),
                   plain_ms=graph_ms(torch, lambda kw=kw: k.mp_gemm_plain(**kw)), bound_ms=b, bound_by=by,
                   library_ms=graph_ms(torch, lambda a_op=a_op, w_op=w_op: torch.matmul(a_op, w_op)),
                   host_ms=host_ms(torch, lambda kw=kw, site=site: k.mp_gemm(**kw, site=site)),
                   eager_ms=time_ms(torch, lambda kw=kw, site=site: k.mp_gemm(**kw, site=site)))
        phase("time", kernel=f"mp_gemm:f32/{site}", shape=f"{m_}x{n_}x{k_}", splits=splits, bound_by=by,
              **{key: f"{row[key]:.4f}" for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms", "eager_ms")})
        rows[site] = row
    # a ragged product: M, N and K off the 128 x 128 x 32 tiles, 8 tokens a
    # sample, the modulate prologue and the f32 residual (checked only)
    m_, n_, k_, t_ = 200, 328, 392, 8
    ragged_rows = randn(m_ // t_, 2 * k_ + n_)
    kw = dict(a=randn(m_, k_), w=normalize(randn(n_, k_)).contiguous(), alpha=1 / math.sqrt(k_), out_dtype=f32,
              modulate=(ragged_rows, 0, k_, gains[0:1]), residual=(randn(m_, n_), ragged_rows, 2 * k_), tokens=t_)
    compare(torch, k.mp_gemm(**kw, site="qkv"), k.mp_gemm_plain(**kw), F32_TOL, F32_TOL, "mp_gemm:f32/ragged")
    # the five together (a block's products, as the f32 launch sequence
    # launches them): the kernels line's mp_gemm:f32 row
    b, by = bound_ms(flops, nbytes, H100_F32_FLOPS)
    block = dict(source=GEMM_SRC, replaces=f"{PALLAS}:279", max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 **{key: sum(r[key] for r in rows.values())
                    for key in ("ms", "plain_ms", "library_ms", "host_ms", "eager_ms")}, bound_ms=b, bound_by=by)
    phase("time", kernel="mp_gemm:f32/block", products=",".join(rows), bound_by=by,
          **{key: f"{block[key]:.4f}" for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms", "eager_ms")})
    rows["block"] = block
    return rows


def f32_cosine_rows(torch, F, k, gen, dev) -> dict:
    """cosine_attention's f32 form at F32_COSINE_SHAPES on f32 qkv: out
    (and in residual mode p) against cosine_attention_plain at out_dtype
    f32 and F32_TOL; timed beside the plain version and f32 SDPA on the
    pre-normalised q, k (TF32 off). Returns a row a shape."""
    from mapdit_tpu_torch.ops.mp import normalize

    f32, rows = torch.float32, {}
    for name, (n, t, heads, hd, residual) in F32_COSINE_SHAPES.items():
        d = heads * hd
        qkv = torch.randn(n * t, 3 * d, generator=gen, device=dev)
        probs, probs_p = ((torch.empty(n, heads, t, t, device=dev) for _ in range(2)) if residual else (None, None))

        def run(qkv=qkv, t=t, heads=heads, residual=residual, probs=probs):
            return k.cosine_attention(qkv, t, heads, f32, normalize_first=residual, probs=probs)

        def plain(qkv=qkv, t=t, heads=heads, residual=residual, probs=probs_p):
            return k.cosine_attention_plain(qkv, t, heads, f32, normalize_first=residual, probs=probs)

        key = "cosine_attention/residual" if residual else "cosine_attention"
        before = k.LAUNCHES[key]
        got = run()
        if k.LAUNCHES[key] != before + 1 or got.dtype != f32:
            raise AssertionError(f"{name}: the call did not launch the f32 kernel once")
        err = compare(torch, got, plain(), F32_TOL, F32_TOL, name)
        if residual:
            err = max(err, compare(torch, probs, probs_p, F32_TOL, F32_TOL, name + ":p"))
        same = bool(torch.equal(got, run()))
        phase("check", what=f"{name}:same-bits-twice", ok=same)
        if not same:
            raise AssertionError(f"{name}: two runs differ")
        q4, k4, v4 = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        qn, kn, vc = normalize(q4).contiguous(), normalize(k4).contiguous(), v4.contiguous()
        p_bytes = n * heads * t * t * 4 if residual else 0
        b, by = bound_ms(4 * n * heads * t * t * hd, n * t * 3 * d * 4 + n * t * d * 4 + p_bytes, H100_F32_FLOPS)
        row = dict(source=COSINE_SRC, replaces=f"{PALLAS}:129", max_abs_err=err, ms=graph_ms(torch, run),
                   plain_ms=graph_ms(torch, plain), bound_ms=b, bound_by=by,
                   library_ms=graph_ms(torch, lambda qn=qn, kn=kn, vc=vc, hd=hd: F.scaled_dot_product_attention(
                       qn, kn, vc, scale=1 / math.sqrt(hd))),
                   host_ms=host_ms(torch, run), eager_ms=time_ms(torch, run))
        phase("time", kernel=name, shape=f"{n}x{t}x{heads}x{hd}", bound_by=by,
              **{key: f"{row[key]:.4f}" for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms", "eager_ms")})
        rows[name] = row
    return rows


def f32_stack_rows(torch, k, check_only: bool = False) -> dict:
    """dit_stack's f32 instances at F32_STACK_SHAPES against the f32 plain
    version at F32_TOL, one launch a call, the same bits on two runs; the
    f32 launch sequence (stack_launch_sequence: mp_gemm_f32 and
    cosine_attention_f32, six launches a block) against the same plain
    version at the same tolerance; at F32_WITNESSED the float64 witness
    (fused_dit_stack_plain at sum_dtype=float64): the kernel's rel L2 from
    it at most F32_WITNESS_RATIO times the f32 plain version's (floor
    F32_WITNESS_FLOOR). Then (unless ``check_only``) the times: device ms
    from CUDA graphs, host and eager ms, the plain version's eager ms, the
    launch sequence graph-captured and eager, the bound on the f32 pipes.
    Returns a row a shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    rows = {}
    for name, spec in F32_STACK_SHAPES.items():
        (x, a, gains, ws, heads), flops, nbytes = stack_case(torch, gen, dev, name, torch.float32, spec)
        kernel, plain, seq = stack_calls(k, name, x, a, gains, ws, heads)
        before = k.LAUNCHES["dit_stack"]
        got = kernel()
        if k.LAUNCHES["dit_stack"] != before + 1 or got.dtype != torch.float32:
            raise AssertionError(f"dit_stack:f32:{name}: the call did not launch the f32 kernel once")
        want = plain()
        err = compare(torch, got, want, F32_TOL, F32_TOL, f"dit_stack:f32:{name}")
        seq_out = seq()
        compare(torch, seq_out, want, F32_TOL, F32_TOL, f"dit_stack:f32:{name}:launch-sequence")
        if name in F32_WITNESSED:
            ref = k.fused_dit_stack_plain(x, a, gains, *ws, heads, sum_dtype=torch.float64)
            e_kernel, e_plain, e_seq = (rel_l2(v.double(), ref) for v in (got, want, seq_out))
            limit = max(F32_WITNESS_RATIO * e_plain, F32_WITNESS_FLOOR)
            phase("check", what=f"dit_stack:f32:{name}:f64-witness", kernel_rel_l2=f"{e_kernel:.4e}",
                  plain_rel_l2=f"{e_plain:.4e}", sequence_rel_l2=f"{e_seq:.4e}", tol=f"{limit:.4e}",
                  ok=e_kernel <= limit)
            if e_kernel > limit:
                raise AssertionError(f"dit_stack:f32:{name}: {e_kernel} from the float64 witness, past {limit}")
        same = bool(torch.equal(got, kernel()))
        phase("check", what=f"dit_stack:f32:{name}:same-bits-twice", ok=same)
        if not same:
            raise AssertionError(f"dit_stack:f32:{name}: two runs differ")
        if check_only:
            continue
        b, by = bound_ms(flops, nbytes, H100_F32_FLOPS)
        iters = 3 if spec[3] > 64 else 10
        row = dict(source=STACK_SRC, replaces=f"{PALLAS}:476" if name.endswith(":block") else f"{PALLAS}:1980",
                   max_abs_err=err, ms=graph_ms(torch, kernel, iters=iters),
                   plain_ms=time_ms(torch, plain, iters=3, warmup=1), bound_ms=b, bound_by=by, library_ms=None,
                   host_ms=host_ms(torch, kernel, iters=10 * iters), eager_ms=time_ms(torch, kernel, iters=iters),
                   sequence_ms=graph_ms(torch, seq, iters=iters), sequence_eager_ms=time_ms(torch, seq, iters=iters))
        phase("time", kernel=f"dit_stack:f32:{name}", shape=f"{x.shape[0]}x{x.shape[1]}x{x.shape[2]}",
              depth=spec[2], **{key: (f"{v:.4f}" if isinstance(v, float) else v) for key, v in row.items()
                                if key not in ("source", "replaces")})
        rows[name] = row
    return rows


# rows 3, 4 and 5 in f32 (csrc/attn_branch.cu's f32 instances; a float32
# model on mega_attn): name -> (N, T, D, heads), drawn in f32 from generator
# SEED + 60 in this order: the DiT-S/2 training shape at 256 (the report
# rows, timed), B/2 at T = 16, and the edge, an odd N at T = 4 and the head
# of 72
F32_BRANCH_SHAPES = {
    "s2": (TRAIN_BATCH, 64, 384, 6),
    "b2:t16": (8, 16, 768, 12),
    "xl:t4:n3": (3, 4, 1152, 16),
}
# the f32 launch sequences' own kernels (the route past T = 64 and the
# yardstick): attention_bwd at the S/2 shape, at 32 x 32 latents and at the
# edge (odd N, T = 4, hd 72): name -> (N, T, heads, hd); out_gate_residual_bwd
# at T = 64 and 256: name -> (N, T, D)
F32_ATTN_BWD_SHAPES = {"attention_bwd:f32": (TRAIN_BATCH, 64, 6, 64), "attention_bwd:f32:t256": (32, 256, 6, 64),
                       "attention_bwd:f32:t4:n5": (5, 4, 16, 72)}
F32_OUT_GATE_SHAPES = {"out_gate_residual_bwd:f32": (TRAIN_BATCH, 64, 384),
                       "out_gate_residual_bwd:f32:t256": (32, 256, 384)}


def f32_branch_args(torch, gen, dev, n, t, d, heads):
    """The half-block's inputs in f32 drawn from ``gen``: ((x, shift, scale,
    gate, gain, W_qkv, W_out, heads), dy)."""
    from mapdit_tpu_torch.ops.mp import normalize

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = randn(n, t, d)
    shift, scale, gate = (randn(n, d) for _ in range(3))
    gain = torch.tensor(0.37, device=dev)
    wq, wo = (normalize(randn(*s)).contiguous() for s in ((3 * d, d), (d, d)))
    return (x, shift, scale, gate, gain, wq, wo, heads), randn(n, t, d)


def launched_once(key: str, fn):
    """fn() and a check that it moved the launch count ``key`` by one."""
    before = launch_counts()[key]
    out = fn()
    if launch_counts()[key] != before + 1:
        raise AssertionError(f"{key}: the call did not launch it once")
    return out


def f32_branch_rows(torch, dev, check_only: bool = False) -> dict:
    """Rows 3, 5 and 4 in f32 at F32_BRANCH_SHAPES: each one launch of its
    f32 instance (branch_route takes the call) held to its f32 plain version
    at F32_TOL (mapdit_tpu_torch/tools/bench_attn_branch.py check under its
    F32 rule: row 5's y, p and attn; row 4's cotangents, dgain within F32_TOL
    of its terms' root-sum-square, the dW pair, f32 products with TF32 off,
    and its operands), each f32 launch sequence (the route past the kernels'
    domain) against the same plain versions, the same bits on two runs.
    Then (unless ``check_only``) the S/2 rows timed beside their launch
    sequences: graph, host and eager ms, the plain version's graph ms, the
    bound on the f32 pipes. Returns the kernels line's three rows."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.tools import bench_attn_branch as bab

    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    rows = {}
    for name, (n, t, d, heads) in F32_BRANCH_SHAPES.items():
        args, dy = f32_branch_args(torch, gen, dev, n, t, d, heads)
        if ab.branch_route(args[0], args[5], args[6], heads, dy) != "kernel":
            raise AssertionError(f"attn_branch:f32:{name}: not the one-launch kernel's route")
        before = launch_counts()
        checks = bab.check(name, args, dy, rule=bab.F32)
        after = launch_counts()
        moved = {key: after[key] - before[key] for key in after if after[key] != before[key]}
        if any(not moved.get(f"attn_branch/{kind}") or moved.get(f"attn_branch/{kind}/sequence")
               for kind in bab.KINDS):
            raise AssertionError(f"attn_branch:f32:{name}: not the one-launch kernels ({moved})")
        errs = {kind: check["max_abs_err"] for kind, check in checks.items()}
        if check_only or name != "s2":
            continue
        bounds = bab.bounds(n, t, d, heads, f32=True)
        for kind, line, path, fn, seq_fn, plain_fn in (
            ("fwd", 1007, "f32/mega_attn+pallas", lambda: ab.attn_branch_fwd(*args),
             lambda: ab.fwd_launch_sequence(*args), lambda: ab.attn_fwd_plain(*args)),
            ("res_fwd", 1152, "f32/mega_attn+residual", lambda: ab.attn_branch_res_fwd(*args),
             lambda: ab.res_fwd_launch_sequence(*args), lambda: ab.attn_res_fwd_plain(*args)),
            ("bwd", 918, "f32/mega_attn+pallas", lambda: ab.attn_branch_bwd(dy, *args),
             lambda: ab.bwd_launch_sequence(dy, *args), lambda: ab.attn_branch_bwd_plain(dy, *args)),
        ):
            times = bab.times(fn, seq_fn, plain_fn)
            rows[f"attn_branch/{kind}:f32"] = dict(
                source=BRANCH_SRC, replaces=f"{PALLAS}:{line}", max_abs_err=errs[kind], ms=times["ms"],
                plain_ms=times["plain_ms"], bound_ms=bounds[kind][0], bound_by=bounds[kind][1], library_ms=None,
                path=path, count_key=f"attn_branch/{kind}", eager_ms=times["eager_ms"], host_ms=times["host_ms"],
                sequence_ms=times["sequence_ms"], sequence_eager_ms=times["sequence_eager_ms"],
                sequence_host_ms=times["sequence_host_ms"])
            phase("time", kernel=f"attn_branch/{kind}:f32:{name}", shape=f"{n}x{t}x{d}x{heads}",
                  **{key: f"{v:.4f}" for key, v in times.items()}, bound_ms=f"{bounds[kind][0]:.4f}",
                  bound_by=bounds[kind][1], card=json.dumps(smi_line()))
        h, attn, dout, dqkv = ab.attn_branch_bwd(dy, *args)[5]
        pair = {"ms": graph_ms(torch, lambda: ab._dw_pair(dqkv, h, dout, attn, 1 / math.sqrt(d), ab.dw_gemm))}
        phase("time", kernel=f"attn_branch/dw-pair:f32:{name}", ms=f"{pair['ms']:.4f}",
              library="torch.mm, f32 operands, TF32 off, x 2")
        del args, dy, h, attn, dout, dqkv
        torch.cuda.empty_cache()
    return rows


def f32_part_rows(torch, F, dev, check_only: bool = False) -> dict:
    """The f32 launch sequences' own kernels of row 4, each held to its f32
    plain version at F32_TOL and to the same bits twice: attention_bwd_f32
    at F32_ATTN_BWD_SHAPES (dqkv from f32 qkv and dattn), the f32
    out_gate_residual_bwd at F32_OUT_GATE_SHAPES (dout and dgate; T = 256
    sums each sample's row tiles in tile order), the f32 dattn and dh
    products (W read as (K, N)) and modulate_fwd writing f32 h at the S/2
    training shape, on draws of generator SEED + 61. Then (unless
    ``check_only``) each timed (graph, host and eager ms) beside its plain
    version and a library call, bounded on the f32 pipes or by bytes.
    Returns the kernels line's rows (the S/2 shapes; their launches from
    phase 6e's f32 mega_attn sequence paths)."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.mp import normalize

    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    f32, rows = torch.float32, {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def row(name, key, run, plain, err, flops, nbytes, library, replaces, source, path):
        same = run()
        again = run()
        same = all(torch.equal(a_, b_) for a_, b_ in zip(same if isinstance(same, tuple) else (same,),
                                                        again if isinstance(again, tuple) else (again,)))
        phase("check", what=f"{name}:same-bits-twice", ok=same)
        if not same:
            raise AssertionError(f"{name}: two runs differ")
        if check_only:
            return
        b, by = bound_ms(flops, nbytes, H100_F32_FLOPS)
        r = dict(source=source, replaces=replaces, max_abs_err=err, ms=graph_ms(torch, run),
                 plain_ms=graph_ms(torch, plain), bound_ms=b, bound_by=by,
                 library_ms=None if library is None else graph_ms(torch, library),
                 host_ms=host_ms(torch, run), eager_ms=time_ms(torch, run), path=path, count_key=key)
        phase("time", kernel=name, bound_by=by, card=json.dumps(smi_line()),
              **{kk: (f"{v:.4f}" if isinstance(v, float) else v) for kk, v in r.items()
                 if kk in ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms", "eager_ms")})
        if ":" not in name.replace(":f32", "", 1):
            rows[name] = r

    # attention_bwd in f32
    for name, (n, t, heads, hd) in F32_ATTN_BWD_SHAPES.items():
        d = heads * hd
        qkv, dattn = randn(n * t, 3 * d), randn(n * t, d)

        def run(qkv=qkv, dattn=dattn, t=t, heads=heads):
            return ab.attention_bwd(qkv, dattn, t, heads, f32)

        def plain(qkv=qkv, dattn=dattn, t=t, heads=heads):
            return ab.attention_bwd_plain(qkv, dattn, t, heads, f32)

        got = launched_once("attn_bwd/attention", run)
        err = compare(torch, got, plain(), F32_TOL, F32_TOL, name)
        q4, k4, v4 = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        qs, ks, vs = (z.contiguous().requires_grad_() for z in (normalize(q4), normalize(k4), v4))
        do4 = dattn.reshape(n, t, heads, hd).transpose(1, 2).contiguous()

        def sdpa(qs=qs, ks=ks, vs=vs, do4=do4, hd=hd):
            o = F.scaled_dot_product_attention(qs, ks, vs, scale=1 / math.sqrt(hd))
            return torch.autograd.grad(o, (qs, ks, vs), do4)

        row(name, "attn_bwd/attention", run, plain, err, 10 * n * heads * t * t * hd,
            n * t * 3 * d * 4 + n * t * d * 4 + n * t * 3 * d * 4, sdpa, f"{PALLAS}:643", BWD_SRC,
            "f32/mega_attn+sequence")
    # out_gate_residual_bwd in f32
    for name, (n, t, d) in F32_OUT_GATE_SHAPES.items():
        attn, dy = randn(n * t, d), randn(n * t, d)
        w = normalize(randn(d, d)).contiguous()
        mods = randn(n, 3 * d)

        def run(attn=attn, w=w, dy=dy, mods=mods, t=t, d=d):
            return ab.out_gate_residual_bwd(attn, w, dy, mods, 2 * d, t)

        def plain(attn=attn, w=w, dy=dy, mods=mods, t=t, d=d):
            return ab.out_gate_residual_bwd_plain(attn, w, dy, mods, 2 * d, t)

        got = launched_once("attn_bwd/out_gate_residual", run)
        err = max(compare(torch, g_, w_, F32_TOL, F32_TOL, f"{name}:{nm}")
                  for nm, g_, w_ in zip(("dout", "dgate"), got, plain()))
        m = n * t
        row(name, "attn_bwd/out_gate_residual", run, plain, err, 2 * m * d * d, 4 * (3 * m * d + d * d + n * 2 * d),
            lambda attn=attn, w=w: torch.matmul(attn, w.t()), f"{PALLAS}:622", GEMM_SRC, "f32/mega_attn+sequence")
    # the dattn and dh products, W read as (K, N), and modulate_fwd writing f32 h
    n, t, d = TRAIN_BATCH, 64, 384
    m, inv_d = n * t, 1 / math.sqrt(d)
    for site, (a_, w_) in (("dattn", (randn(m, d), normalize(randn(d, d)).contiguous())),
                           ("dh", (randn(m, 3 * d), normalize(randn(3 * d, d)).contiguous()))):
        kw = dict(a=a_, w=w_, alpha=inv_d, out_dtype=f32, w_kn=True)
        name = f"mp_gemm:f32/{site}"

        def run(kw=kw, site=site):
            return k.mp_gemm(**kw, site=site)

        def plain(kw=kw):
            return k.mp_gemm_plain(**kw)

        got = launched_once(f"mp_gemm/{site}", run)
        err = compare(torch, got, plain(), F32_TOL, F32_TOL, name)
        kk, nn = a_.shape[1], w_.shape[1]
        row(name, f"mp_gemm/{site}", run, plain, err, 2 * m * nn * kk, 4 * (m * kk + kk * nn + m * nn),
            lambda a_=a_, w_=w_: torch.matmul(a_, w_), f"{PALLAS}:{636 if site == 'dattn' else 683}", GEMM_SRC,
            "f32/mega_attn+sequence")
    x, mods, gain = randn(m, d), randn(n, 3 * d), torch.tensor([0.37], device=dev)

    def run():
        return ab.modulate_fwd(x, mods, gain, t, f32)

    def plain():
        return ab.modulate_fwd_plain(x, mods, gain, t, f32)

    got = launched_once("attn_bwd/modulate_fwd", run)
    err = compare(torch, got, plain(), F32_TOL, F32_TOL, "modulate_fwd:f32")
    shift, scale = mods[:, :d].repeat_interleave(t, 0), mods[:, d:2 * d].repeat_interleave(t, 0)
    row("modulate_fwd:f32", "attn_bwd/modulate_fwd", run, plain, err, 0, 4 * (2 * m * d + 2 * n * d),
        lambda: torch.addcmul(shift, x, scale), f"{PALLAS}:588", BWD_SRC, "f32/mega_attn+sequence")
    return rows


# The attention kernels at phase 3's shapes. A name without ":" is a report
# row (the kernels line); the others are checked and timed beside it.
# cosine_attention: name -> (N, T, heads, hd, residual mode). The S/2
# sampling call (64 rows), the S/2 training residual mode (256 rows; drawn
# from the backward's own qkv in phase 3), DiT-XL/2 on one card (8 rows, 16
# heads of 72) and its tensor-parallel shards (8 and 4 local heads), an odd
# N, T=256 (input size 32) in both modes, and the ragged tiles of input size
# 16: T=16 (patch 4) and T=4 at hd 72 (DiT-XL/8), residual mode.
COSINE_SHAPES = {
    "cosine_attention": (64, 64, 6, 64, False),
    "cosine_attention/residual": (256, 64, 6, 64, True),
    "cosine_attention:xl": (8, 64, 16, 72, False),
    "cosine_attention:tp2": (8, 64, 8, 72, False),
    "cosine_attention:tp4": (8, 64, 4, 72, False),
    "cosine_attention:n3": (3, 64, 6, 64, False),
    "cosine_attention:t256": (8, 256, 6, 64, False),
    "cosine_attention/residual:t256": (8, 256, 6, 64, True),
    "cosine_attention:t16": (8, 16, 6, 64, False),
    "cosine_attention/residual:t4": (8, 4, 16, 72, True),
}
# fused_attention: name -> ((B, H, T, D'), type, cosine, input scale, atol,
# rtol). The B/2 sampling (64) and training (256) calls on the model's
# strided views, then the XL head width, T=256, no cosine, logits past 88
# (the row maximum at work) in f32 and bf16, f32 with cosine, and the
# ragged tiles of T=16 and T=4 (hd 72). bf16:
# 1e-2 relative is ~2.5 bf16 ulps of the output; p and the normalised rows
# can each round to the neighbouring bf16. f32: sums in another order;
# logits of a few hundred carry ~1e-5 of absolute error into the exponent.
# The bf16 case scales its inputs by 2 (logits to ~180): at 6 they reach
# ~1600, where the order of the f32 sums alone moves a logit by ~1e-3 and a
# near-tied p across a bf16 rounding boundary (PERF.md). At 2 that still
# happens: the f32 plain version lands up to 0.0234 from a float64
# evaluation of its roundings, where the kernel was exact, so where the two
# lie apart float64 decides (order_witness).
FUSED_SHAPES = {
    "fused_attention": ((64, 12, 64, 64), "bf16", True, 1.0, 1e-2, 1e-2),
    "fused_attention/train": ((256, 12, 64, 64), "bf16", True, 1.0, 1e-2, 1e-2),
    "fused_attention:xl-head-72": ((64, 16, 64, 72), "bf16", True, 1.0, 1e-2, 1e-2),
    "fused_attention:t256": ((8, 12, 256, 64), "bf16", True, 1.0, 1e-2, 1e-2),
    "fused_attention:bf16-no-cosine": ((64, 12, 64, 64), "bf16", False, 1.0, 1e-2, 1e-2),
    "fused_attention:f32-no-cosine-logits>88": ((4, 4, 64, 32), "f32", False, 6.0, 1e-4, 1e-3),
    "fused_attention:f32-cosine": ((4, 4, 64, 32), "f32", True, 1.0, 1e-5, 1e-4),
    "fused_attention:bf16-no-cosine-logits>88": ((64, 12, 64, 64), "bf16", False, 2.0, 1e-2, 1e-2),
    "fused_attention:t16": ((8, 12, 16, 64), "bf16", True, 1.0, 1e-2, 1e-2),
    "fused_attention:t4-head-72": ((8, 16, 4, 72), "bf16", True, 1.0, 1e-2, 1e-2),
}


# attention_bwd: name -> (N, T, heads, hd). The S/2 training call (the
# report row; drawn from the backward's own qkv and dattn in phase 3), then
# B/2's 12 heads, the XL head (16 of 72), an odd N, the ragged T=16 and T=4
# (hd 72), then the form past T = 64: one T past one key tile (96), T=256
# (32 x 32 latents) at the 32 x 32 train batch (the report row of that
# form, counted on phase 6c's path) and at the XL head, and a ragged T=144;
# T=ATTN_BWD_TOO_LONG must raise.
ATTN_BWD_SHAPES = {
    "attn_bwd/attention": (256, 64, 6, 64),
    "attn_bwd/attention:b2": (256, 64, 12, 64),
    "attn_bwd/attention:xl": (32, 64, 16, 72),
    "attn_bwd/attention:n3": (3, 64, 6, 64),
    "attn_bwd/attention:t16": (8, 16, 6, 64),
    "attn_bwd/attention:t4-head-72": (8, 4, 16, 72),
    "attn_bwd/attention:t96": (8, 96, 6, 64),
    "attn_bwd/attention:t256": (32, 256, 6, 64),
    "attn_bwd/attention:t256-head-72": (8, 256, 16, 72),
    "attn_bwd/attention:t144": (8, 144, 6, 64),
}
ATTN_BWD_TOO_LONG = 257
# dw_gemm's product pairs (dqkv^T.h, dout^T.attn) at the training shapes of
# batch 256 x 64 tokens: name -> ((M, P, Q), (M, P, Q))
DW_PAIRS = {
    "s2": ((TRAIN_BATCH * 64, 1152, 384), (TRAIN_BATCH * 64, 384, 384)),
    "b2": ((TRAIN_BATCH * 64, 2304, 768), (TRAIN_BATCH * 64, 768, 768)),
}
BWD_SRC = "mapdit_tpu_torch/csrc/attn_branch_bwd.cu"
# the modulate passes and the residual backward of the attention half-block:
# name -> (N, T, D). The S/2 training call (the report rows, on the
# backward's own tensors in phase 3), then the B/2 and XL/2 widths at batch
# 256, an odd N, and the registry's T = 16 and T = 4 (16 x 16 latents at
# patch 4 and 8); D = MODULATE_BAD_D (not a multiple of 8) must raise.
MODULATE_SHAPES = {
    "s2": (TRAIN_BATCH, 64, 384),
    "b2": (TRAIN_BATCH, 64, 768),
    "xl": (TRAIN_BATCH, 64, 1152),
    "n3": (3, 64, 384),
    "t16": (8, 16, 768),
    "t4": (8, 4, 1152),
}
MODULATE_BAD_D = 388
# the attention backward's out product with the residual backward as its
# epilogue (attn_branch.out_gate_residual_bwd): name -> (N, T, D). The
# MODULATE_SHAPES entries (s2 the report row, on the backward's own tensors
# in phase 3; b2 and xl printed beside it; n3, t16 and t4 split K), then
# whole tiles at T = 16 and T = 128, and N = 257 at T = 4 and T = 64 (the
# last tile partly past M), then T not dividing 128, where a sample's sums
# cross row tiles: T = 256 at the 32 x 32 train batch (the report row of
# that form, counted on phase 6c's path) and at the XL width (split K),
# T = 48 (the former refusal) and T = 144; T = OUT_GATE_BAD_T (below 8, not
# dividing 128) must raise.
OUT_GATE_SHAPES = dict(MODULATE_SHAPES, **{
    "t16-n256": (TRAIN_BATCH, 16, 768),
    "t128": (64, 128, 384),
    "t4-n257": (TRAIN_BATCH + 1, 4, 1152),
    "t64-n257": (TRAIN_BATCH + 1, 64, 384),
    "t256": (32, 256, 384),
    "t256-xl": (2, 256, 1152),
    "t48": (64, 48, 384),
    "t144": (3, 144, 768),
})
OUT_GATE_BAD_T = 6
# the report rows of the T = 256 forms and the path whose launches they
# report: phase 6c's mega_attn path, phase 5d's 32 x 32 mega_stack run
T256_PATH = "t256/mega_attn+pallas"
T256_BENCH = "bench/ddpm-50-input-32-mega-stack"
GEMM_SRC = "mapdit_tpu_torch/csrc/mp_gemm.cu"


def attn_bwd_case(torch, F, gen, dev, name, qkv=None, dattn=None):
    """One ATTN_BWD_SHAPES entry on f32 qkv and dattn drawn from ``gen`` (or
    the given ones): the wrapper and plain calls (bf16 dqkv), FLOPs, bytes
    (qkv and dattn read once, dqkv written once) and the yardstick, SDPA's
    forward and backward on the pre-normalised bf16 q, k, v. ``check(got)``
    holds dqkv to the plain version at 1e-2 relative L2 (~2.5 bf16 ulps;
    several bf16 roundings upstream: the normalised rows, p, dlog) and a
    second run to the same bits."""
    import types

    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.mp import normalize

    n, t, heads, hd = ATTN_BWD_SHAPES[name]
    d, bf = heads * hd, torch.bfloat16
    if qkv is None:
        qkv = torch.randn(n * t, 3 * d, generator=gen, device=dev)
    if dattn is None:
        dattn = torch.randn(n * t, d, generator=gen, device=dev)
    q4, k4, v4 = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qs, ks, vs = (z.to(bf).contiguous().requires_grad_() for z in (normalize(q4), normalize(k4), v4))
    do4 = dattn.reshape(n, t, heads, hd).transpose(1, 2).to(bf).contiguous()

    def run():
        return ab.attention_bwd(qkv, dattn, t, heads, bf)

    def plain():
        return ab.attention_bwd_plain(qkv, dattn, t, heads, bf)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, scale=1 / math.sqrt(hd))
        return torch.autograd.grad(o, (qs, ks, vs), do4)

    def check(got):
        err = compare_rel(torch, got, plain(), 1e-2, name)
        same = bool(torch.equal(got, run()))
        phase("check", what=f"{name}:same-bits-twice", ok=same)
        if not same:
            raise AssertionError(f"{name}: two runs on the same inputs differ in their bits")
        return err

    return types.SimpleNamespace(
        qkv=qkv, dattn=dattn, shape=(n, t, heads, hd), run=run, plain=plain, library=sdpa_fwd_bwd, check=check,
        flops=10 * n * heads * t * t * hd, nbytes=n * t * 3 * d * 4 + n * t * d * 4 + n * t * 3 * d * 2,
    )


def attn_bwd_shape_checks(torch, F, gen, dev) -> dict:
    """attention_bwd at its ATTN_BWD_SHAPES entries beside the report row,
    checked and timed; then T=ATTN_BWD_TOO_LONG, which must raise before
    anything is launched. Returns the report row of the form past T = 64
    (at T = 256, counted on phase 6c's path)."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    rows = {}
    for name in ATTN_BWD_SHAPES:
        if ":" in name:
            case = attn_bwd_case(torch, F, gen, dev, name)
            err = case.check(case.run())
            row = attention_row(torch, case, name, BWD_SRC, f"{PALLAS}:643")
            if name == "attn_bwd/attention:t256":
                rows[name] = dict(row, max_abs_err=err, path=T256_PATH, count_key="attn_bwd/attention")
    n, t, heads, hd = 2, ATTN_BWD_TOO_LONG, 6, 64
    before = ab.LAUNCHES["attn_bwd/attention"]
    try:
        ab.attention_bwd(torch.zeros(n * t, 3 * heads * hd, device=dev), torch.zeros(n * t, heads * hd, device=dev), t,
                         heads, torch.bfloat16)
    except ValueError as e:
        phase("check", what=f"attn_bwd/attention:t{t}", raises="ValueError", message=json.dumps(str(e)),
              launched=ab.LAUNCHES["attn_bwd/attention"] - before)
    else:
        raise AssertionError(f"attention_bwd took T={t}, past its limit of {ab.ATTENTION_BWD_MAX_T}")
    return rows


def cosine_case(torch, F, gen, dev, name, qkv=None):
    """One COSINE_SHAPES entry on f32 qkv drawn from ``gen`` (or the given
    one): the wrapper and plain calls (bf16 out; residual mode writes p),
    FLOPs, bytes (qkv read once, the output and p written once) and the SDPA
    yardstick on pre-normalised bf16 q, k, v. ``check(got, got_p)`` holds an
    output (and p) to the plain version: 1e-2 + 1e-2 relative (~2.5 bf16
    ulps), p 1e-3 + 1e-2 relative (f32, exp in another form)."""
    import types

    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.mp import normalize

    n, t, heads, hd, residual = COSINE_SHAPES[name]
    d, bf = heads * hd, torch.bfloat16
    if qkv is None:
        qkv = torch.randn(n * t, 3 * d, generator=gen, device=dev)
    probs, probs_p = ((torch.empty(n, heads, t, t, device=dev) for _ in range(2)) if residual else (None, None))
    q4, k4, v4 = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qn, kn, vb = normalize(q4).to(bf), normalize(k4).to(bf), v4.to(bf)

    def check(got, got_p=None):
        err = compare(torch, got, k.cosine_attention_plain(qkv, t, heads, bf, normalize_first=residual, probs=probs_p),
                      1e-2, 1e-2, name)
        if residual:
            err = max(err, compare(torch, got_p, probs_p, 1e-3, 1e-2, name + ":p"))
        return err

    p_bytes = n * heads * t * t * 4 if residual else 0
    return types.SimpleNamespace(
        qkv=qkv, probs=probs, shape=(n, t, heads, hd), residual=residual, check=check,
        run=lambda: k.cosine_attention(qkv, t, heads, bf, normalize_first=residual, probs=probs),
        plain=lambda: k.cosine_attention_plain(qkv, t, heads, bf, normalize_first=residual, probs=probs_p),
        library=lambda: F.scaled_dot_product_attention(qn, kn, vb, scale=1 / math.sqrt(hd)),
        flops=4 * n * heads * t * t * hd, nbytes=n * t * 3 * d * 4 + n * t * d * 2 + p_bytes,
    )


def fused_case(torch, F, gen, dev, name):
    """One FUSED_SHAPES entry on q, k, v drawn from ``gen`` as the model
    hands them in (transposed views of one (N, T, 3D) qkv product, no copy):
    the wrapper and plain calls, FLOPs, bytes and the SDPA yardstick (on
    pre-normalised q, k under cosine). ``check(got)`` holds an output to the
    plain version at the entry's tolerance; a case with scaled inputs first
    shows that its logits pass 88."""
    import types

    from mapdit_tpu_torch.ops.cuda import attention as at
    from mapdit_tpu_torch.ops.mp import normalize

    (n, h, t, hd), dtype, cosine, scale_in, atol, rtol = FUSED_SHAPES[name]
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    qkv = (torch.randn(n, t, 3 * h * hd, generator=gen, device=dev) * scale_in).to(dtype)
    q, k_, v = (z.reshape(n, t, h, hd).transpose(1, 2) for z in qkv.split(h * hd, dim=-1))
    sc = 1.0 if scale_in != 1.0 else 1 / math.sqrt(hd)
    qn, kn = (normalize(q.float()).to(dtype), normalize(k_.float()).to(dtype)) if cosine else (q, k_)
    qn, kn, vc = qn.contiguous(), kn.contiguous(), v.contiguous()

    def check(got):
        want = at.fused_attention_plain(q, k_, v, sc, cosine)
        if scale_in != 1.0:
            top = float((q.float() @ k_.float().transpose(-1, -2)).abs().max()) * sc
            phase("check", what=name, max_abs_logit=f"{top:.1f}")
            if top <= 88.0:
                raise AssertionError(f"{name}: logits stay under 88, the case does not test the row maximum")
            if dtype == torch.bfloat16:
                # where the kernel and the plain version lie apart, float64
                # decides (order_witness; PERF.md, ROADMAP C)
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name}: non-finite kernel output")
                row = order_witness(torch, name, q, k_, v, sc, got, want, atol, rtol)
                if not row["ok"]:
                    raise AssertionError(f"{name}: kernel or plain version lies past a near tie from float64: {row}")
                return row["kernel_vs_plain"]
        return compare(torch, got, want, atol, rtol, name)

    return types.SimpleNamespace(
        q=q, k=k_, v=v, scale=sc, cosine=cosine, shape=(n, h, t, hd), check=check,
        run=lambda: at.fused_attention(q, k_, v, sc, cosine),
        plain=lambda: at.fused_attention_plain(q, k_, v, sc, cosine),
        library=lambda: F.scaled_dot_product_attention(qn, kn, vc, scale=sc),
        flops=4 * n * h * t * t * hd, nbytes=4 * n * h * t * hd * q.element_size(),
    )


def order_witness(torch, name, q, k, v, scale, got, want, atol, rtol) -> dict:
    """bf16 attention without cosine at logits past 88, where the order of
    the f32 sums alone moves a near-tied p across a bf16 rounding boundary:
    the kernel's ``got`` and the plain version's ``want`` against a float64
    evaluation of the same roundings (p rounded to bf16, the product summed
    in float64, the output rounded to bf16). Where got and want lie more
    than atol + rtol |want| apart, ``ok`` asks both to lie within atol +
    rtol |ref| + tie of it, tie = 2^-8 max|v|: two near-tied p of ~1/2,
    each moved by its bf16 ulp (2^-9), times the largest |v|. Prints the max
    abs distances (all, and where got and want lie apart) and ``ok``;
    returns them."""
    p64 = torch.softmax((q.double() @ k.double().transpose(-1, -2)) * scale, dim=-1)
    ref = (p64.to(torch.bfloat16).double() @ v.double()).to(torch.bfloat16).double()
    g, w = got.double(), want.double()
    gd, wd = (g - ref).abs(), (w - ref).abs()
    apart = (g - w).abs() > atol + rtol * w.abs()
    tie = 2.0 ** -8 * float(v.abs().max())
    near = atol + rtol * ref.abs() + tie

    def most(d):
        return float(d.max()) if d.numel() else 0.0

    row = dict(kernel_vs_plain=most((g - w).abs()), kernel_vs_f64=most(gd), plain_vs_f64=most(wd),
               apart=int(apart.sum()), kernel_vs_f64_apart=most(gd[apart]), plain_vs_f64_apart=most(wd[apart]),
               tie=tie, ok=bool(((gd <= near) & (wd <= near))[apart].all()))
    phase("check", what=name + ":order-witness", **row)
    return row


def attention_row(torch, case, name, source, replaces) -> dict:
    """A case's report row: device ms of the wrapper, the plain version and
    the SDPA yardstick from CUDA-graph replays, the bound, and the wrapper's
    host ms printed beside."""
    b, by = bound_ms(case.flops, case.nbytes)
    row = dict(source=source, replaces=replaces, ms=graph_ms(torch, case.run), plain_ms=graph_ms(torch, case.plain),
               bound_ms=b, bound_by=by, library_ms=graph_ms(torch, case.library))
    phase("time", kernel=name, shape="x".join(map(str, case.shape)), ms=f"{row['ms']:.4f}",
          plain_ms=f"{row['plain_ms']:.4f}", bound_ms=f"{b:.4f}", library_ms=f"{row['library_ms']:.4f}",
          host_ms=f"{host_ms(torch, case.run):.4f}")
    return row


COSINE_SRC = "mapdit_tpu_torch/csrc/cosine_attention.cu"
FUSED_SRC = "mapdit_tpu_torch/csrc/fused_attention.cu"
FUSED_LINE = "mapdit_tpu/ops/pallas/attention.py:125"


def cosine_shape_checks(torch, F, gen, dev) -> None:
    """Phase 3, last part: cosine_attention at its COSINE_SHAPES entries
    beside the report rows, checked and timed."""
    for name in COSINE_SHAPES:
        if ":" in name:
            case = cosine_case(torch, F, gen, dev, name)
            case.check(case.run(), case.probs)
            attention_row(torch, case, name, COSINE_SRC, None)


# The kernel paths' gradients against autograd of the float32 reference on
# the same bf16 inputs. A bf16 VJP (the JAX package's and the port's: both
# recompute in the inputs' types) lands ~1e-2 relative L2 from it: JAX's
# twin reads up to 1.064e-2 against its own float32 VJP on the cotangent
# arrays of tests/test_torch_vjp.py (run as a script, it prints them), which
# holds both packages to GRAD_TOL there; the port read 3.8e-3 to 9.1e-3 on the
# arrays here (H100). GRAD_TOL is twice JAX's reading, as check_paths allows
# twice the bf16 plain path's distance. The gains' cotangents are sums over
# the batch that cancel, so their relative error is set by the sum's size:
# they read 5.7e-3 to 1.236e-2 here, 1.729e-2 and 4.403e-2 from JAX's float32
# VJP at the test's XS widths, and are held to GAIN_GRAD_TOL. 1e-2 (1e-3 on
# a gain) holds only a float32 recompute, one bf16 rounding from the
# reference.
GRAD_TOL, GAIN_GRAD_TOL = 2e-2, 5e-2


def grad_checks(torch, what, kernel_grad, reference, inputs, cot, names, gains=()):
    """A kernel path's gradients against autograd of the float32 reference
    on the same inputs: relative L2 at most GRAD_TOL, GAIN_GRAD_TOL for the
    cotangents named in ``gains``. The kernels' VJP recomputes the backward
    through the plain reference in the inputs' types (as jax.vjp of the
    Pallas package's _reference does), so its gradients must also equal
    autograd of that reference in those types bit for bit: a wiring check
    that the saved inputs and the cotangent reach the recompute unchanged.
    Times of the three."""
    def same_types():
        ref_in = [v.detach().requires_grad_() for v in inputs]
        return torch.autograd.grad(reference(*ref_in), ref_in, cot)

    def in_f32():
        ref_in = [v.detach().float().requires_grad_() for v in inputs]
        return torch.autograd.grad(reference(*ref_in), ref_in, cot.float())

    for nm, g_, w_, f_ in zip(names, kernel_grad(), same_types(), in_f32()):
        compare_rel(torch, g_, f_, GAIN_GRAD_TOL if nm in gains else GRAD_TOL, f"{what}:{nm}")
        same = bool(torch.equal(g_, w_))
        phase("check", what=f"{what}:{nm}:wiring", same_bits_as_reference_in_input_types=same)
        if not same:
            raise AssertionError(f"{what}:{nm}: not the recompute through the reference in the inputs' types")
    phase("time", kernel=what, ms=f"{time_ms(torch, kernel_grad, iters=3):.4f}",
          plain_ms=f"{time_ms(torch, same_types, iters=3):.4f}", f32_ms=f"{time_ms(torch, in_f32, iters=3):.4f}",
          note="forward+backward, rows=" + str(inputs[0].shape[0]))


def attn_branch_args(torch, gen, dev, n, t, d, heads):
    """The attention half-block's inputs at phase 3's training shapes, drawn
    from ``gen``: ((x, shift, scale, gate, gain, W_qkv, W_out, heads), dy),
    bf16 but the gain."""
    from mapdit_tpu_torch.ops.mp import normalize

    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    x = randn(n, t, d)
    shift, scale, gate = (randn(n, d) for _ in range(3))
    gain = torch.tensor(0.37, device=dev)
    wq, wo = (normalize(torch.randn(*s, generator=gen, device=dev)).to(bf).contiguous() for s in ((3 * d, d), (d, d)))
    return (x, shift, scale, gate, gain, wq, wo, heads), randn(n, t, d)


def attn_bwd_stages(torch, k, ab, dy, args):
    """The attention half-block backward's intermediates from the plain
    versions, in the order of ``attn_branch._bwd_stages``: (rows, gain,
    x, h, qkv, attn, out, dout, dattn, dqkv, dh), x flat."""
    x, shift, scale, gate, gain, wq, wo, heads = args
    n, t, d = x.shape
    bf, f32, inv_d = torch.bfloat16, torch.float32, 1 / math.sqrt(d)
    rows = torch.cat([shift, scale, gate], dim=1).float().contiguous()
    g1 = gain.reshape(1).float().contiguous()
    xf = x.reshape(n * t, d)
    h = ab.modulate_fwd_plain(xf, rows, g1, t, bf)
    qkv = k.mp_gemm_plain(h, wq, alpha=inv_d, out_dtype=f32)
    attn = k.cosine_attention_plain(qkv, t, heads, bf, normalize_first=True)
    out = k.mp_gemm_plain(attn, wo, alpha=inv_d, out_dtype=f32)
    # dout is the second to last output of every form of gate_residual_bwd
    # (an earlier one returned dx0 first), so tools/attn_bwd_witness.py can
    # run an older checkout's kernels on the same inputs
    dout = ab.gate_residual_bwd_plain(dy, out, rows, 2 * d, t, bf)[-2]
    dattn = k.mp_gemm_plain(dout, wo, alpha=inv_d, out_dtype=f32, w_kn=True)
    dqkv = ab.attention_bwd_plain(qkv, dattn, t, heads, bf)
    dh = k.mp_gemm_plain(dqkv, wq, alpha=inv_d, out_dtype=f32, w_kn=True)
    return rows, g1, xf, h, qkv, attn, out, dout, dattn, dqkv, dh


def dgain_terms(torch, stages):
    """The terms whose sum is the attention half-block's dgain,
    dh * (shift - x*scale) / sqrt((1-g)^2 + g^2), from attn_bwd_stages."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    rows, g1, xf, dh = stages[0], stages[1], stages[2], stages[-1]
    g = g1.reshape(())
    return ab.dgain_terms(dh, xf, rows, g1, xf.shape[0] // rows.shape[0]) / torch.sqrt((1 - g) ** 2 + g**2)


def pass_check(torch, what, run, plain, names, scalars=()):
    """A check for a kernel of several outputs: every output against the
    plain version at 1e-2 + 1e-2 relative (those named in ``scalars`` by
    compare_scalar at 1e-4: one sum of identical f32 inputs, only its order
    differs), then a second run to the same bits. ``check(got)`` returns
    the max abs error."""

    def check(got):
        got = got if isinstance(got, tuple) else (got,)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        errs = [compare_scalar(torch, g_, w_, 1e-4, f"{what}:{nm}") if nm in scalars
                else compare(torch, g_, w_, 1e-2, 1e-2, f"{what}:{nm}") for nm, g_, w_ in zip(names, got, want)]
        again = run()
        again = again if isinstance(again, tuple) else (again,)
        same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again))
        phase("check", what=f"{what}:same-bits-twice", outputs=",".join(names), ok=same)
        if not same:
            raise AssertionError(f"{what}: two runs on the same inputs differ in their bits")
        return max(errs)

    return check


def modulate_case(torch, gen, dev, name, tensors=None):
    """One MODULATE_SHAPES entry: x and dy (bf16, flat (N*T, D)), rows
    (N, 3D) f32 [shift | scale | gate], the gain (0.37) and dh (f32), drawn
    from ``gen`` unless ``tensors`` gives them (a dict of those names).
    Returns ``{kernel: namespace}`` for modulate_fwd and modulate_bwd, with
    ``run`` and ``plain`` (the wrapper and its plain version), ``check(got)``
    (pass_check; dgain by compare_scalar), ``flops``, ``nbytes`` (each input
    read once, each output written once) and ``library``: for modulate_fwd
    one torch.addcmul over the (N, T, D) view into a bf16 h with the rows
    a = scale*(1-g)/den and b = shift*g/den made beforehand, else None (no
    one call gives modulate's backward: dx and three sums)."""
    import types

    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    n, t, d = MODULATE_SHAPES[name]
    mt, bf = n * t, torch.bfloat16
    if tensors is None:
        x, dy = (torch.randn(mt, d, generator=gen, device=dev).to(bf) for _ in range(2))
        rows = torch.randn(n, 3 * d, generator=gen, device=dev)
        dh = torch.randn(mt, d, generator=gen, device=dev)
        gain = torch.tensor([0.37], device=dev)
    else:
        x, dy, rows, gain, dh = (tensors[key] for key in ("x", "dy", "rows", "gain", "dh"))
    calls = {
        "modulate_fwd": (lambda: ab.modulate_fwd(x, rows, gain, t, bf),
                         lambda: ab.modulate_fwd_plain(x, rows, gain, t, bf), ("h",)),
        "modulate_bwd": (lambda: ab.modulate_bwd(dh, x, rows, gain, dy, t),
                         lambda: ab.modulate_bwd_plain(dh, x, rows, gain, dy, t), ("dx", "dshift", "dscale", "dgain")),
    }
    g = gain.reshape(())
    den = torch.sqrt((1 - g) ** 2 + g**2)
    a3 = (rows[:, d:2 * d] * ((1 - g) / den)).reshape(n, 1, d)
    b3 = (rows[:, :d] * (g / den)).reshape(n, 1, d)
    x3, h3 = x.view(n, t, d), torch.empty(n, t, d, dtype=bf, device=dev)
    sizes = {  # (flops, bytes)
        "modulate_fwd": (5 * mt * d, mt * d * (2 + 2) + 2 * n * d * 4 + 4),
        "modulate_bwd": (10 * mt * d, mt * d * (4 + 2 + 2 + 2) + 2 * n * d * 4 + 2 * n * d * 4 + 4 + 4),
    }
    cases = {}
    for kernel, (run, plain, names) in calls.items():
        flops, nbytes = sizes[kernel]
        library = (lambda: torch.addcmul(b3, x3, a3, out=h3)) if kernel == "modulate_fwd" else None
        cases[kernel] = types.SimpleNamespace(
            run=run, plain=plain, check=pass_check(torch, f"attn_bwd/{kernel}:{name}", run, plain, names, ("dgain",)),
            flops=flops, nbytes=nbytes, library=library, shape=(n, t, d),
            inputs=dict(x=x, dy=dy, rows=rows, gain=gain, dh=dh))
    return cases


def out_gate_case(torch, gen, dev, name, tensors=None):
    """One OUT_GATE_SHAPES entry of out_gate_residual_bwd: attn and dy
    (bf16, flat (N*T, D)), the weight w (D, D) bf16 and rows (N, 3D) f32
    holding the gate at 2D, drawn from ``gen`` unless ``tensors`` gives them
    (a dict of those names). A namespace as modulate_case's: ``check``
    holds dout and dgate to the plain version (the product's f32 out, then
    gate_residual_bwd_plain) at 1e-2 + 1e-2 relative and a second run to the
    same bits; the bound counts attn, w, dy and the gate read once, dout and
    dgate written once, and the product's 2*M*D*D operations; ``library`` is
    one torch.matmul of the product alone."""
    import types

    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.mp import normalize

    n, t, d = OUT_GATE_SHAPES[name]
    mt, bf = n * t, torch.bfloat16
    if tensors is None:
        attn, dy = (torch.randn(mt, d, generator=gen, device=dev).to(bf) for _ in range(2))
        w = normalize(torch.randn(d, d, generator=gen, device=dev)).to(bf).contiguous()
        rows = torch.randn(n, 3 * d, generator=gen, device=dev)
    else:
        attn, w, dy, rows = (tensors[key] for key in ("attn", "w", "dy", "rows"))

    def run():
        return ab.out_gate_residual_bwd(attn, w, dy, rows, 2 * d, t)

    def plain():
        return ab.out_gate_residual_bwd_plain(attn, w, dy, rows, 2 * d, t)

    nbytes = mt * d * 2 + d * d * 2 + dy.numel() * dy.element_size() + n * d * 4 + mt * d * 2 + n * d * 4
    return types.SimpleNamespace(
        run=run, plain=plain, check=pass_check(torch, f"attn_bwd/out_gate_residual:{name}", run, plain,
                                               ("dout", "dgate")),
        flops=2 * mt * d * d, nbytes=nbytes, library=lambda: torch.matmul(attn, w.t()), shape=(n, t, d),
        inputs=dict(attn=attn, w=w, dy=dy, rows=rows))


def pass_row(torch, case, replaces, source=BWD_SRC) -> dict:
    """A report row of a modulate_case or out_gate_case kernel: device ms of
    CUDA-graph replays for the kernel, its plain version and the library
    call, and the wrapper's host ms."""
    b, by = bound_ms(case.flops, case.nbytes)
    return dict(source=source, replaces=f"{PALLAS}:{replaces}", ms=graph_ms(torch, case.run),
                plain_ms=graph_ms(torch, case.plain), bound_ms=b, bound_by=by,
                library_ms=None if case.library is None else graph_ms(torch, case.library),
                host_ms=host_ms(torch, case.run))


def out_gate_shape_checks(torch, gen, dev) -> dict:
    """out_gate_residual_bwd at its OUT_GATE_SHAPES entries beside the
    report row, checked and timed; then T = OUT_GATE_BAD_T, which it must
    refuse before anything is launched. Returns the report row of the form
    where T does not divide 128 (at T = 256, counted on phase 6c's path)."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    rows = {}
    for name in OUT_GATE_SHAPES:
        if name == "s2":
            continue
        case = out_gate_case(torch, gen, dev, name)
        err = case.check(case.run())
        row = pass_row(torch, case, 622, GEMM_SRC)
        if name == "t256":
            rows["attn_bwd/out_gate_residual:t256"] = dict(row, max_abs_err=err, path=T256_PATH,
                                                          count_key="attn_bwd/out_gate_residual")
        phase("time", kernel=f"attn_bwd/out_gate_residual:{name}", shape=case.shape, max_abs_err=f"{err:.3e}",
              **{key: f"{row[key]:.4f}" for key in ("ms", "plain_ms", "bound_ms", "library_ms", "host_ms")},
              bound_by=row["bound_by"])
    n, t, d = 2, OUT_GATE_BAD_T, 64
    z = torch.zeros(n * t, d, dtype=torch.bfloat16, device=dev)
    before = ab.LAUNCHES["attn_bwd/out_gate_residual"]
    try:
        ab.out_gate_residual_bwd(z, z[:d], z, torch.zeros(n, 3 * d, device=dev), 2 * d, t)
    except ValueError as e:
        phase("check", what=f"attn_bwd/out_gate_residual:t{t}", raises="ValueError", message=json.dumps(str(e)),
              launched=ab.LAUNCHES["attn_bwd/out_gate_residual"] - before)
    else:
        raise AssertionError(f"out_gate_residual_bwd took T={t}, which neither divides {ab.GEMM_TILE_ROWS} nor "
                             f"exceeds {ab.GATE_GROUP_ROWS}")
    return rows


def modulate_shape_checks(torch, gen, dev) -> None:
    """The modulate passes at their MODULATE_SHAPES entries beside the
    report rows, checked and timed; then
    D = MODULATE_BAD_D, which both modulate passes must refuse before
    anything is launched."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    for name in MODULATE_SHAPES:
        if name == "s2":
            continue
        for kernel, case in modulate_case(torch, gen, dev, name).items():
            case.check(case.run())
            row = pass_row(torch, case, None)
            phase("time", kernel=f"attn_bwd/{kernel}:{name}", shape=case.shape, ms=f"{row['ms']:.4f}",
                  plain_ms=f"{row['plain_ms']:.4f}", bound_ms=f"{row['bound_ms']:.4f}",
                  library_ms=row["library_ms"] and f"{row['library_ms']:.4f}")
    n, t, d = 2, 16, MODULATE_BAD_D
    x = torch.zeros(n * t, d, dtype=torch.bfloat16, device=dev)
    rows, gain, dh = torch.zeros(n, 3 * d, device=dev), torch.zeros(1, device=dev), torch.zeros(n * t, d, device=dev)
    for kernel, call in (("modulate_fwd", lambda: ab.modulate_fwd(x, rows, gain, t, torch.bfloat16)),
                         ("modulate_bwd", lambda: ab.modulate_bwd(dh, x, rows, gain, x, t))):
        before = ab.LAUNCHES[f"attn_bwd/{kernel}"]
        try:
            call()
        except ValueError as e:
            phase("check", what=f"attn_bwd/{kernel}:d{d}", raises="ValueError", message=json.dumps(str(e)),
                  launched=ab.LAUNCHES[f"attn_bwd/{kernel}"] - before)
        else:
            raise AssertionError(f"{kernel} took D={d}, not a multiple of {ab.MODULATE_COLUMNS}")


# attn_branch/bwd beside its report row: name -> (N, T, D, heads); the B/2
# and XL/2 widths, an odd N, T = 16 and T = 4
BRANCH_BWD_SHAPES = {
    "b2": (8, 64, 768, 12),
    "xl": (4, 64, 1152, 16),
    "n3": (3, 64, 384, 6),
    "t16": (8, 16, 768, 12),
    "t4": (8, 4, 1152, 16),
    "t2": (5, 2, 384, 6),
}
# a T outside the one-launch kernels' domain (even, not dividing 128)
BRANCH_OUTSIDE_T = 48
# rows 3 and 4's report rows at DiT-XL/2 (hd 72) at its training batch:
# (N, T, D, heads), and the train path whose launches they report
BRANCH_XL = (XL_TRAIN_BATCH, 64, 1152, 16)
BRANCH_XL_PATH = "xl/mega_attn+pallas:no-remat"
BRANCH_SRC = "mapdit_tpu_torch/csrc/attn_branch.cu"


def branch_bwd_checks(torch, k, gen, dev) -> None:
    """Rows 3, 4 and 5 (csrc/attn_branch.cu through attn_fwd, attn_bwd and
    attn_branch_res_fwd) at BRANCH_BWD_SHAPES against attn_fwd_plain,
    attn_bwd_plain and attn_res_fwd_plain (the report rows' limits: relative
    L2 1e-2, dgain within 2^-8 of its terms' root-sum-square), the same bits
    on two runs and whether they equal the launch sequences'; then the
    domain rule at T = 48: all three take their launch sequences (the
    backward's, past the T dividing 128 that out_gate_residual_bwd once
    took, held to attn_bwd_plain by the same limits), no one-launch kernel
    runs."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.tools import bench_attn_branch as bab

    for name, (n, t, d, heads) in BRANCH_BWD_SHAPES.items():
        args, dy = attn_branch_args(torch, gen, dev, n, t, d, heads)
        before = launch_counts()
        bab.check(name, args, dy)
        after = launch_counts()
        if after["attn_branch/bwd"] == before["attn_branch/bwd"] or after["attn_branch/bwd/sequence"] != before[
                "attn_branch/bwd/sequence"]:
            raise AssertionError(f"attn_branch:{name}: attn_bwd did not take the one-launch kernel")
    args, dy = attn_branch_args(torch, gen, dev, 4, BRANCH_OUTSIDE_T, 384, 6)
    before = launch_counts()
    y = ab.attn_fwd(*args)
    compare_rel(torch, y, ab.attn_fwd_plain(*args), 1e-2, f"attn_branch/fwd:t{BRANCH_OUTSIDE_T}:sequence")
    for nm, g_, w_ in zip(("y", "p", "attn"), ab.attn_res_fwd(*args), ab.attn_res_fwd_plain(*args)):
        compare_rel(torch, g_, w_, 1e-2, f"attn_branch/res_fwd:t{BRANCH_OUTSIDE_T}:sequence:{nm}")
    try:
        bab.check_bwd(f"t{BRANCH_OUTSIDE_T}:sequence", args, dy)
        raised = None
    except ValueError as e:
        raised = str(e)
    after = launch_counts()
    moved = {key: after[key] - before[key] for key in after if after[key] != before[key]}
    # check_bwd calls the backward twice (the same bits on two runs)
    ok = (raised is None and all(moved.get(f"attn_branch/{row}/sequence") == 1 for row in ("fwd", "res_fwd"))
          and moved.get("attn_branch/bwd/sequence") == 2
          and not any(moved.get(f"attn_branch/{row}") for row in ("fwd", "bwd", "res_fwd")))
    phase("check", what=f"attn_branch:t{BRANCH_OUTSIDE_T}:sequence-route", raises=json.dumps(raised),
          launched=json.dumps(moved), ok=ok)
    if not ok:
        raise AssertionError(f"attn_branch at T={BRANCH_OUTSIDE_T}: not the sequence route ({moved}, {raised})")


def branch_rows(torch, args, dy, path: str) -> dict:
    """Rows 3 and 4 at one shape: both kernels held to their plain versions
    (mapdit_tpu_torch/tools/bench_attn_branch.py check: relative L2 1e-2,
    dgain within 2^-8 of its terms' root-sum-square, the same bits twice,
    whether they equal the launch sequences'), timed beside the launch
    sequences in the same call (graph, eager and host ms), their bounds
    (row 4's without the dW pair); then the dW pair as the path runs it
    (one bf16 product each with f32 sums) against the f32 pair (relative L2
    1e-5), both timed. Returns the kernels line's two rows."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.tools import bench_attn_branch as bab

    x, heads = args[0], args[-1]
    n, t, d = x.shape
    tag = "s2" if d == 384 else "xl" if d == 1152 else f"d{d}"
    checks = bab.check(tag, args, dy, kinds=("fwd", "bwd"))
    bounds = bab.bounds(n, t, d, heads)
    out = {}
    for kind, line, fn, seq, plain in (
        ("fwd", 1007, lambda: ab.attn_branch_fwd(*args), lambda: ab.fwd_launch_sequence(*args),
         lambda: ab.attn_fwd_plain(*args)),
        ("bwd", 918, lambda: ab.attn_branch_bwd(dy, *args), lambda: ab.bwd_launch_sequence(dy, *args),
         lambda: ab.attn_bwd_plain(dy, *args)),
    ):
        times = bab.times(fn, seq, plain)
        out[f"attn_branch/{kind}"] = dict(
            source=BRANCH_SRC, replaces=f"{PALLAS}:{line}", max_abs_err=checks[kind]["max_abs_err"], ms=times["ms"],
            plain_ms=times["plain_ms"], bound_ms=bounds[kind][0], bound_by=bounds[kind][1], library_ms=None, path=path,
            eager_ms=times["eager_ms"], host_ms=times["host_ms"], sequence_ms=times["sequence_ms"],
            sequence_eager_ms=times["sequence_eager_ms"], sequence_host_ms=times["sequence_host_ms"],
            same_bits_as_sequence=checks[kind]["same_bits_as_sequence"])
        phase("time", kernel=f"attn_branch/{kind}:{tag}", **{key: (f"{v:.4f}" if isinstance(v, float) else v)
                                                            for key, v in times.items()},
              bound_ms=f"{bounds[kind][0]:.4f}", bound_by=bounds[kind][1])
    pair = bab.dw_pair(args, dy)
    phase("time", kernel=f"attn_branch/dw-pair:{tag}", **{key: f"{v:.4e}" for key, v in pair.items()},
          library="torch.mm(out_dtype=torch.float32) x 2")
    return out


# row 5's draws: a generator of its own, so that every other row keeps the
# inputs it drew before row 5 had a kernel
RES_SEED_OFFSET = 17


def res_rows(torch, dev, t, d, heads) -> dict:
    """Row 5 (csrc/attn_branch.cu attn_branch_res_fwd) at the DiT-S/2 and
    DiT-XL/2 training shapes on draws of its own: y, p and attn each held to
    attn_res_fwd_plain by relative L2 1e-2, the same bits twice, whether
    each equals the launch sequence's bits
    (mapdit_tpu_torch/tools/bench_attn_branch.py check_res); timed beside
    its launch sequence (graph, host and eager ms), the plain version's
    graph ms, the bound. Returns the kernels line's S/2 row (its launches
    from phase 6's mega_attn+residual path); XL/2 is printed only (no main
    path trains XL/2 on the residual backward)."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.tools import bench_attn_branch as bab

    gen = torch.Generator(device=dev).manual_seed(SEED + RES_SEED_OFFSET)
    out = {}
    for tag, shape in (("s2", (TRAIN_BATCH, t, d, heads)), ("xl", BRANCH_XL)):
        args, _ = attn_branch_args(torch, gen, dev, *shape)
        check = bab.check_res(tag, args)
        bound, by, *_ = bab.bounds(*shape)["res_fwd"]
        times = bab.times(lambda: ab.attn_branch_res_fwd(*args), lambda: ab.res_fwd_launch_sequence(*args),
                          lambda: ab.attn_res_fwd_plain(*args))
        phase("time", kernel=f"attn_branch/res_fwd:{tag}", **{key: f"{v:.4f}" for key, v in times.items()},
              bound_ms=f"{bound:.4f}", bound_by=by)
        if tag == "s2":
            out["attn_branch/res_fwd"] = dict(
                source=BRANCH_SRC, replaces=f"{PALLAS}:1152", max_abs_err=check["max_abs_err"], ms=times["ms"],
                plain_ms=times["plain_ms"], bound_ms=bound, bound_by=by, library_ms=None, path="mega_attn+residual",
                eager_ms=times["eager_ms"], host_ms=times["host_ms"], sequence_ms=times["sequence_ms"],
                sequence_eager_ms=times["sequence_eager_ms"], sequence_host_ms=times["sequence_host_ms"],
                same_bits_as_sequence=check["same_bits_as_sequence"])
        del args
        torch.cuda.empty_cache()
    return out


def train_kernel_rows(torch, F, k, gen, dev, t, d, heads, x_s, a_s, gains_s, w0):
    """Phase 3, second part: the attention half-block's wrappers and
    sub-kernels at the DiT-S/2 training shapes (TRAIN_BATCH samples x t
    tokens, bf16) against their plain versions, and fused_dit_block's
    gradient at the sampling shapes; returns the kernels' report rows (each
    names the train path whose launch counts it reports)."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.ops.mp import normalize

    bf, f32 = torch.bfloat16, torch.float32
    n, hd = TRAIN_BATCH, d // heads
    mt, inv_d = n * t, 1 / math.sqrt(d)
    args, dy = attn_branch_args(torch, gen, dev, n, t, d, heads)
    x, shift, scale, gate, gain, wq, wo, _ = args
    out_rows = {}

    def row(name, source, replaces, err, fn, plain, flops, nbytes, path, library=None):
        b, by = bound_ms(flops, nbytes)
        out_rows[name] = dict(
            source=source, replaces=f"{PALLAS}:{replaces}", max_abs_err=err, ms=time_ms(torch, fn),
            plain_ms=time_ms(torch, plain), bound_ms=b, bound_by=by,
            library_ms=None if library is None else time_ms(torch, library), path=path,
        )

    # rows 3 and 4, one launch each (csrc/attn_branch.cu): composite outputs,
    # where several bf16 roundings upstream can each land an element one bf16
    # ulp apart from the plain version, so they are held by relative L2 error
    # (1e-2, ~2.5 bf16 ulps) with the max reported; timed beside their launch
    # sequences; at S/2 here and at XL/2 (hd 72) on draws of their own
    out_rows.update(branch_rows(torch, args, dy, "mega_attn+pallas"))
    xl_args, xl_dy = attn_branch_args(torch, torch.Generator(device=dev).manual_seed(SEED + 13), dev, *BRANCH_XL)
    out_rows.update({f"{key}:xl": dict(row_, path=BRANCH_XL_PATH, count_key=key)
                     for key, row_ in branch_rows(torch, xl_args, xl_dy, BRANCH_XL_PATH).items()})
    del xl_args, xl_dy
    # row 5, one launch (csrc/attn_branch.cu), on draws of its own
    out_rows.update(res_rows(torch, dev, t, d, heads))

    # the backward's intermediates, from the plain versions, as inputs of the
    # sub-kernel checks (the order of attn_branch._bwd_stages)
    stages = attn_bwd_stages(torch, k, ab, dy, args)
    rows_, g1, xf, h, qkv, attn, out, dout, dattn, dqkv, dh = stages
    terms = dgain_terms(torch, stages)

    # the A.W products of the backward, on identical inputs
    for site, a_, w_, line in (("dattn", dout, wo, 636), ("dh", dqkv, wq, 683)):
        kk, nn = w_.shape
        err = compare(torch, k.mp_gemm(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True, site=site),
                      k.mp_gemm_plain(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True), 1e-2, 1e-2, f"mp_gemm/{site}")
        row(f"mp_gemm/{site}", "mapdit_tpu_torch/csrc/mp_gemm.cu", line, err,
            lambda a_=a_, w_=w_, site=site: k.mp_gemm(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True, site=site),
            lambda a_=a_, w_=w_: k.mp_gemm_plain(a_, w_, alpha=inv_d, out_dtype=f32, w_kn=True),
            2 * mt * kk * nn, mt * kk * 2 + kk * nn * 2 + mt * nn * 4,
            library=lambda a_=a_, w_=w_: torch.matmul(a_, w_), path="mega_attn+sequence")

    # residual-mode attention, on identical inputs
    case = cosine_case(torch, F, gen, dev, "cosine_attention/residual", qkv=qkv)
    err = case.check(case.run(), case.probs)
    out_rows["cosine_attention/residual"] = dict(
        attention_row(torch, case, "cosine_attention/residual", COSINE_SRC, f"{PALLAS}:1083"), max_abs_err=err,
        path="mega_attn+residual+sequence")

    # the backward's passes around the products, on identical inputs (device
    # ms of CUDA-graph replays), then at their other shapes
    passes = modulate_case(torch, gen, dev, "s2", tensors=dict(x=xf, dy=dy.reshape(mt, d), rows=rows_, gain=g1,
                                                                dh=dh))
    passes["out_gate_residual"] = out_gate_case(torch, gen, dev, "s2", tensors=dict(attn=attn, w=wo,
                                                                                   dy=dy.reshape(mt, d), rows=rows_))
    for kernel, case in passes.items():
        if case.shape != (n, t, d):
            raise AssertionError(f"the {kernel} report row {case.shape} is not the training shape")
    for kernel, line, source in (("out_gate_residual", 622, GEMM_SRC), ("modulate_fwd", 588, BWD_SRC),
                                 ("modulate_bwd", 690, BWD_SRC)):
        case = passes[kernel]
        out_rows[f"attn_bwd/{kernel}"] = dict(pass_row(torch, case, line, source),
                                              max_abs_err=case.check(case.run()), path="mega_attn+sequence")
    # their own generators: every other row keeps the inputs it drew before
    # these checks were added
    mod_gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    modulate_shape_checks(torch, mod_gen, dev)
    branch_bwd_checks(torch, k, mod_gen, dev)
    out_rows.update(out_gate_shape_checks(torch, torch.Generator(device=dev).manual_seed(SEED + 11), dev))

    # attention_bwd on identical inputs (device ms of CUDA-graph replays,
    # SDPA's forward and backward beside), then at its other shapes
    case = attn_bwd_case(torch, F, gen, dev, "attn_bwd/attention", qkv=qkv, dattn=dattn)
    if case.shape != (n, t, heads, hd):
        raise AssertionError(f"ATTN_BWD_SHAPES' report row {case.shape} is not the training shape {(n, t, heads, hd)}")
    err = case.check(case.run())
    out_rows["attn_bwd/attention"] = dict(
        attention_row(torch, case, "attn_bwd/attention", BWD_SRC, f"{PALLAS}:643"), max_abs_err=err,
        path="mega_attn+sequence")
    out_rows.update(attn_bwd_shape_checks(torch, F, gen, dev))

    out_rows["attn_bwd/dw"] = dw_kernel_row(torch, ab, gen, dev, dy, args, (dqkv, h, dout, attn), inv_d, terms)

    # fused_dit_block's gradient: kernel forward, backward through the
    # reference math in the inputs' types (as jax.vjp of the Pallas
    # package's _reference), against autograd of the float32 reference
    inputs = [v.detach().requires_grad_() for v in (x_s, a_s, gains_s, *w0)]
    cot = torch.randn(x_s.shape, generator=gen, device=dev).to(bf)

    def block_grad():
        return torch.autograd.grad(k.fused_dit_block(*inputs, heads), inputs, cot)

    grad_checks(torch, "fused_dit_block/grad", block_grad, lambda *z: k.block_reference(*z, heads), inputs, cot,
                [str(i) for i in range(len(inputs))], gains=("2",))
    return out_rows


def dw_kernel_row(torch, ab, gen, dev, dy, args, operands, inv_d, terms) -> dict:
    """Phase 3, row 4': dw_gemm against its plain version on the backward's
    own operands at the DiT-S/2 training shapes (both products; the row times
    the pair, device ms of CUDA-graph replays), at the DiT-B/2 shapes and at
    a ragged M, the same bits on two runs; then attn_bwd with the dW switch
    on against attn_bwd_plain with it on (seven cotangents, dgain against
    the spread of its ``terms``), with no f32 matmul left on the path. The
    row's launches come from the train CLI's run with the switch on (phase
    8)."""
    from torch.overrides import TorchFunctionMode

    bf = torch.bfloat16
    dqkv, h, dout, attn = operands
    pairs = ((dqkv, h), (dout, attn))

    def kernel_pair():
        return [ab.dw_gemm(a_, b_, inv_d) for a_, b_ in pairs]

    def plain_pair():
        return [ab.dw_gemm_plain(a_, b_, inv_d) for a_, b_ in pairs]

    # products of bf16 values are exact in f32 and both sides sum in f32:
    # only the order of the sums differs
    errs = [compare(torch, g_, w_, 1e-4, 1e-4, f"dw_gemm:{nm}")
            for nm, g_, w_ in zip(("dqkv^T.h", "dout^T.attn"), kernel_pair(), plain_pair())]
    for g_, again in zip(kernel_pair(), kernel_pair()):
        if not torch.equal(g_, again):
            raise AssertionError("dw_gemm: two runs on the same inputs differ in their bits")
    flops = sum(2 * a_.shape[0] * a_.shape[1] * b_.shape[1] for a_, b_ in pairs)
    nbytes = sum((a_.numel() + b_.numel()) * 2 + a_.shape[1] * b_.shape[1] * 4 for a_, b_ in pairs)
    b, by = bound_ms(flops, nbytes)
    row = dict(
        source="mapdit_tpu_torch/csrc/dw_gemm.cu", replaces=f"{PALLAS}:783", max_abs_err=max(errs),
        ms=graph_ms(torch, kernel_pair), plain_ms=graph_ms(torch, plain_pair), bound_ms=b, bound_by=by,
        # one PyTorch call each: the bf16 products cuBLAS would run
        library_ms=graph_ms(torch, lambda: [torch.matmul(a_.t(), b_) for a_, b_ in pairs]),
        # the products the kernel replaces on the path: f32 torch.matmul
        replaced_f32_matmul_ms=graph_ms(torch, lambda: [(a_.t().float() @ b_.float()) * inv_d for a_, b_ in pairs]),
        path="cli+dw",
    )
    for (a_, b_), nm in zip(pairs, ("dqkv^T.h", "dout^T.attn")):
        phase("time", kernel=f"dw_gemm:{nm}", shape=f"{tuple(a_.shape)}^T.{tuple(b_.shape)}",
              ms=f"{graph_ms(torch, lambda: ab.dw_gemm(a_, b_, inv_d)):.4f}",
              f32_matmul_ms=f"{graph_ms(torch, lambda: (a_.t().float() @ b_.float()) * inv_d):.4f}",
              bf16_matmul_ms=f"{graph_ms(torch, lambda: torch.matmul(a_.t(), b_)):.4f}")
    # off the main path: the DiT-B/2 widths, DiT-XL/2's qkv product (108
    # tiles: the plan whose splits had run 256 k steps deep), and M that no
    # tile depth divides
    for what, (m, p_, q) in (("dw_gemm:b2-qkv", DW_PAIRS["b2"][0]), ("dw_gemm:b2-out", DW_PAIRS["b2"][1]),
                             ("dw_gemm:xl-qkv", (TRAIN_BATCH * 64, 3456, 1152)),
                             ("dw_gemm:ragged-m", (6 * 16, 192, 64)), ("dw_gemm:ragged-m-1000", (1000, 1152, 384))):
        a_ = torch.randn(m, p_, generator=gen, device=dev).to(bf)
        b_ = torch.randn(m, q, generator=gen, device=dev).to(bf)
        alpha = 1 / math.sqrt(q)
        got = ab.dw_gemm(a_, b_, alpha)
        compare(torch, got, ab.dw_gemm_plain(a_, b_, alpha), 1e-4, 1e-4, what)
        if not torch.equal(got, ab.dw_gemm(a_, b_, alpha)):
            raise AssertionError(f"{what}: two runs on the same inputs differ in their bits")
        phase("time", kernel=what, ms=f"{graph_ms(torch, lambda: ab.dw_gemm(a_, b_, alpha)):.4f}",
              plain_ms=f"{graph_ms(torch, lambda: ab.dw_gemm_plain(a_, b_, alpha)):.4f}",
              bf16_matmul_ms=f"{graph_ms(torch, lambda: torch.matmul(a_.t(), b_)):.4f}")

    class CountMatmuls(TorchFunctionMode):
        """Counts the matrix products PyTorch itself is asked for."""

        def __init__(self):
            super().__init__()
            self.count = 0

        def __torch_function__(self, func, types, fargs=(), kwargs=None):
            if getattr(func, "__name__", "") in ("matmul", "mm", "bmm", "addmm", "linear", "einsum"):
                self.count += 1
            return func(*fargs, **(kwargs or {}))

    def matmuls_in_attn_bwd():
        with CountMatmuls() as mode:
            ab.attn_bwd(dy, *args)
        return mode.count

    d = args[0].shape[-1]
    off_ms, off_matmuls = time_ms(torch, lambda: ab.attn_bwd(dy, *args)), matmuls_in_attn_bwd()
    ab.DW_IN_KERNEL_BUDGET = 16 * d * d
    try:
        before = ab.LAUNCHES["attn_bwd/dw"]
        got, want = ab.attn_bwd(dy, *args), ab.attn_bwd_plain(dy, *args)
        launched = ab.LAUNCHES["attn_bwd/dw"] - before
        for nm, g_, w_ in zip(("dx", "dshift", "dscale", "dgate", "dgain", "dw_qkv", "dw_out"), got, want):
            if nm == "dgain":
                compare_sum(torch, g_, w_, terms, "attn_branch/bwd+dw:dgain")
            else:
                compare_rel(torch, g_, w_, 1e-2, f"attn_branch/bwd+dw:{nm}")
        on_ms, on_matmuls = time_ms(torch, lambda: ab.attn_bwd(dy, *args)), matmuls_in_attn_bwd()
    finally:
        ab.DW_IN_KERNEL_BUDGET = 0
    phase("time", kernel="attn_branch/bwd", dw="f32 torch.matmul", ms=f"{off_ms:.4f}", torch_matmuls=off_matmuls)
    phase("time", kernel="attn_branch/bwd", dw="dw_gemm", ms=f"{on_ms:.4f}", torch_matmuls=on_matmuls,
          dw_launches=launched)
    if (off_matmuls, on_matmuls, launched) != (2, 0, 2):
        raise AssertionError(f"attn_bwd: {off_matmuls} torch matmuls with the switch off (2 expected), {on_matmuls} "
                             f"with it on (0 expected), {launched} dw_gemm launches (2 expected)")
    return row


def launch_counts() -> dict:
    """Every wrapper's launch count, by name."""
    from mapdit_tpu_torch.ops.cuda import attention, attn_branch, dit_block, dit_block_tp, mlp_block

    return {**dit_block.LAUNCHES, **attn_branch.LAUNCHES, **attention.LAUNCHES, **mlp_block.LAUNCHES,
            **dit_block_tp.LAUNCHES}


def reset_launch_counts() -> None:
    from mapdit_tpu_torch.ops.cuda import attention, attn_branch, dit_block, dit_block_tp, mlp_block

    for mod in (dit_block, attn_branch, attention, mlp_block, dit_block_tp):
        mod.reset_launch_counts()


def check_counts(what: str, counts: dict, exact: dict) -> None:
    """``exact`` maps a launch count's name to the count it must show; every
    name outside it must show 0."""
    wrong = {key: (counts[key], want) for key, want in exact.items() if counts[key] != want}
    stray = {key: v for key, v in counts.items() if v and key not in exact}
    if wrong or stray:
        raise AssertionError(f"{what}: launch counts {counts} (got, expected: {wrong}; launched unexpectedly: {stray})")


def draw_gains(torch, model, seed: int) -> None:
    """The block gains start at 0, which switches the conditioning off (and
    zeroes the shift's gradient); draw them so the modulations act."""
    with torch.no_grad():
        g_cpu = torch.Generator().manual_seed(seed)
        for blk in model.blocks:
            # drawn on the CPU, so the values do not depend on the model's device
            for gain in (blk.gain_msa, blk.gain_mlp):
                gain.copy_(torch.empty(()).uniform_(0.2, 0.8, generator=g_cpu))


def train_inputs(torch, dev, cfg, rows: int):
    """Synthetic VAE-posterior latents (1000 classes, seed SEED, the
    model's latent side): the dataset, one batch of ``rows`` on the card,
    and one train step's draws (posterior noise, t, q-sample noise, label
    dropout), so that every path of a phase takes the same step."""
    from mapdit_tpu_torch.training import SyntheticLatentDataset

    ds = SyntheticLatentDataset(num_examples=max(1024, 2 * rows), num_classes=1000, size=cfg.input_size, seed=SEED)
    batch = {key: torch.as_tensor(v).to(dev) for key, v in next(ds.batches(rows, seed=SEED)).items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    shape = batch["mean"].shape
    draws = {
        "posterior_eps": torch.randn(shape, generator=gen, device=dev),
        "t": torch.randint(0, 1000, (rows,), generator=gen, device=dev),
        "noise": torch.randn(shape, generator=gen, device=dev),
        "drop": (torch.rand(rows, generator=gen, device=dev) < cfg.class_dropout_prob).long(),
    }
    return ds, batch, draws


def train_phase(torch, dev, tag: str, paths: dict, expect: dict, steps: int, around=None,
                rows: int = TRAIN_BATCH) -> dict:
    """Train steps at ``rows`` on synthetic latents for each config of
    ``paths`` ("f32", the float32 plain path, and "off", the bf16 plain
    path, among them). The first step (same weights, same injected draws on
    every path) is held against the float32 plain path by check_paths' rule,
    on the loss and on all gradients; then ``steps`` timed steps per path
    with the launch counts read around them and held to
    ``expect[path](counts)``; ``around[path]()``, where given, is a context
    the path runs inside. Returns {path: launch counts}."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import init_model
    from mapdit_tpu_torch.training import create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt

    cfg = paths["off"]
    init = init_model(cfg, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd0 = init.state_dict()
    del init
    ds, batch, draws = train_inputs(torch, dev, cfg, rows)
    diffusion = create_diffusion("", device=dev)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    losses, grads, counts = {}, {}, {}
    for name, c in paths.items():
        with (around or {}).get(name, contextlib.nullcontext)():
            state = create_train_state(c, tx, seed=SEED, device=dev, state_dict=sd0)
            step = make_train_step(c, diffusion, tx, stats_mean=ds.stats["mean"], stats_std=ds.stats["std"])
            losses[name] = step(state, batch, draws=draws)["loss"].reshape(1)
            grads[name] = torch.cat([p.grad.float().reshape(-1) for p in state.model.parameters()])
            if name != "f32":
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                for _ in range(steps):
                    metrics = step(state, batch)
                last = float(metrics["loss"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts[name] = launch_counts()
                phase(tag, path=name, model=json.dumps(c.flags_dict()["modulation"]), batch=rows, steps=steps,
                      seconds=f"{seconds:.4f}", steps_per_s=f"{steps / seconds:.3f}",
                      ms_per_step=f"{1e3 * seconds / steps:.4f}", first_loss=f"{float(losses[name]):.6f}",
                      last_loss=f"{last:.6f}", launches=json.dumps({key: v for key, v in counts[name].items() if v}))
                if not math.isfinite(last):
                    raise AssertionError(f"{tag}/{name}: non-finite loss")
                check_counts(f"{tag}/{name}", counts[name], expect[name])
            del state, step
            torch.cuda.empty_cache()
    kernel_paths = tuple(name for name in paths if name not in ("f32", "off"))
    check_paths(torch, f"{tag}-loss", losses, kernel_paths)
    check_paths(torch, f"{tag}-grads", grads, kernel_paths)
    return counts


# kernel launches a call of the attention half-block's forward (row 3),
# fused backward (row 4) and residual forward (row 5): one each,
# csrc/attn_branch.cu; their launch sequences (the route before it, and
# outside its domain): qkv, attention, out (rows 3 and 5), and
# modulate_fwd, qkv, attention, out with the residual backward, dattn,
# attention_bwd, dh, modulate_bwd
ROW3_LAUNCHES = 1
ROW4_LAUNCHES = 1
ROW5_LAUNCHES = 1
ROW3_SEQUENCE_LAUNCHES = 3
ROW4_SEQUENCE_LAUNCHES = 8
ROW5_SEQUENCE_LAUNCHES = 3


@contextlib.contextmanager
def launch_sequences(ab):
    """The attention half-block's one-launch kernels switched off: rows 3,
    4 and 5 run their launch sequences (attn_branch.BRANCH_KERNELS)."""
    ab.BRANCH_KERNELS = False
    try:
        yield
    finally:
        ab.BRANCH_KERNELS = True


def s2_train_phase(torch, dev, cfg) -> dict:
    """Phase 6: DiT-S/2 training on the plain path and through the
    attention half-block kernels with both of their backwards, and with rows
    3, 4 and 5 as their launch sequences (the paths the other rows' kernels
    in the kernels line report their launches from)."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    per_step = cfg.depth * TRAIN_STEPS
    kernel = cfg.replace(block_kernel="mega_attn", attn_bwd="pallas")
    paths = {
        "f32": cfg.replace(compute_dtype="float32"),
        "off": cfg,
        "mega_attn+pallas": kernel,
        "mega_attn+sequence": kernel,
        "mega_attn+residual": cfg.replace(block_kernel="mega_attn", attn_bwd="residual"),
        "mega_attn+residual+sequence": cfg.replace(block_kernel="mega_attn", attn_bwd="residual"),
    }
    expect = {
        "off": {},
        "mega_attn+pallas": mega_attn_expect(ab, cfg.depth, TRAIN_STEPS, remat=False),
        "mega_attn+sequence": mega_attn_expect(ab, cfg.depth, TRAIN_STEPS, remat=False, sequence=True),
        "mega_attn+residual": {"attn_branch/res_fwd": ROW5_LAUNCHES * per_step},
        "mega_attn+residual+sequence": {"attn_branch/res_fwd/sequence": per_step, "mp_gemm/qkv": per_step,
                                        "mp_gemm/out": per_step, "cosine_attention/residual": per_step},
    }
    counts = train_phase(torch, dev, "train", paths, expect, TRAIN_STEPS,
                         around={name: lambda: launch_sequences(ab)
                                 for name in ("mega_attn+sequence", "mega_attn+residual+sequence")})
    # rows 3 and 4: their launches a call, one each; on the sequence path
    # row 4's own kernels a call, the forward's three taken from a block's
    # share
    pallas, seq = counts["mega_attn+pallas"], counts["mega_attn+sequence"]
    row3, row4 = pallas["attn_branch/fwd"] / per_step, pallas["attn_branch/bwd"] / per_step
    seq_row4 = sum(v for key, v in seq.items() if not key.startswith("attn_branch/")) // per_step - ROW3_SEQUENCE_LAUNCHES
    ok = (row3, row4, seq_row4) == (ROW3_LAUNCHES, ROW4_LAUNCHES, ROW4_SEQUENCE_LAUNCHES)
    phase("check", what="train/mega_attn+pallas:launches-a-call", row3=row3, row4=row4,
          expected=f"{ROW3_LAUNCHES},{ROW4_LAUNCHES}", sequence_row4=seq_row4, sequence_expected=ROW4_SEQUENCE_LAUNCHES,
          ok=ok)
    if not ok:
        raise AssertionError(f"rows 3 and 4 made {row3} and {row4} launches a call ({ROW3_LAUNCHES}, {ROW4_LAUNCHES} "
                             f"expected), the backward's sequence {seq_row4} ({ROW4_SEQUENCE_LAUNCHES})")
    # row 5: one launch a call, its sequence none; on the sequence path three
    res, res_seq = counts["mega_attn+residual"], counts["mega_attn+residual+sequence"]
    row5, row5_seq = res["attn_branch/res_fwd"] / per_step, res["attn_branch/res_fwd/sequence"]
    seq_row5 = sum(v for key, v in res_seq.items() if not key.startswith("attn_branch/")) // per_step
    ok = (row5, row5_seq, seq_row5) == (ROW5_LAUNCHES, 0, ROW5_SEQUENCE_LAUNCHES)
    phase("check", what="train/mega_attn+residual:launches-a-call", row5=row5, expected=ROW5_LAUNCHES,
          row5_sequence_calls=row5_seq, sequence_row5=seq_row5, sequence_expected=ROW5_SEQUENCE_LAUNCHES, ok=ok)
    if not ok:
        raise AssertionError(f"row 5 made {row5} launches a call ({ROW5_LAUNCHES} expected) and {row5_seq} sequence "
                             f"calls, its sequence {seq_row5} launches a call ({ROW5_SEQUENCE_LAUNCHES})")
    return counts


# phase 6c: DiT-S/2 training at 32 x 32 latents (T = 256)
T256_TRAIN_BATCH = 32
T256_TRAIN_STEPS = 3


def t256_train_phase(torch, dev, cfg) -> dict:
    """Phase 6c: DiT-S/2 at 32 x 32 latents (T = 256), batch
    T256_TRAIN_BATCH, on the plain path, on mega_attn with attn_bwd pallas
    (rows 3 and 4 past their one-launch kernels' T <= 64: their launch
    sequences, with attention_bwd's form past T = 64 and
    out_gate_residual_bwd's tile-order form at T = 256) and on mega (the
    forward one dit_stack launch a block, the gradient recomputed through the
    reference math): the first step held to the float32 plain step by
    check_paths' rule, then T256_TRAIN_STEPS timed steps a path with exact
    launch counts. Returns {path: launch counts}, keyed "t256/<path>"."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    c32 = cfg.replace(input_size=32)
    per = c32.depth * T256_TRAIN_STEPS
    paths = {"f32": c32.replace(compute_dtype="float32"), "off": c32,
             "mega_attn+pallas": c32.replace(block_kernel="mega_attn", attn_bwd="pallas"),
             "mega": c32.replace(block_kernel="mega")}
    expect = {"off": {},
              "mega_attn+pallas": mega_attn_expect(ab, c32.depth, T256_TRAIN_STEPS, remat=False, sequence=True),
              "mega": {"fused_dit_block": per, "dit_stack": per}}
    counts = train_phase(torch, dev, "train-t256", paths, expect, T256_TRAIN_STEPS, rows=T256_TRAIN_BATCH)
    return {f"t256/{name}": v for name, v in counts.items()}


# phase 6d: float32 on the whole-block kernels (a float32 model: the train
# CLI's default --compute-dtype, and every experiment trained with it
# samples in float32). The checked step's and chains' batch, the CLI's steps,
# the ddim chain, the launch-sequence chain and the bench's turns.
F32_TRAIN_BATCH = 64
F32_CLI_STEPS = 4
F32_CHAIN_STEPS = 50
F32_CHAIN_BATCH = 8  # pre-CFG samples of the checked chains
F32_SEQUENCE_STEPS = 10
F32_BENCH_ORDER = ("off", "mega_stack", "mega_stack", "off")
# the f32 kernel path's rel L2 from the f32 plain path, times this, is at
# most the bf16 kernel path's: TF32- or bf16-rounded products would fail it
F32_CLOSER = 10.0


def f32_distances(ref, f32_kernel, bf16_kernel) -> tuple:
    """The f32 and bf16 kernel paths' rel L2 from ``ref`` (the L2 distance
    itself where ``ref`` is zero: a gradient that is 0 on the plain path,
    as the zero-initialised output layer's is) and whether the f32 one is
    at least F32_CLOSER times closer (or exactly on it)."""
    ref, a, b = ref.double(), f32_kernel.double(), bf16_kernel.double()
    norm = float(ref.norm())
    e32, e16 = (float((v - ref).norm()) / (norm if norm > 0 else 1.0) for v in (a, b))
    ok = math.isfinite(e32) and math.isfinite(e16) and (e32 == 0 or F32_CLOSER * e32 <= e16)
    return e32, e16, ok


def f32_closer(what: str, ref, f32_kernel, bf16_kernel) -> float:
    """``f32_kernel`` at least F32_CLOSER times closer to ``ref`` than
    ``bf16_kernel`` is (f32_distances); prints both distances and the ratio,
    returns the ratio."""
    e32, e16, ok = f32_distances(ref, f32_kernel, bf16_kernel)
    ratio = e16 / e32 if e32 > 0 else math.inf
    phase("check", what=what, f32_kernel_rel_l2=f"{e32:.4e}", bf16_kernel_rel_l2=f"{e16:.4e}", ratio=f"{ratio:.1f}",
          tol=f"ratio>={F32_CLOSER:g}", ok=ok)
    if not ok:
        raise AssertionError(f"{what}: the f32 kernel path lies {e32} from the f32 plain path, the bf16 one {e16}")
    return ratio


def f32_step_closer(torch, tag: str, losses: dict, grads: dict, kernel_paths, bf16_path: str) -> None:
    """Each f32 kernel path's loss and every gradient at least F32_CLOSER
    times closer to the f32 plain step ("f32") than ``bf16_path``'s
    (f32_distances), one check line a path."""
    for name in kernel_paths:
        f32_closer(f"{tag}:{name}:loss", losses["f32"], losses[name], losses[bf16_path])
        dist = {key: f32_distances(want, grads[name][key], grads[bf16_path][key])
                for key, want in grads["f32"].items()}
        failed = {key: v[:2] for key, v in dist.items() if not v[2]}
        ratio = {key: (e16 / e32 if e32 > 0 else math.inf) for key, (e32, e16, _) in dist.items()}
        worst = min(ratio, key=ratio.get)
        phase("check", what=f"{tag}:{name}:grads", parameters=len(dist),
              zero_on_plain=sum(float(w.norm()) == 0 for w in grads["f32"].values()),
              f32_kernel_rel_l2_max=f"{max(v[0] for v in dist.values()):.4e}",
              bf16_kernel_rel_l2_min=f"{min(v[1] for v in dist.values()):.4e}", worst_ratio=f"{ratio[worst]:.1f}",
              worst=worst, tol=f"ratio>={F32_CLOSER:g} each", ok=not failed)
        if failed:
            raise AssertionError(f"{tag}/{name}: gradients not {F32_CLOSER}x closer to the f32 plain step: {failed}")


def f32_checked_steps(torch, dev, tag: str, paths: dict, sd0, batch, draws, stats) -> tuple:
    """One checked train step (make_train_step on the same weights and
    injected draws) for each (config, expected launch counts, context) of
    ``paths``, the counts held exact. Returns ({path: loss}, {path:
    {parameter: gradient}}, {path: launch counts})."""
    losses, grads, counts = {}, {}, {}
    for name, (c, expect, around) in paths.items():
        with around():
            torch.cuda.synchronize()
            reset_launch_counts()
            state, _, loss, g = checked_step(torch, dev, c, sd0, batch, draws, stats)
            torch.cuda.synchronize()
            counts[name] = launch_counts()
        check_counts(f"{tag}/{name}", counts[name], expect)
        losses[name] = loss.float().reshape(1)
        grads[name] = {key: v.float().clone() for key, v in g.items() if v is not None}
        phase("f32", step=tag, path=name, loss=f"{float(loss):.6f}",
              launches=json.dumps({key: v for key, v in counts[name].items() if v}))
        del state, g
        torch.cuda.empty_cache()
    return losses, grads, counts


def f32_train_cli(torch, tmp: str, common: list, kernel: str, steps: int, *flags) -> tuple:
    """The train CLI in process (float32, its default) on --block-kernel
    ``kernel`` for ``steps`` steps under ``tmp``, the launch counts zeroed
    first: (experiment, its metrics rows, the launch counts, seconds with
    set-up). Raises on a missing row or a non-finite loss."""
    from mapdit_tpu_torch import train

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    exp = train.main(train.build_parser().parse_args(
        [*common, "--block-kernel", kernel, "--num-steps", str(steps), "--results-dir", os.path.join(tmp, kernel),
         *flags]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != steps or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"f32 train CLI ({kernel}): {len(rows)} rows or a non-finite loss in {exp}")
    return exp, rows, launch_counts(), seconds


def f32_phase(torch, dev, cfg) -> dict:
    """Phase 6d, float32 at full DiT-S/2 on dit_stack's f32 instances:
    (1) one train step (make_train_step, the same weights and injected
    draws) on the f32 plain path, on f32 mega and on bf16 mega: the f32
    mega step's loss and every gradient at least F32_CLOSER times closer to
    the f32 plain step than the bf16 mega step's, one dit_stack launch a
    block; (2) the train CLI in process at its default --compute-dtype
    float32 with --block-kernel mega (F32_CLI_STEPS steps, a checkpoint and
    EMA snapshots), its first logged loss held to a one-step run of the same
    CLI on --block-kernel off (the same seed: the same batch and draws) at
    F32_TOL; (3) mapdit_tpu_torch.sample on that experiment with
    --block-kernel mega_stack, ddim 50 (one dit_stack launch a model call);
    (4) ddim 50 chains on the same weights, f32 mega_stack at least
    F32_CLOSER times closer to the f32 plain chain than bf16 mega_stack;
    (5) the f32 launch sequence as the stack's route (dit_block.STACK_KERNEL
    off: mp_gemm_f32 and cosine_attention_f32, the path the kernels line
    counts their launches on) on a ddim F32_SEQUENCE_STEPS chain against
    the kernel's; (6) mapdit_tpu_torch.bench --dtype float32 on off and
    mega_stack in turns (F32_BENCH_ORDER), one JSON line each. Every run
    has exact launch counts. Returns {path: launch counts}."""
    import io

    from mapdit_tpu_torch import bench, sample
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import init_model
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.runtime import build_sample_fn
    from mapdit_tpu_torch.utils.experiment import load_config

    t_phase = time.perf_counter()
    depth, f32 = cfg.depth, torch.float32
    c32 = cfg.replace(compute_dtype="float32")
    out = {}

    # 1. the checked step
    init = init_model(cfg, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd0 = init.state_dict()
    del init
    ds, batch, draws = train_inputs(torch, dev, cfg, F32_TRAIN_BATCH)
    mega = {"fused_dit_block": depth, "dit_stack": depth}
    none = contextlib.nullcontext
    paths = {"f32": (c32, {}, none), "f32+mega": (c32.replace(block_kernel="mega"), mega, none),
             "bf16+mega": (cfg.replace(block_kernel="mega"), mega, none)}
    losses, grads, _ = f32_checked_steps(torch, dev, "f32/step", paths, sd0, batch, draws, ds.stats)
    f32_step_closer(torch, "f32/step", losses, grads, ("f32+mega",), "bf16+mega")
    del grads

    with tempfile.TemporaryDirectory(prefix="mapdit_f32_") as tmp:
        # 2. the train CLI
        common = ["--model", MODEL, "--data-path", "synthetic:1024", "--batch-size", str(F32_TRAIN_BATCH),
                  "--compute-dtype", "float32", "--num-classes", "1000", "--log-every", "1", "--metrics-jsonl", "auto",
                  "--num-lin-warmup", "2", "--start-decay", "10"]

        def cli(kernel, steps, *flags):
            return f32_train_cli(torch, tmp, common, kernel, steps, *flags)

        exp, rows, counts, seconds = cli("mega", F32_CLI_STEPS, "--ckpt-every", str(F32_CLI_STEPS),
                                         "--ema-snapshot-every", str(F32_CLI_STEPS))
        check_counts("f32/train-cli", counts, {"fused_dit_block": depth * F32_CLI_STEPS,
                                               "dit_stack": depth * F32_CLI_STEPS})
        out["f32/train-cli"] = counts
        _, rows_off, _, _ = cli("off", 1, "--ckpt-every", "1000", "--ema-snapshot-every", "0")
        rel = abs(rows[0]["loss"] - rows_off[0]["loss"]) / abs(rows_off[0]["loss"])
        dtype = load_config(exp)["compute_dtype"]
        phase("f32", cli="train", block_kernel="mega", compute_dtype=dtype, batch=F32_TRAIN_BATCH,
              steps=F32_CLI_STEPS, seconds_with_setup=f"{seconds:.3f}", losses=json.dumps([r["loss"] for r in rows]),
              first_loss_off=f"{rows_off[0]['loss']:.6f}", first_loss_rel_diff=f"{rel:.3e}", tol=f"{F32_TOL:g}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))
        if rel > F32_TOL or dtype != "float32":
            raise AssertionError(f"f32 train CLI: first loss {rows[0]['loss']} against {rows_off[0]['loss']} off "
                                 f"({dtype})")

        # 3. the sample CLI on that experiment
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        png = sample.main(sample.build_parser().parse_args(
            ["--result-dir", exp, "--use-vae", "false", "--block-kernel", "mega_stack", "--sampler", "ddim",
             "--num-sampling-steps", str(F32_CHAIN_STEPS), "--clip-denoised", "true", "--class-label", "3",
             "--output-file", os.path.join(tmp, "f32.png")]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts("f32/sample-cli", counts, {"fused_dit_stack": F32_CHAIN_STEPS, "dit_stack": F32_CHAIN_STEPS})
        out["f32/sample-cli"] = counts
        phase("f32", cli="sample", block_kernel="mega_stack", sampler="ddim", steps=F32_CHAIN_STEPS,
              png=json.dumps(png_check(png)), seconds=f"{seconds:.3f}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))

    # 4. the checked chains
    z = torch.randn(2 * F32_CHAIN_BATCH, 4, cfg.input_size, cfg.input_size,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 50), device=dev)
    y = torch.cat([torch.arange(F32_CHAIN_BATCH, device=dev) * 97 % 1000,
                   torch.full((F32_CHAIN_BATCH,), 1000, device=dev)])
    ddim = create_diffusion(f"ddim{F32_CHAIN_STEPS}", device=dev)

    def chain(c, diffusion, kernel):
        fn = build_sample_fn(c.replace(block_kernel=kernel), sd0, diffusion, cfg_scale=CFG_SCALE, sampler="ddim",
                             clip_denoised=True, batch_hint=F32_CHAIN_BATCH, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = fn(z, y, torch.Generator(device=dev).manual_seed(SEED + 51))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not torch.isfinite(got).all():
            raise AssertionError(f"f32 chain ({kernel}): non-finite latents")
        return got, launch_counts(), seconds

    chains = {}
    for name, c, kernel in (("f32", c32, "off"), ("f32+mega_stack", c32, "mega_stack"),
                            ("bf16+mega_stack", cfg, "mega_stack")):
        chains[name], counts, seconds = chain(c, ddim, kernel)
        check_counts(f"f32/chain/{name}", counts, {} if kernel == "off" else
                     {"fused_dit_stack": F32_CHAIN_STEPS, "dit_stack": F32_CHAIN_STEPS})
        phase("f32", chain=name, sampler="ddim", steps=F32_CHAIN_STEPS, batch=f"{F32_CHAIN_BATCH}x2",
              seconds=f"{seconds:.4f}", launches=json.dumps({key: v for key, v in counts.items() if v}))
    f32_closer("f32/chain-ddim50", chains["f32"], chains["f32+mega_stack"], chains["bf16+mega_stack"])

    # 5. the f32 launch sequence as the stack's route
    short = create_diffusion(f"ddim{F32_SEQUENCE_STEPS}", device=dev)
    kernel_out, _, _ = chain(c32, short, "mega_stack")
    k.STACK_KERNEL = False
    try:
        seq_out, counts, seconds = chain(c32, short, "mega_stack")
    finally:
        k.STACK_KERNEL = True
    calls = F32_SEQUENCE_STEPS * depth
    check_counts("f32/mega_stack+sequence", counts, {"fused_dit_stack": F32_SEQUENCE_STEPS, "cosine_attention": calls,
                                                    **{f"mp_gemm/{site}": calls for site in k.GEMM_SITES[:5]}})
    err = rel_l2(seq_out, kernel_out)
    phase("f32", chain="f32+mega_stack+sequence", sampler="ddim", steps=F32_SEQUENCE_STEPS, seconds=f"{seconds:.4f}",
          rel_l2_vs_kernel=f"{err:.3e}", tol=f"{F32_TOL:g}",
          launches=json.dumps({key: v for key, v in counts.items() if v}))
    if err > F32_TOL:
        raise AssertionError(f"f32 launch-sequence chain lies {err} from the kernel's")
    out["f32/mega_stack+sequence"] = dict(counts, mp_gemm=sum(v for key, v in counts.items()
                                                              if key.startswith("mp_gemm/")))

    # 6. the bench in turns
    for kernel in F32_BENCH_ORDER:
        argv = ["--dtype", "float32", "--block-kernel", kernel, "--sampler", "ddim", "--steps", str(F32_CHAIN_STEPS),
                "--repeats", str(BENCH_REPEATS)]
        torch.cuda.synchronize()
        reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench.main(argv)
        counts = launch_counts()
        line = buf.getvalue().strip().splitlines()[-1]
        result = json.loads(line)
        print(line, flush=True)
        runs = (1 + BENCH_REPEATS) * F32_CHAIN_STEPS
        check_counts(f"f32/bench/{kernel}", counts,
                     {} if kernel == "off" else {"fused_dit_stack": runs, "dit_stack": runs})
        phase("bench-f32", block_kernel=result["block_kernel"], dtype="float32", value=f"{result['value']:.3f}",
              unit=json.dumps(result["unit"]), card=json.dumps(smi_line()))
        if result["block_kernel"] != kernel:
            raise AssertionError(f"bench --dtype float32 --block-kernel {kernel} ran {result['block_kernel']}")
        torch.cuda.empty_cache()
    phase("f32", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return out


# phase 6e: float32 on the attention half-block kernels (rows 3, 5 and 4's
# f32 instances and their f32 launch sequences), at phase 6d's batch, CLI
# steps and ddim chain; the checked step at 32 x 32 latents (T = 256: the
# sequences' route) takes this batch
F32_T256_BATCH = 8


def f32_attn_phase(torch, dev, cfg) -> dict:
    """Phase 6e, float32 at full DiT-S/2 on the attention half-block's f32
    kernels (rows 3, 5 and 4: csrc/attn_branch.cu's f32 instances; past
    their domain the f32 launch sequences): (1) one checked train step at
    F32_TRAIN_BATCH on the f32 plain path, on f32 mega_attn with attn_bwd
    pallas and residual (one launch a block of rows 3 and 4, or of row 5),
    on each again as its launch sequence (attn_branch.BRANCH_KERNELS off:
    the path the sequences' kernels count their launches on) and on bf16
    mega_attn: every f32 kernel path's loss and every gradient at least
    F32_CLOSER times closer to the f32 plain step than bf16 mega_attn's;
    (2) the train CLI in process at its default --compute-dtype float32 with
    --block-kernel mega_attn --attn-bwd pallas (F32_CLI_STEPS steps, a
    checkpoint), its first logged loss held to a one-step run of the CLI on
    --block-kernel off at F32_TOL; (3) mapdit_tpu_torch.sample on that
    experiment with --block-kernel mega_attn, ddim F32_CHAIN_STEPS (one
    row 3 launch a block and model call); (4) one checked f32 step at 32 x
    32 latents (T = 256, F32_T256_BATCH rows) on mega_attn + pallas, whose
    rows take their f32 launch sequences there, against the f32 plain step
    and bf16 mega_attn's by the same rule. Every run has exact launch counts.
    Returns {path: launch counts}."""
    from mapdit_tpu_torch import sample
    from mapdit_tpu_torch.models import init_model
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.utils.experiment import load_config

    t_phase = time.perf_counter()
    depth = cfg.depth
    c32 = cfg.replace(compute_dtype="float32")
    none = contextlib.nullcontext
    out = {}

    # 1. the checked step
    init = init_model(cfg, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd0 = init.state_dict()
    del init
    ds, batch, draws = train_inputs(torch, dev, cfg, F32_TRAIN_BATCH)
    pallas, residual = (dict(block_kernel="mega_attn", attn_bwd=bwd) for bwd in ("pallas", "residual"))
    res_seq = {"attn_branch/res_fwd/sequence": depth, "mp_gemm/qkv": depth, "mp_gemm/out": depth,
               "cosine_attention/residual": depth}
    paths = {
        "f32": (c32, {}, none),
        "f32+mega_attn+pallas": (c32.replace(**pallas), mega_attn_expect(ab, depth, 1, remat=False), none),
        "f32+mega_attn+residual": (c32.replace(**residual), {"attn_branch/res_fwd": ROW5_LAUNCHES * depth}, none),
        "f32+mega_attn+sequence": (c32.replace(**pallas), mega_attn_expect(ab, depth, 1, remat=False, sequence=True),
                                   lambda: launch_sequences(ab)),
        "f32+mega_attn+residual+sequence": (c32.replace(**residual), res_seq, lambda: launch_sequences(ab)),
        "bf16+mega_attn+pallas": (cfg.replace(**pallas), mega_attn_expect(ab, depth, 1, remat=False), none),
    }
    losses, grads, counts = f32_checked_steps(torch, dev, "f32-attn/step", paths, sd0, batch, draws, ds.stats)
    f32_step_closer(torch, "f32-attn/step", losses, grads, [p for p in paths if p.startswith("f32+")],
                    "bf16+mega_attn+pallas")
    out.update({f"f32/{name[4:]}": counts[name] for name in paths if name.startswith("f32+")})
    del grads

    with tempfile.TemporaryDirectory(prefix="mapdit_f32_attn_") as tmp:
        # 2. the train CLI
        common = ["--model", MODEL, "--data-path", "synthetic:1024", "--batch-size", str(F32_TRAIN_BATCH),
                  "--num-classes", "1000", "--log-every", "1", "--metrics-jsonl", "auto", "--num-lin-warmup", "2",
                  "--start-decay", "10"]

        def cli(kernel, steps, *flags):
            return f32_train_cli(torch, tmp, common, kernel, steps, *flags)

        steps = F32_CLI_STEPS
        exp, rows, counts, seconds = cli("mega_attn", steps, "--attn-bwd", "pallas", "--ckpt-every", str(steps),
                                         "--ema-snapshot-every", str(steps))
        check_counts("f32-attn/train-cli", counts, mega_attn_expect(ab, depth, steps, remat=False))
        out["f32/attn-train-cli"] = counts
        _, rows_off, _, _ = cli("off", 1, "--ckpt-every", "1000", "--ema-snapshot-every", "0")
        rel = abs(rows[0]["loss"] - rows_off[0]["loss"]) / abs(rows_off[0]["loss"])
        dtype = load_config(exp)["compute_dtype"]
        phase("f32-attn", cli="train", block_kernel="mega_attn", attn_bwd="pallas", compute_dtype=dtype,
              batch=F32_TRAIN_BATCH, steps=steps, seconds_with_setup=f"{seconds:.3f}",
              losses=json.dumps([r["loss"] for r in rows]), first_loss_off=f"{rows_off[0]['loss']:.6f}",
              first_loss_rel_diff=f"{rel:.3e}", tol=f"{F32_TOL:g}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))
        if rel > F32_TOL or dtype != "float32":
            raise AssertionError(f"f32 train CLI on mega_attn: first loss {rows[0]['loss']} against "
                                 f"{rows_off[0]['loss']} off ({dtype})")

        # 3. the sample CLI on that experiment
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        png = sample.main(sample.build_parser().parse_args(
            ["--result-dir", exp, "--use-vae", "false", "--block-kernel", "mega_attn", "--sampler", "ddim",
             "--num-sampling-steps", str(F32_CHAIN_STEPS), "--clip-denoised", "true", "--class-label", "3",
             "--output-file", os.path.join(tmp, "f32_attn.png")]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts("f32-attn/sample-cli", counts, {"attn_branch/fwd": ROW3_LAUNCHES * depth * F32_CHAIN_STEPS})
        out["f32/attn-sample-cli"] = counts
        phase("f32-attn", cli="sample", block_kernel="mega_attn", sampler="ddim", steps=F32_CHAIN_STEPS,
              png=json.dumps(png_check(png)), seconds=f"{seconds:.3f}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))

    # 4. one checked step at 32 x 32 latents: the rows' f32 launch sequences
    c256 = cfg.replace(input_size=32)
    init = init_model(c256, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd0 = init.state_dict()
    del init
    ds, batch, draws = train_inputs(torch, dev, c256, F32_T256_BATCH)
    seq = mega_attn_expect(ab, depth, 1, remat=False, sequence=True)
    paths = {"f32": (c256.replace(compute_dtype="float32"), {}, none),
             "f32+mega_attn+pallas": (c256.replace(compute_dtype="float32", **pallas), seq, none),
             "bf16+mega_attn+pallas": (c256.replace(**pallas), seq, none)}
    losses, grads, counts = f32_checked_steps(torch, dev, "f32-attn/t256-step", paths, sd0, batch, draws, ds.stats)
    f32_step_closer(torch, "f32-attn/t256-step", losses, grads, ("f32+mega_attn+pallas",), "bf16+mega_attn+pallas")
    out["f32/t256/mega_attn+pallas"] = counts["f32+mega_attn+pallas"]
    del grads
    torch.cuda.empty_cache()
    phase("f32-attn", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return out


# phase 6f: float32 on row 9 (fused_mlp_branch's f32 form, mlp_branch_f32)
# with fused_attention's f32 form beside it (block_kernel="pallas",
# attention_impl="pallas"), at phase 6d's batch, CLI steps and ddim chain
F32_PALLAS = dict(block_kernel="pallas", attention_impl="pallas")


def pallas_expect(depth: int, model_calls: int) -> dict:
    """The launches of ``model_calls`` model calls on pallas + pallas: each
    block's MLP half one launch of row 9, its attention one of
    fused_attention (a train step's backward recomputes through the plain
    references and launches nothing)."""
    n = depth * model_calls
    return {"fused_attention": n, "mlp_branch/fwd": n, "mlp_branch/kernel": n}


def f32_pallas_phase(torch, dev, cfg) -> dict:
    """Phase 6f, float32 at full DiT-S/2 on row 9's f32 form
    (mlp_branch_f32, the TP kernels' f32 instance) and fused_attention's f32
    form: (1) one checked train step at F32_TRAIN_BATCH on the f32 plain
    path, on f32 pallas + pallas and on bf16 pallas + pallas: the f32 step's
    loss and every gradient at least F32_CLOSER times closer to the f32
    plain step than the bf16 step's; (2) the train CLI in process at its
    default --compute-dtype float32 with --block-kernel pallas
    --attention-impl pallas (F32_CLI_STEPS steps, a checkpoint), its first
    logged loss held to a one-step run of the CLI on --block-kernel off at
    F32_TOL; (3) mapdit_tpu_torch.sample on that experiment with
    --block-kernel pallas, ddim F32_CHAIN_STEPS (one row 9 launch a block and
    model call). Every run has exact launch counts. Returns {path: launch
    counts}."""
    from mapdit_tpu_torch import sample
    from mapdit_tpu_torch.models import init_model
    from mapdit_tpu_torch.utils.experiment import load_config

    t_phase = time.perf_counter()
    depth = cfg.depth
    c32 = cfg.replace(compute_dtype="float32")
    none = contextlib.nullcontext
    out = {}

    # 1. the checked step
    init = init_model(cfg, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd0 = init.state_dict()
    del init
    ds, batch, draws = train_inputs(torch, dev, cfg, F32_TRAIN_BATCH)
    paths = {
        "f32": (c32, {}, none),
        "f32+pallas": (c32.replace(**F32_PALLAS), pallas_expect(depth, 1), none),
        "bf16+pallas": (cfg.replace(**F32_PALLAS), pallas_expect(depth, 1), none),
    }
    losses, grads, counts = f32_checked_steps(torch, dev, "f32-pallas/step", paths, sd0, batch, draws, ds.stats)
    f32_step_closer(torch, "f32-pallas/step", losses, grads, ("f32+pallas",), "bf16+pallas")
    out["f32/pallas"] = counts["f32+pallas"]
    del grads

    with tempfile.TemporaryDirectory(prefix="mapdit_f32_pallas_") as tmp:
        # 2. the train CLI
        common = ["--model", MODEL, "--data-path", "synthetic:1024", "--batch-size", str(F32_TRAIN_BATCH),
                  "--num-classes", "1000", "--log-every", "1", "--metrics-jsonl", "auto", "--num-lin-warmup", "2",
                  "--start-decay", "10"]
        steps = F32_CLI_STEPS
        exp, rows, counts, seconds = f32_train_cli(torch, tmp, common, "pallas", steps, "--attention-impl", "pallas",
                                                   "--ckpt-every", str(steps), "--ema-snapshot-every", str(steps))
        check_counts("f32-pallas/train-cli", counts, pallas_expect(depth, steps))
        out["f32/pallas-train-cli"] = counts
        _, rows_off, _, _ = f32_train_cli(torch, tmp, common, "off", 1, "--ckpt-every", "1000",
                                          "--ema-snapshot-every", "0")
        rel = abs(rows[0]["loss"] - rows_off[0]["loss"]) / abs(rows_off[0]["loss"])
        dtype = load_config(exp)["compute_dtype"]
        phase("f32-pallas", cli="train", block_kernel="pallas", attention_impl="pallas", compute_dtype=dtype,
              batch=F32_TRAIN_BATCH, steps=steps, seconds_with_setup=f"{seconds:.3f}",
              losses=json.dumps([r["loss"] for r in rows]), first_loss_off=f"{rows_off[0]['loss']:.6f}",
              first_loss_rel_diff=f"{rel:.3e}", tol=f"{F32_TOL:g}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))
        if rel > F32_TOL or dtype != "float32":
            raise AssertionError(f"f32 train CLI on pallas: first loss {rows[0]['loss']} against "
                                 f"{rows_off[0]['loss']} off ({dtype})")

        # 3. the sample CLI on that experiment
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        png = sample.main(sample.build_parser().parse_args(
            ["--result-dir", exp, "--use-vae", "false", "--block-kernel", "pallas", "--sampler", "ddim",
             "--num-sampling-steps", str(F32_CHAIN_STEPS), "--clip-denoised", "true", "--class-label", "3",
             "--output-file", os.path.join(tmp, "f32_pallas.png")]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts("f32-pallas/sample-cli", counts, pallas_expect(depth, F32_CHAIN_STEPS))
        out["f32/pallas-sample-cli"] = counts
        phase("f32-pallas", cli="sample", block_kernel="pallas", sampler="ddim", steps=F32_CHAIN_STEPS,
              png=json.dumps(png_check(png)), seconds=f"{seconds:.3f}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))
    torch.cuda.empty_cache()
    phase("f32-pallas", seconds=f"{time.perf_counter() - t_phase:.2f}")
    return out


def checked_step(torch, dev, cfg, sd0, batch, draws, stats, ema_stds=None):
    """A train state of ``cfg`` on the weights ``sd0``, its step, and the
    first step's loss and gradients (by parameter name, on the card) on the
    injected ``draws``."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.training import EMA_STDS, create_optimizer, create_train_state, make_train_step
    from mapdit_tpu_torch.training import warmup_flat_invsqrt

    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    emas = EMA_STDS if ema_stds is None else ema_stds
    state = create_train_state(cfg, tx, seed=SEED, device=dev, state_dict=sd0, ema_stds=emas)
    step = make_train_step(cfg, create_diffusion("", device=dev), tx, stats_mean=stats["mean"],
                           stats_std=stats["std"], ema_stds=emas)
    loss = step(state, batch, draws=draws)["loss"].detach()
    return state, step, loss, {name: p.grad for name, p in state.model.named_parameters()}


def timed_steps(torch, state, step, batch, runs: int) -> dict:
    """``runs`` steps after the checked one, each timed on the host clock
    to a synchronise: ms a step, wrapper launches, the allocation peak."""
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"ms": ms, "launches": launch_counts(), "peak": torch.cuda.max_memory_allocated(),
            "loss": float(metrics["loss"])}


def mega_attn_expect(ab, depth: int, steps: int, remat: bool, forwards: int = 1, sequence: bool = False) -> dict:
    """The wrapper launches of ``steps`` train steps on mega_attn + pallas
    with ``forwards`` forwards a step taking gradient or not (under remat
    every block's forward runs again in the backward): one launch of row 3
    (``csrc/attn_branch.cu``) a block and forward, one of row 4 a block and
    backward; the dW products are library calls (the switch is off by
    default). ``sequence``: with the one-launch kernels switched off, the
    launch sequences in their place (the forward and the backward's
    recompute each launch the qkv product, the backward's out product is
    out_gate_residual_bwd's)."""
    per = depth * steps
    fwd = (2 if remat else 1) * forwards
    if not sequence:
        return {"attn_branch/fwd": fwd * per, "attn_branch/bwd": per}
    bwd = {key: per for key in ab.LAUNCHES if key.startswith("attn_bwd/") and key != "attn_bwd/dw"}
    return {"attn_branch/fwd/sequence": fwd * per, "attn_branch/bwd/sequence": per, "mp_gemm/qkv": (fwd + 1) * per,
            "mp_gemm/out": fwd * per, "mp_gemm/dattn": per, "mp_gemm/dh": per, "cosine_attention": fwd * per,
            "cosine_attention/residual": per, **bwd}


def remat_scan_phase(torch, dev, s2_cfg) -> dict:
    """Phase 6b: DiT-XL/2 training with remat off and on, then the S/2 train
    step and chain in the scan_blocks layout (module docstring). Returns
    {path: launch counts} of the timed steps."""
    from mapdit_tpu_torch.bench import _profile
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import build_config, init_model
    from mapdit_tpu_torch.models.dit import stack_block_params, unstack_block_params
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.runtime import build_sample_fn

    counts = {}
    # 1. DiT-XL/2 at batch 256 on mega_attn + pallas, remat off then on, on
    # the same weights and draws: loss and every gradient bit for bit
    xl = build_config(XL_MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16",
                      block_kernel="mega_attn", attn_bwd="pallas")
    sd0 = xl_state_dict(torch, xl.replace(block_kernel="off"), dev)
    ds, batch, draws = train_inputs(torch, dev, xl, XL_TRAIN_BATCH)
    sides = {}
    for remat in (False, True):
        name = "remat" if remat else "no-remat"
        cfg = xl.replace(remat=remat)
        state, step, loss, grads = checked_step(torch, dev, cfg, sd0, batch, draws, ds.stats)
        sides[name] = (loss.cpu(), {key: g.cpu() for key, g in grads.items()})
        del grads
        run = timed_steps(torch, state, step, batch, REMAT_TIMED_STEPS)
        counts[f"xl/mega_attn+pallas:{name}"] = run["launches"]
        phase("remat", model=XL_MODEL, depth=xl.depth, width=xl.hidden_size, heads=xl.num_heads,
              batch=XL_TRAIN_BATCH, path=f"mega_attn+pallas:{name}", first_loss=f"{float(loss):.6f}",
              ms_per_step=json.dumps([round(v, 4) for v in run["ms"]]), peak_allocated_bytes=run["peak"],
              peak_allocated_gib=f"{run['peak'] / 2**30:.3f}", last_loss=f"{run['loss']:.6f}",
              launches_per_step=json.dumps({k: v // REMAT_TIMED_STEPS for k, v in run["launches"].items() if v}))
        if not math.isfinite(run["loss"]):
            raise AssertionError(f"remat/{name}: non-finite loss")
        check_counts(f"remat/{name}", run["launches"], mega_attn_expect(ab, xl.depth, REMAT_TIMED_STEPS, remat))
        del state, step, run
        torch.cuda.empty_cache()
    (loss_off, grads_off), (loss_on, grads_on) = sides["no-remat"], sides["remat"]
    loss_same, differs = torch.equal(loss_on, loss_off), tree_mismatch(torch, grads_on, grads_off)
    phase("check", what="remat/xl:same-bits-as-no-remat", loss=loss_same, gradients=differs is None,
          tensors=len(grads_off), first_differing=differs)
    if not loss_same or differs is not None:
        raise AssertionError(f"remat changes the step: loss same {loss_same}, first differing gradient {differs}")
    del sides, grads_off, grads_on

    # the kernel path under remat against the float32 plain path, by
    # check_paths' rule, at XL_CHECK_BATCH rows
    ds, batch, draws = train_inputs(torch, dev, xl, XL_CHECK_BATCH)
    losses, grads = {}, {}
    for name, cfg in (("f32", xl.replace(compute_dtype="float32", block_kernel="off")),
                      ("off", xl.replace(block_kernel="off")), ("mega_attn+pallas:remat", xl.replace(remat=True))):
        state, step, losses[name], g = checked_step(torch, dev, cfg, sd0, batch, draws, ds.stats, ema_stds=())
        grads[name] = torch.cat([v.float().reshape(-1) for v in g.values()])
        del state, step, g
        torch.cuda.empty_cache()
    phase("remat", check_batch=XL_CHECK_BATCH, note="the f32 plain path at 256 rows does not fit beside the others")
    check_paths(torch, "remat-xl-loss", {k: v.reshape(1) for k, v in losses.items()}, ("mega_attn+pallas:remat",))
    check_paths(torch, "remat-xl-grads", grads, ("mega_attn+pallas:remat",))
    del sd0, grads, losses, batch, draws
    torch.cuda.empty_cache()

    # 2. DiT-S/2 at batch 256 in the scan_blocks layout on the per-block
    # weights stacked: the step bit for bit, launches a step of both
    cfg = s2_cfg.replace(block_kernel="mega_attn", attn_bwd="pallas")
    init = init_model(cfg, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd0 = init.state_dict()
    del init
    ds, batch, draws = train_inputs(torch, dev, cfg, TRAIN_BATCH)
    steps = {}
    for name, c, weights in (("per-block", cfg, sd0),
                             ("scan_blocks", cfg.replace(scan_blocks=True), stack_block_params(sd0, cfg.depth))):
        state, step, loss, g = checked_step(torch, dev, c, weights, batch, draws, ds.stats)
        steps[name] = (loss, unstack_block_params(g, cfg.depth) if c.scan_blocks else dict(g))
        run = timed_steps(torch, state, step, batch, REMAT_TIMED_STEPS)
        with tempfile.TemporaryDirectory(prefix="mapdit_scan_profile_") as out_dir:
            prof = _profile(out_dir, lambda: step(state, batch), "key_averages.txt", calls=SCAN_PROFILED_STEPS)
        counts[f"s2/mega_attn+pallas:{name}"] = run["launches"]
        phase("scan", model=MODEL, layout=name, batch=TRAIN_BATCH, first_loss=f"{float(loss):.6f}",
              ms_per_step=json.dumps([round(v, 4) for v in run["ms"]]),
              device_launches_per_step=f"{prof['device_launches_per_step']:.1f}",
              device_busy_ms_per_step=f"{prof['device_busy_ms_per_step']:.4f}", parameters=len(g),
              launches_per_step=json.dumps({k: v // REMAT_TIMED_STEPS for k, v in run["launches"].items() if v}))
        check_counts(f"scan/{name}", run["launches"], mega_attn_expect(ab, cfg.depth, REMAT_TIMED_STEPS, False))
        del state, step
    (loss_a, grads_a), (loss_b, grads_b) = steps["per-block"], steps["scan_blocks"]
    differs = tree_mismatch(torch, grads_b, grads_a)
    phase("check", what="scan/s2:step-same-bits-as-per-block", loss=torch.equal(loss_a, loss_b),
          gradients=differs is None, first_differing=differs)
    if not torch.equal(loss_a, loss_b) or differs is not None:
        raise AssertionError(f"scan_blocks changes the S/2 step (first differing gradient {differs})")
    del steps, grads_a, grads_b

    # the clipped 10-step chain through auto with a batch hint: one dit_stack
    # launch a block (the per-block kernel on the views), never the stack,
    # bit for bit against the per-block layout's per-block path
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    z = torch.randn(2 * BATCH, 4, 16, 16, generator=gen, device=dev)
    y = torch.cat([torch.randint(0, 1000, (BATCH,), generator=gen, device=dev), torch.full((BATCH,), 1000, device=dev)])
    short = create_diffusion("10", device=dev)
    chains = {}
    for name, c, weights, hint in (("per-block", s2_cfg, sd0, None),
                                   ("scan_blocks", s2_cfg.replace(scan_blocks=True), stack_block_params(sd0, cfg.depth),
                                    BATCH)):
        fn = build_sample_fn(c.replace(block_kernel="auto"), weights, short, cfg_scale=CFG_SCALE, clip_denoised=True,
                             batch_hint=hint, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        chains[name] = fn(z, y, torch.Generator(device=dev).manual_seed(SEED + 12))
        torch.cuda.synchronize()
        launched = launch_counts()
        phase("scan", chain=name, run_cfg=fn.run_cfg.block_kernel, batch_hint=hint, steps=10,
              finite=bool(torch.isfinite(chains[name]).all()),
              launches=json.dumps({k: v for k, v in launched.items() if v}))
        check_counts(f"scan/chain:{name}", launched, {"fused_dit_block": 10 * cfg.depth, "dit_stack": 10 * cfg.depth})
    same = torch.equal(chains["scan_blocks"], chains["per-block"])
    phase("check", what="scan/s2:chain-same-bits-as-per-block", ok=same)
    if not same:
        raise AssertionError("the scan_blocks chain differs from the per-block layout's")
    try:
        build_sample_fn(s2_cfg.replace(scan_blocks=True, block_kernel="mega_stack"), stack_block_params(sd0, cfg.depth),
                        short, cfg_scale=CFG_SCALE, batch_hint=BATCH, device=dev)
    except ValueError as e:
        phase("check", what="scan/mega_stack", raises="ValueError", message=json.dumps(str(e)))
    else:
        raise AssertionError("an explicit mega_stack under scan_blocks did not raise")
    return counts


def standalone_kernel_rows(torch, F, gen, dev) -> dict:
    """Phase 3, third part: fused_attention at its FUSED_SHAPES entries and
    fused_mlp_branch at the DiT-B/2 shapes (64 CFG rows and TRAIN_BATCH
    rows x 64 tokens, D=768, 12 heads, H=3072, bf16) against their plain
    versions, and both gradients against autograd through the plain
    versions. Returns the report rows (each names the run and the counter
    whose launch count it reports)."""
    from mapdit_tpu_torch.ops.cuda import attention as at
    from mapdit_tpu_torch.ops.cuda import mlp_block as mb

    bf, f32 = torch.bfloat16, torch.float32
    t, d, heads = 64, 768, 12
    hd = d // heads
    out_rows = {}

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def model_views(n, t_, h_, hd_, dtype=bf, scale=1.0):
        """q, k, v as models/layers.py:Attention hands them in: transposed
        views of one (N, T, 3D) qkv product, no copy."""
        qkv = (randn(n, t_, 3 * h_ * hd_) * scale).to(dtype)
        return tuple(z.reshape(n, t_, h_, hd_).transpose(1, 2) for z in qkv.split(h_ * hd_, dim=-1))

    count_from = {"fused_attention": ("P1/chain", "fused_attention"),
                  "fused_attention/train": ("P2/train", "fused_attention")}
    for name in FUSED_SHAPES:
        case = fused_case(torch, F, gen, dev, name)
        got = case.run()
        err = case.check(got)
        row = attention_row(torch, case, name, FUSED_SRC, FUSED_LINE)
        if ":" in name:  # off the main path: checked and timed, not in the kernels line
            continue
        if not got.transpose(1, 2).is_contiguous():
            raise AssertionError("fused_attention's output does not reshape to (N, T, D) as a view")
        out_rows[name] = dict(row, max_abs_err=err, count_from=count_from[name])
        qc, kc, vc = (z.contiguous() for z in (case.q, case.k, case.v))
        compare(torch, at.fused_attention(qc, kc, vc, case.scale, True), got, 0.0, 0.0, name + ":contiguous==strided")
        phase("time", kernel=name + ":contiguous",
              ms=f"{graph_ms(torch, lambda: at.fused_attention(qc, kc, vc, case.scale, True)):.4f}")

    # fused_attention's gradient: kernel forward, backward through the plain
    # path, against autograd through the plain version in f32
    q, k_, v = (z.detach().requires_grad_() for z in model_views(2 * BATCH, t, heads, hd))
    cot = randn(2 * BATCH, heads, t, hd, dtype=bf)
    sc = 1 / math.sqrt(hd)

    def attn_grad():
        return torch.autograd.grad(at.fused_attention(q, k_, v, sc, True), (q, k_, v), cot)

    grad_checks(torch, "fused_attention/grad", attn_grad, lambda *z: at.attention_reference(*z, sc, True),
                [q, k_, v], cot, ["dq", "dk", "dv"])

    # row 9: one launch of mlp_branch (csrc/dit_block_tp.cu) a call, at the
    # B/2 shapes (timed beside its former two-launch route and the library
    # pair), then at the other token counts and widths (checked)
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.tools import bench_mlp_branch as mbench
    from mapdit_tpu_torch.tools import bench_tp_kernels as tpbench

    words = build.library("dit_block_tp").dit_block_tp_plan_words()
    plan_words = len(mb.mlp_plan(2 * BATCH, t, d, 4 * d).words())
    phase("check", what="mlp_branch:plan-words", kernel_words=words, plan_words=plan_words, ok=words == plan_words)
    if words != plan_words:
        raise AssertionError("mlp_branch reads another number of plan words than mlp_plan gives")
    card = json.dumps(smi_line())

    def mlp_check(what, args, timed=False):
        before, before_k = dict(mb.LAUNCHES), dict(k.LAUNCHES)
        got = mb.fused_mlp_branch(*args)
        moved = {key: v - before[key] for key, v in mb.LAUNCHES.items() if v != before[key]}
        if moved != {"mlp_branch/fwd": 1, "mlp_branch/kernel": 1} or k.LAUNCHES != before_k:
            raise AssertionError(f"{what}: not one launch of mlp_branch and no other kernel's ({moved})")
        # two bf16 roundings upstream (hidden, output): relative L2
        err = compare_rel(torch, got, mb.fused_mlp_branch_plain(*args), 1e-2, what)
        compare(torch, mb.fused_mlp_branch(*args), got, 0.0, 0.0, what + ":same-bits-twice")
        if timed:
            one_device_operation(what, lambda: mb.fused_mlp_branch(*args))
            compare_rel(torch, mb.mlp_launch_sequence(*args), got, 1e-2, what + ":route-vs-kernel")
        return err

    mlp_src = "mapdit_tpu_torch/csrc/dit_block_tp.cu"
    mlp_line = "mapdit_tpu/ops/pallas/mlp_block.py:89"
    for name, n, count_from in (("fused_mlp_branch", 2 * BATCH, ("P1/chain", "mlp_branch/kernel")),
                                ("fused_mlp_branch/train", TRAIN_BATCH, ("P1/train", "mlp_branch/kernel"))):
        case = mbench.mlp_case(gen, dev, n)
        args = case["args"]
        err = mlp_check(name, args, timed=True)
        b, by = bound_ms(case["flops"], case["bytes"])
        kernel_times = tpbench.times(lambda args=args: mb.fused_mlp_branch(*args),
                                     lambda args=args: mb.mlp_launch_sequence(*args))
        row = dict(source=mlp_src, replaces=mlp_line, max_abs_err=err, **kernel_times,
                   plain_ms=graph_ms(torch, lambda args=args: mb.fused_mlp_branch_plain(*args)),
                   bound_ms=b, bound_by=by, library_ms=graph_ms(torch, case["library"]),
                   library_eager_ms=time_ms(torch, case["library"]), count_from=count_from)
        phase("time", kernel=name, **{key: f"{v:.4f}" for key, v in row.items() if isinstance(v, float)},
              bound_by=by, card=card)
        out_rows[name] = row
    for tag, n, t_, d_, hid_ in mbench.RAGGED:
        mlp_check(f"fused_mlp_branch:{tag}", mbench.mlp_case(gen, dev, n, t_, d_, hid_)["args"])
    # fc1 pre-activations far below -88, where e^-c overflows f32: the
    # MP-SiLU gives -0 there, as the plain version and the former route do
    tag, n, t_, d_, hid_, deep = mbench.DEEP
    deep_args = mbench.mlp_case(gen, dev, n, t_, d_, hid_, deep=deep)["args"]
    below = mbench.fc1_below(deep_args)
    phase("check", what=f"fused_mlp_branch:{tag}:inputs", fc1_below=below, ok=below > 0)
    if not below:
        raise AssertionError(f"fused_mlp_branch:{tag}: no fc1 pre-activation below -88")
    mlp_check(f"fused_mlp_branch:{tag}", deep_args)
    compare_rel(torch, mb.fused_mlp_branch(*deep_args), mb.mlp_launch_sequence(*deep_args), 1e-2,
                f"fused_mlp_branch:{tag}:kernel-vs-route")
    inputs = [z.detach().requires_grad_() for z in args]
    cot = randn(TRAIN_BATCH, t, d, dtype=bf)

    def mlp_grad():
        return torch.autograd.grad(mb.fused_mlp_branch(*inputs), inputs, cot)

    grad_checks(torch, "fused_mlp_branch/grad", mlp_grad, mb.mlp_reference, inputs, cot,
                ["dx", "dshift", "dscale", "dgate", "dgain", "dw1", "dw2"], gains=("dgain",))
    return out_rows


def family_phase(torch, dev, tag: str, flags: dict, kernels: dict) -> dict:
    """Phase 7 for one family: DiT-B/2 at full width and depth on the
    generic block path, the family by ``flags``, its kernels by ``kernels``. The first model call and
    a clipped 10-step chain are held to the float32 plain path; then the
    FAMILY_STEPS-step chain through build_sample_fn and FAMILY_TRAIN_STEPS train
    steps at TRAIN_BATCH through make_train_step, launch counts read around
    each. Returns {"<tag>/call" | "<tag>/chain" | "<tag>/train": counts}."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import DiT, build_config, init_model
    from mapdit_tpu_torch.runtime import build_sample_fn, fold_weights_for_inference

    base = build_config(FAMILY_MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16", **flags)
    kernel_cfg = base.replace(**kernels)
    depth = base.depth
    fused_mlp = kernels["block_kernel"] == "pallas"

    def expect(model_calls):
        counts = {"fused_attention": depth * model_calls}
        if fused_mlp:
            counts.update({"mlp_branch/fwd": depth * model_calls, "mlp_branch/kernel": depth * model_calls})
        return counts

    init = init_model(base, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd = {key: v.to(dev) for key, v in init.state_dict().items()}
    n_params = sum(p.numel() for p in init.parameters())
    del init
    phase(tag, model=FAMILY_MODEL, flags=json.dumps({**base.flags_dict(), **kernels}), parameters=n_params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    n = 2 * BATCH
    z = torch.randn(n, 4, 16, 16, generator=gen, device=dev)
    y = torch.cat([torch.randint(0, 1000, (BATCH,), generator=gen, device=dev), torch.full((BATCH,), 1000, device=dev)])
    tf = torch.full((n,), 500.0, device=dev)
    paths = {"f32": base.replace(compute_dtype="float32"), "off": base, tag: kernel_cfg}

    # first model call, folded weights as the chain folds them
    outs, counts = {}, {}
    for name, c in paths.items():
        c = c.replace(fold_weights=True)
        model = DiT(c).to(dev).eval()
        model.load_state_dict(fold_weights_for_inference(sd, c))
        reset_launch_counts()
        with torch.no_grad():
            outs[name] = model.forward_with_cfg(z, tf, y, CFG_SCALE)
        torch.cuda.synchronize()
        if name == tag:
            counts[f"{tag}/call"] = launch_counts()
        del model
    phase(tag, step="model-call", launches=json.dumps({key: v for key, v in counts[f"{tag}/call"].items() if v}))
    check_counts(f"{tag}/call", counts[f"{tag}/call"], expect(1))
    check_paths(torch, f"{tag}-forward", outs, (tag,))

    # a clipped 10-step chain on every path (also the kernel path's warm-up)
    short = create_diffusion("10", device=dev)
    outs = {}
    for name, c in paths.items():
        fn = build_sample_fn(c, sd, short, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=BATCH, device=dev)
        outs[name] = fn(z, y, torch.Generator(device=dev).manual_seed(SEED + 1))
        if name == tag and fn.run_cfg.block_kernel != kernel_cfg.block_kernel:
            raise AssertionError(f"{tag}: the runtime changed block_kernel to {fn.run_cfg.block_kernel}")
        del fn
    check_paths(torch, f"{tag}-chain-10", outs, (tag,))

    sample = build_sample_fn(kernel_cfg, sd, create_diffusion(str(FAMILY_STEPS), device=dev), cfg_scale=CFG_SCALE,
                             batch_hint=BATCH, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = sample(z, y, torch.Generator(device=dev).manual_seed(SEED + 3))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts[f"{tag}/chain"] = launch_counts()
    finite = bool(torch.isfinite(out).all())
    phase(tag, step="chain", model=FAMILY_MODEL, batch=f"{BATCH}x2", steps=FAMILY_STEPS, seconds=f"{seconds:.4f}",
          steps_per_s=f"{FAMILY_STEPS / seconds:.3f}", ms_per_model_call=f"{1e3 * seconds / FAMILY_STEPS:.4f}", finite=finite,
          shape=tuple(out.shape), launches=json.dumps({key: v for key, v in counts[f"{tag}/chain"].items() if v}))
    check_counts(f"{tag}/chain", counts[f"{tag}/chain"], expect(FAMILY_STEPS))
    if not finite:
        # untrained weights at clip_denoised=False can leave the data range;
        # the clipped 10-step chain above must be finite
        clipped = bool(torch.isfinite(outs[tag]).all())
        phase(tag, note="non-finite at clip_denoised=False; 10-step clip_denoised=True chain", finite=clipped)
        if not clipped:
            raise AssertionError(f"{tag}: the sampling chain gives non-finite latents")
    del sample, sd, outs
    torch.cuda.empty_cache()

    # the forward of each train step is one model call; the backward
    # recomputes through the plain references and launches nothing
    train = train_phase(torch, dev, f"{tag}-train", paths,
                        {"off": {}, tag: expect(FAMILY_TRAIN_STEPS)}, FAMILY_TRAIN_STEPS)
    counts[f"{tag}/train"] = train[tag]
    return counts


def train_cli_phase(torch, dev, tmp: str):
    """Phase 8: the training entry point, ``mapdit_tpu_torch.train.main``
    called in process, at full DiT-S/2 (depth 12, width 384), batch
    TRAIN_BATCH, bf16, through the attention half-block kernels, into the
    results directory ``tmp``. Returns ({"cli": run A's launch counts,
    "cli+dw": run C's}, run A's experiment directory)."""
    from mapdit_tpu_torch import train
    from mapdit_tpu_torch.models import build_config
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.training import checkpoint as ckpt
    from mapdit_tpu_torch.training import create_optimizer, create_train_state, warmup_flat_invsqrt
    from mapdit_tpu_torch.utils.experiment import config_from_args, load_config

    depth = build_config(MODEL).depth
    common = ["--model", MODEL, "--data-path", "synthetic:1024", "--batch-size", str(TRAIN_BATCH), "--compute-dtype",
              "bfloat16", "--block-kernel", "mega_attn", "--attn-bwd", "pallas", "--num-classes", "1000",
              "--log-every", "1", "--metrics-jsonl", "auto",
              # given, because their defaults follow --num-steps, which run B changes
              "--num-lin-warmup", "4", "--start-decay", "10",
              "--ckpt-every", str(CLI_CKPT_STEP), "--ema-snapshot-every", str(CLI_CKPT_STEP)]

    def run(results, *flags, steps=CLI_STEPS):
        """One run of the CLI: (experiment dir, metrics rows, launch counts)."""
        torch.cuda.synchronize()
        reset_launch_counts()
        exp = train.main(train.build_parser().parse_args([*common, "--results-dir", results, "--num-steps", str(steps), *flags]))
        torch.cuda.synchronize()
        counts = launch_counts()
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
            raise AssertionError(f"train CLI: non-finite loss or gradient norm in {exp}")
        return exp, rows, counts

    def expected(steps, dw):
        # one launch for each of the two dW products with the switch on
        return {**mega_attn_expect(ab, depth, steps, remat=False), **({"attn_bwd/dw": 2 * depth * steps} if dw else {})}

    def rate(rows):
        """steps/s from the third logged step to the checkpoint's (the first
        two build the kernels and warm the allocator up; after the checkpoint
        the background writers share the host with the loop)."""
        first, last = rows[1], rows[CLI_CKPT_STEP - 1]
        return (last["step"] - first["step"]) / (last["wall_time"] - first["wall_time"])

    def rate_after_checkpoint(rows):
        first, last = rows[CLI_CKPT_STEP - 1], rows[-1]
        return (last["step"] - first["step"]) / (last["wall_time"] - first["wall_time"])

    def rel_diffs(rows, ref):
        return [abs(r["loss"] - a["loss"]) / abs(a["loss"]) for r, a in zip(rows, ref)]

    # 1. run A
    exp_a, rows_a, counts_a = run(os.path.join(tmp, "a"))
    check_counts("cli/A", counts_a, expected(CLI_STEPS, dw=False))
    phase("cli", run="A", steps=CLI_STEPS, steps_per_s=f"{rate(rows_a):.3f}",
          steps_per_s_while_writing=f"{rate_after_checkpoint(rows_a):.3f}",
          losses=json.dumps([r["loss"] for r in rows_a]),
          launches=json.dumps({key: v for key, v in counts_a.items() if v}))

    # 2. run B: stop at the checkpoint, restore, go on
    exp_b1, rows_b1, _ = run(os.path.join(tmp, "b"), steps=CLI_CKPT_STEP)
    ckpt_file = ckpt.checkpoint_path(exp_b1, CLI_CKPT_STEP)
    saved = torch.load(ckpt_file, map_location="cpu", weights_only=True)
    args_b = load_config(exp_b1)
    tx = create_optimizer(warmup_flat_invsqrt(args_b["lr"], args_b["num_lin_warmup"], args_b["start_decay"]))
    restored = ckpt.restore_state(ckpt_file, create_train_state(config_from_args(args_b), tx, seed=1, device=dev))
    mismatch = tree_mismatch(torch, ckpt.map_tensors(ckpt.state_tree(restored), lambda v: v.cpu()), saved)
    phase("cli", run="B", restored_equals_saved=mismatch is None, checkpoint=os.path.basename(ckpt_file))
    if mismatch is not None:
        raise AssertionError(f"train CLI: the restored state differs from the saved one at {mismatch}")
    del restored, saved
    exp_b2, rows_b2, _ = run(os.path.join(tmp, "b"), "--resume", exp_b1)
    if [r["step"] for r in rows_b2] != list(range(CLI_CKPT_STEP + 1, CLI_STEPS + 1)):
        raise AssertionError(f"train CLI: the resumed run logged steps {[r['step'] for r in rows_b2]}")
    tail_a = rows_a[CLI_CKPT_STEP:]
    worst = max(rel_diffs(rows_b2, tail_a) + rel_diffs(rows_b1, rows_a))
    phase("cli", run="B", resumed_losses=json.dumps([r["loss"] for r in rows_b2]),
          run_a_losses=json.dumps([r["loss"] for r in tail_a]), max_rel_diff=f"{worst:.3e}", tol="1e-3")
    if worst > 1e-3:
        raise AssertionError(f"train CLI: the resumed run's losses leave run A's by {worst} relative")

    # 3. run C: run A with the dW products through dw_gemm
    ab.DW_IN_KERNEL_BUDGET = 16 * build_config(MODEL).hidden_size ** 2
    try:
        exp_c, rows_c, counts_c = run(os.path.join(tmp, "c"))
    finally:
        ab.DW_IN_KERNEL_BUDGET = 0
    check_counts("cli/C", counts_c, expected(CLI_STEPS, dw=True))
    worst = max(rel_diffs(rows_c, rows_a))
    phase("cli", run="C", steps=CLI_STEPS, steps_per_s=f"{rate(rows_c):.3f}", run_a_steps_per_s=f"{rate(rows_a):.3f}",
          losses=json.dumps([r["loss"] for r in rows_c]), max_rel_diff_vs_a=f"{worst:.3e}", tol="1e-2",
          launches=json.dumps({key: v for key, v in counts_c.items() if v}))
    if worst > 1e-2:
        raise AssertionError(f"train CLI: run C's losses leave run A's by {worst} relative")

    # 4. gradient accumulation and clipping: the same draws up front
    _, rows_d, counts_d = run(os.path.join(tmp, "d"), "--grad-accum", "4", "--grad-clip", "1.0", steps=4)
    check_counts("cli/accum", counts_d, expected(4 * 4, dw=False))
    g_d, g_a = rows_d[0]["grad_norm"], rows_a[0]["grad_norm"]
    rel = abs(g_d - g_a) / g_a
    phase("cli", run="accum4+clip1", losses=json.dumps([r["loss"] for r in rows_d]), grad_norm_step1=g_d,
          run_a_grad_norm_step1=g_a, rel_diff=f"{rel:.3e}", tol="1e-2")
    if rel > 1e-2:
        raise AssertionError(f"train CLI: step-1 grad_norm {g_d} with --grad-accum 4 against {g_a} without")

    # 5. the artifacts
    keys = {"step", "loss", "steps_per_sec", "lr", "samples_seen", "wall_time"}
    for exp, rows in ((exp_a, rows_a), (exp_c, rows_c)):
        missing = [name for name in ("config.yaml", "log.txt", f"checkpoints/{CLI_CKPT_STEP:07d}.pt")
                   if not os.path.isfile(os.path.join(exp, name))]
        snaps = sorted(os.listdir(os.path.join(exp, "ema")))
        want_snaps = [f"{std}_{CLI_CKPT_STEP:07d}.npz" for std in ("0.050", "0.100")]
        if missing or snaps != want_snaps or not all(keys <= set(r) for r in rows) or len(rows) != CLI_STEPS:
            raise AssertionError(f"train CLI: artifacts of {exp}: missing {missing}, ema {snaps}, rows {len(rows)}")
    phase("cli", artifacts="ok", ema=json.dumps(want_snaps), metrics_keys=json.dumps(sorted(rows_a[0])))
    return {"cli": counts_a, "cli+dw": counts_c}, exp_a

TP_SRC = "mapdit_tpu_torch/csrc/dit_block_tp.cu"
TP_LONG_T = 256  # the attention partials' T > 64 route (the launch sequence), at 2 samples


def tp_check(torch, what, got, again, want) -> float:
    """A partial kernel's output against its plain version (f32 partials
    behind bf16 roundings of the hidden / attention operands: relative L2
    1e-2, as the other composite outputs; row 7's mods, bf16 products summed
    in f32 where only the order differs, 1e-4), and the same bits on two
    runs. Returns the partial's max abs error."""
    if isinstance(got, tuple):
        compare(torch, got[1], want[1], 1e-4, 1e-4, what + ":mods")
        same = all(torch.equal(g, h) for g, h in zip(got, again))
        got, want = got[0], want[0]
    else:
        same = torch.equal(got, again)
    err = compare_rel(torch, got, want, 1e-2, what)
    phase("check", what=f"{what}:same-bits-twice", ok=same)
    if not same:
        raise AssertionError(f"{what}: two runs of the kernel differ")
    return err


def tp_kernel_rows(torch, gen, dev) -> dict:
    """Phase 3, fourth part: the tensor-parallel partial kernels
    (csrc/dit_block_tp.cu) against their plain versions at the DiT-XL/2
    shard shapes (XL_BATCH x 2 rows x 64 tokens; the cases of
    mapdit_tpu_torch/tools/bench_tp_kernels.py): tp=2 (the mesh of phase
    10; the report rows) and tp=4 (checked and timed), the same bits twice,
    rows 6 and 8 also on f32 shift and scale views of a mods-shaped buffer
    (the kernels round them to bf16 as they read them); one launch and one
    device operation a call (a captured CUDA graph's nodes). Times: device ms from
    CUDA-graph replays, host ms and eager ms (a host-launched loop, as the
    program runs them), each beside the launch sequence the kernel replaced
    (same call), the plain version and the library call; then one XL/2
    fused_dit_block_tp without its all-reduces, kernels against sequences.
    Then rows 6 and 7 at T > 64, through the launch sequence the wrappers
    take there."""
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.cuda import dit_block_tp as tpk
    from mapdit_tpu_torch.tools import bench_tp_kernels as bench

    words = build.library("dit_block_tp").dit_block_tp_plan_words()
    phase("check", what="dit_block_tp:plan-words", kernel_words=words, plan_words=tpk.TP_PLAN_WORDS,
          ok=words == tpk.TP_PLAN_WORDS)
    if words != tpk.TP_PLAN_WORDS:
        raise AssertionError("dit_block_tp reads another number of plan words than tp_plan gives")
    card = json.dumps(smi_line())
    out_rows = {}
    for tp in bench.TP_WAYS:
        cases = bench.tp_cases(gen, dev, tp)
        for name, (fn, seq, plain, args, line, flops, nbytes, library) in cases.items():
            what = f"{name}:tp{tp}"
            before, before_k = dict(tpk.LAUNCHES), dict(k.LAUNCHES)
            got = fn(*args)
            key = "dit_block_tp/mlp" if name == "mlp_tp_partial" else "dit_block_tp/attn"
            if (tpk.LAUNCHES[key] != before[key] + 1 or tpk.LAUNCHES[name + "/sequence"] != before[name + "/sequence"]
                    or k.LAUNCHES != before_k):
                raise AssertionError(f"{what}: not one launch of {key} and no other kernel's")
            one_device_operation(what, lambda fn=fn, args=args: fn(*args))
            err = tp_check(torch, what, got, fn(*args), plain(*args))
            compare_rel(torch, seq(*args)[0] if name == "block_tp_attn" else seq(*args),
                        got[0] if name == "block_tp_attn" else got, 1e-2, what + ":sequence-vs-kernel")
            if name != "block_tp_attn":
                # shift and scale as f32 views of an (N, 6, D) buffer, as row 8 reads row 7's mods
                mods = torch.randn(args[0].shape[0], 6, args[0].shape[2], generator=gen, device=dev)
                f32_args = (args[0], mods[:, 3], mods[:, 4], *args[3:])
                tp_check(torch, what + ":f32-row-views", fn(*f32_args), fn(*f32_args), plain(*f32_args))
            b, by = bound_ms(flops, nbytes)
            row = dict(source=TP_SRC, replaces=f"{PALLAS}:{line}", max_abs_err=err,
                       **bench.times(lambda fn=fn, args=args: fn(*args), lambda seq=seq, args=args: seq(*args)),
                       plain_ms=graph_ms(torch, lambda plain=plain, args=args: plain(*args)),
                       bound_ms=b, bound_by=by, library_ms=graph_ms(torch, library),
                       count_from=("tp/mega_attn_tp" if name == "attn_tp_partial" else "tp/mega_tp", name))
            phase("time", kernel=what, **{key: f"{v:.4f}" for key, v in row.items() if isinstance(v, float)},
                  bound_by=by, card=card)
            if tp == bench.TP_WAYS[0]:
                out_rows[name] = row
        # one XL/2 block on a rank as fused_dit_block_tp runs it, all-reduces skipped
        kernel, seq = bench.block_call(cases, "kernel"), bench.block_call(cases, "sequence")
        before = dict(tpk.LAUNCHES)
        got = kernel()
        moved = {key: v - before[key] for key, v in tpk.LAUNCHES.items() if v != before[key]}
        want = {"block_tp_attn": 1, "mlp_tp_partial": 1, "dit_block_tp/attn": 1, "dit_block_tp/mlp": 1}
        phase("check", what=f"fused_dit_block_tp:tp{tp}:launches", launches=json.dumps(moved), ok=moved == want)
        if moved != want:
            raise AssertionError(f"fused_dit_block_tp:tp{tp}: launches {moved}, not {want}")
        compare_rel(torch, got, seq(), 1e-2, f"fused_dit_block_tp:tp{tp}:kernels-vs-sequences")
        same = torch.equal(got, kernel())
        phase("check", what=f"fused_dit_block_tp:tp{tp}:same-bits-twice", ok=same)
        if not same:
            raise AssertionError(f"fused_dit_block_tp:tp{tp}: two runs differ")
        row = dict(bench.times(kernel, seq), device_ops=bench.device_ops(kernel)[0],
                   sequence_device_ops=bench.device_ops(seq)[0])
        phase("time", kernel=f"fused_dit_block_tp-without-all-reduce:tp{tp}",
              **{key: f"{v:.4f}" for key, v in row.items()}, card=card)
    # T > 64: rows 6 and 7 take the launch sequence, counted under its own key
    cases = bench.tp_cases(gen, dev, bench.TP_WAYS[0], t=TP_LONG_T, n=2)
    for name in ("attn_tp_partial", "block_tp_attn"):
        fn, _, plain, args = cases[name][:4]
        before = dict(tpk.LAUNCHES)
        got = fn(*args)
        if (tpk.LAUNCHES[name + "/sequence"] != before[name + "/sequence"] + 1
                or tpk.LAUNCHES["dit_block_tp/attn"] != before["dit_block_tp/attn"]):
            raise AssertionError(f"{name} at T={TP_LONG_T}: not the launch sequence's route")
        tp_check(torch, f"{name}:tp{bench.TP_WAYS[0]}:t{TP_LONG_T}:sequence-route", got, fn(*args), plain(*args))
    return out_rows


# the f32 forms of csrc/dit_block_tp.cu (a float32 model on mega_tp,
# mega_attn_tp or pallas), drawn in f32 from generator SEED + 62 in this
# order: the TP partials at the XL/2 shards, (tp, T, N): tp=2 at T = 64 (the
# report rows, timed), then checked at tp=4, T = 16 and at T = 4 with an odd
# N; row 9 at the B/2 shapes, N = 64 and 256 (timed), then checked at
# bench_mlp_branch's DEEP case (fc1 pre-activations below -88) and its
# RAGGED cases. DEEP's outputs reach |y| ~ 440 from sums of terms in the
# thousands, where f32 sums in k order (the f32 products' FFMA order) and
# the plain version's blocked sums lie up to ~1.5e-3 apart: DEEP holds the
# kernel, its sequence and the plain version element by element to the
# float64 witness, each output within F32_TOL of the sum of its terms'
# absolute values (bench_mlp_branch.f64_witness) plus F32_TOL
F32_TP_SHAPES = ((2, 64, 8), (4, 16, 8), (2, 4, 3))
F32_MLP_SAMPLES = (64, 256)


def one_device_operation(what: str, fn) -> None:
    """Fails unless one call of ``fn`` is one device operation, a kernel:
    the nodes of a CUDA graph captured around a call
    (bench_tp_kernels.device_ops; a capture drops nothing). Beside it, for
    the record, what a torch.profiler trace of five calls sees
    (bench_tp_kernels.profiler_ops: device events a call, and the ms from
    each kernel's launch call to its start), which late in a long process
    has missed kernel events."""
    from mapdit_tpu_torch.tools import bench_tp_kernels as bench

    ops, names = bench.device_ops(fn)
    seen = bench.profiler_ops(fn)
    ok = bench.is_one_kernel(names)
    phase("check", what=f"{what}:device-operations-a-call", ops=ops, names=json.dumps(names),
          profiler_ops=seen["ops"], launch_to_kernel_ms=json.dumps(seen["launch_to_kernel_ms"]), ok=ok)
    if not ok:
        raise AssertionError(f"{what}: {ops} device operations a call ({names}), not one kernel")


def f32_tp_rows(torch, dev, check_only: bool = False) -> dict:
    """Rows 6, 7 and 8 in f32 (tp_attn_f32 and tp_mlp_f32, the f32
    instances of csrc/dit_block_tp.cu) at F32_TP_SHAPES
    (bench_tp_kernels.tp_cases in f32) and row 9 in f32 (mlp_branch_f32, on
    the TP kernels' f32 instance) at F32_MLP_SAMPLES, DEEP and RAGGED
    (bench_mlp_branch.mlp_case in f32): each call one launch of its f32
    instance (no launch sequence, no mp_gemm or cosine_attention launch) and
    one device operation, held to its f32 plain version at F32_TOL with
    TF32 off (row 7's mods too), the same bits twice, and its f32 launch
    sequence (rows 6 and 7's route at T > 64, every row's yardstick) held to
    the same plain version. Then (unless ``check_only``) the report shapes
    timed beside their f32 sequences: graph, host and eager ms, the plain
    version's and the f32 library calls' graph ms (torch.matmul with TF32
    off, f32 SDPA), the bound on the f32 pipes. Returns the kernels line's
    four rows (their launches from phase 10's f32 island chains and phase
    6f's f32 pallas paths)."""
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.cuda import mlp_block as mb
    from mapdit_tpu_torch.tools import bench_mlp_branch as mbench
    from mapdit_tpu_torch.tools import bench_tp_kernels as bench

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 62)
    card = json.dumps(smi_line())
    rows = {}

    def checked(what, key, fn, seq, plain, args, witness=None):
        """One call (one launch of ``key``, one device operation) against
        the plain version and the same bits twice; the sequence against the
        plain version. ``witness``: (the float64 reference, each output's
        scale), to which the call, the sequence and the plain version are
        held instead, element by element: within F32_TOL x (scale + 1).
        Returns the main output's max abs error."""
        before, before_k = launch_counts(), dict(k.LAUNCHES)
        got = fn(*args)
        after = launch_counts()
        moved = {name: after[name] - before[name] for name in after if after[name] != before[name]}
        if moved.get(key) != 1 or any(name.endswith("/sequence") for name in moved) or k.LAUNCHES != before_k:
            raise AssertionError(f"{what}: not one launch of {key} and no other kernel's ({moved})")
        one_device_operation(what, lambda: fn(*args))
        want, again, from_seq = plain(*args), fn(*args), seq(*args)
        outs = (got, again, want, from_seq) if isinstance(got, tuple) else ((got,), (again,), (want,), (from_seq,))
        if witness is not None:
            ref, scale = witness()
            tol = F32_TOL * (scale + 1)
            worst = {name: float(((v.double() - ref).abs() / tol).max())
                     for name, v in (("kernel", got), ("sequence", from_seq), ("plain", want))}
            err = float((got - want).abs().max())
            ok = all(bool(torch.isfinite(v).all()) for v in (got, from_seq, want)) and max(worst.values()) <= 1
            phase("check", what=f"{what}:f64-witness", **{f"{name}_err_over_tol": f"{v:.4e}" for name, v in worst.items()},
                  kernel_max_abs_err_f64=f"{float((got.double() - ref).abs().max()):.3e}",
                  max_abs_err_vs_plain=f"{err:.3e}", max_abs_f64=f"{float(ref.abs().max()):.4e}",
                  tol=f"F32_TOL x (scale + 1), scale to {float(scale.max()):.4e}", ok=ok)
            if not ok:
                raise AssertionError(f"{what}: past F32_TOL x (scale + 1) of the float64 witness: {worst}")
            errs = [err]
        else:
            errs = [compare(torch, g, w, F32_TOL, F32_TOL, f"{what}{':mods' if i else ''}")
                    for i, (g, w) in enumerate(zip(outs[0], outs[2]))]
            for i, (q, w) in enumerate(zip(outs[3], outs[2])):
                compare(torch, q, w, F32_TOL, F32_TOL, f"{what}{':mods' if i else ''}:sequence")
        same = all(torch.equal(g, h) for g, h in zip(outs[0], outs[1]))
        phase("check", what=f"{what}:same-bits-twice", ok=same)
        if not same:
            raise AssertionError(f"{what}: two runs of the kernel differ")
        return errs[0]

    def timed(name, what, fn, seq, plain, library, err, flops, nbytes, replaces, **counted_on):
        b, by = bound_ms(flops, nbytes, H100_F32_FLOPS)
        row = dict(source=TP_SRC, replaces=replaces, max_abs_err=err, **bench.times(fn, seq),
                   plain_ms=graph_ms(torch, plain), bound_ms=b, bound_by=by, library_ms=graph_ms(torch, library),
                   **counted_on)
        phase("time", kernel=what, **{key: f"{v:.4f}" for key, v in row.items() if isinstance(v, float)},
              bound_by=by, card=card)
        rows[name] = row

    names = {"attn_tp_partial": ("dit_block_tp/attn:f32", "dit_block_tp/attn", "tp/mega_attn_tp:f32"),
             "block_tp_attn": ("dit_block_tp/block:f32", "dit_block_tp/attn", "tp/mega_tp:f32"),
             "mlp_tp_partial": ("dit_block_tp/mlp:f32", "dit_block_tp/mlp", "tp/mega_tp:f32")}
    for tp, t, n in F32_TP_SHAPES:
        for name, (fn, seq, plain, args, line, flops, nbytes, library) in bench.tp_cases(gen, dev, tp, t, n,
                                                                                        f32).items():
            row, key, path = names[name]
            what = f"{row}:tp{tp}:t{t}:n{n}"
            err = checked(what, key, fn, seq, plain, args)
            if not check_only and (tp, t, n) == F32_TP_SHAPES[0]:
                timed(row, what, lambda fn=fn, args=args: fn(*args), lambda seq=seq, args=args: seq(*args),
                      lambda plain=plain, args=args: plain(*args), library, err, flops, nbytes, f"{PALLAS}:{line}",
                      count_from=(path, name))
            del args
        torch.cuda.empty_cache()

    mlp_line = "mapdit_tpu/ops/pallas/mlp_block.py:89"
    deep_tag, *deep_shape, deep = mbench.DEEP
    cases = [(f"n{n}", (n,), 0.0) for n in F32_MLP_SAMPLES] + [(deep_tag, tuple(deep_shape), deep)]
    cases += [(tag, tuple(shape), 0.0) for tag, *shape in mbench.RAGGED]
    for tag, shape, scale in cases:
        case = mbench.mlp_case(gen, dev, *shape, deep=scale, dtype=f32)
        args = case["args"]
        what = f"mlp_branch:f32:{tag}"
        if scale:
            below = mbench.fc1_below(args)
            phase("check", what=f"{what}:inputs", fc1_below=below, ok=below > 0)
            if not below:
                raise AssertionError(f"{what}: no fc1 pre-activation below -88")
        witness = (lambda args=args: mbench.f64_witness(args)) if scale else None
        err = checked(what, "mlp_branch/kernel", mb.fused_mlp_branch, mb.mlp_launch_sequence,
                      mb.fused_mlp_branch_plain, args, witness)
        if not check_only and tag in ("n64", "n256"):
            timed("mlp_branch:f32" if tag == "n64" else "mlp_branch:f32:n256", what,
                  lambda args=args: mb.fused_mlp_branch(*args), lambda args=args: mb.mlp_launch_sequence(*args),
                  lambda args=args: mb.fused_mlp_branch_plain(*args), case["library"], err, case["flops"],
                  case["bytes"], mlp_line, path="f32/pallas", count_key="mlp_branch/kernel")
        del args, case
        torch.cuda.empty_cache()
    # N = 256 is printed beside N = 64; the kernels line holds N = 64
    rows.pop("mlp_branch:f32:n256", None)
    return rows


def xl_config():
    from mapdit_tpu_torch.models import build_config

    return build_config(XL_MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16")


def xl_state_dict(torch, cfg, dev) -> dict:
    """DiT-XL/2's random weights from SEED, gains drawn. Drawn on the card
    (a CPU draw of 674M values takes seconds in every process): the parent
    and every rank draw the same on the same card."""
    from mapdit_tpu_torch.models import DiT

    init = DiT(cfg).to(dev)
    init.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    draw_gains(torch, init, SEED)
    return init.state_dict()


def xl_phase(torch, dev) -> dict:
    """Phase 9: DiT-XL/2 at full depth and width on one card. The first
    model call (folded weights; "auto" takes the whole-block kernels per
    block) and a clipped XL_CHECK_STEPS-step CFG chain ("auto" with a batch
    hint takes the whole-stack path) against the float32 plain path, launch
    counts read around each, and their times (the kernel chain's from a
    second, warm run). Returns the chain inputs and the chains on the CPU,
    for the TP ranks of phase 10."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import DiT
    from mapdit_tpu_torch.runtime import build_sample_fn, fold_weights_for_inference

    cfg = xl_config()
    depth = cfg.depth
    t0 = time.perf_counter()
    sd = xl_state_dict(torch, cfg, dev)
    phase("xl", model=XL_MODEL, depth=depth, width=cfg.hidden_size, heads=cfg.num_heads, batch=f"{XL_BATCH}x2",
          parameters=sum(v.numel() for key, v in sd.items() if key != "pos_embed"),
          init_seconds=f"{time.perf_counter() - t0:.2f}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n = 2 * XL_BATCH
    z = torch.randn(n, 4, 16, 16, generator=gen, device=dev)
    y = torch.cat([torch.randint(0, 1000, (XL_BATCH,), generator=gen, device=dev),
                   torch.full((XL_BATCH,), 1000, device=dev)])
    tf = torch.full((n,), 500.0, device=dev)
    paths = {"f32": cfg.replace(compute_dtype="float32"), "off": cfg, "auto": cfg.replace(block_kernel="auto")}

    outs = {}
    for name, c in paths.items():
        c = c.replace(fold_weights=True)
        model = DiT(c).to(dev).eval()
        model.load_state_dict(fold_weights_for_inference(sd, c))
        with torch.no_grad():
            torch.cuda.synchronize()
            reset_launch_counts()
            outs[name] = model.forward_with_cfg(z, tf, y, CFG_SCALE)
            torch.cuda.synchronize()
            counts = launch_counts()
            ms = time_ms(torch, lambda: model.forward_with_cfg(z, tf, y, CFG_SCALE), iters=5, warmup=1)
        phase("xl", step="model-call", path=name, ms=f"{ms:.4f}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))
        if name == "auto":
            check_counts("xl/call", counts, {"fused_dit_block": depth, "dit_stack": depth})
        del model
    check_paths(torch, "xl-forward", outs, ("auto",))

    short = create_diffusion(str(XL_CHECK_STEPS), device=dev)
    chains = {}
    for name, c in paths.items():
        fn = build_sample_fn(c, sd, short, cfg_scale=CFG_SCALE, clip_denoised=True,
                             batch_hint=XL_BATCH if name == "auto" else None, device=dev)
        for _ in range(2 if name == "auto" else 1):  # the kernel chain's second run is timed
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            chains[name] = fn(z, y, torch.Generator(device=dev).manual_seed(SEED + 12))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = launch_counts()
        phase("xl", step="chain", path=name, run_cfg=fn.run_cfg.block_kernel, steps=XL_CHECK_STEPS,
              seconds=f"{seconds:.4f}", ms_per_model_call=f"{1e3 * seconds / XL_CHECK_STEPS:.4f}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))
        if name == "auto":
            check_counts("xl/chain", counts, {"fused_dit_stack": XL_CHECK_STEPS, "dit_stack": XL_CHECK_STEPS})
        del fn
    check_paths(torch, "xl-chain-10", chains, ("auto",))
    torch.cuda.empty_cache()
    return {name: v.cpu() for name, v in (("z", z), ("y", y), *chains.items())}


def tp_islands(torch, rank, dev, mesh, refs) -> dict:
    """Phase 10's islands on this rank of the (1, 2) mesh: DiT-XL/2 from the
    seed, the clipped chain through each island held to the float32 plain
    chain of phase 9 by check_paths' rule with exact launch counts of this
    rank, the same chain again warm and timed; then the same for a float32
    model on each island (the f32 instances of csrc/dit_block_tp.cu), each
    at least F32_CLOSER times closer to the float32 plain chain than the
    bf16 island's chain of this spawn. Returns the report (raises on a
    failure)."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.runtime import build_sample_fn

    cfg = xl_config()
    sd = xl_state_dict(torch, cfg, dev)
    z, y = refs["z"].to(dev), refs["y"].to(dev)
    per = XL_CHECK_STEPS * cfg.depth
    expect = {
        # one launch of each dit_block_tp kernel a block, no mp_gemm or cosine_attention launch
        "mega_tp": {"block_tp_attn": per, "mlp_tp_partial": per, "dit_block_tp/attn": per, "dit_block_tp/mlp": per},
        # the modulation head and the MLP run plain, replicated
        "mega_attn_tp": {"attn_tp_partial": per, "dit_block_tp/attn": per},
    }
    limit = max(2 * rel_l2(refs["off"], refs["f32"]), 1e-2)
    report = {"counts": {}, "rel_l2_err_vs_f32": {}, "rel_l2_err_vs_auto": {}, "first_ms_per_model_call": {},
              "ms_per_model_call": {}, "limit": limit}
    short = create_diffusion(str(XL_CHECK_STEPS), device=dev)
    chains = {}
    for kernel in ("mega_tp", "mega_attn_tp"):
        for dtype in ("bfloat16", "float32"):
            key = kernel if dtype == "bfloat16" else f"{kernel}:f32"
            fn = build_sample_fn(cfg.replace(block_kernel=kernel, compute_dtype=dtype), sd, short, cfg_scale=CFG_SCALE,
                                 clip_denoised=True, mesh=mesh)
            seconds = []
            for run in range(2):  # the first run is checked and counted, the second (warm) timed
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                out = fn(z, y, torch.Generator(device=dev).manual_seed(SEED + 12))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                if run == 0:
                    counts = launch_counts()
                    check_counts(f"tp/{key}/rank{rank}", counts, expect[kernel])
                    chains[key] = out.cpu()
                    err = rel_l2(chains[key], refs["f32"])
                    if not bool(torch.isfinite(out).all()) or err > limit:
                        raise AssertionError(f"tp/{key}/rank{rank}: off the f32 plain chain (rel L2 {err} > {limit})")
                    report["counts"][key] = counts
                    report["rel_l2_err_vs_f32"][key] = err
                    report["rel_l2_err_vs_auto"][key] = rel_l2(chains[key], refs["auto"])
            report["first_ms_per_model_call"][key] = 1e3 * seconds[0] / XL_CHECK_STEPS
            report["ms_per_model_call"][key] = 1e3 * seconds[1] / XL_CHECK_STEPS
            del fn, out
            torch.cuda.empty_cache()
        # the f32 island against the bf16 one of this spawn (f32_distances)
        e32, e16, ok = f32_distances(refs["f32"], chains[f"{kernel}:f32"], chains[kernel])
        report.setdefault("f32_closer", {})[kernel] = {"f32_rel_l2": e32, "bf16_rel_l2": e16, "ok": ok}
        if not ok:
            raise AssertionError(f"tp/{kernel}:f32/rank{rank}: {e32} from the f32 plain chain, the bf16 island {e16}")

    del sd
    torch.cuda.empty_cache()
    return report


def tp_rank(rank, dev, refs, out_dir):
    """One rank of phase 10 (started by mapdit_tpu_torch.parallel.spawn):
    the (1, 2) mesh and its islands (tp_islands), then one all-reduce of a
    partial, then the (2, 1) mesh's data-parallel checks (dp_checks). Writes
    its report to ``out_dir``; any failure raises, and then
    mapdit_tpu_torch.parallel.spawn raises in the parent."""
    import torch
    import torch.distributed as dist

    from mapdit_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 2, device=dev)
    report = tp_islands(torch, rank, dev, mesh, refs)
    cfg = xl_config()
    partial = torch.randn(2 * XL_BATCH, 64, cfg.hidden_size, device=dev)
    for _ in range(3):
        dist.all_reduce(partial, group=mesh.model_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(partial, group=mesh.model_group)
    torch.cuda.synchronize()
    report["all_reduce_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    report["backend"] = dist.get_backend(mesh.model_group)
    del partial
    torch.cuda.empty_cache()
    report["dp"] = dp_checks(torch, rank, dev, refs)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def dp_checks(torch, rank, dev, refs) -> dict:
    """Phase 10's data-parallel part on a (2, 1) mesh of the two ranks, at
    DiT-S/2 (weights from SEED, gains drawn): build_dp_sharded_sample_fn's
    clipped ddpm chain, this rank's rows the same bits as the one-device
    chain on them under this rank's stream; PIT on the mesh (block, full
    sweeps, one sample, window PIT_WINDOW: its rows split over the ranks)
    against the unsharded PIT chain within phase 5c's limit; sample_fid in
    process with --kernel-sharding shard_map and with --pit-window on phase
    8's run A, rank 0's npz. Exact dit_stack launches of this rank for each.
    Returns the report's rows."""
    import numpy as np

    from mapdit_tpu_torch import sample_fid
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import build_config, init_model
    from mapdit_tpu_torch.parallel import make_mesh
    from mapdit_tpu_torch.runtime import (
        build_dp_sharded_sample_fn, build_pit_sample_fn, build_sample_fn, data_rank_generator,
    )

    mesh = make_mesh(2, 1, device=dev)
    cfg = build_config(MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16",
                       block_kernel="auto")
    model = init_model(cfg, seed=SEED, device=dev)
    draw_gains(torch, model, SEED)
    sd = model.state_dict()
    del model
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    z = torch.randn(DP_BATCH, 4, 16, 16, generator=gen, device=dev)
    y = torch.randint(0, 1000, (DP_BATCH,), generator=gen, device=dev)
    out = {}

    def run(what, fn, *args, calls):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts(f"{what}/rank{rank}", counts, {"fused_dit_stack": calls, "dit_stack": calls})
        return res, seconds, counts

    d = create_diffusion(str(DP_STEPS), device=dev)
    fn = build_dp_sharded_sample_fn(cfg, sd, d, mesh, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=DP_BATCH)
    got, seconds, counts = run("dp", fn, z, y, torch.Generator(device=dev).manual_seed(SEED + 14), calls=DP_STEPS)
    n_loc = DP_BATCH // mesh.n_data
    rows = slice(mesh.data_index * n_loc, (mesh.data_index + 1) * n_loc)
    single = build_sample_fn(cfg, sd, d, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=n_loc, device=dev,
                             prepared=fn.prepared)
    stream = data_rank_generator(torch.Generator(device=dev).manual_seed(SEED + 14), mesh.data_index, dev)
    want = single(torch.cat([z[rows], z[rows]]), torch.cat([y[rows], torch.full_like(y[rows], 1000)]), stream)[:n_loc]
    same = bool(torch.equal(got[rows], want))
    out["dp"] = dict(kernel=fn.run_cfg.block_kernel, rows_a_rank=n_loc, same_bits_as_one_device_chain=same,
                     finite=bool(torch.isfinite(got).all()), shape=list(got.shape), seconds=seconds,
                     launches={key: v for key, v in counts.items() if v})
    if not same or got.shape != z.shape or fn.run_cfg.block_kernel != "mega_stack":
        raise AssertionError(f"dp/rank{rank}: {out['dp']}")

    d = create_diffusion(f"ddim{PIT_STEPS}", device=dev)
    z1, y1 = torch.cat([z[:1], z[:1]]), torch.cat([y[:1], torch.full_like(y[:1], 1000)])
    kw = dict(cfg_scale=CFG_SCALE, window=PIT_WINDOW, sweeps=PIT_WINDOW, clip_denoised=True)
    pit_mesh = build_pit_sample_fn(cfg, sd, d, mesh=mesh, **kw)
    got, seconds, counts = run("dp/pit", pit_mesh, z1, y1, calls=PIT_STEPS)
    want = build_pit_sample_fn(cfg, sd, d, device=dev, prepared=pit_mesh.prepared, **kw)(z1, y1)
    err, limit = rel_l2(got, want), refs["pit_limit"]
    out["pit"] = dict(kernel=pit_mesh.run_cfg.block_kernel, rel_l2_vs_unsharded=err, tol=limit,
                      same_bits_as_unsharded=bool(torch.equal(got, want)), seconds=seconds,
                      rows_a_call=2 * PIT_WINDOW // mesh.n_data, launches={key: v for key, v in counts.items() if v})
    if not (bool(torch.isfinite(got).all()) and err <= limit):
        raise AssertionError(f"dp/pit/rank{rank}: {out['pit']}")

    # sample_fid's PIT: DP_STEPS / PIT_WINDOW blocks of 2 sweeps
    for tag, flags, calls in (("shard_map", ["--kernel-sharding", "shard_map"], DP_STEPS),
                              ("pit", ["--pit-window", str(PIT_WINDOW), "--pit-sweeps", "2", "--sampler", "ddim"],
                               DP_STEPS // PIT_WINDOW * 2)):
        argv = ["--result-dir", refs["exp"], "--use-vae", "false", "--num-classes", "1000", "--num-samples",
                str(DP_FID_IMAGES), "--batch-size", str(DP_FID_IMAGES), "--num-sampling-steps", str(DP_STEPS),
                "--clip-denoised", "true", "--block-kernel", "auto", "--output-file", f"mesh_{tag}.npz", *flags]
        path, seconds, counts = run(f"dp/sample_fid-{tag}", sample_fid.main, sample_fid.build_parser().parse_args(argv),
                                    calls=calls)
        row = dict(seconds=seconds, launches={key: v for key, v in counts.items() if v})
        if rank == 0:
            with np.load(path) as f:
                arr = f["arr_0"]
            row["arr_0"] = f"{arr.dtype}{tuple(arr.shape)}"
            if arr.dtype != np.uint8 or arr.shape != (DP_FID_IMAGES, 16, 16, 4):
                raise AssertionError(f"dp/sample_fid-{tag}: arr_0 {arr.dtype} {arr.shape}")
        elif path is not None:
            raise AssertionError(f"dp/sample_fid-{tag}: rank {rank} wrote {path}")
        out[f"sample_fid-{tag}"] = row
    return out


def tp_phase(torch, refs) -> dict:
    """Phase 10: two ranks on the card (see tp_rank). Returns rank 0's
    launch counts of each island's checked chain."""
    from mapdit_tpu_torch.parallel import spawn

    with tempfile.TemporaryDirectory(prefix="mapdit_smoke_tp_") as tmp:
        t0 = time.perf_counter()
        spawn(tp_rank, 2, args=(refs, tmp))
        seconds = time.perf_counter() - t0
        reports = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    keys = ("mega_tp", "mega_attn_tp", "mega_tp:f32", "mega_attn_tp:f32")
    for r, rep in enumerate(reports):
        for kernel in keys:
            phase("tp", rank=r, mesh="(1,2)", backend=rep["backend"], kernel=kernel, steps=XL_CHECK_STEPS,
                  rel_l2_err_vs_f32=f"{rep['rel_l2_err_vs_f32'][kernel]:.3e}", tol=f"{rep['limit']:.3e}",
                  rel_l2_err_vs_single_card_kernels=f"{rep['rel_l2_err_vs_auto'][kernel]:.3e}",
                  first_ms_per_model_call=f"{rep['first_ms_per_model_call'][kernel]:.4f}",
                  ms_per_model_call=f"{rep['ms_per_model_call'][kernel]:.4f}",
                  launches=json.dumps({key: v for key, v in rep["counts"][kernel].items() if v}))
        for kernel, row in rep["f32_closer"].items():
            e32, e16 = row["f32_rel_l2"], row["bf16_rel_l2"]
            phase("check", what=f"tp/{kernel}:f32/rank{r}:closer-than-bf16", f32_kernel_rel_l2=f"{e32:.4e}",
                  bf16_kernel_rel_l2=f"{e16:.4e}", ratio=f"{e16 / e32 if e32 > 0 else math.inf:.1f}",
                  tol=f"ratio>={F32_CLOSER:g}", ok=row["ok"])
        phase("tp", rank=r, all_reduce_ms=f"{rep['all_reduce_ms']:.4f}", all_reduce_shape=f"({2 * XL_BATCH},64,1152)f32",
              note="two ranks share one card; gloo all-reduces pass through host memory")
        for what, row in rep["dp"].items():
            phase("dp", rank=r, mesh="(2,1)", what=what, **{key: json.dumps(v) if isinstance(v, (dict, list)) else v
                                                             for key, v in row.items()})
    phase("tp", seconds_with_spawn=f"{seconds:.2f}", card=json.dumps(smi_line()))
    return {f"tp/{kernel}": reports[0]["counts"][kernel] for kernel in keys}


def dp_train_rank(rank, dev, out_dir):
    """One rank of phase 10b (started by mapdit_tpu_torch.parallel.spawn) on
    the (2, 1) mesh: DiT-S/2 at TRAIN_BATCH global rows (the one-card step
    on rank 0 first, from the same seed and weights), then DiT-XL/2 DP and
    FSDP. Writes its report to ``out_dir``; any failure raises, and then
    spawn raises in the parent."""
    import torch
    import torch.distributed as dist

    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import build_config, init_model
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.parallel import make_mesh
    from mapdit_tpu_torch.parallel.mesh import check_replicated, mean_all_reduce_
    from mapdit_tpu_torch.training import (
        SyntheticLatentDataset, create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt,
    )

    mesh = make_mesh(2, 1, device=dev)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    diffusion = create_diffusion("", device=dev)
    ds = SyntheticLatentDataset(num_examples=1024, num_classes=1000, size=16, seed=SEED)
    report = {"backend": dist.get_backend(mesh.data_group)}

    def make(cfg, sd, on_mesh, fsdp=False):
        m = mesh if on_mesh else None
        state = create_train_state(cfg, tx, seed=SEED, device=dev, state_dict=sd, mesh=m, fsdp=fsdp)
        step = make_train_step(cfg, diffusion, tx, stats_mean=ds.stats["mean"], stats_std=ds.stats["std"], mesh=m,
                               fsdp=fsdp)
        return state, step

    def rows(batch, on_mesh):
        if not on_mesh:
            return batch
        n = next(iter(batch.values())).shape[0] // mesh.n_data
        return {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in batch.items()}

    def timed(state, step, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in metrics.items()}, 1e3 * (time.perf_counter() - t0)

    def collective_ms(fn, runs=3, warm=True):
        """Host ms of one collective call (after a warm-up call), to a
        synchronise."""
        if warm:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / runs

    # 1. DiT-S/2 at the global batch TRAIN_BATCH: the one-card steps on rank
    # 0 (float32 plain, then the bf16 kernel path), then the same on the mesh
    cfg = build_config(MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16",
                       block_kernel="mega_attn", attn_bwd="pallas")
    f32 = cfg.replace(compute_dtype="float32", block_kernel="off")
    init = init_model(cfg, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    sd0 = init.state_dict()
    del init
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(ds.batches(TRAIN_BATCH, seed=SEED)).items()}
    steps = {}
    for name, c, on_mesh in (("one/f32", f32, False), ("one", cfg, False), ("dp/f32", f32, True), ("dp", cfg, True)):
        if not on_mesh and rank != 0:
            continue
        state, step = make(c, sd0, on_mesh)
        reset_launch_counts()
        metrics, ms = timed(state, step, rows(batch, on_mesh))
        counts = launch_counts()
        check_counts(f"dp-train/s2/{name}/rank{rank}", counts,
                     {} if c is f32 else mega_attn_expect(ab, cfg.depth, 1, remat=False))
        steps[name] = {"metrics": metrics, "ms": ms, "counts": counts,
                       "grads": {k: p.grad.detach().float().cpu() for k, p in state.params.items()},
                       "params": {k: p.detach().cpu() for k, p in state.params.items()}}
        if name != "dp":
            del state, step
            torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        one, dp = steps["one/f32"], steps["dp/f32"]
        err = {"metrics": max(abs(dp["metrics"][k] - v) / abs(v) for k, v in one["metrics"].items()),
               "grads": 0.0, "params": 0.0}
        for k, g in one["grads"].items():
            scale = float(g.abs().max()) + 1e-12
            err["grads"] = max(err["grads"], float((dp["grads"][k] - g).abs().max()) / scale)
            settled = g.abs() > DP_GRAD_ATOL * scale + 1e-7
            if bool(settled.any()):
                err["params"] = max(err["params"], float((dp["params"][k] - one["params"][k])[settled].abs().max()))
        report["s2_f32_vs_one_card"] = err
        if err["metrics"] > DP_METRIC_RTOL or err["grads"] > DP_GRAD_ATOL or err["params"] > DP_PARAM_ATOL:
            raise AssertionError(f"dp-train/s2: the 2-rank float32 step leaves the one-card step: {err}")

        def flat(side):
            return (torch.tensor([steps[side]["metrics"]["loss"]]),
                    torch.cat([g.reshape(-1) for g in steps[side]["grads"].values()]))

        (loss_f32, grads_f32), (loss_one, grads_one), (loss_dp, grads_dp) = flat("one/f32"), flat("one"), flat("dp")
        limit = {"loss": max(2 * rel_l2(loss_one, loss_f32), 1e-2), "grads": max(2 * rel_l2(grads_one, grads_f32), 1e-2)}
        got = {"loss": rel_l2(loss_dp, loss_f32), "grads": rel_l2(grads_dp, grads_f32)}
        report["s2_kernels_vs_f32"] = {"dp": got, "one_card": {"loss": rel_l2(loss_one, loss_f32),
                                                               "grads": rel_l2(grads_one, grads_f32)}, "limit": limit}
        if any(got[k] > limit[k] for k in got):
            raise AssertionError(f"dp-train/s2: the 2-rank kernel step {got} off the float32 step beyond {limit}")
        report["s2_one_card_ms"] = steps["one"]["ms"]
        if steps["one"]["counts"] != steps["dp"]["counts"]:
            raise AssertionError(f"dp-train/s2: launches a step {steps['dp']['counts']} against the one-card "
                                 f"{steps['one']['counts']}")
    dp = steps.pop("dp")
    report["s2_first"] = {"metrics": dp["metrics"], "ms": dp["ms"]}
    counts = dict(dp["counts"])
    del steps, dp
    ms = []
    for _ in range(DP_TRAIN_STEPS - 1):
        reset_launch_counts()
        metrics, t = timed(state, step, rows(batch, True))
        ms.append(t)
        after = launch_counts()
        counts = {k: v + after[k] for k, v in counts.items()}
    report["s2_ms"], report["s2_last_loss"], report["s2_counts"] = ms, metrics["loss"], counts
    tree = {**state.params, "generator": state.generator.get_state()}
    for key, ema in state.ema.items():
        tree.update({f"ema{key}.{k}": v for k, v in ema.items()})
    check_replicated(tree, dev)
    grads = [p.grad for p in state.params.values()]
    report["s2_all_reduce_ms"] = collective_ms(lambda: mean_all_reduce_(grads, mesh.data_group))
    report["s2_grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    del state, step, grads, tree, batch, sd0
    torch.cuda.empty_cache()

    # 2. DiT-XL/2 at DP_XL_BATCH global rows, DP then FSDP
    xl = xl_config().replace(block_kernel="mega_attn", attn_bwd="pallas")
    sd_xl = xl_state_dict(torch, xl.replace(block_kernel="off"), dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(ds.batches(DP_XL_BATCH, seed=SEED)).items()}
    report["xl"] = {}
    for name, fsdp in (("dp", False), ("fsdp", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state, step = make(xl, sd_xl, True, fsdp)
        runs = [timed(state, step, rows(batch, True)) for _ in range(DP_TRAIN_STEPS)]
        opt_bytes = sum(t.numel() * t.element_size() for st in state.optimizer.state.values() for t in st.values()
                        if torch.is_tensor(t) and t.is_cuda)
        held_bytes = sum(t.numel() * t.element_size() for t in state.held.values())
        ema_bytes = sum(t.numel() * t.element_size() for ema in state.ema.values() for t in ema.values())
        row = {"ms": [t for _, t in runs], "loss": [m["loss"] for m, _ in runs],
               "grad_norm": [m["grad_norm"] for m, _ in runs], "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "resident_bytes": held_bytes + opt_bytes + ema_bytes}
        if fsdp:
            dp_ = state.dp
            row["sharded_tensors"], row["replicated_tensors"] = len(dp_.sharded), len(dp_.replicated)
            # one call each: the steps warmed them up, and each takes seconds through host memory
            row["all_gather_ms"] = collective_ms(dp_.gather_params, runs=1, warm=False)
            stage = dp_.flat.new_zeros(dp_.n * dp_.shard_numel)
            row["reduce_scatter_ms"] = collective_ms(
                lambda: dist.reduce_scatter_tensor(dp_.grad_flat, stage, group=mesh.data_group), runs=1, warm=False)
            row["gathered_bytes"] = stage.numel() * stage.element_size()
            del stage, dp_
        else:
            grads = [p.grad for p in state.params.values()]
            row["all_reduce_ms"] = collective_ms(lambda: mean_all_reduce_(grads, mesh.data_group), runs=1, warm=False)
            row["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
            del grads
        report["xl"][name] = row
        del state, step
    dp_row, fsdp_row = report["xl"]["dp"], report["xl"]["fsdp"]
    for key in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(fsdp_row[key], dp_row[key])):
            tol = DP_METRIC_RTOL if i == 0 else DP_LATER_RTOL
            if not math.isfinite(a) or abs(a - b) > tol * abs(b):
                raise AssertionError(f"dp-train/xl: FSDP {key} at step {i + 1} {a} against DP's {b} (rtol {tol})")
    del sd_xl, batch
    torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def dp_train_phase(torch, dev, tmp: str) -> dict:
    """Phase 10b: data-parallel and fully-sharded training on two ranks
    sharing the card (see dp_train_rank), then the train CLI under torchrun
    at S/2 with --fsdp true --checkpointer torch-sharded, resumed on one
    process in process and sampled from its EMA snapshot. Returns rank 0's
    launch counts of its S/2 DP steps."""
    from mapdit_tpu_torch import sample, train
    from mapdit_tpu_torch.models import build_config
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab
    from mapdit_tpu_torch.parallel import spawn

    card = smi_line()
    with tempfile.TemporaryDirectory(prefix="mapdit_smoke_dp_") as out:
        t0 = time.perf_counter()
        spawn(dp_train_rank, 2, args=(out,))
        seconds = time.perf_counter() - t0
        reports = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    err, kern = reports[0]["s2_f32_vs_one_card"], reports[0]["s2_kernels_vs_f32"]
    phase("dp-train", model=MODEL, mesh="(2,1)", batch=TRAIN_BATCH, path="f32 plain", vs="one card",
          metrics_rel_err=f"{err['metrics']:.3e}", grads_err_scaled=f"{err['grads']:.3e}",
          params_err_settled=f"{err['params']:.3e}",
          tol=f"metrics rtol {DP_METRIC_RTOL:g}, grads {DP_GRAD_ATOL:g} of max, params {DP_PARAM_ATOL:g}")
    phase("dp-train", model=MODEL, mesh="(2,1)", batch=TRAIN_BATCH, path="mega_attn+pallas", vs="f32 one card",
          rel_l2_loss=f"{kern['dp']['loss']:.3e}", rel_l2_grads=f"{kern['dp']['grads']:.3e}",
          one_card_rel_l2_loss=f"{kern['one_card']['loss']:.3e}",
          one_card_rel_l2_grads=f"{kern['one_card']['grads']:.3e}",
          tol=json.dumps({k: float(f"{v:.3e}") for k, v in kern["limit"].items()}),
          launches_a_step_equal_one_card=True, one_card_ms=f"{reports[0]['s2_one_card_ms']:.4f}", card=json.dumps(card))
    for r, rep in enumerate(reports):
        phase("dp-train", rank=r, model=MODEL, backend=rep["backend"], rows_a_rank=TRAIN_BATCH // 2,
              first_ms=f"{rep['s2_first']['ms']:.4f}", ms_per_step=json.dumps([round(v, 4) for v in rep["s2_ms"]]),
              loss=f"{rep['s2_last_loss']:.6f}", replicas_identical=True,
              all_reduce_ms=f"{rep['s2_all_reduce_ms']:.4f}", all_reduce_bytes=rep["s2_grad_bytes"],
              launches=json.dumps({k: v for k, v in rep["s2_counts"].items() if v}), card=json.dumps(card))
        for name, row in rep["xl"].items():
            coll = {k: (f"{v:.4f}" if k.endswith("_ms") else v) for k, v in row.items()
                    if k.endswith("_ms") or k.endswith("_bytes") and k not in ("peak_bytes", "resident_bytes")
                    or k.endswith("_tensors")}
            phase("dp-train", rank=r, model=XL_MODEL, layout=name, batch=DP_XL_BATCH, rows_a_rank=DP_XL_BATCH // 2,
                  ms_per_step=json.dumps([round(v, 4) for v in row["ms"]]),
                  loss=json.dumps([round(v, 6) for v in row["loss"]]),
                  grad_norm=json.dumps([round(v, 6) for v in row["grad_norm"]]),
                  max_memory_allocated_gb=f"{row['peak_bytes'] / 1e9:.3f}",
                  resident_state_gb=f"{row['resident_bytes'] / 1e9:.3f}",
                  predicted_resident_gb=DP_XL_RESIDENT_GB[name], **coll, card=json.dumps(card))
    phase("dp-train", check="xl fsdp loss and grad_norm vs dp", step1_rtol=DP_METRIC_RTOL,
          later_rtol=DP_LATER_RTOL, ok=True, seconds_with_spawn=f"{seconds:.2f}")

    # the CLI under torchrun, every rank on the one card
    repo = os.path.dirname(os.path.abspath(__file__))
    results = os.path.join(tmp, "dp_cli")
    flags = ["--model", MODEL, "--data-path", "synthetic:1024", "--results-dir", results, "--batch-size",
             str(TRAIN_BATCH), "--compute-dtype", "bfloat16", "--block-kernel", "mega_attn", "--attn-bwd", "pallas",
             "--num-classes", "1000", "--log-every", "1", "--metrics-jsonl", "auto", "--num-lin-warmup", "4",
             "--start-decay", "10", "--ckpt-every", str(DP_CLI_CKPT), "--ema-snapshot-every", str(DP_CLI_CKPT)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                           "-m", "mapdit_tpu_torch.train", *flags, "--num-steps", str(DP_CLI_STEPS), "--fsdp", "true",
                           "--checkpointer", "torch-sharded"],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dp-cli: torchrun exited {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    (exp,) = [os.path.join(results, d) for d in os.listdir(results)]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    shards = os.path.join(exp, "checkpoints", f"{DP_CLI_CKPT:07d}.shards")
    files = sorted(os.listdir(shards))
    snaps = sorted(os.listdir(os.path.join(exp, "ema")))
    log = open(os.path.join(exp, "log.txt")).read()
    rate = (rows[-1]["step"] - rows[1]["step"]) / (rows[-1]["wall_time"] - rows[1]["wall_time"])
    phase("dp-cli", run="torchrun", ranks=2, fsdp=True, checkpointer="torch-sharded", steps=DP_CLI_STEPS,
          seconds=f"{seconds:.2f}", steps_per_s=f"{rate:.3f}", losses=json.dumps([r["loss"] for r in rows]),
          shards=json.dumps(files), ema=json.dumps(snaps), card=json.dumps(card))
    if ("devices: 2x" not in log or files != ["index.pt", "rank00000.pt", "rank00001.pt"] or len(rows) != DP_CLI_STEPS
            or not all(math.isfinite(r["loss"]) for r in rows)
            or snaps != [f"{std}_{DP_CLI_CKPT:07d}.npz" for std in ("0.050", "0.100")]):
        raise AssertionError(f"dp-cli: artifacts of {exp}: shards {files}, ema {snaps}, rows {len(rows)}")

    torch.cuda.synchronize()
    reset_launch_counts()
    exp_b = train.main(train.build_parser().parse_args(
        [*flags, "--num-steps", str(DP_CLI_RESUMED), "--resume", shards]))
    torch.cuda.synchronize()
    counts = launch_counts()
    with open(os.path.join(exp_b, "metrics.jsonl")) as f:
        rows_b = [json.loads(line) for line in f]
    resumed = f"resumed from {shards} at step {DP_CLI_CKPT}" in open(os.path.join(exp_b, "log.txt")).read()
    depth = build_config(MODEL).depth
    check_counts("dp-cli/resume", counts, mega_attn_expect(ab, depth, DP_CLI_RESUMED - DP_CLI_CKPT, remat=False))
    phase("dp-cli", run="resume on one process", resumed_from_shards=resumed, steps=json.dumps([r["step"] for r in rows_b]),
          losses=json.dumps([r["loss"] for r in rows_b]))
    if not resumed or [r["step"] for r in rows_b] != list(range(DP_CLI_CKPT + 1, DP_CLI_RESUMED + 1)) or not all(
            math.isfinite(r["loss"]) for r in rows_b):
        raise AssertionError(f"dp-cli: the one-process resume of {shards}: {rows_b}")

    png = os.path.join(tmp, "dp_cli_sample.png")
    reset_launch_counts()
    sample.main(sample.build_parser().parse_args(
        ["--result-dir", exp, "--use-vae", "false", "--class-label", "3", "--sampler", "ddim", "--num-sampling-steps",
         "10", "--clip-denoised", "true", "--block-kernel", "auto", "--output-file", png]))
    torch.cuda.synchronize()
    shape = png_check(png)
    check_counts("dp-cli/sample", launch_counts(), {"fused_dit_stack": 10, "dit_stack": 10})
    phase("dp-cli", run="sample from the EMA snapshot", png=json.dumps(shape), snapshot=json.dumps(snaps))
    return reports[0]["s2_counts"]


def tp_train_rank(rank, dev, out_dir):
    """One rank of phase 10d (started by mapdit_tpu_torch.parallel.spawn) on
    the (1, 2) mesh: DiT-XL/2 at TP_TRAIN_ROWS rows, rank 0's one-card steps
    first (float32 plain, then bf16 with fused_attention), then the same two
    on the mesh. Writes its report to ``out_dir``; any failure raises, and
    then spawn raises in the parent."""
    import torch
    import torch.distributed as dist

    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.ops.cuda import attention
    from mapdit_tpu_torch.parallel import make_mesh
    from mapdit_tpu_torch.parallel.mesh import check_replicated
    from mapdit_tpu_torch.training import (
        SyntheticLatentDataset, create_optimizer, create_train_state, make_train_step, warmup_flat_invsqrt,
    )

    t_rank = time.perf_counter()
    mesh = make_mesh(1, 2, device=dev)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    diffusion = create_diffusion("", device=dev)
    ds = SyntheticLatentDataset(num_examples=1024, num_classes=1000, size=16, seed=SEED)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(ds.batches(TP_TRAIN_ROWS, seed=SEED)).items()}
    xl = xl_config()
    paths = {"f32": xl.replace(compute_dtype="float32", block_kernel="off"),
             "bf16+pallas": xl.replace(block_kernel="auto", attention_impl="pallas")}
    sd = xl_state_dict(torch, paths["f32"], dev)
    report = {"backend": dist.get_backend(mesh.model_group)}
    sizes = []  # the bytes of each all-reduce, while counted
    real_all_reduce = dist.all_reduce

    def counted_all_reduce(tensor, *args, **kwargs):
        sizes.append(tensor.numel() * tensor.element_size())
        return real_all_reduce(tensor, *args, **kwargs)

    def timed(state, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in metrics.items()}, 1e3 * (time.perf_counter() - t0)

    def run(name, on_mesh):
        """TP_TRAIN_STEPS steps; the first one's metrics, whole gradients and
        parameters (gathered over the mesh), launches and all-reduces a
        step."""
        m = mesh if on_mesh else None
        cfg = paths[name]
        state = create_train_state(cfg, tx, seed=SEED, device=dev, state_dict=sd, mesh=m)
        step = make_train_step(cfg, diffusion, tx, stats_mean=ds.stats["mean"], stats_std=ds.stats["std"], mesh=m)
        out = {"ms": [], "launches": []}
        for i in range(TP_TRAIN_STEPS):
            reset_launch_counts()
            sizes.clear()
            metrics, ms = timed(state, step)
            out["ms"].append(ms)
            out["launches"].append(dict(launch_counts()))
            if i == 0:
                held = {k: t.grad for k, t in state.held.items()}
                out["metrics"] = metrics
                out["grads"] = held if not on_mesh else state.dp.gather(held)
                if name == "f32":  # the parameters after step 1, held against the one-card step
                    params = dict(state.params) if not on_mesh else state.dp.gather_model(state.params)
                    out["params"] = {k: v.detach().clone() for k, v in params.items()}
            out["all_reduces"] = list(sizes)
        if on_mesh:
            dp = state.dp
            opt = sum(t.numel() * t.element_size() for st in state.optimizer.state.values() for t in st.values()
                      if torch.is_tensor(t) and t.is_cuda)
            held = sum(t.numel() * t.element_size() for t in dp.held.values())
            ema = sum(t.numel() * t.element_size() for e in state.ema.values() for t in e.values())
            out["resident_bytes"], out["held_params"] = held + opt + ema, sum(t.numel() for t in dp.held.values())
            split = set(dp.tp_split)
            tree = {k: v.detach() for k, v in state.params.items() if k not in split}
            tree["generator"] = state.generator.get_state()
            check_replicated(tree, dev)  # the model group holds the same replicated tensors and draws
        del state, step
        torch.cuda.empty_cache()
        return out

    dist.all_reduce = counted_all_reduce
    try:
        one = {}
        if rank == 0:
            for name in paths:
                one[name] = run(name, False)
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        tp = {name: run(name, True) for name in paths}
    finally:
        dist.all_reduce = real_all_reduce
    report["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    report["tp"] = {name: {k: v for k, v in r.items() if k not in ("grads", "params")} for name, r in tp.items()}
    want_launches = {"fused_attention": xl.depth}
    for i, counts in enumerate(tp["bf16+pallas"]["launches"]):
        check_counts(f"tp-train/bf16+pallas/rank{rank}/step{i + 1}", counts, want_launches)
    for i, counts in enumerate(tp["f32"]["launches"]):
        check_counts(f"tp-train/f32/rank{rank}/step{i + 1}", counts, {})
    if rank == 0:
        a, b = tp["f32"], one["f32"]
        err = {"metrics": max(abs(a["metrics"][k] - v) / abs(v) for k, v in b["metrics"].items()),
               "params_settled": 0.0, "params_lr": 0.0, "settled_share": 0.0}
        lr0 = tx.lr_schedule(0)
        settled_n = total_n = 0
        for k, g in b["grads"].items():
            settled = g.abs() > DP_GRAD_ATOL * float(g.abs().max()) + 1e-7
            diff = (a["params"][k] - b["params"][k]).abs()
            over = diff > TP_PARAM_ATOL + TP_PARAM_RTOL * b["params"][k].abs()
            if bool((over & settled).any()):
                raise AssertionError(f"tp-train/f32: {k} after step 1 off the one-card step at rtol {TP_PARAM_RTOL} / "
                                     f"atol {TP_PARAM_ATOL}: max abs err {float(diff[settled].max())}")
            if bool(settled.any()):
                err["params_settled"] = max(err["params_settled"], float(diff[settled].max()))
            err["params_lr"] = max(err["params_lr"], float(diff.max()) / lr0)
            settled_n, total_n = settled_n + int(settled.sum()), total_n + g.numel()
        err["settled_share"] = settled_n / total_n
        report["f32_vs_one_card"] = err
        if err["metrics"] > TP_METRIC_RTOL or err["params_lr"] > TP_LR_BOUND:
            raise AssertionError(f"tp-train/f32: the 2-rank float32 step leaves the one-card step: {err}")

        def flat(r):
            return torch.tensor([r["metrics"]["loss"]]), torch.cat([g.reshape(-1) for g in r["grads"].values()])

        (loss_f32, grads_f32), (loss_one, grads_one) = flat(one["f32"]), flat(one["bf16+pallas"])
        loss_tp, grads_tp = flat(tp["bf16+pallas"])
        limit = {"loss": max(2 * rel_l2(loss_one, loss_f32), 1e-2), "grads": max(2 * rel_l2(grads_one, grads_f32), 1e-2)}
        got = {"loss": rel_l2(loss_tp, loss_f32), "grads": rel_l2(grads_tp, grads_f32)}
        report["bf16_vs_f32"] = {"tp": got, "one_card": {"loss": rel_l2(loss_one, loss_f32),
                                                        "grads": rel_l2(grads_one, grads_f32)}, "limit": limit}
        if any(got[k] > limit[k] for k in got):
            raise AssertionError(f"tp-train/bf16+pallas: the 2-rank step {got} off the float32 step beyond {limit}")
        report["one_card"] = {name: {"ms": r["ms"], "loss": r["metrics"]["loss"],
                                     "grad_norm": r["metrics"]["grad_norm"]} for name, r in one.items()}
    report["seconds"] = time.perf_counter() - t_rank
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def tp_train_phase(torch, dev, tmp: str) -> dict:
    """Phase 10d: tensor-parallel training on two ranks sharing the card
    (see tp_train_rank), then the train CLI under torchrun on four ranks
    (--n-model 2 --fsdp true --checkpointer torch-sharded) at S/2 with
    attention_impl pallas, a checkpoint mid-run, resumed on one process in
    process. Returns the launch counts of the one-process resume."""
    from mapdit_tpu_torch import train
    from mapdit_tpu_torch.models import build_config
    from mapdit_tpu_torch.parallel import spawn

    card = smi_line()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mapdit_smoke_tp_train_") as out:
        t0 = time.perf_counter()
        spawn(tp_train_rank, 2, args=(out,))
        seconds = time.perf_counter() - t0
        reports = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    lead = reports[0]
    err, kern = lead["f32_vs_one_card"], lead["bf16_vs_f32"]
    phase("tp-train", model=XL_MODEL, mesh="(1,2)", rows=TP_TRAIN_ROWS, path="f32 plain", vs="one card f32",
          metrics_rel_err=f"{err['metrics']:.3e}", params_settled_max_abs_err=f"{err['params_settled']:.3e}",
          params_max_err_in_lr=f"{err['params_lr']:.3e}", settled_share=f"{err['settled_share']:.6f}",
          tol=f"metrics rtol {TP_METRIC_RTOL:g}, params rtol {TP_PARAM_RTOL:g} atol {TP_PARAM_ATOL:g} settled, "
              f"{TP_LR_BOUND:g} lr everywhere", card=json.dumps(card))
    phase("tp-train", model=XL_MODEL, mesh="(1,2)", rows=TP_TRAIN_ROWS, path="bf16+pallas (fused_attention)",
          vs="one card f32", rel_l2_loss=f"{kern['tp']['loss']:.3e}", rel_l2_grads=f"{kern['tp']['grads']:.3e}",
          one_card_rel_l2_loss=f"{kern['one_card']['loss']:.3e}",
          one_card_rel_l2_grads=f"{kern['one_card']['grads']:.3e}",
          tol=json.dumps({k: float(f"{v:.3e}") for k, v in kern["limit"].items()}), card=json.dumps(card))
    for name, row in lead["one_card"].items():
        phase("tp-train", model=XL_MODEL, layout="one card", path=name, rows=TP_TRAIN_ROWS,
              ms_per_step=json.dumps([round(v, 4) for v in row["ms"]]), loss=f"{row['loss']:.6f}",
              grad_norm=f"{row['grad_norm']:.6f}", card=json.dumps(card))
    for r, rep in enumerate(reports):
        for name, row in rep["tp"].items():
            large = [b for b in row["all_reduces"] if b >= TP_LARGE_ALL_REDUCE_BYTES]
            phase("tp-train", rank=r, model=XL_MODEL, mesh="(1,2)", backend=rep["backend"], path=name,
                  rows=TP_TRAIN_ROWS, ms_per_step=json.dumps([round(v, 4) for v in row["ms"]]),
                  loss=f"{row['metrics']['loss']:.6f}", grad_norm=f"{row['metrics']['grad_norm']:.6f}",
                  all_reduces_a_step=len(row["all_reduces"]), activation_all_reduces_a_step=len(large),
                  activation_all_reduce_bytes=json.dumps(sorted(set(large))),
                  other_all_reduce_bytes=sum(row["all_reduces"]) - sum(large),
                  fused_attention_a_step=json.dumps([c["fused_attention"] for c in row["launches"]]),
                  resident_state_gb=f"{row['resident_bytes'] / 1e9:.3f}", held_params=row["held_params"],
                  predicted_resident_gb=TP_XL_RESIDENT_GB, card=json.dumps(card))
        phase("tp-train", rank=r, max_memory_allocated_gb=f"{rep['peak_bytes'] / 1e9:.3f}",
              rank_seconds=f"{rep['seconds']:.2f}", replicas_identical=True)
    phase("tp-train", check="f32 vs one card, bf16+pallas vs f32, launches, replicas", ok=True,
          seconds_with_spawn=f"{seconds:.2f}")

    # the CLI under torchrun: four ranks on the one card, a (2, 2) mesh
    repo = os.path.dirname(os.path.abspath(__file__))
    results = os.path.join(tmp, "tp_cli")
    flags = ["--model", MODEL, "--data-path", "synthetic:1024", "--results-dir", results, "--batch-size",
             str(TP_CLI_BATCH), "--compute-dtype", "bfloat16", "--attention-impl", "pallas", "--num-classes", "1000",
             "--log-every", "1", "--metrics-jsonl", "auto", "--num-lin-warmup", "4", "--start-decay", "10",
             "--ckpt-every", str(DP_CLI_CKPT), "--ema-snapshot-every", str(DP_CLI_CKPT)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                           "-m", "mapdit_tpu_torch.train", *flags, "--num-steps", str(DP_CLI_STEPS), "--n-model", "2",
                           "--fsdp", "true", "--checkpointer", "torch-sharded"],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"tp-cli: torchrun exited {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    (exp,) = [os.path.join(results, d) for d in os.listdir(results)]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    shards = os.path.join(exp, "checkpoints", f"{DP_CLI_CKPT:07d}.shards")
    files = sorted(os.listdir(shards))
    snaps = sorted(os.listdir(os.path.join(exp, "ema")))
    log = open(os.path.join(exp, "log.txt")).read()
    rate = (rows[-1]["step"] - rows[1]["step"]) / (rows[-1]["wall_time"] - rows[1]["wall_time"])
    phase("tp-cli", run="torchrun", ranks=4, mesh="(2,2)", fsdp=True, checkpointer="torch-sharded", steps=DP_CLI_STEPS,
          batch=TP_CLI_BATCH, seconds=f"{seconds:.2f}", steps_per_s=f"{rate:.3f}",
          losses=json.dumps([r["loss"] for r in rows]), shards=json.dumps(files), ema=json.dumps(snaps),
          card=json.dumps(card))
    if ("devices: 4x" not in log or "mesh data=2 model=2" not in log or len(rows) != DP_CLI_STEPS
            or files != ["index.pt", "rank00000.pt", "rank00001.pt"] or not all(math.isfinite(r["loss"]) for r in rows)
            or snaps != [f"{std}_{DP_CLI_CKPT:07d}.npz" for std in ("0.050", "0.100")]):
        raise AssertionError(f"tp-cli: artifacts of {exp}: shards {files}, ema {snaps}, rows {len(rows)}")

    torch.cuda.synchronize()
    reset_launch_counts()
    exp_b = train.main(train.build_parser().parse_args(
        [*flags, "--num-steps", str(DP_CLI_RESUMED), "--resume", shards]))
    torch.cuda.synchronize()
    counts = launch_counts()
    with open(os.path.join(exp_b, "metrics.jsonl")) as f:
        rows_b = [json.loads(line) for line in f]
    resumed = f"resumed from {shards} at step {DP_CLI_CKPT}" in open(os.path.join(exp_b, "log.txt")).read()
    depth = build_config(MODEL).depth
    check_counts("tp-cli/resume", counts, {"fused_attention": depth * (DP_CLI_RESUMED - DP_CLI_CKPT)})
    phase("tp-cli", run="resume on one process", resumed_from_shards=resumed,
          steps=json.dumps([r["step"] for r in rows_b]), losses=json.dumps([r["loss"] for r in rows_b]),
          launches=json.dumps({k: v for k, v in counts.items() if v}))
    if not resumed or [r["step"] for r in rows_b] != list(range(DP_CLI_CKPT + 1, DP_CLI_RESUMED + 1)) or not all(
            math.isfinite(r["loss"]) for r in rows_b):
        raise AssertionError(f"tp-cli: the one-process resume of {shards}: {rows_b}")
    phase("tp-train", phase_seconds=f"{time.perf_counter() - t_phase:.2f}")
    return counts


def mesh_serve_expect(key, depth: int, layout: str) -> dict:
    """The launches one rank makes for one batch of program ``key`` (the
    server's program key) on phase 10c's servers: one dit_stack launch a
    model call for an exact chain on the data axis or on every rank, one a
    computed block for a cached chain (blocks [depth/4, 3 depth/4) skipped
    on every other step), and the TP island's two partial launches a block
    and a model call on a model axis (one of each dit_block_tp kernel)."""
    sampler, steps, cache_interval = key[0], key[1], key[5]
    if cache_interval > 1:
        lo, hi = depth // 4, depth - depth // 4
        blocks = (steps // cache_interval) * depth + (steps - steps // cache_interval) * (depth - (hi - lo))
        return {"fused_dit_block": blocks, "dit_stack": blocks}
    if layout == "mega_tp":
        per = steps * depth
        return {"block_tp_attn": per, "mlp_tp_partial": per, "dit_block_tp/attn": per, "dit_block_tp/mlp": per}
    return {"fused_dit_stack": steps, "dit_stack": steps}


def mesh_serve_rank(rank, dev, refs, out_dir):
    """One rank of phase 10c (started by mapdit_tpu_torch.parallel.spawn):
    the server of ``mapdit_tpu_torch.serve`` as one service over the two
    ranks, built by the entry point's own build_service / build_server (rank
    0 serves HTTP on an ephemeral port and samples in process, rank 1
    follows), first (2, 1) on phase 8c's copy of run A, then (1, 2) on the
    DiT-XL/2 experiment; each batch's launches recorded on both ranks around
    the service's batch execution. Then build_sample_fn(mesh=) on (1, 2) at
    DiT-B/2 rotation_scale, the plain path. Writes its report to
    ``out_dir``; any failure raises, and then spawn raises in the parent."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    import torch.distributed as dist

    from mapdit_tpu_torch import serve
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.parallel import make_mesh
    from mapdit_tpu_torch.runtime import build_sample_fn

    report = {"batches": {}, "checks": {}, "loads": {}}
    scale = 2.0**SERVE_STATS_EXP

    def record(service, log):
        """Wrap the service's batch execution (the whole of a batch's
        device work on every rank) to log each batch's launches."""
        execute = service._execute

        def logged(fn_key, *rest):
            out = execute(fn_key, *rest)
            torch.cuda.synchronize()
            log.append([list(fn_key[:6]), launch_counts()])
            reset_launch_counts()
            return out

        service._execute = logged

    def post(base, payload):
        req = urllib.request.Request(base + "/v1/sample", data=json.dumps(payload).encode())
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def info(base):
        with urllib.request.urlopen(base + "/info", timeout=60) as resp:
            return json.loads(resp.read())

    def served(tag, flags, body):
        """The service of ``flags`` on both ranks; ``body(service, base)``
        on the lead while HTTP serves from a thread."""
        args = serve.build_parser().parse_args(
            ["--port", "0", "--seed", str(SERVE_SEED), "--block-kernel", "auto", "--device", str(dev),
             "--shard", "true", *flags])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        service = serve.build_service(args)
        log = report["batches"].setdefault(tag, [])
        reset_launch_counts()
        record(service, log)
        if not service.lead:
            service.follow()
            return
        server, service = serve.build_server(args, service)  # warms the default protocol at the largest bucket
        report["checks"][f"{tag}:startup_s"] = time.perf_counter() - t0
        server.RequestHandlerClass.log_message = lambda self, fmt, *a: None
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            body(service, f"http://127.0.0.1:{server.server_address[1]}")
        finally:
            server.shutdown()
            server.server_close()
            service.close()

    def held(tag, got, ref):
        """check_paths' rule on served floats (latents times 2**-24)."""
        got = torch.from_numpy(np.asarray(got)) * scale
        err, limit = rel_l2(got, ref["f32"]), max(2 * rel_l2(ref["off"], ref["f32"]), 1e-2)
        ok = bool(torch.isfinite(got).all()) and err <= limit
        report["checks"][tag] = dict(rel_l2_err_vs_f32=err, tol=limit, ok=ok)
        if not ok:
            raise AssertionError(f"serve-mesh: {tag} off the f32 plain chain (rel L2 {err} > {limit})")

    def load(base, clients):
        latencies, errors, lock = [], [], threading.Lock()

        def client(i):
            for r in range(SERVE_REQUESTS):
                t0 = time.perf_counter()
                status, body = post(base, {"class_label": (37 * i) % 1000, "seed": 1000 * i + r})
                with lock:
                    latencies.append(time.perf_counter() - t0)
                    if status != 200 or body[:8] != b"\x89PNG\r\n\x1a\n":
                        errors.append(status)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        seconds = time.perf_counter() - t0
        lat = np.asarray(latencies) * 1e3
        if errors or len(latencies) != clients * SERVE_REQUESTS:
            raise AssertionError(f"serve-mesh: load of {clients} clients: {errors[:3]}")
        return dict(requests=clients * SERVE_REQUESTS, seconds=seconds, requests_per_s=len(lat) / seconds,
                    p50_ms=float(np.percentile(lat, 50)), p95_ms=float(np.percentile(lat, 95)))

    def data_parallel(service, base):
        i = info(base)
        report["checks"]["dp:info"] = dict(devices=i["devices"], mesh=i["mesh"])
        if i["devices"] != 2 or i["mesh"] != {"data": 2, "model": 1}:
            raise AssertionError(f"serve-mesh: /info {i['devices']} {i['mesh']}")
        labels = refs["s2_labels"]
        # the default protocol at bucket 4 (each rank the one-device chain on
        # two rows) and at bucket 1 (the whole batch on both ranks)
        held("dp:default-b4", service.sample(labels, seed=MESH_SERVE_SEED, **SERVE_DEFAULTS), refs["s2_b4"])
        held("dp:default-b1", service.sample(labels[:1], seed=MESH_SERVE_SEED, **SERVE_DEFAULTS), refs["s2_b1"])
        status, body = post(base, {"class_labels": labels, "seed": MESH_SERVE_SEED + 1, "steps": 20,
                                   "sampler": "dpm++", "format": "npz"})
        if status != 200:
            raise AssertionError(f"serve-mesh: dpm++ 20 over HTTP: {status} {body[:200]!r}")
        cached = service.sample(labels, seed=MESH_SERVE_SEED, steps=2, sampler="ddpm", cfg_scale=4.0,
                                cache_interval=2)
        report["checks"]["dp:cached-ddpm-2"] = dict(finite=bool(np.isfinite(cached).all()), shape=list(cached.shape))
        if not np.isfinite(cached).all():
            raise AssertionError("serve-mesh: the cached ddpm 2 chain on the data axis is non-finite")
        for clients in MESH_SERVE_LOADS:
            report["loads"][f"dp:{clients}"] = load(base, clients)

    def tensor_parallel(service, base):
        i = info(base)
        report["checks"]["tp:info"] = dict(devices=i["devices"], mesh=i["mesh"],
                                           block_kernel=service._prepared["model"].cfg.block_kernel)
        if i["mesh"] != {"data": 1, "model": 2} or service._prepared["model"].cfg.block_kernel != "mega_tp":
            raise AssertionError(f"serve-mesh: TP server {report['checks']['tp:info']}")
        labels = refs["xl_labels"]
        held("tp:dpm++-20", service.sample(labels, seed=MESH_SERVE_SEED, **SERVE_DEFAULTS), refs["xl"])
        times = []
        for r in range(MESH_TP_TIMED):
            t0 = time.perf_counter()
            status, _ = post(base, {"class_labels": labels, "seed": MESH_SERVE_SEED + 2 + r})
            times.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"serve-mesh: TP request {status}")
        report["checks"]["tp:request_ms"] = times
        status, body = post(base, {"class_label": 1, "cache_interval": 2, "steps": 20})
        report["checks"]["tp:cached"] = dict(status=status, error=json.loads(body)["error"])
        if status != 400 or "tensor-parallel" not in json.loads(body)["error"]:
            raise AssertionError(f"serve-mesh: a cached request on the TP server gave {status}")

    served("dp", ["--result-dir", refs["s2_exp"], "--buckets", ",".join(map(str, MESH_SERVE_BUCKETS))],
           data_parallel)
    torch.cuda.empty_cache()
    served("tp", ["--result-dir", refs["xl_exp"], "--ckpt", "0000000", "--buckets", str(len(refs["xl_labels"])),
                  "--n-model", "2"], tensor_parallel)
    torch.cuda.empty_cache()

    # the plain path's tensor parallelism at DiT-B/2 rotation_scale (P2)
    mesh = make_mesh(1, 2, device=dev)
    cfg = refs["b2_cfg"]
    sd = b2_state_dict(torch, cfg, dev)
    z, y, tf = (refs["b2_in"][k].to(dev) for k in ("z", "y", "t"))
    fn = build_sample_fn(cfg, sd, create_diffusion("10", device=dev), cfg_scale=CFG_SCALE, clip_denoised=True,
                         mesh=mesh)
    model = fn.prepared["model"]
    if fn.run_cfg.block_kernel != "off" or model.blocks[0].attn.tp_group is None:
        raise AssertionError(f"plain-tp: resolved {fn.run_cfg.block_kernel}")
    counts = {}
    with torch.no_grad():
        for what, run in (("call", lambda: model.forward_with_cfg(z, tf, y, CFG_SCALE)),
                          ("chain-10", lambda: fn(z, y, torch.Generator(device=dev).manual_seed(SEED + 1)))):
            times = []
            for r in range(2):  # checked and counted, then timed warm
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                if r == 0:
                    counts[what] = launch_counts()
                    calls = 1 if what == "call" else 10
                    check_counts(f"plain-tp/{what}/rank{rank}", counts[what], {"fused_attention": cfg.depth * calls})
                    ref = refs["b2"][what]
                    err, limit = rel_l2(out.cpu(), ref["f32"]), max(2 * rel_l2(ref["off"], ref["f32"]), 1e-2)
                    report["checks"][f"plain-tp:{what}"] = dict(rel_l2_err_vs_f32=err, tol=limit)
                    if not bool(torch.isfinite(out).all()) or err > limit:
                        raise AssertionError(f"plain-tp/{what}: off the f32 plain path (rel L2 {err} > {limit})")
            report["checks"][f"plain-tp:{what}:ms"] = times
    report["plain_counts"] = counts
    report["backend"] = dist.get_backend()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def mesh_serve_refs(torch, dev, exp_s: str, tmp: str) -> dict:
    """Phase 10c's references on one device: the float32 and bf16 plain
    chains of the requests the servers are held on (the host preamble's z
    for MESH_SERVE_SEED), DiT-XL/2's experiment directory (phase 9's weights
    as a checkpoint, statistics as phase 8c's copy), and DiT-B/2
    rotation_scale's weights, inputs, model call and clipped chain."""
    from mapdit_tpu_torch import serve
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import DiT, build_config
    from mapdit_tpu_torch.runtime import build_sample_fn, fold_weights_for_inference
    from mapdit_tpu_torch.sample import load_variables, run_config
    from mapdit_tpu_torch.utils.experiment import load_config, save_config

    def chains(cfg, sd, labels):
        z = serve.draw(MESH_SERVE_SEED, (len(labels), 4, 16, 16), dev)
        y = torch.tensor(labels, device=dev)
        z, y = torch.cat([z, z]), torch.cat([y, torch.full_like(y, 1000)])
        d = create_diffusion("20", device=dev)
        out = {}
        for name, c in (("f32", cfg.replace(compute_dtype="float32", block_kernel="off")),
                        ("off", cfg.replace(block_kernel="off"))):
            fn = build_sample_fn(c, sd, d, cfg_scale=4.0, sampler="dpm++", device=dev)
            out[name] = fn(z, y)[: len(labels)].cpu()
        return out

    train_args = load_config(exp_s)
    s2_cfg = run_config(train_args, "auto")
    s2_sd = load_variables(exp_s, train_args)
    s2_labels = [(37 * i) % 1000 for i in range(MESH_SERVE_BUCKETS[-1])]
    refs = dict(s2_exp=exp_s, s2_labels=s2_labels, s2_b4=chains(s2_cfg, s2_sd, s2_labels),
                s2_b1=chains(s2_cfg, s2_sd, s2_labels[:1]))

    xl_cfg = xl_config()
    xl_sd = xl_state_dict(torch, xl_cfg, dev)
    xl_exp = os.path.join(tmp, "xl_serve")
    os.makedirs(os.path.join(xl_exp, "checkpoints"))
    torch.save({"model": {k: v.cpu() for k, v in xl_sd.items()}}, os.path.join(xl_exp, "checkpoints", "0000000.pt"))
    save_config(xl_exp, dict(train_args, model=XL_MODEL))
    xl_labels = [(37 * i) % 1000 for i in range(MESH_TP_BATCH)]
    refs.update(xl_exp=xl_exp, xl_labels=xl_labels, xl=chains(xl_cfg, xl_sd, xl_labels))
    del xl_sd
    torch.cuda.empty_cache()

    flags, kernels = FAMILIES["P2"]
    b2 = build_config(FAMILY_MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16",
                      **flags)
    sd_dev = b2_state_dict(torch, b2, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    n = 2 * MESH_TP_BATCH
    b2_in = dict(z=torch.randn(n, 4, 16, 16, generator=gen, device=dev),
                 y=torch.cat([torch.randint(0, 1000, (MESH_TP_BATCH,), generator=gen, device=dev),
                              torch.full((MESH_TP_BATCH,), 1000, device=dev)]),
                 t=torch.full((n,), 500.0, device=dev))
    # the references are the plain path on one device, without kernels
    b2_refs = {"call": {}, "chain-10": {}}
    for name, c in (("f32", b2.replace(compute_dtype="float32")), ("off", b2)):
        model = DiT(c.replace(fold_weights=True)).to(dev).eval()
        model.load_state_dict(fold_weights_for_inference(sd_dev, c.replace(fold_weights=True)))
        with torch.no_grad():
            b2_refs["call"][name] = model.forward_with_cfg(b2_in["z"], b2_in["t"], b2_in["y"], CFG_SCALE).cpu()
        fn = build_sample_fn(c, sd_dev, create_diffusion("10", device=dev), cfg_scale=CFG_SCALE, clip_denoised=True,
                             device=dev)
        b2_refs["chain-10"][name] = fn(b2_in["z"], b2_in["y"],
                                       torch.Generator(device=dev).manual_seed(SEED + 1)).cpu()
        del model, fn
    refs.update(b2_cfg=b2.replace(**kernels), b2_in={k: v.cpu() for k, v in b2_in.items()}, b2=b2_refs)
    return refs


def b2_state_dict(torch, cfg, dev) -> dict:
    """DiT-B/2's weights of phase 7 (init from SEED, gains drawn) on the
    card; the parent and each rank draw the same."""
    from mapdit_tpu_torch.models import init_model

    init = init_model(cfg, seed=SEED, device="cpu")
    draw_gains(torch, init, SEED)
    return {key: v.to(dev) for key, v in init.state_dict().items()}


def torchrun_children(pid: int) -> dict:
    """{RANK: pid} of the worker processes torchrun ``pid`` started (its
    children, read from /proc)."""
    ranks = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != pid:
                continue
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = dict(item.split(b"=", 1) for item in f.read().split(b"\0") if b"=" in item)
        except OSError:
            continue
        if b"RANK" in env:
            ranks[int(env[b"RANK"])] = int(entry)
    return ranks


def mesh_serve_cli(exp_s: str) -> dict:
    """The server's entry point under torchrun: two ranks on the card with
    --shard true, /info's mesh, one request, then SIGTERM to the lead
    worker alone: it stops accepting, broadcasts the stop, both workers and
    torchrun exit 0."""
    import signal
    import threading
    import urllib.request

    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", "-m",
         "mapdit_tpu_torch.serve", "--result-dir", exp_s, "--port", "0", "--shard", "true", "--buckets", "2",
         "--block-kernel", "auto", "--warmup", "false", "--default-steps", "2"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: [lines.append(x) for x in proc.stdout], daemon=True)
    reader.start()
    t0 = time.perf_counter()
    try:
        port = None
        while port is None and time.perf_counter() - t0 < 300:
            text = "".join(lines)
            if "listening on http://" in text:
                port = int(text.split("listening on http://")[1].split()[0].rsplit(":", 1)[1])
            elif proc.poll() is not None:
                raise AssertionError(f"serve-cli: torchrun exited {proc.returncode}:\n{text[-3000:]}")
            time.sleep(0.2)
        if port is None:
            raise AssertionError("serve-cli: no listening line")
        startup = time.perf_counter() - t0
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/info", timeout=60) as resp:
            info = json.loads(resp.read())
        req = urllib.request.Request(base + "/v1/sample", data=json.dumps({"class_labels": [1, 2], "seed": 3}).encode())
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, png = resp.status, resp.read()
        workers = torchrun_children(proc.pid)
        os.kill(workers[0], signal.SIGTERM)
        code = proc.wait(timeout=120)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = "".join(lines)
    out = dict(startup_s=startup, mesh=info["mesh"], devices=info["devices"], status=status,
               png=png[:8] == b"\x89PNG\r\n\x1a\n", torchrun_exit=code, lead_stopped="[serve] stopped" in text,
               follower_stopped="[serve] rank 1 stopped" in text)
    if not (info["mesh"] == {"data": 2, "model": 1} and status == 200 and out["png"] and code == 0
            and out["lead_stopped"] and out["follower_stopped"]):
        raise AssertionError(f"serve-cli: {out}\n{text[-3000:]}")
    return out


def mesh_serve_phase(torch, dev, exp_a: str, tmp: str) -> dict:
    """Phase 10c: the server on two ranks sharing the card (see
    mesh_serve_rank), then its entry point under torchrun (mesh_serve_cli).
    Every batch's launches of each rank are held to mesh_serve_expect and
    to the other rank's. Returns rank 0's launch counts of the plain path's
    TP chain."""
    import shutil

    from mapdit_tpu_torch.parallel import spawn

    card = smi_line()
    exp_s = exp_a.rstrip("/") + "-serve"  # phase 8c's copy of run A, statistics 2**-24
    t0 = time.perf_counter()
    refs = mesh_serve_refs(torch, dev, exp_s, tmp)
    refs_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mapdit_smoke_serve_") as out:
        t0 = time.perf_counter()
        spawn(mesh_serve_rank, 2, args=(refs, out))
        seconds = time.perf_counter() - t0
        reports = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    shutil.rmtree(refs["xl_exp"], ignore_errors=True)
    depth = {"dp": 12, "tp": 28}
    for tag in ("dp", "tp"):
        logs = [rep["batches"][tag] for rep in reports]
        if len(logs[0]) != len(logs[1]):
            raise AssertionError(f"serve-mesh/{tag}: the ranks ran {len(logs[0])} and {len(logs[1])} batches")
        for i, ((key0, c0), (key1, c1)) in enumerate(zip(*logs)):
            layout = "mega_tp" if tag == "tp" else "dp"
            if key0 != key1:
                raise AssertionError(f"serve-mesh/{tag}: batch {i} ran {key0} and {key1}")
            for r, counts in enumerate((c0, c1)):
                check_counts(f"serve-mesh/{tag}/batch{i}/rank{r}", counts, mesh_serve_expect(key0, depth[tag], layout))
        kinds = {}
        for key, counts in logs[0]:
            kinds.setdefault(json.dumps(key), {k: v for k, v in counts.items() if v})
        for key, counts in kinds.items():
            phase("serve-mesh", server=tag, program=key, launches_a_batch_each_rank=json.dumps(counts))
        phase("serve-mesh", server=tag, batches=len(logs[0]), ranks_launched_alike=True)
    checks = reports[0]["checks"]
    for name, row in checks.items():
        phase("serve-mesh", check=name, **({k: json.dumps(v) if isinstance(v, (dict, list)) else v
                                            for k, v in row.items()} if isinstance(row, dict) else {"value": row}))
    for name, row in reports[0]["loads"].items():
        phase("serve-mesh-load", server=name.split(":")[0], clients=int(name.split(":")[1]), requests=row["requests"],
              seconds=f"{row['seconds']:.4f}", requests_per_s=f"{row['requests_per_s']:.3f}",
              p50_ms=f"{row['p50_ms']:.3f}", p95_ms=f"{row['p95_ms']:.3f}",
              note="two ranks share one card over gloo; phase 8c's serve-load lines are the one-device numbers",
              card=json.dumps(card))
    for r, rep in enumerate(reports):
        phase("plain-tp", rank=r, model=FAMILY_MODEL, family="rotation_scale", attention_impl="pallas",
              mesh="(1,2)", backend=rep["backend"],
              launches=json.dumps({w: {k: v for k, v in c.items() if v} for w, c in rep["plain_counts"].items()}),
              call_ms=json.dumps([round(v, 4) for v in rep["checks"]["plain-tp:call:ms"]]),
              chain10_ms=json.dumps([round(v, 4) for v in rep["checks"]["plain-tp:chain-10:ms"]]))
    cli = mesh_serve_cli(exp_s)
    phase("serve-cli", **{k: json.dumps(v) if isinstance(v, dict) else v for k, v in cli.items()})
    phase("serve-mesh", refs_seconds=f"{refs_s:.2f}", seconds_with_spawn=f"{seconds:.2f}", card=json.dumps(card))
    return {"plain-tp/chain": reports[0]["plain_counts"]["chain-10"]}


def count_stack_rows(k):
    """Wrap ``fused_dit_stack`` (the model looks it up at each call) to
    record each call's rows; returns (rows seen, undo)."""
    seen, orig = [], k.fused_dit_stack

    def wrapped(x, *args, **kw):
        seen.append(x.shape[0])
        return orig(x, *args, **kw)

    k.fused_dit_stack = wrapped
    return seen, lambda: setattr(k, "fused_dit_stack", orig)


def sampler_phase(torch, dev, cfg, sd, z, yf, headline_steps_per_s: float) -> None:
    """Phase 5b: every sampler on the card at DiT-S/2, batch BATCH x 2, CFG
    CFG_SCALE, through block_kernel="auto" with a batch hint (one dit_stack
    launch a model call). Each short chain of SAMPLER_CHECKS and the cached
    ddpm chain (per block: fused_dit_block) is held to the float32 plain
    chain by check_paths' rule, with exact launch counts; then the chains of
    SAMPLER_TIMES are timed beside phase 5's headline."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.runtime import build_cached_sample_fn, build_sample_fn

    depth = cfg.depth
    paths = (("f32", cfg.replace(compute_dtype="float32"), None), ("off", cfg, None),
             ("auto+hint", cfg.replace(block_kernel="auto"), BATCH))
    for name, (spacing, kw) in SAMPLER_CHECKS.items():
        diffusion = create_diffusion(spacing, device=dev)
        steps = diffusion.num_timesteps
        outs = {}
        for path, c, hint in paths:
            fn = build_sample_fn(c, sd, diffusion, cfg_scale=CFG_SCALE, batch_hint=hint, device=dev, **kw)
            torch.cuda.synchronize()
            reset_launch_counts()
            rows, undo = count_stack_rows(k)
            try:
                outs[path] = fn(z, yf, torch.Generator(device=dev).manual_seed(SEED + 5))
                torch.cuda.synchronize()
            finally:
                undo()
            counts = launch_counts()
        if fn.run_cfg.block_kernel != "mega_stack":
            raise AssertionError(f"sampler {name}: auto with a batch hint resolved to {fn.run_cfg.block_kernel}")
        check_paths(torch, f"sampler-{name}", outs, ("auto+hint",))
        check_counts(f"sampler-{name}", counts, {"fused_dit_stack": steps, "dit_stack": steps})
        if fn.cfg_segments is not None:
            g0, g1 = fn.cfg_segments
            guided, unguided = rows.count(2 * BATCH), rows.count(BATCH)
            phase("sampler-" + name, cfg_interval=json.dumps(kw["cfg_interval"]), guided_positions=f"[{g0},{g1})",
                  guided_calls=guided, cond_only_calls=unguided)
            if not 0 < g1 - g0 < steps or guided != g1 - g0 or unguided != steps - (g1 - g0):
                raise AssertionError(f"sampler {name}: guided range [{g0}, {g1}) of {steps}, calls {rows}")
        elif rows != [2 * BATCH] * steps:
            raise AssertionError(f"sampler {name}: stack calls of {rows} rows")

    diffusion = create_diffusion("10", device=dev)
    outs = {}
    for path, c, _ in paths:
        fn = build_cached_sample_fn(c, sd, diffusion, cfg_scale=CFG_SCALE, cache_interval=CACHE_INTERVAL,
                                    cache_mode="forecast", clip_denoised=True, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        outs[path] = fn(z, yf, torch.Generator(device=dev).manual_seed(SEED + 5))
        torch.cuda.synchronize()
    counts = launch_counts()
    lo, hi = fn.span
    full = 10 // CACHE_INTERVAL
    blocks = full * depth + (10 - full) * (depth - (hi - lo))
    phase("sampler-cached", interval=CACHE_INTERVAL, mode="forecast", span=f"[{lo},{hi})", full_steps=full,
          block_launches=counts["fused_dit_block"], expected=blocks)
    check_paths(torch, "sampler-cached", {"f32": outs["f32"], "off": outs["off"], "auto": outs["auto+hint"]},
                ("auto",))
    check_counts("sampler-cached", counts, {"fused_dit_block": blocks, "dit_stack": blocks})

    for name, (spacing, sampler) in SAMPLER_TIMES.items():
        diffusion = create_diffusion(spacing, device=dev)
        steps = diffusion.num_timesteps
        fn = build_sample_fn(cfg.replace(block_kernel="auto"), sd, diffusion, cfg_scale=CFG_SCALE, sampler=sampler,
                             batch_hint=BATCH, device=dev)
        fn(z, yf, torch.Generator(device=dev).manual_seed(SEED + 6))  # warm-up
        runs = []
        for rep in range(SAMPLER_TIME_RUNS):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(z, yf, torch.Generator(device=dev).manual_seed(SEED + 7 + rep))
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            check_counts(f"sampler-time/{name}", launch_counts(), {"fused_dit_stack": steps, "dit_stack": steps})
        seconds = min(runs)
        phase("sampler-time", chain=name, batch=f"{BATCH}x2", steps=steps,
              seconds=json.dumps([round(r, 4) for r in runs]), steps_per_s=f"{steps / seconds:.3f}", ms_per_model_call=f"{1e3 * seconds / steps:.4f}",
              ddpm_250_steps_per_s=f"{headline_steps_per_s:.3f}", finite=bool(torch.isfinite(out).all()))


def pit_phase(torch, dev, cfg, sd, z, yf) -> float:
    """Phase 5c: parallel-in-time ddim (build_pit_sample_fn) at DiT-S/2 on
    the headline's weights, PIT_BATCH x 2 CFG rows, clipped ddim PIT_STEPS,
    window PIT_WINDOW, through auto (one dit_stack launch a sweep over
    window x PIT_BATCH x 2 rows, exact counts). The exact schedules are held
    to the f32 plain sequential ddim chain by check_paths' rule and to the
    kernels' own sequential chain within the limit of phase 8c's bucket 1
    against 4 (twice the bf16 plain chain's distance from f32, floor
    1e-2), with the same bits reported; the accelerated ones to the f32
    plain chain of their own schedule, their distance from the sequential
    chain printed. Every chain's ms beside sequential ddim at the same
    rows; the JAX package expects PIT to be slower on one chip, and nothing
    is claimed. Returns that limit (phase 10 holds the mesh's PIT to it)."""
    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.runtime import build_pit_sample_fn, build_sample_fn

    n = PIT_BATCH
    zp, yp = torch.cat([z[:n], z[:n]]), torch.cat([yf[:n], yf[BATCH:BATCH + n]])
    d = create_diffusion(f"ddim{PIT_STEPS}", device=dev)
    auto, f32 = cfg.replace(block_kernel="auto"), cfg.replace(compute_dtype="float32")
    hidden = int(cfg.hidden_size * cfg.mlp_ratio)

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 9)

    def timed(what, fn, calls, rows):
        """A warm-up (stack rows checked), then PIT_TIME_RUNS timed runs,
        each with exact launch counts; the last output, seconds, peak MiB
        of allocation above the start."""
        seen, undo = count_stack_rows(k)
        try:
            fn(zp, yp, gen())
            torch.cuda.synchronize()
        finally:
            undo()
        if seen != [rows] * calls:
            raise AssertionError(f"{what}: stack calls of {sorted(set(seen))} rows, {len(seen)} calls")
        runs = []
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        for _ in range(PIT_TIME_RUNS):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(zp, yp, gen())
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            check_counts(what, launch_counts(), {"fused_dit_stack": calls, "dit_stack": calls})
        return out, runs, (torch.cuda.max_memory_allocated() - start_bytes) / 2**20

    seq = {name: build_sample_fn(c, sd, d, cfg_scale=CFG_SCALE, sampler="ddim", clip_denoised=True, device=dev)(
        zp, yp, gen()) for name, c in (("f32", f32), ("off", cfg))}
    limit = max(2 * rel_l2(seq["off"], seq["f32"]), 1e-2)
    seq_fn = build_sample_fn(auto, sd, d, cfg_scale=CFG_SCALE, sampler="ddim", clip_denoised=True, batch_hint=n,
                             device=dev)
    seq_k, seq_runs, _ = timed("pit/sequential-ddim", seq_fn, PIT_STEPS, 2 * n)
    check_paths(torch, "pit-sequential", {**seq, "kernels": seq_k}, ("kernels",))
    seq_ms = 1e3 * min(seq_runs)
    prepared = seq_fn.prepared
    for rows, what in ((2 * BATCH, "headline"), (2 * n * PIT_WINDOW, "pit-sweep"),
                       (2 * PIT_FID_BATCH * PIT_WINDOW, f"sample_fid-batch-{PIT_FID_BATCH}")):
        plan = k.stack_plan(rows, cfg.num_patches, cfg.hidden_size, hidden, cfg.num_heads, cfg.depth)
        phase("pit", workspace=what, rows=rows, token_rows=rows * cfg.num_patches,
              dit_stack_workspace_mib=f"{plan.workspace_bytes / 2**20:.1f}", source="stack_plan")
    for name, (schedule, calls, exact) in PIT_SCHEDULES.items():
        kw = dict(cfg_scale=CFG_SCALE, window=PIT_WINDOW, clip_denoised=True, device=dev, **schedule)
        fn = build_pit_sample_fn(auto, sd, d, prepared=prepared, **kw)
        if fn.run_cfg.block_kernel != "mega_stack" or fn.model_calls != calls:
            raise AssertionError(f"pit {name}: {fn.run_cfg.block_kernel}, {fn.model_calls} model calls")
        out, runs, peak_mib = timed(f"pit/{name}", fn, calls, 2 * n * PIT_WINDOW)
        if exact:
            check_paths(torch, f"pit-{name}", {**seq, "kernels": out}, ("kernels",))
            err = rel_l2(out, seq_k)
            phase("pit", schedule=name, exact=True, rel_l2_vs_kernel_sequential=f"{err:.3e}", tol=f"{limit:.3e}",
                  same_bits_as_kernel_sequential=bool(torch.equal(out, seq_k)),
                  max_abs_vs_kernel_sequential=f"{float((out - seq_k).abs().max()):.3e}")
            if not err <= limit:
                raise AssertionError(f"pit {name}: off the kernels' sequential ddim by {err} > {limit}")
        else:
            plain = {p: build_pit_sample_fn(c, sd, d, **kw)(zp, yp, gen()) for p, c in (("f32", f32), ("off", cfg))}
            check_paths(torch, f"pit-{name}", {**plain, "kernels": out}, ("kernels",))
            phase("pit", schedule=name, exact=False, rel_l2_vs_f32_sequential=f"{rel_l2(out, seq['f32']):.3e}",
                  rel_l2_vs_kernel_sequential=f"{rel_l2(out, seq_k):.3e}",
                  f32_pit_rel_l2_vs_f32_sequential=f"{rel_l2(plain['f32'], seq['f32']):.3e}")
        phase("pit-time", schedule=name, batch=f"{n}x2", window=PIT_WINDOW, steps=PIT_STEPS, model_calls=calls,
              rows_a_call=2 * n * PIT_WINDOW, seconds=json.dumps([round(r, 4) for r in runs]),
              ms=f"{1e3 * min(runs):.3f}", ms_per_model_call=f"{1e3 * min(runs) / calls:.4f}",
              sequential_ddim_ms=f"{seq_ms:.3f}", sequential_ms_per_model_call=f"{seq_ms / PIT_STEPS:.4f}",
              peak_alloc_above_start_mib=f"{peak_mib:.1f}", card=json.dumps(smi_line()))
        del fn, out
    torch.cuda.empty_cache()
    return limit


def bench_phase(torch, dev) -> dict:
    """Phase 5d: mapdit_tpu_torch.bench.main in process for each of
    BENCH_RUNS; its JSON line printed. The sampler chains make phase 5b's
    launches (one dit_stack a model call; the cached chain one a block it
    runs), the 32 x 32 run on auto resolves to the plain path (no launch)
    and on an explicit mega_stack makes one dit_stack launch a model call
    (T = 256), the train run with --grad-accum 4 phase 6's launches per
    micro-batch. Returns each run's launch counts, by tag."""
    import io

    from mapdit_tpu_torch import bench
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    depth, runs = 12, {}
    for tag, flags in BENCH_RUNS.items():
        argv = [*flags, "--repeats", str(BENCH_REPEATS)]
        args = bench.build_parser().parse_args(argv)
        chains = 1 + BENCH_REPEATS
        if args.mode == "train":
            expect = mega_attn_expect(ab, depth, (1 + max(args.steps, 10)) * args.grad_accum, remat=False)
        elif args.input_size != 16 and args.block_kernel == "auto":
            expect = {}
        elif args.cache_interval > 1:
            full = args.steps // args.cache_interval
            blocks = chains * (full * depth + (args.steps - full) * (depth - depth // 2))
            expect = {"fused_dit_block": blocks, "dit_stack": blocks}
        else:
            expect = {"fused_dit_stack": chains * args.steps, "dit_stack": chains * args.steps}
        torch.cuda.synchronize()
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            bench.main(argv)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        line = buf.getvalue().strip().splitlines()[-1]
        result = json.loads(line)
        print(line, flush=True)
        phase("bench", run=tag, value=f"{result['value']:.3f}", mfu_pct=result["mfu_pct"],
              block_kernel=result.get("block_kernel"), seconds_with_build=f"{seconds:.2f}",
              launches=json.dumps({key: v for key, v in counts.items() if v}), card=json.dumps(smi_line()))
        check_counts(f"bench/{tag}", counts, expect)
        runs[tag] = counts
        want = "off" if args.input_size != 16 else ("mega" if args.cache_interval > 1 else "mega_stack")
        if args.block_kernel != "auto":
            want = args.block_kernel
        if args.mode == "sample" and result["block_kernel"] != want:
            raise AssertionError(f"bench {tag}: block_kernel {result['block_kernel']}, not {want}")
        if f"block_kernel {want}" not in result["unit"] and args.mode == "sample":
            raise AssertionError(f"bench {tag}: the unit does not name block_kernel {want}: {result['unit']}")
        torch.cuda.empty_cache()
    return runs


def png_check(path: str) -> tuple:
    """Decode a PNG's chunks: CRCs, the IHDR, and the inflated IDAT size
    against it (a filter byte and width x channels bytes a row). Returns
    (height, width, channels)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in chunk {kind}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    width, height, bits, color = header[:4]
    channels = {0: 1, 4: 2, 2: 3, 6: 4}[color]
    raw = zlib.decompress(idat)
    if bits != 8 or len(raw) != height * (1 + width * channels):
        raise AssertionError(f"{path}: {len(raw)} bytes inflated for {height}x{width}x{channels}")
    return height, width, channels


def sample_cli_phase(torch, dev, exp: str) -> None:
    """Phase 8b: the sampling CLIs, called in process on phase 8's run-A
    experiment directory (full DiT-S/2, its EMA snapshots), with a
    random-weight VAE of the port's own init written through the port's
    safetensors writer; block_kernel "auto" (run A trained on mega_attn)."""
    from mapdit_tpu_torch import sample, sample_ema, sample_fid
    from mapdit_tpu_torch.models.vae import init_vae, load_decoder
    from mapdit_tpu_torch.utils.experiment import config_from_args, load_config
    from mapdit_tpu_torch.utils.safetensors import save_file

    cfg = config_from_args(load_config(exp))
    depth, side = cfg.depth, 8 * cfg.input_size  # the VAE decodes a latent pixel to 8 x 8
    vae = init_vae(SEED).eval()
    vae_path = os.path.join(exp, "vae.safetensors")
    save_file({key: v.numpy() for key, v in vae.state_dict().items()}, vae_path)
    common = ["--result-dir", exp, "--vae-path", vae_path, "--block-kernel", "auto"]
    label = ["--class-label", str(min(88, cfg.num_classes - 1))]

    def run(module, what, argv, expect):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = module.main(module.build_parser().parse_args([*common, *argv]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check_counts(f"sample-cli/{what}", counts, expect)
        return out, seconds, counts

    grid, seconds, counts = run(sample, "sample", [*label, "--sampler", "ddim", "--num-sampling-steps", "50",
                                                   "--clip-denoised", "true", "--output-file",
                                                   os.path.join(exp, "ddim.png")],
                                {"fused_dit_stack": 50, "dit_stack": 50})
    shape = png_check(grid)
    phase("sample-cli", cli="sample", sampler="ddim", steps=50, png=json.dumps(shape), seconds=f"{seconds:.3f}",
          launches=json.dumps({key: v for key, v in counts.items() if v}))
    if shape != (2 * (side + 2) + 2, 2 * (side + 2) + 2, 3):
        raise AssertionError(f"sample: grid of shape {shape}")
    traj = os.path.join(exp, "trajectory.png")
    # the trajectory's progressive chain runs the model per block (no batch hint)
    grid, seconds, counts = run(sample, "sample+trajectory",
                                [*label, "--sampler", "ddpm", "--num-sampling-steps", "50", "--clip-denoised", "true",
                                 "--output-file", os.path.join(exp, "ddpm.png"), "--save-trajectory", traj],
                                {"fused_dit_stack": 50, "fused_dit_block": 50 * depth, "dit_stack": 50 + 50 * depth})
    shapes = (png_check(grid), png_check(traj))
    phase("sample-cli", cli="sample", sampler="ddpm", steps=50, png=json.dumps(shapes[0]),
          trajectory_png=json.dumps(shapes[1]), seconds=f"{seconds:.3f}")
    if shapes[1] != (4 * (side + 2) + 2, 8 * (side + 2) + 2, 3):
        raise AssertionError(f"sample: trajectory grid of shape {shapes[1]}")

    grid, seconds, counts = run(sample_ema, "sample_ema", [*label, "--sampler", "dpm++", "--num-sampling-steps", "20",
                                                           "--output-file", os.path.join(exp, "ema.png")],
                                {"fused_dit_stack": 5 * 20, "dit_stack": 5 * 20})
    shape = png_check(grid)
    phase("sample-cli", cli="sample_ema", sampler="dpm++", steps=20, png=json.dumps(shape), seconds=f"{seconds:.3f}")
    if shape != (8 * (side + 2) + 2, 5 * (side + 2) + 2, 3):
        raise AssertionError(f"sample_ema: grid of shape {shape}")

    batches = FID_SAMPLES // FID_BATCH
    npz, seconds, counts = run(sample_fid, "sample_fid",
                               ["--num-samples", str(FID_SAMPLES), "--batch-size", str(FID_BATCH), "--num-classes",
                                str(cfg.num_classes), "--cfg-scale",
                                str(CFG_SCALE), "--num-sampling-steps", str(STEPS)],
                               {"fused_dit_stack": batches * STEPS, "dit_stack": batches * STEPS})
    import numpy as np

    with np.load(npz) as f:
        arr = f["arr_0"]
    phase("sample-cli", cli="sample_fid", samples=FID_SAMPLES, batch=FID_BATCH, steps=STEPS, seconds=f"{seconds:.3f}",
          images_per_s=f"{FID_SAMPLES / seconds:.3f}", arr_0=f"{arr.dtype}{tuple(arr.shape)}",
          launches=json.dumps({key: v for key, v in counts.items() if v}))
    if arr.dtype != np.uint8 or arr.shape != (FID_SAMPLES, side, side, 3):
        raise AssertionError(f"sample_fid: arr_0 {arr.dtype} {arr.shape}")

    # the VAE on the card against the same module's f32 decode on the CPU
    # (TF32 is off for the whole smoke, set at its start: full f32
    # convolutions on both sides, summed in other orders)
    decode = load_decoder(vae_path, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    lat = torch.randn(FID_BATCH, cfg.in_channels, cfg.input_size, cfg.input_size, generator=gen, device=dev)
    got = decode(lat[:VAE_CHECK_IMAGES]).float().cpu()
    with torch.no_grad():
        want = vae.decode(lat[:VAE_CHECK_IMAGES].cpu())
    err = rel_l2(got, want)
    ms = time_ms(torch, lambda: decode(lat), iters=3, warmup=1)
    phase("sample-cli", vae="decode", tf32=False, images=VAE_CHECK_IMAGES, rel_l2_err_vs_cpu=f"{err:.3e}",
          tol="1e-4", ms_per_image=f"{ms / FID_BATCH:.4f}", batch=FID_BATCH, side=side)
    if not err <= 1e-4:
        raise AssertionError(f"VAE decode on the card is off the CPU's by {err} relative")
    # the same with PyTorch's default TF32 convolutions, which the CLIs run
    # under outside this smoke: a 10-bit mantissa in each product
    torch.backends.cudnn.allow_tf32 = True
    try:
        err = rel_l2(decode(lat[:VAE_CHECK_IMAGES]).float().cpu(), want)
        ms = time_ms(torch, lambda: decode(lat), iters=3, warmup=1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    phase("sample-cli", vae="decode", tf32=True, images=VAE_CHECK_IMAGES, rel_l2_err_vs_cpu=f"{err:.3e}",
          tol="1e-2", ms_per_image=f"{ms / FID_BATCH:.4f}", batch=FID_BATCH, side=side)
    if not err <= 1e-2:
        raise AssertionError(f"VAE decode on the card with TF32 is off the CPU's by {err} relative")


def serve_phase(torch, dev, exp: str) -> None:
    """Phase 8c: the server (``mapdit_tpu_torch.serve``) on phase 8's run-A
    experiment, over real HTTP on an ephemeral port, buckets SERVE_BUCKETS,
    ``--block-kernel auto``. Its latent statistics are set as
    SERVE_STATS_EXP says in a copy of the experiment (config.yaml, the EMA
    snapshots, the constants), so what the server returns is the chains'
    latents times a power of two. Checks: the headline protocol's launches
    (one dit_stack a model call), and its request at
    SERVE_HEADLINE_CHECK_STEPS bit for bit against build_sample_fn on the
    host preamble's z and generator; SERVE_CHECKS against the float32 plain
    chain by check_paths' rule with exact launch counts; coalescing within a
    bucket bit for bit; bucket 1 against bucket 4; every compared output
    finite and unclipped; the device memory of the programs; a VAE-decoded
    PNG from a second server on run A itself; then the timed loads of
    SERVE_LOADS."""
    import io
    import shutil
    import threading
    import urllib.error
    import urllib.request
    import numpy as np

    from mapdit_tpu_torch import serve
    from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
    from mapdit_tpu_torch.runtime import build_cached_sample_fn, build_sample_fn
    from mapdit_tpu_torch.sample import decode_latents, load_variables, run_config
    from mapdit_tpu_torch.utils.experiment import load_config, save_config
    from mapdit_tpu_torch.utils.image import to_uint8

    exp_s = exp.rstrip("/") + "-serve"
    os.makedirs(exp_s)
    shutil.copytree(os.path.join(exp, "ema"), os.path.join(exp_s, "ema"))
    shutil.copy(os.path.join(exp, "constants.pt"), exp_s)
    train_args = load_config(exp)
    c, side = train_args["in_channels"], train_args["input_size"]
    train_args.update(stats_mean=[0.0] * c, stats_std=[2.0**-SERVE_STATS_EXP] * c)
    save_config(exp_s, train_args)
    cfg = run_config(train_args, "auto")
    sd = load_variables(exp_s, train_args)
    weight_bytes = sum(v.numel() * v.element_size() for v in sd.values())  # one f32 folded copy
    labels = [i % cfg.num_classes for i in range(0, 37 * BATCH, 37)]

    def start(*flags):
        """The server as ``python -m mapdit_tpu_torch.serve`` builds it (and
        warms it), its request log off (a line a request would bury the
        phase's lines), serving from a thread: (server, service, base URL)."""
        args = serve.build_parser().parse_args(
            ["--port", "0", "--seed", str(SERVE_SEED), "--block-kernel", "auto", *flags])
        server, service = serve.build_server(args, serve.build_service(args))
        server.RequestHandlerClass.log_message = lambda self, fmt, *args: None
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, service, f"http://127.0.0.1:{server.server_address[1]}"

    def unclipped(what, *outs):
        """Raise unless every served output compared is finite and inside
        (-1, 1): the image range the server clips to, so a comparison sees
        the chains' own values."""
        for out in outs:
            out = np.asarray(out)
            if not (np.isfinite(out).all() and np.abs(out).max() < 1):
                raise AssertionError(f"serve: {what}: a compared output is non-finite or clipped "
                                     f"(finite share {float(np.isfinite(out).mean()):.4f}, "
                                     f"max |x| {float(np.nanmax(np.abs(out))):.3e})")

    def post(base, payload):
        req = urllib.request.Request(base + "/v1/sample", data=json.dumps(payload).encode())
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as e:
            raise AssertionError(f"serve: {payload} -> {e.code} {e.read()[:300]!r}") from None

    def arr_0(body):
        with np.load(io.BytesIO(body)) as f:
            return f["arr_0"]

    def served(base, payload, expect, what):
        """One request alone: (response, launch counts), the counts exact."""
        torch.cuda.synchronize()
        reset_launch_counts()
        out = post(base, payload)
        counts = launch_counts()
        check_counts(f"serve/{what}", counts, expect)
        return out, counts

    def reference(path_cfg, proto, z_seed_rows, counter, n, bucket):
        """The chain function's output on the host preamble's z and generator for
        one seeded job of n rows in ``bucket``: raw latents (n, C, H, W)."""
        proto = dict(proto)
        steps, sampler, cfg_scale = proto.pop("steps"), proto.pop("sampler"), proto.pop("cfg_scale")
        z = torch.cat([serve.draw(z_seed_rows, (n, c, side, side), dev), torch.zeros(bucket - n, c, side, side,
                                                                                        device=dev)])
        y = torch.tensor(labels[:n] + [0] * (bucket - n), device=dev)
        z, y = torch.cat([z, z]), torch.cat([y, torch.full_like(y, cfg.num_classes)])
        diffusion = create_diffusion(respacing_string(steps, sampler, proto.pop("schedule", "uniform")), device=dev)
        if proto.get("cache_interval", 0) > 1:
            fn = build_cached_sample_fn(path_cfg, sd, diffusion, cfg_scale=cfg_scale, sampler=sampler, device=dev,
                                        cache_interval=proto.pop("cache_interval"), **proto)
        else:
            fn = build_sample_fn(path_cfg, sd, diffusion, cfg_scale=cfg_scale, sampler=sampler, batch_hint=bucket,
                                 device=dev, **proto)
        return fn(z, y, serve.generator(serve.chain_seed(SERVE_SEED, counter), dev))[:n]

    def image(latents):
        """What the server returns for raw latents (its decode, no VAE)."""
        return decode_latents(latents.float().cpu().numpy(), train_args, False)

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    # warmed at startup: the default protocol's program at the largest bucket
    server, service, base = start("--result-dir", exp_s, "--buckets", ",".join(map(str, SERVE_BUCKETS)))
    try:
        torch.cuda.synchronize()
        mem_first = torch.cuda.memory_allocated() - mem0
        prepared = service._prepared
        held = sum(t.numel() * t.element_size() for t in [*prepared["model"].parameters(), *prepared["model"].buffers(),
                                                        *(prepared["block_stack"] or {}).values()])
        depth = cfg.depth

        # the headline protocol: 32 samples, ddpm 250, CFG 1.5, one seeded
        # request; its launches, then its bits at SERVE_HEADLINE_CHECK_STEPS
        headline = {"class_labels": labels, "steps": STEPS, "sampler": "ddpm", "cfg_scale": CFG_SCALE, "seed": 101,
                    "format": "npz"}
        (_, headers, body), counts = served(base, headline, {"fused_dit_stack": STEPS, "dit_stack": STEPS},
                                            "headline")
        phase("serve", protocol="headline", steps=STEPS, samples=BATCH, bucket=BATCH, cfg_scale=CFG_SCALE,
              launches=json.dumps({key: v for key, v in counts.items() if v}),
              seed_deterministic=headers["X-Seed-Deterministic"],
              note="launches only: the bits are held on the same request at SERVE_HEADLINE_CHECK_STEPS")
        steps = SERVE_HEADLINE_CHECK_STEPS
        proto = {"steps": steps, "sampler": "ddpm", "cfg_scale": CFG_SCALE}
        (_, _, body), counts = served(base, {**headline, "steps": steps},
                                      {"fused_dit_stack": steps, "dit_stack": steps}, "headline-bits")
        want = reference(cfg, proto, 101, service._request_counter, BATCH, BATCH)
        same_http = bool(np.array_equal(arr_0(body), to_uint8(image(want))))
        # the same request in process (floats), against build_sample_fn again
        got = service.sample(labels, seed=101, **proto)
        want = image(reference(cfg, proto, 101, service._request_counter, BATCH, BATCH))
        same = bool(np.array_equal(got, want))
        phase("serve", protocol=f"headline-ddpm-{steps}", samples=BATCH, bucket=BATCH, cfg_scale=CFG_SCALE,
              launches=json.dumps({key: v for key, v in counts.items() if v}), npz_equals_build_sample_fn=same_http,
              floats_equal_build_sample_fn=same, max_abs_served=f"{float(np.nanmax(np.abs(got))):.4e}")
        unclipped(f"headline-ddpm-{steps}", got, want)
        if not (same_http and same):
            raise AssertionError("serve: the headline differs from build_sample_fn on the same z and generator")

        # the other protocols against the float32 plain chain
        limits = {}
        for name, proto in SERVE_CHECKS.items():
            steps, cached = proto["steps"], proto.get("cache_interval", 0) > 1
            lo, hi = depth // 4, depth - depth // 4
            blocks = (steps // 2) * depth + (steps - steps // 2) * (depth - (hi - lo))
            expect = ({"fused_dit_block": blocks, "dit_stack": blocks} if cached
                      else {"fused_dit_stack": steps, "dit_stack": steps})
            (_, _, body), counts = served(base, {**proto, "class_labels": labels, "seed": 102, "format": "npz"},
                                          expect, name)
            counter = service._request_counter
            outs = {path: reference(path_cfg, proto, 102, counter, BATCH, BATCH)
                    for path, path_cfg in (("f32", cfg.replace(compute_dtype="float32", block_kernel="off")),
                                           ("off", cfg.replace(block_kernel="off")), ("served", cfg))}
            same_http = bool(np.array_equal(arr_0(body), to_uint8(image(outs["served"]))))
            got = service.sample(labels, seed=102, **proto)  # in process: floats
            want = image(reference(cfg, proto, 102, service._request_counter, BATCH, BATCH))
            same = bool(np.array_equal(got, want))
            phase("serve", protocol=name, launches=json.dumps({key: v for key, v in counts.items() if v}),
                  npz_equals_chain_fn=same_http, floats_equal_chain_fn=same,
                  max_abs_latent=f"{float(outs['served'].abs().max()):.3e}",
                  max_abs_served=f"{float(np.nanmax(np.abs(got))):.4e}")
            unclipped(name, got, want, *(image(v) for v in outs.values()))
            if not (same_http and same):
                raise AssertionError(f"serve: {name} differs from its chain function on the same z and generator")
            # the served bits are the chain function's kernel path: hold it to the f32 plain chain
            check_paths(torch, f"serve-{name}", outs, ("served",))
            limits[name] = max(2 * rel_l2(outs["off"], outs["f32"]), 1e-2)

        # coalescing: a two-sample job alone and beside another (bucket 4
        # both), then a one-sample job alone (bucket 1) and beside two others
        # (bucket 4); deterministic dpm++ 20
        def concurrently(jobs):
            results, barrier = [None] * len(jobs), threading.Barrier(len(jobs))

            def run(i, seed, k):
                barrier.wait()
                results[i] = service.sample(labels[:k], seed=seed, **SERVE_DEFAULTS)

            threads = [threading.Thread(target=run, args=(i, *job)) for i, job in enumerate(jobs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            return results

        alone = service.sample(labels[:2], seed=201, **SERVE_DEFAULTS)
        service.coalesce_ms = 200.0
        try:
            before = service.info()["coalesced_batches"]
            pair = concurrently([(201, 2), (202, 2)])
            one = service.sample(labels[:1], seed=203, **SERVE_DEFAULTS)
            three = concurrently([(203, 1), (204, 1), (205, 1)])
            coalesced = service.info()["coalesced_batches"] - before
        finally:
            service.coalesce_ms = 3.0
        unclipped("coalescing", alone, *pair, one, *three)
        same = bool(np.array_equal(alone, pair[0]))
        latent = torch.from_numpy(one[0]) * 2.0**SERVE_STATS_EXP, torch.from_numpy(three[0][0]) * 2.0**SERVE_STATS_EXP
        across = rel_l2(*latent)
        limit = limits["dpm++-20"]
        phase("serve", coalescing="bucket-4", same_bits_alone_and_coalesced=same, coalesced_batches=coalesced,
              seeds_differ=not np.array_equal(pair[0], pair[1]))
        phase("serve", across_buckets="1-vs-4", rel_l2=f"{across:.3e}",
              max_abs_latent_diff=f"{float((latent[0] - latent[1]).abs().max()):.3e}",
              max_uint8_diff=int(np.abs(to_uint8(one).astype(int) - to_uint8(three[0]).astype(int)).max()),
              tol=f"{limit:.3e}", note="the tolerance is dpm++-20's limit against the float32 plain chain")
        if not same or coalesced != 2 or np.array_equal(pair[0], pair[1]):
            raise AssertionError(f"serve: coalescing within a bucket (same bits {same}, {coalesced} coalesced)")
        if not across <= limit:
            raise AssertionError(f"serve: bucket 1 against bucket 4 differ by {across} relative")

        # every bucket of the default protocol, then the memory
        for b in SERVE_BUCKETS:
            service.sample(labels[:b], seed=300 + b, **SERVE_DEFAULTS)
        torch.cuda.synchronize()
        mem_all = torch.cuda.memory_allocated() - mem0
        programs = service.info()["compiled_programs"]
        phase("serve", memory="allocated", prepared_weights_bytes=held, after_first_program=mem_first,
              after_every_program=mem_all, programs=programs, one_weight_copy_bytes=weight_bytes)
        if mem_all - mem_first >= weight_bytes:
            raise AssertionError(f"serve: {programs} programs grew the device memory by {mem_all - mem_first} bytes")

        # the timed loads of the default protocol
        for clients in SERVE_LOADS:
            info0 = service.info()
            latencies, errors = [], []
            lock = threading.Lock()

            def client(i):
                for r in range(SERVE_REQUESTS):
                    t0 = time.perf_counter()
                    try:
                        status, _, body = post(base, {"class_label": labels[i], "seed": 1000 * i + r})
                    except AssertionError as e:
                        errors.append(str(e))
                        continue
                    with lock:
                        latencies.append(time.perf_counter() - t0)
                    if status != 200 or body[:8] != b"\x89PNG\r\n\x1a\n":
                        errors.append(f"status {status}")

            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            info = service.info()
            batches = info["batches_run"] - info0["batches_run"]
            chain_s = info["chain_seconds_sum"] - info0["chain_seconds_sum"]
            requests = clients * SERVE_REQUESTS
            lat = np.asarray(latencies) * 1e3
            phase("serve-load", clients=clients, requests=requests, failed=len(errors),
                  seconds=f"{seconds:.4f}",
                  requests_per_s=f"{requests / seconds:.3f}", images_per_s=f"{requests / seconds:.3f}",
                  p50_ms=f"{np.percentile(lat, 50):.3f}", p95_ms=f"{np.percentile(lat, 95):.3f}",
                  max_ms=f"{lat.max():.3f}", batches=batches, rows_per_batch=f"{requests / batches:.3f}",
                  chain_ms_per_batch=f"{1e3 * chain_s / batches:.3f}",
                  coalesced_share=f"{(info['coalesced_batches'] - info0['coalesced_batches']) / batches:.3f}",
                  dit_stack_per_batch=f"{counts['dit_stack'] / batches:.3f}", compile_batches=info[
                      "compile_seconds_count"] - info0["compile_seconds_count"])
            if errors or len(latencies) != requests:
                raise AssertionError(f"serve: load of {clients} clients: {errors[:3]}")
            check_counts(f"serve-load/{clients}", counts,
                         {"fused_dit_stack": SERVE_DEFAULTS["steps"] * batches,
                          "dit_stack": SERVE_DEFAULTS["steps"] * batches})
    finally:
        server.shutdown()
        server.server_close()
        service.close()

    # a VAE-decoded PNG from run A itself (phase 8b's random-weight VAE)
    server, vae, base = start("--result-dir", exp, "--buckets", "1", "--warmup", "false", "--use-vae", "true",
                              "--vae-path", os.path.join(exp, "vae.safetensors"))
    try:
        (_, headers, body), counts = served(base, {"class_label": labels[1], "seed": 7},
                                            {"fused_dit_stack": 20, "dit_stack": 20}, "vae")
    finally:
        server.shutdown()
        server.server_close()
        vae.close()
    path = os.path.join(exp_s, "served.png")
    with open(path, "wb") as f:
        f.write(body)
    shape = png_check(path)
    phase("serve", decode="vae", png=json.dumps(shape), content_type=headers["Content-Type"])
    if shape != (8 * side + 4, 8 * side + 4, 3):
        raise AssertionError(f"serve: VAE PNG of shape {shape}")


def distill_step_launches(depth: int) -> dict:
    """The launch counts of one distill step on mega_attn + pallas: phase
    6's train step plus the teacher pair's two forwards (row 3 in every
    block, run without a gradient), whatever the rows a call."""
    from mapdit_tpu_torch.ops.cuda import attn_branch as ab

    return mega_attn_expect(ab, depth, 1, remat=False, forwards=3)  # the teacher pair and the student


def distill_phase(torch, dev, exp: str, tmp: str, train_counts: dict) -> None:
    """Phase 8d: progressive distillation of phase 8's run A, then its
    2-step student sampled and served (module docstring)."""
    import io
    import logging
    import re
    import shutil
    import threading
    import urllib.request

    import numpy as np

    from mapdit_tpu_torch import distill, sample, sample_fid, serve
    from mapdit_tpu_torch.diffusion import distill as dd
    from mapdit_tpu_torch.models import init_model
    from mapdit_tpu_torch.runtime import build_sample_fn
    from mapdit_tpu_torch.training import SyntheticLatentDataset, create_optimizer, create_train_state, make_train_step
    from mapdit_tpu_torch.training import warmup_flat_invsqrt
    from mapdit_tpu_torch.utils.experiment import config_from_args, load_config, save_config
    from mapdit_tpu_torch.utils.image import to_uint8

    teacher_args = load_config(exp)
    cfg = config_from_args(teacher_args)  # run A: mega_attn + pallas, bf16, weights not folded
    depth = cfg.depth
    teacher_sd = sample.load_variables(exp, teacher_args)

    def unchanged(model) -> bool:
        state = model.state_dict()
        return all(torch.equal(state[key].cpu(), v) for key, v in teacher_sd.items())

    # 1. one distill step: the kernel path against the float32 plain path
    m = dd.base_timestep_map(DISTILL_BASE_STEPS)
    d_t, d_s = dd.diffusion_from_map(m, device=dev), dd.diffusion_from_map(dd.halved_map(m), device=dev)
    ds = SyntheticLatentDataset(num_examples=1024, num_classes=cfg.num_classes, size=cfg.input_size, seed=SEED)
    batch = {key: torch.as_tensor(v).to(dev) for key, v in next(ds.batches(DISTILL_BATCH, seed=SEED)).items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    shape = batch["mean"].shape
    draws = {"posterior_eps": torch.randn(shape, generator=gen, device=dev),
             "t": torch.randint(0, d_s.num_timesteps, (DISTILL_BATCH,), generator=gen, device=dev),
             "noise": torch.randn(shape, generator=gen, device=dev)}
    tx = create_optimizer(warmup_flat_invsqrt(2e-3, 1, 100))
    paths = {"f32": cfg.replace(compute_dtype="float32", block_kernel="off"), "off": cfg.replace(block_kernel="off"),
             "mega_attn+pallas": cfg}
    expect = distill_step_launches(depth)
    losses, grads = {}, {}
    for name, c in paths.items():
        teacher = init_model(c, seed=SEED, device=dev)
        teacher.load_state_dict(teacher_sd)
        teacher.requires_grad_(False)
        state = create_train_state(c, tx, seed=SEED, device=dev, state_dict=teacher_sd)
        step = make_train_step(
            c, d_s, tx, stats_mean=teacher_args["stats_mean"], stats_std=teacher_args["stats_std"],
            losses_fn=dd.make_distill_losses(d_t, d_s, dd.make_teacher_fn(teacher, c.num_classes, DISTILL_CFG_SCALE)),
            model_train=False)
        torch.cuda.synchronize()
        reset_launch_counts()
        losses[name] = step(state, batch, draws=draws)["loss"].reshape(1)
        torch.cuda.synchronize()
        counts = launch_counts()
        grads[name] = torch.cat([p.grad.float().reshape(-1) for p in state.model.parameters()])
        if name != "f32":
            times = []
            for _ in range(DISTILL_TIMED_RUNS + 1):  # the first is the warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(state, batch)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            phase("distill", step=name, batch=DISTILL_BATCH, cfg_scale=DISTILL_CFG_SCALE,
                  grid=f"{len(m)}->{len(m) // 2}", ms_per_step=json.dumps([round(v, 4) for v in times[1:]]),
                  warmup_ms=f"{times[0]:.4f}", first_loss=f"{float(losses[name]):.6e}",
                  last_loss=f"{float(metrics['loss']):.6e}",
                  launches=json.dumps({key: v for key, v in counts.items() if v}))
            if not math.isfinite(float(metrics["loss"])):
                raise AssertionError(f"distill/{name}: non-finite loss")
            if not unchanged(teacher):
                raise AssertionError(f"distill/{name}: the student's steps moved the teacher's tensors")
        if name == "mega_attn+pallas":
            check_counts("distill/step", counts, expect)
            train_step = {key: v // TRAIN_STEPS for key, v in train_counts["mega_attn+pallas"].items() if v}
            phase("distill", launches_a_step="mega_attn+pallas", distill_step=json.dumps(expect),
                  train_step=json.dumps(train_step), row3_a_step=expect["attn_branch/fwd"],
                  row3_train_step=train_step["attn_branch/fwd"], row4_a_step=expect["attn_branch/bwd"])
        del state, step, teacher
        torch.cuda.empty_cache()
    check_paths(torch, "distill-loss", losses, ("mega_attn+pallas",))
    check_paths(torch, "distill-grads", grads, ("mega_attn+pallas",))

    # 2. the CLI in process
    teachers, records = [], []
    make_teacher_fn = distill.make_teacher_fn

    def spy(model, num_classes, cfg_scale):
        teachers.append(model)
        return make_teacher_fn(model, num_classes, cfg_scale)

    class Log(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Log()
    logging.getLogger("mapdit_tpu_torch").addHandler(handler)
    distill.make_teacher_fn = spy
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        dirs = distill.main(distill.build_parser().parse_args(
            ["--teacher", exp, "--data-path", "synthetic:1024", "--results-dir", os.path.join(tmp, "distill"),
             "--stages", str(DISTILL_STAGES), "--steps-per-stage", str(DISTILL_STEPS_PER_STAGE),
             "--batch-size", str(DISTILL_BATCH), "--base-steps", str(DISTILL_BASE_STEPS),
             "--cfg-scale", str(DISTILL_CFG_SCALE), "--log-every", "1"]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        distill.make_teacher_fn = make_teacher_fn
        logging.getLogger("mapdit_tpu_torch").removeHandler(handler)
    logged = [re.search(r"\[stage (\d+)\] step (\d+) distill loss (\S+) \((\S+) steps/s\)", r) for r in records]
    logged = [(int(g[1]), int(g[2]), float(g[3]), float(g[4])) for g in logged if g]
    fields = [{key: v for key, v in load_config(d).items() if key.startswith("distill_")} for d in dirs]
    raw = torch.load(os.path.join(dirs[0], "checkpoints", f"{DISTILL_STEPS_PER_STAGE:07d}.pt"), map_location="cpu",
                     weights_only=True)["model"]
    chained = all(torch.equal(teachers[1].state_dict()[key].cpu(), v) for key, v in raw.items())
    phase("distill", cli="stages", seconds=f"{seconds:.3f}", stage_dirs=json.dumps([os.path.basename(d) for d in dirs]),
          fields=json.dumps(fields), losses=json.dumps([row[2] for row in logged]),
          steps_per_s=json.dumps([row[3] for row in logged]), stage1_teacher_unchanged=unchanged(teachers[0]),
          stage2_teacher_is_stage1_student=chained, launches=json.dumps({key: v for key, v in counts.items() if v}))
    want_fields = [(1, 4), (2, 2)]
    if ([(f["distill_rounds"], f["distill_num_steps"]) for f in fields] != want_fields
            or any(f["distill_cfg_scale"] != DISTILL_CFG_SCALE or f["distill_base_steps"] != DISTILL_BASE_STEPS
                   for f in fields)):
        raise AssertionError(f"distill CLI: stage fields {fields}")
    if len(logged) != DISTILL_STAGES * DISTILL_STEPS_PER_STAGE or not all(math.isfinite(r[2]) for r in logged):
        raise AssertionError(f"distill CLI: logged steps {logged}")
    if not (unchanged(teachers[0]) and chained):
        raise AssertionError("distill CLI: a stage's teacher is not the weights it should hold")
    check_counts("distill/cli", counts, {key: DISTILL_STAGES * DISTILL_STEPS_PER_STAGE * v for key, v in expect.items()})
    del teachers
    torch.cuda.empty_cache()

    # 3. the 2-step student sampled at the requested ddpm 250 and CFG 4.0
    student = dirs[-1]
    student_args = load_config(student)
    d_student = dd.student_diffusion_from_config(student_args, device=dev)
    calls = []
    build = sample.build_sample_fn

    def spy_build(c, sd, diffusion, **kw):
        fn = build(c, sd, diffusion, **kw)
        call = dict(cfg=c, sd=sd, kw=kw, steps=diffusion.num_timesteps)
        calls.append(call)

        def run(z, y, g):
            call.update(z=z.clone(), y=y.clone())
            call["out"] = fn(z, y, g)
            return call["out"]

        return run

    out = io.StringIO()
    sample.build_sample_fn = spy_build
    try:
        with contextlib.redirect_stdout(out):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            sample.main(sample.build_parser().parse_args(
                ["--result-dir", student, "--use-vae", "false", "--block-kernel", "auto", "--sampler", "ddpm",
                 "--num-sampling-steps", str(STEPS), "--class-label", str(min(88, cfg.num_classes - 1)),
                 "--output-file", os.path.join(student, "sample.png")]))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        sample.build_sample_fn = build
    printed = out.getvalue()
    print(printed, end="")
    (call,) = calls
    rows = call["z"].shape[0]
    outs = {"auto": call["out"]}
    for path, c in (("f32", call["cfg"].replace(compute_dtype="float32", block_kernel="off")),
                    ("off", call["cfg"].replace(block_kernel="off"))):
        outs[path] = build_sample_fn(c, call["sd"], d_student, sampler="ddim", device=dev)(call["z"], call["y"], None)
    finite = bool(torch.isfinite(outs["auto"]).all())
    phase("distill", cli="sample", requested=f"ddpm-{STEPS}-cfg4.0", sampler=call["kw"]["sampler"],
          steps=call["steps"], cfg_scale=call["kw"]["cfg_scale"], rows_a_call=rows, seconds=f"{seconds:.3f}",
          finite=finite, max_abs_latent=f"{float(outs['auto'].abs().max()):.3e}",
          launches=json.dumps({key: v for key, v in counts.items() if v}))
    if "forcing --sampler ddim at its 2-step grid" not in printed or "forcing --cfg-scale 1" not in printed:
        raise AssertionError(f"distill: sample printed {printed!r}")
    if (call["kw"]["sampler"], call["steps"], call["kw"]["cfg_scale"], rows) != ("ddim", 2, None, 4) or not finite:
        raise AssertionError(f"distill: the student sampled as {call['kw']}, {call['steps']} steps, {rows} rows, "
                             f"finite {finite}")
    check_counts("distill/sample", counts, {"fused_dit_stack": 2, "dit_stack": 2})
    check_paths(torch, "distill-sample", outs, ("auto",))

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    npz = sample_fid.main(sample_fid.build_parser().parse_args(
        ["--result-dir", student, "--use-vae", "false", "--block-kernel", "auto", "--num-classes",
         str(cfg.num_classes), "--num-samples", str(DISTILL_FID_SAMPLES), "--batch-size", str(DISTILL_FID_BATCH)]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    with np.load(npz) as f:
        arr = f["arr_0"]
    batches = DISTILL_FID_SAMPLES // DISTILL_FID_BATCH
    phase("distill", cli="sample_fid", samples=DISTILL_FID_SAMPLES, batch=DISTILL_FID_BATCH, seconds=f"{seconds:.3f}",
          images_per_s=f"{DISTILL_FID_SAMPLES / seconds:.3f}", arr_0=f"{arr.dtype}{tuple(arr.shape)}",
          launches=json.dumps({key: v for key, v in counts.items() if v}))
    check_counts("distill/sample_fid", counts, {"fused_dit_stack": 2 * batches, "dit_stack": 2 * batches})
    if arr.shape[0] != DISTILL_FID_SAMPLES:
        raise AssertionError(f"distill: sample_fid wrote {arr.shape}")

    # 4. the student served; its statistics set as phase 8c sets them
    exp_s = student.rstrip("/") + "-serve"
    os.makedirs(exp_s)
    shutil.copytree(os.path.join(student, "ema"), os.path.join(exp_s, "ema"))
    shutil.copy(os.path.join(student, "constants.pt"), exp_s)
    c_, side = student_args["in_channels"], student_args["input_size"]
    student_args.update(stats_mean=[0.0] * c_, stats_std=[2.0**-SERVE_STATS_EXP] * c_)
    save_config(exp_s, student_args)
    args = serve.build_parser().parse_args(
        ["--port", "0", "--seed", str(SERVE_SEED), "--block-kernel", "auto", "--result-dir", exp_s,
         "--buckets", "1,4"])
    server, service = serve.build_server(args, serve.build_service(args))
    server.RequestHandlerClass.log_message = lambda self, fmt, *args: None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    labels = [3, 141, 592]
    try:
        with urllib.request.urlopen(base + "/info", timeout=60) as resp:
            info = json.loads(resp.read())
        torch.cuda.synchronize()
        reset_launch_counts()
        req = urllib.request.Request(base + "/v1/sample", data=json.dumps(
            {"class_labels": labels, "seed": 401, "format": "npz"}).encode())
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = resp.read()
        counts = launch_counts()
        counter = service._request_counter
        got = service.sample(labels, 20, "dpm++", 4.0, seed=401)  # the default protocol, in process: floats
        # the host preamble's z (3 rows and a zero pad row in bucket 4) and
        # chain generator through build_sample_fn on the student diffusion
        fn = build_sample_fn(sample.run_config(student_args, "auto"), sample.load_variables(exp_s, student_args),
                             d_student, sampler="ddim", batch_hint=4, device=dev)
        z = torch.cat([serve.draw(401, (3, c_, side, side), dev), torch.zeros(1, c_, side, side, device=dev)])
        y = torch.tensor(labels + [0], device=dev)

        def reference(counter_):
            want = fn(z, y, serve.generator(serve.chain_seed(SERVE_SEED, counter_), dev))[:3]
            return sample.decode_latents(want.float().cpu().numpy(), student_args, False)

        with np.load(io.BytesIO(body)) as f:
            same_http = bool(np.array_equal(f["arr_0"], to_uint8(reference(counter))))
        same = bool(np.array_equal(got, reference(service._request_counter)))
        programs = sorted(key[:4] for key in service._fns)
        finite = bool(np.isfinite(got).all() and np.abs(got).max() < 1)
        phase("distill", serve="default-protocol", programs=json.dumps(programs), distilled=json.dumps(info["distilled"]),
              npz_equals_build_sample_fn=same_http, floats_equal_build_sample_fn=same, finite_unclipped=finite,
              max_abs_served=f"{float(np.nanmax(np.abs(got))):.4e}",
              launches=json.dumps({key: v for key, v in counts.items() if v}))
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    check_counts("distill/serve", counts, {"fused_dit_stack": 2, "dit_stack": 2})
    if info["distilled"] != {"steps": 2, "rounds": 2, "baked_cfg_scale": DISTILL_CFG_SCALE}:
        raise AssertionError(f"distill: /info distilled {info['distilled']}")
    if any(key[:3] != ("ddim", 2, 1.0) for key in programs) or not (same_http and same and finite):
        raise AssertionError(f"distill: served programs {programs}, same bits {same_http} / {same}, finite {finite}")


def data_probe_phase(torch, dev, exp: str, tmp: str) -> None:
    """Phase 8e: download_data's encode on the card, the distribution probe
    (trained on mega_attn, sampled through dit_stack), the guidance sweep
    and run_fid50k on run A (module docstring)."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mapdit_tpu_torch import sample_fid
    from mapdit_tpu_torch.download_data import encode_batches, mog_stats
    from mapdit_tpu_torch.models.vae import load_encoder
    from mapdit_tpu_torch.tools import distribution_probe, guidance_sweep, run_fid50k
    from mapdit_tpu_torch.training.data import LatentDataset, save_dataset

    # 1. the encode: synthetic uint8 images through the random-weight VAE of
    # phase 8b on the card, held to the same module's f32 encode on the CPU
    vae_path = os.path.join(exp, "vae.safetensors")
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (ENCODE_IMAGES, ENCODE_SIDE, ENCODE_SIDE, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, ENCODE_IMAGES)
    batches = [(images[i:i + ENCODE_BATCH], labels[i:i + ENCODE_BATCH]) for i in range(0, ENCODE_IMAGES, ENCODE_BATCH)]
    encoder = load_encoder(vae_path, dev)
    encode_batches(encoder, batches[:1], ENCODE_BATCH, ENCODE_SIDE, SEED, dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means, stds, got_labels = encode_batches(encoder, batches, ENCODE_IMAGES, ENCODE_SIDE, SEED, dev)
    seconds = time.perf_counter() - t0
    n = ENCODE_CHECK_IMAGES
    # the flips of the first images are the stream's first draws whatever the batch
    want = encode_batches(load_encoder(vae_path, "cpu"), [(images[:n], labels[:n])], n, ENCODE_SIDE, SEED, "cpu")
    errs = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got = encode_batches(encoder, [(images[:n], labels[:n])], n, ENCODE_SIDE, SEED, dev)
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        errs[tf32] = max(rel_l2(torch.from_numpy(g), torch.from_numpy(w)) for g, w in zip(got[:2], want[:2]))
        limit = 1e-2 if tf32 else 1e-4
        phase("encode", tf32=tf32, images=n, rel_l2_err_vs_cpu=f"{errs[tf32]:.3e}", tol=f"{limit:g}")
        if not errs[tf32] <= limit:
            raise AssertionError(f"the VAE encode on the card (TF32 {tf32}) is off the CPU's by {errs[tf32]} relative")
    out_dir = os.path.join(tmp, "latents")
    save_dataset(out_dir, means, stds, got_labels, mog_stats(means, stds))
    ds = LatentDataset(out_dir)
    same = (np.array_equal(ds.means, means) and np.array_equal(ds.stds, stds) and np.array_equal(ds.labels, labels)
            and len(ds) == ENCODE_IMAGES and ds.channels == 4 and ds.data_size == ENCODE_SIDE // 8)
    finite = bool(np.isfinite(means).all() and np.isfinite(stds).all())
    phase("encode", images=ENCODE_IMAGES, batch=ENCODE_BATCH, side=ENCODE_SIDE, seconds=f"{seconds:.4f}",
          images_per_s=f"{ENCODE_IMAGES / seconds:.3f}", latents=f"{means.dtype}{means.shape}", finite=finite,
          read_back=same, stats_std=json.dumps([round(float(v), 6) for v in ds.stats["std"]]))
    if not (same and finite):
        raise AssertionError("the encoded dataset is not finite or does not read back")
    del encoder
    torch.cuda.empty_cache()

    # 2. the distribution probe at PROBE_SEEDS: each trained by the train CLI
    # in a subprocess on mega_attn (the three at once), then sampled here
    # through auto (the whole-stack kernel); the limits hold on the mean
    # over the seeds (one 600-step run's mean_err spreads 0.60-3.13 over
    # seeds on the card, PERF.md)
    def argv(seed):
        return ["--work-dir", os.path.join(tmp, f"dprobe_s{seed}"), "--device", dev.type, "--seed", str(seed),
                *PROBE_ARGS]

    def train(seed):
        args = distribution_probe.build_parser().parse_args(argv(seed))
        data = os.path.join(args.work_dir, "data")
        distribution_probe.make_data(data, args.classes, args.examples, args.input_size, seed=seed)
        return distribution_probe.run_train(args, data, os.path.join(args.work_dir, "results"))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(PROBE_SEEDS)) as pool:
        run_dirs = list(pool.map(train, PROBE_SEEDS))
    train_seconds = time.perf_counter() - t0
    steps = int(PROBE_ARGS[PROBE_ARGS.index("--num-sampling-steps") + 1])
    outs = []
    for seed, run_dir in zip(PROBE_SEEDS, run_dirs):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = distribution_probe.main([*argv(seed), "--skip-train"])
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        # two chains (trained and init), one dit_stack launch a model call
        check_counts(f"probe/seed{seed}", counts, {"fused_dit_stack": 2 * steps, "dit_stack": 2 * steps})
        log = open(os.path.join(run_dir, "log.txt")).read()
        phase("probe", seed=seed, model=out["model"], classes=out["classes"], train_steps=out["train_steps"],
              batch=out["batch_size"], sampler=out["sampler"], eval_seconds=f"{seconds:.2f}",
              **{key[: -len("_trained")]: out[key] for key in PROBE_LIMITS},
              **{f"{key[: -len('_trained')]}_init": out[key.replace("_trained", "_init")] for key in PROBE_LIMITS},
              conditioning_signal=json.dumps(out["conditioning_signal"]),
              launches=json.dumps({k: v for k, v in counts.items() if v}),
              train_steps_per_s=json.dumps([float(v) for v in re.findall(r"train steps/sec: ([0-9.]+)", log)]))
        outs.append(out)
    means = {key: float(np.mean([o[key] if o[key] is not None else np.nan for o in outs])) for key in PROBE_LIMITS}
    ok = {key: (means[key] >= limit if op == ">=" else means[key] <= limit) for key, (op, limit) in PROBE_LIMITS.items()}
    phase("probe", seeds=json.dumps(PROBE_SEEDS), train="mega_attn+pallas, bf16, the seeds' trainings at once",
          train_seconds=f"{train_seconds:.2f}", **{f"mean_{key[: -len('_trained')]}": f"{v:.6f}"
                                                   for key, v in means.items()},
          limits=json.dumps({key: f"{op}{limit:g}" for key, (op, limit) in PROBE_LIMITS.items()}), ok=all(ok.values()))
    if not all(ok.values()):
        raise AssertionError(f"the probe's trained models miss their limits on the mean over seeds: {means}")

    # 3. the guidance sweep on run A: a reference set at cfg 1 (dpm++ 20,
    # no VAE), then one sweep a point, each point a sample_fid subprocess
    torch.cuda.empty_cache()
    ref = sample_fid.main(sample_fid.build_parser().parse_args([
        "--result-dir", exp, "--use-vae", "false", "--num-samples", str(SWEEP_SAMPLES), "--batch-size",
        str(SWEEP_SAMPLES), "--num-classes", "1000", "--cfg-scale", "1.0", "--sampler", "dpm++",
        "--time-schedule", "karras", "--num-sampling-steps", str(SWEEP_STEPS), "--seed", "1", "--block-kernel", "auto",
        "--device", dev.type, "--output-file", os.path.join(tmp, "sweep_ref.npz")]))
    rows = []
    t0 = time.perf_counter()
    for scale, interval in SWEEP_POINTS:
        rows += guidance_sweep.main([
            "--result-dir", exp, "--ref-samples", ref, "--cfg-scales", scale, "--cfg-intervals", interval,
            "--num-samples", str(SWEEP_SAMPLES), "--batch-size", str(SWEEP_SAMPLES), "--steps", str(SWEEP_STEPS), "--sampler", "dpm++", "--time-schedule", "karras",
            "--features", "random-proj", "--block-kernel", "auto", "--device", dev.type,
            "--work-dir", os.path.join(tmp, "sweep"),
            "--out", os.path.join(tmp, f"sweep_{scale}.jsonl")])
    seconds = time.perf_counter() - t0
    for row in rows:
        finite = all(math.isfinite(row[k]) for k in ("fid", "kid", "kid_std", "precision", "recall"))
        phase("sweep", cfg_scale=row["cfg_scale"], cfg_interval=json.dumps(row["cfg_interval"]), fid=row["fid"],
              kid=row["kid"], kid_std=row["kid_std"], precision=row["precision"], recall=row["recall"],
              samples=SWEEP_SAMPLES, finite=finite)
        if not finite:
            raise AssertionError(f"guidance sweep: non-finite row {row}")
    phase("sweep", points=len(rows), seconds_with_subprocesses=f"{seconds:.2f}", features="random-proj")

    # 4. the FID protocol runner at FID_PROTOCOL_SAMPLES samples
    report = run_fid50k.main(["--result-dir", exp, "--num-samples", str(FID_PROTOCOL_SAMPLES), "--num-classes", "1000",
                              "--block-kernel", "auto", "--device", dev.type, "--output-file", "fid_protocol.npz"])
    phase("fid50k", samples=FID_PROTOCOL_SAMPLES, wall_seconds=f"{report['wall_seconds']:.2f}",
          peak_rss_mb=f"{report['peak_rss_kb'] / 1024:.0f}", shape=json.dumps(report["shape"]),
          fid_vs_own_stats=f"{report['fid']:.3e}")
    # no VAE: the latents as uint8 NHWC (run A's 16 x 16 x 4)
    if report["shape"] != [FID_PROTOCOL_SAMPLES, 16, 16, 4] or not math.isfinite(report["fid"]):
        raise AssertionError(f"run_fid50k: samples of shape {report['shape']}, FID {report['fid']}")


def tree_mismatch(torch, a, b, path=""):
    """The path of the first leaf where two trees of tensors and plain
    values differ (tensors bit for bit), or None."""
    if isinstance(a, torch.Tensor):
        return None if isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b) else path
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return path + " (keys)"
        return next((m for key in a if (m := tree_mismatch(torch, a[key], b[key], f"{path}/{key}")) is not None), None)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return path + " (length)"
        return next((m for i, (x, y) in enumerate(zip(a, b))
                     if (m := tree_mismatch(torch, x, y, f"{path}/{i}")) is not None), None)
    return None if a == b else path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a GPU", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "mapdit_tpu_torch")):
        print("chip_smoke: run from a checkout that holds mapdit_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from mapdit_tpu_torch.diffusion import create_diffusion
    from mapdit_tpu_torch.models import build_config, init_model
    from mapdit_tpu_torch.ops.cuda import build
    from mapdit_tpu_torch.ops.cuda import dit_block as k
    from mapdit_tpu_torch.ops.mp import mp_silu, normalize
    from mapdit_tpu_torch.runtime import build_block_stack, build_sample_fn, fold_weights_for_inference

    # 1. device
    smi = smi_line()
    print(smi, flush=True)
    phase("device", kind=json.dumps(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    t_smoke = time.perf_counter()

    def elapsed(after: str) -> None:
        phase("elapsed", after=after, seconds=f"{time.perf_counter() - t_smoke:.2f}")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}", sources=",".join(build.SOURCES),
          compiled=json.dumps({n: round(s, 2) for n, s in built.items()}))

    # 3. kernels at the S/2 sampling shapes
    dev = torch.device("cuda")
    cfg = build_config(MODEL, in_channels=4, input_size=16, num_classes=1000, compute_dtype="bfloat16")
    n, t, d, heads, depth = 2 * BATCH, cfg.num_patches, cfg.hidden_size, cfg.num_heads, cfg.depth
    hid = int(d * cfg.mlp_ratio)
    hd = d // heads
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def weight(*shape):
        return normalize(randn(*shape)).to(bf).contiguous()

    x = randn(n, t, d, dtype=bf)
    a = mp_silu(randn(n, d)).to(bf)
    gains = torch.rand(depth, 2, generator=gen, device=dev) * 0.6 + 0.2
    ws = [weight(depth, 6 * d, d), weight(depth, 3 * d, d), weight(depth, d, d), weight(depth, hid, d), weight(depth, d, hid)]
    w0 = [w[0].contiguous() for w in ws]
    mods = k.mp_gemm_plain(a, w0[0], alpha=1 / math.sqrt(d), out_dtype=f32)
    xf = x.reshape(n * t, d)
    x1 = randn(n * t, d)
    attn_in = randn(n * t, d, dtype=bf)
    h_in = mp_silu(randn(n * t, hid)).to(bf)
    g0 = gains[0]
    gemm_cases = {
        # site: (kwargs, M, N, K, bytes of the extra operands)
        "modulation": (dict(a=a, w=w0[0], alpha=1 / math.sqrt(d), out_dtype=f32), n, 6 * d, d, 0),
        "qkv": (dict(a=xf, w=w0[1], alpha=1 / math.sqrt(d), out_dtype=f32, modulate=(mods, 0, d, g0[0:1]), tokens=t),
                n * t, 3 * d, d, n * 2 * d * 4),
        "out": (dict(a=attn_in, w=w0[2], alpha=1 / math.sqrt(d), out_dtype=f32, residual=(xf, mods, 2 * d), tokens=t),
                n * t, d, d, n * d * 4 + n * t * d * 2),
        "fc1": (dict(a=x1, w=w0[3], alpha=1 / math.sqrt(d), out_dtype=bf, modulate=(mods, 3 * d, 4 * d, g0[1:2]),
                     silu=True, tokens=t), n * t, hid, d, n * 2 * d * 4),
        "fc2": (dict(a=h_in, w=w0[4], alpha=1 / math.sqrt(hid), out_dtype=bf, residual=(x1, mods, 5 * d), tokens=t),
                n * t, d, hid, n * d * 4 + n * t * d * 4),
    }
    rows = {}
    for site, (kw, m_, n_, k_, extra) in gemm_cases.items():
        a_bytes = kw["a"].numel() * kw["a"].element_size()
        out_bytes = m_ * n_ * (4 if kw["out_dtype"] == f32 else 2)
        a_bf = kw["a"].to(bf)
        rows[f"mp_gemm/{site}"] = gemm_row(
            torch, k, site, kw, (m_, n_, k_), 2 * m_ * n_ * k_, a_bytes + n_ * k_ * 2 + out_bytes + extra,
            lambda a_bf=a_bf, w=kw["w"]: torch.matmul(a_bf, w.t()), site)
    # the other paths' shapes and the ragged one: checked and timed, not in
    # the kernels line
    mp_gemm_rows(torch, k, gen, dev, [name for name in GEMM_SHAPES if name not in gemm_cases])
    elapsed("3.mp_gemm")

    case = cosine_case(torch, F, gen, dev, "cosine_attention")
    err = case.check(case.run())
    rows["cosine_attention"] = dict(
        attention_row(torch, case, "cosine_attention", COSINE_SRC, f"{PALLAS}:129"), max_abs_err=err)
    # the sampling chain runs these shapes inside dit_stack, the TP islands
    # inside dit_block_tp and P1's MLP branch inside mlp_branch now; the
    # separate launches' counts come from the path that still makes them:
    # the attention half-block's training forward (qkv, out, the attention).
    # No main path launches the modulation, fc1 or fc2 product on its own any
    # more: their rows are checked and timed, and left out of the kernels
    # line.
    for name in ("mp_gemm/qkv", "mp_gemm/out", "cosine_attention"):
        rows[name]["path"] = "mega_attn+sequence"
    for name in ("mp_gemm/modulation", "mp_gemm/fc1", "mp_gemm/fc2"):
        off_path = rows.pop(name)
        phase("time", kernel=name, ms=f"{off_path['ms']:.4f}", plain_ms=f"{off_path['plain_ms']:.4f}",
              bound_ms=f"{off_path['bound_ms']:.4f}", library_ms=off_path["library_ms"],
              note="no main path launches it; not in the kernels line")

    rows.update(train_kernel_rows(torch, F, k, gen, dev, t, d, heads, x, a, gains[0], w0))
    rows.update(standalone_kernel_rows(torch, F, gen, dev))
    elapsed("3.standalone")
    rows.update(tp_kernel_rows(torch, gen, dev))
    elapsed("3.tp")
    cosine_shape_checks(torch, F, gen, dev)
    elapsed("3.attention")
    stack = stack_rows(torch, k)
    rows["fused_dit_stack"], rows["fused_dit_block"] = stack["S2"], stack["S2:block"]
    # at 32 x 32 latents: the stack counted on phase 5d's mega_stack bench
    # run, the block on phase 6c's mega train path
    rows["fused_dit_stack:t256"] = dict(stack["S2:T256"], count_from=(T256_BENCH, "fused_dit_stack"))
    rows["fused_dit_block:t256"] = dict(stack["S2:T256:block"], path="t256/mega", count_key="fused_dit_block")
    elapsed("3.stack")
    # the f32 forms, on draws of their own; phase 6d's float32 paths count
    # their launches: the sample CLI's mega_stack chain, the train CLI's mega
    # steps, and the f32 launch sequence as the stack's route
    gen32 = torch.Generator(device=dev).manual_seed(SEED + 30)
    f32_gemm = f32_gemm_rows(torch, k, gen32, dev)
    f32_cos = f32_cosine_rows(torch, F, k, gen32, dev)
    f32_stack = f32_stack_rows(torch, k)
    rows["fused_dit_stack:f32"] = dict(f32_stack["S2"], path="f32/sample-cli", count_key="fused_dit_stack")
    rows["fused_dit_block:f32"] = dict(f32_stack["S2:block"], path="f32/train-cli", count_key="fused_dit_block")
    rows["mp_gemm:f32"] = dict(f32_gemm["block"], path="f32/mega_stack+sequence", count_key="mp_gemm")
    rows["cosine_attention:f32"] = dict(f32_cos["cosine_attention:f32"], path="f32/mega_stack+sequence",
                                        count_key="cosine_attention")
    # the attention half-block's f32 forms: rows 3, 5 and 4 (their launches
    # from phase 6e's f32 mega_attn paths) and their launch sequences' own
    # kernels (from phase 6e's f32 sequence path)
    rows.update(f32_branch_rows(torch, dev))
    rows.update(f32_part_rows(torch, F, dev))
    # the f32 forms of csrc/dit_block_tp.cu: rows 6-8 (their launches from
    # phase 10's f32 island chains) and row 9 (from phase 6f's f32 pallas step)
    rows.update(f32_tp_rows(torch, dev))
    elapsed("3.f32")
    for name, row in rows.items():
        phase("time", kernel=name, ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
              bound_ms=f"{row['bound_ms']:.4f}", bound_by=row["bound_by"], library_ms=row["library_ms"])

    # 4. full DiT-S/2 forward_with_cfg: kernel paths against the plain path
    model = init_model(cfg, seed=SEED, device=dev)
    with torch.no_grad():
        # gains start at 0 in the reference; draw them so the modulate and
        # residual mixing the kernels fuse is exercised
        for blk in model.blocks:
            blk.gain_msa.uniform_(0.2, 0.8, generator=gen)
            blk.gain_mlp.uniform_(0.2, 0.8, generator=gen)
    sd = model.state_dict()
    folded_cfg = cfg.replace(fold_weights=True)
    fsd = fold_weights_for_inference(sd, folded_cfg)
    ref_cfg = folded_cfg.replace(compute_dtype="float32")
    paths = {}
    for name, c in (("f32", ref_cfg), ("off", folded_cfg), ("mega", folded_cfg.replace(block_kernel="mega"))):
        m = init_model(c, seed=SEED, device=dev)
        m.load_state_dict(fsd)
        paths[name] = m
    zf = randn(n, 4, 16, 16)
    tf = torch.full((n,), 500.0, device=dev)
    yf = torch.cat([torch.randint(0, 1000, (BATCH,), generator=gen, device=dev), torch.full((BATCH,), 1000, device=dev)])
    with torch.no_grad():
        outs = {name: m.forward_with_cfg(zf, tf, yf, CFG_SCALE) for name, m in paths.items()}
        outs["mega_stack"] = paths["off"].forward_with_cfg(
            zf, tf, yf, CFG_SCALE, block_stack=build_block_stack(fsd, folded_cfg))
    check_paths(torch, "forward", outs, ("mega", "mega_stack"))

    # 5. chains: a short clipped chain on every path, then the headline
    z = randn(2 * BATCH, 4, 16, 16)
    short = create_diffusion("10", device=dev)
    outs = {}
    for name, c, hint in (("f32", cfg.replace(compute_dtype="float32"), None), ("off", cfg, None),
                          ("auto+hint", cfg.replace(block_kernel="auto"), BATCH)):
        fn = build_sample_fn(c, sd, short, cfg_scale=CFG_SCALE, clip_denoised=True, batch_hint=hint, device=dev)
        outs[name] = fn(z, yf, torch.Generator(device=dev).manual_seed(SEED + 1))
    check_paths(torch, "chain-10", outs, ("auto+hint",))

    diffusion = create_diffusion(str(STEPS), device=dev)
    sample = build_sample_fn(cfg.replace(block_kernel="auto"), sd, diffusion, cfg_scale=CFG_SCALE, batch_hint=BATCH,
                             device=dev)
    if sample.run_cfg.block_kernel != "mega_stack":
        raise AssertionError(f"auto with a batch hint resolved to {sample.run_cfg.block_kernel}, not mega_stack")
    sample(z, yf, torch.Generator(device=dev).manual_seed(SEED + 2))  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = sample(z, yf, torch.Generator(device=dev).manual_seed(SEED + 3))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(k.LAUNCHES)
    finite = bool(torch.isfinite(out).all())
    phase("chain", model=MODEL, batch=f"{BATCH}x2", steps=STEPS, seconds=f"{seconds:.4f}",
          steps_per_s=f"{STEPS / seconds:.3f}", ms_per_model_call=f"{1e3 * seconds / STEPS:.4f}",
          finite=finite, shape=tuple(out.shape), launches=json.dumps(launches))
    if not finite:
        # untrained weights at clip_denoised=False can leave the data range;
        # the finiteness check then runs on a clipped short chain
        fn = build_sample_fn(cfg.replace(block_kernel="auto"), sd, short, cfg_scale=CFG_SCALE, clip_denoised=True,
                             batch_hint=BATCH, device=dev)
        finite = bool(torch.isfinite(fn(z, yf, torch.Generator(device=dev).manual_seed(SEED))).all())
        phase("chain", note="non-finite at clip_denoised=False; 10-step clip_denoised=True chain", finite=finite)
        if not finite:
            raise AssertionError("the sampling chain gives non-finite latents")
    # one dit_stack launch a model call, and no per-block mp_gemm or
    # cosine_attention launch
    check_counts("chain", launches, {"fused_dit_stack": STEPS, "dit_stack": STEPS})

    block_chain = build_sample_fn(cfg.replace(block_kernel="auto"), sd, short, cfg_scale=CFG_SCALE, device=dev)
    if block_chain.run_cfg.block_kernel != "auto":
        raise AssertionError("without a batch hint auto must stay per-block")
    reset_launch_counts()
    out_b = block_chain(z, yf, torch.Generator(device=dev).manual_seed(SEED + 4))
    torch.cuda.synchronize()
    block_launches = dict(k.LAUNCHES)
    phase("chain-per-block", steps=10, finite=bool(torch.isfinite(out_b).all()), launches=json.dumps(block_launches))
    check_counts("chain-per-block", block_launches, {"fused_dit_block": 10 * depth, "dit_stack": 10 * depth})
    elapsed("5")

    # 5b. the other samplers, limited-interval guidance, dynamic
    # thresholding and span caching on the same weights
    sampler_phase(torch, dev, cfg, sd, z, yf, STEPS / seconds)
    elapsed("5b")
    # 5c. parallel-in-time ddim on the same weights, 5d. the bench's flags
    pit_limit = pit_phase(torch, dev, cfg, sd, z, yf)
    elapsed("5c")
    bench_counts = bench_phase(torch, dev)
    elapsed("5d")

    # 6. train
    del model, paths, sample, block_chain, outs
    torch.cuda.empty_cache()
    train_launches = s2_train_phase(torch, dev, cfg)
    elapsed("6")
    # 6b. remat at DiT-XL/2, the scan_blocks layout at DiT-S/2
    train_launches.update(remat_scan_phase(torch, dev, cfg))
    torch.cuda.empty_cache()
    elapsed("6b")

    # 6c. DiT-S/2 training at 32 x 32 latents
    train_launches.update(t256_train_phase(torch, dev, cfg))
    torch.cuda.empty_cache()
    elapsed("6c")

    # 6d. float32 on the whole-block kernels: the train CLI, the sample CLI,
    # the chains and the bench
    train_launches.update(f32_phase(torch, dev, cfg))
    torch.cuda.empty_cache()
    elapsed("6d")

    # 6e. float32 on the attention half-block kernels: the checked steps, the
    # train CLI on mega_attn, the sample CLI on mega_attn, T = 256
    train_launches.update(f32_attn_phase(torch, dev, cfg))
    torch.cuda.empty_cache()
    elapsed("6e")

    # 6f. float32 on row 9 (pallas): the checked step, the train CLI and the
    # sample CLI on pallas
    train_launches.update(f32_pallas_phase(torch, dev, cfg))
    torch.cuda.empty_cache()
    elapsed("6f")

    # 7. the flag families at DiT-B/2
    family_launches = {T256_BENCH: bench_counts["ddpm-50-input-32-mega-stack"]}
    for tag, (flags, kernels) in FAMILIES.items():
        family_launches.update(family_phase(torch, dev, tag, flags, kernels))
    elapsed("7")

    # 8. the training entry point, 8b. the sampling entry points on its run A,
    # 8c. the server on it, 8d. its progressive distillation, 8e. the data
    # path, the distribution probe and the tools that read samples
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mapdit_smoke_") as tmp:
        cli_launches, exp_a = train_cli_phase(torch, dev, tmp)
        train_launches.update(cli_launches)
        elapsed("8")
        sample_cli_phase(torch, dev, exp_a)
        elapsed("8b")
        serve_phase(torch, dev, exp_a)
        elapsed("8c")
        torch.cuda.empty_cache()
        distill_phase(torch, dev, exp_a, tmp, train_launches)
        elapsed("8d")
        torch.cuda.empty_cache()
        data_probe_phase(torch, dev, exp_a, tmp)
        elapsed("8e")

        # 9. DiT-XL/2 on one card, 10. the tensor-parallel islands and the
        # data-parallel layouts (sample_fid on run A) on two ranks
        torch.cuda.empty_cache()
        refs = xl_phase(torch, dev)
        elapsed("9")
        family_launches.update(tp_phase(torch, dict(refs, exp=exp_a, pit_limit=pit_limit)))
        elapsed("10")
        # 10b. data-parallel and fully-sharded training on the two ranks, and
        # the train CLI under torchrun; its S/2 steps' launches join phase 6's
        torch.cuda.empty_cache()
        dp_counts = dp_train_phase(torch, dev, tmp)
        train_launches["mega_attn+pallas"] = {
            key: v + dp_counts.get(key, 0) for key, v in train_launches["mega_attn+pallas"].items()}
        elapsed("10b")
        # 10c. the server on the two ranks, data- and tensor-parallel, and the
        # plain path's tensor parallelism
        torch.cuda.empty_cache()
        family_launches.update(mesh_serve_phase(torch, dev, exp_a, tmp))
        elapsed("10c")
        # 10d. tensor-parallel training on the two ranks, and the train CLI
        # under torchrun on a (2, 2) mesh
        torch.cuda.empty_cache()
        tp_train_phase(torch, dev, tmp)
        elapsed("10d")

    # 11. report
    kernels = []
    for name, row in rows.items():
        path, count_from = row.pop("path", None), row.pop("count_from", None)
        count_key = row.pop("count_key", name)
        if count_from is not None:
            count = family_launches[count_from[0]][count_from[1]]
        elif path is not None:
            count = train_launches[path][count_key]
        else:
            count = block_launches[name] if name == "fused_dit_block" else launches[name]
        if count == 0:
            raise AssertionError(f"{name}: not launched on the path that the report names")
        kernels.append(dict(name=name, route="cuda", source=row.pop("source"), replaces=row.pop("replaces"),
                            launches=count, **row))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
