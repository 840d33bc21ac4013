"""Benchmarks of the port on one GPU: denoise steps/s (sample) or train steps/s.

    python -m mapdit_tpu_torch.bench [--mode sample] [--model DiT-S/2] [--batch 32] [--steps 250]
                                     [--dtype bfloat16] [--block-kernel auto]
    python -m mapdit_tpu_torch.bench --mode train [--batch 32] [--steps 250] [--resident-data]
                                     [--block-kernel mega_attn] [--attn-bwd pallas]
    python -m mapdit_tpu_torch.bench --model DiT-B/2 --block-kernel pallas --attention-impl pallas
    python -m mapdit_tpu_torch.bench --model DiT-B/2 --modulation rotation_scale --attention-impl pallas \
                                     --block-kernel off [--no-use-cosine-attention ...]
    torchrun --nproc-per-node 2 -m mapdit_tpu_torch.bench --model DiT-XL/2 --batch 4 --n-model 2

``--modulation``, ``--attention-impl`` and one ``--no-use-<flag>`` switch per
``use_*`` flag of the config select the model family in both modes. Under
``torchrun`` sample mode runs ``build_sample_fn(mesh=)`` on a mesh of every
rank with ``--n-model`` ranks on its model axis (the tensor-parallel
islands; ``auto`` resolves to ``mega_tp`` where the widths split); rank 0
prints the line. Ranks that share a card talk over gloo, through host
memory.

Sample mode is the protocol of the JAX package's ``bench.py`` sample mode:
4x16x16 latents, 1000 classes, random weights drawn from seed 0 and folded,
batched CFG at scale 1.5 over batch x 2 rows through the half-CFG chain, the
respaced DDPM chain of ``--steps`` steps, ``block_kernel`` resolved with the
batch as hint; ``value`` is the best of ``--repeats`` timed chains after one
warm-up chain. Train mode is its ``bench_train``: synthetic VAE-posterior
latents (1000 classes), Adam(0.9, 0.99) under warmup_flat_invsqrt(1e-2,
100, 1000), two EMAs, one warm-up step, then max(``--steps``, 10) timed
steps; ``--resident-data`` reuses one device-resident batch;
``--profile-dir`` then traces a few more steps (in sample mode: one 10-step
chain) with ``torch.profiler`` and writes the device-time table there (the
timed steps and chains run untraced). Each mode
prints one JSON line with ``metric``, ``value``, ``unit`` and ``mfu_pct``
against the H100's 989 TFLOP/s dense bf16 peak (train: 3x the forward's
matrix-product FLOPs; the backward's recompute is not counted as useful
work).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import time

import torch

from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.models.blocks import modulation_dims
from mapdit_tpu_torch.models.config import ATTENTION_IMPLS, BLOCK_KERNELS, MODULATION_KINDS, DiTConfig
from mapdit_tpu_torch.runtime import build_sample_fn

H100_BF16_FLOPS = 989e12  # dense, H100 SXM data sheet
CFG_SCALE = 1.5


def model_call_flops(cfg, rows: int) -> int:
    """Matrix-product FLOPs of one model call on ``rows`` samples: the block
    stack (the count of ``mapdit_tpu/ops/pallas/dit_block.py:2024-2029``)
    plus the layers outside it. The modulation heads follow
    ``modulation_dims`` (6D rows a block for adaln, 5D for rotation_scale,
    3D for rotation, its angles being D/2 wide); the ones column
    of ``x_embedder`` and the output scales exist only in their families."""
    d, t, depth = cfg.hidden_size, cfg.num_patches, cfg.depth
    h = int(d * cfg.mlp_ratio)
    hd = d // cfg.num_heads
    p2c = cfg.patch_size**2 * cfg.in_channels
    mod_rows = 2 * sum(modulation_dims(cfg, with_gate=True))
    blocks = depth * (2 * rows * d * mod_rows + 2 * rows * t * d * (3 * d + d + 2 * h) + 4 * rows * cfg.num_heads * t * t * hd)
    x_embed = 2 * rows * t * (p2c + int(cfg.use_weight_normalization)) * d
    t_embed = 2 * rows * (256 * d + d * d)
    n_out = 2 if cfg.learn_sigma else 1
    final = 2 * rows * d * sum(modulation_dims(cfg, with_gate=False)) + 2 * rows * t * d * n_out * p2c
    if cfg.mp_style:
        final += n_out * 2 * rows * d * 8
    return blocks + x_embed + t_embed + final


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _device_info() -> dict:
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "nvidia_smi": _smi()}


def bench_train(args, cfg, device) -> dict:
    """Train steps/s at ``args.batch`` (the JAX package's ``bench_train``)."""
    from mapdit_tpu_torch.training import (
        SyntheticLatentDataset,
        create_optimizer,
        create_train_state,
        make_train_step,
        warmup_flat_invsqrt,
    )

    diffusion = create_diffusion("", device=device)
    ds = SyntheticLatentDataset(num_examples=max(1024, 2 * args.batch), num_classes=1000, size=16)
    tx = create_optimizer(warmup_flat_invsqrt(1e-2, 100, 1000))
    step_fn = make_train_step(cfg, diffusion, tx, stats_mean=ds.stats["mean"], stats_std=ds.stats["std"])
    state = create_train_state(cfg, tx, seed=0, device=device)
    batches = ds.batches(batch_size=args.batch, seed=0)
    if args.resident_data:
        fixed = {k: torch.as_tensor(v).to(device) for k, v in next(batches).items()}
        batches = itertools.repeat(fixed)

    metrics = step_fn(state, next(batches))  # warm-up: builds the kernels
    torch.cuda.synchronize()
    n_steps = max(args.steps, 10)
    start = time.perf_counter()
    for _ in range(n_steps):
        metrics = step_fn(state, next(batches))
    loss = float(metrics["loss"])
    elapsed = time.perf_counter() - start
    value = n_steps / elapsed
    profile = None
    if args.profile_dir:
        profile = _profile(args.profile_dir, lambda: step_fn(state, next(batches)), "train_key_averages.txt")
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms_per_step"] / (1e3 / value)
    return {
        "metric": "train_steps_per_sec",
        "value": value,
        "unit": f"steps/s ({args.model}, batch {args.batch}" + (", resident-data" if args.resident_data else "")
                + f", {args.dtype}, block_kernel {args.block_kernel}"
                + (f", attn_bwd {args.attn_bwd}" if args.block_kernel == "mega_attn" else "") + _family(cfg) + ")",
        "mfu_pct": 100.0 * 3 * model_call_flops(cfg, args.batch) * value / H100_BF16_FLOPS,
        "seconds": elapsed,
        "last_loss": loss,
        "profile": profile,
        "device": _device_info(),
    }


def _family(cfg) -> str:
    """The non-default family switches of ``cfg``, for a result's unit."""
    off = [name for name, value in cfg.flags_dict().items() if value is False]
    parts = ([f"modulation {cfg.modulation}"] if cfg.modulation != "adaln" else []) + (
        [f"attention_impl {cfg.attention_impl}"] if cfg.attention_impl != "auto" else []) + (
        ["off: " + " ".join(off)] if off else [])
    return "".join(", " + part for part in parts)


def _profile(out_dir: str, call, table: str, calls: int = 3, steps_per_call: int = 1) -> dict:
    """Trace ``calls`` calls of ``call`` (a train step, or a chain of
    ``steps_per_call`` denoise steps) with torch.profiler (CPU + CUDA):
    write the table of device time by op and kernel to ``out_dir/<table>``
    and return the traced wall ms per step, the device-busy ms per step (the
    kernels' and copies' own time; one stream, so they do not overlap), the
    device launches per step (kernels, copies and fills) and the kernels
    with the most device time. The caller sets the idle share against the
    untraced step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    steps = calls * steps_per_call
    events = prof.key_averages()
    with open(os.path.join(out_dir, table), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    # device-side events only: a CPU op's row repeats its kernels' time
    device = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    kernels = sorted(((e.key, e.self_device_time_total) for e in device), key=lambda kv: -kv[1])
    busy_us = sum(us for _, us in kernels)
    return {
        "steps": steps,
        "traced_wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_launches_per_step": sum(e.count for e in device) / steps,
        "top_kernels_ms_per_step": {name[:120]: us / 1e3 / steps for name, us in kernels[:15]},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["sample", "train"], default="sample")
    p.add_argument("--model", default="DiT-S/2")
    p.add_argument("--batch", type=int, default=32, help="pre-CFG samples (sample) or the train batch")
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--block-kernel", choices=list(BLOCK_KERNELS), default="auto")
    p.add_argument("--modulation", choices=list(MODULATION_KINDS), default="adaln")
    p.add_argument("--attention-impl", choices=list(ATTENTION_IMPLS), default="auto")
    use_flags = [f.name for f in dataclasses.fields(DiTConfig) if f.name.startswith("use_")]
    for name in use_flags:
        p.add_argument("--no-" + name.replace("_", "-"), dest=name, action="store_false",
                       help=f"turn {name} off (default on)")
    p.add_argument("--attn-bwd", choices=["pallas", "residual", "reference"], default="pallas",
                   help="train mode with --block-kernel mega_attn: the attention half-block's VJP")
    p.add_argument("--resident-data", action="store_true",
                   help="train mode: reuse one device-resident batch (no per-step host upload)")
    p.add_argument("--profile-dir", default=None,
                   help="trace a few train steps (or one 10-step chain) with torch.profiler after the timed "
                        "ones and write the table here")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--n-model", type=int, default=1,
                   help="sample mode under torchrun: ranks on the mesh's model axis (the data axis takes the rest)")
    args = p.parse_args(argv)

    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark measures a GPU and none is available")
    mesh, rank = None, 0
    if "RANK" in os.environ and args.mode == "sample":
        from mapdit_tpu_torch.parallel import init_distributed, make_mesh

        device = init_distributed()
        mesh = make_mesh(n_model=args.n_model, device=device)
        rank = mesh.rank
    elif args.n_model > 1:
        raise SystemExit("--n-model > 1 runs in sample mode under torchrun --nproc-per-node N")
    cfg = build_config(args.model, in_channels=4, input_size=16, num_classes=1000, compute_dtype=args.dtype,
                       block_kernel=args.block_kernel, attn_bwd=args.attn_bwd, modulation=args.modulation,
                       attention_impl=args.attention_impl, **{name: getattr(args, name) for name in use_flags})
    if args.mode == "train":
        print(json.dumps(bench_train(args, cfg, device)))
        return 0
    model = init_model(cfg, seed=0, device=device)
    diffusion = create_diffusion(str(args.steps), device=device)
    sample = build_sample_fn(cfg, model.state_dict(), diffusion, cfg_scale=CFG_SCALE, batch_hint=args.batch,
                             device=device, mesh=mesh)
    n = args.batch
    gen = torch.Generator(device=device).manual_seed(0)
    z = torch.randn(2 * n, 4, 16, 16, generator=gen, device=device)
    y = torch.cat([torch.randint(0, 1000, (n,), generator=gen, device=device), torch.full((n,), 1000, device=device)])

    sample(z, y, torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    times = []
    for i in range(args.repeats):
        start = time.perf_counter()
        sample(z, y, torch.Generator(device=device).manual_seed(2 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    best = min(times)
    value = args.steps / best
    profile = None
    if args.profile_dir:
        short = build_sample_fn(cfg, model.state_dict(), create_diffusion("10", device=device), cfg_scale=CFG_SCALE,
                                batch_hint=args.batch, device=device, mesh=mesh)
        short(z, y, torch.Generator(device=device).manual_seed(1))
        if rank == 0:
            profile = _profile(args.profile_dir, lambda: short(z, y, torch.Generator(device=device).manual_seed(1)),
                               "sample_key_averages.txt", calls=1, steps_per_call=10)
            profile["device_idle_share"] = 1.0 - profile["device_busy_ms_per_step"] / (1e3 / value)
        else:  # the other ranks run the traced chain's collectives
            short(z, y, torch.Generator(device=device).manual_seed(1))
    # a mesh's ranks may share cards: the peak is that of the cards they use
    cards = 1 if mesh is None else min(mesh.size, torch.cuda.device_count())
    mfu = 100.0 * model_call_flops(cfg, 2 * n) * args.steps / best / (cards * H100_BF16_FLOPS)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if rank != 0:
        return 0
    print(json.dumps({
        "metric": "denoise_steps_per_sec_per_gpu",
        "value": value,
        "unit": f"DDPM steps/s ({args.model}, batch {n}x2 CFG, {args.steps} respaced steps, {args.dtype}, "
                f"block_kernel {sample.run_cfg.block_kernel}{_family(cfg)}"
                + ("" if mesh is None else f", mesh ({mesh.n_data}, {mesh.n_model}) over {cards} card(s)") + ")",
        "mfu_pct": mfu,
        "chain_seconds": times,
        "profile": profile,
        "device": _device_info(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
