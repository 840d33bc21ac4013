"""Benchmarks of the port on one GPU: denoise steps/s (sample) or train steps/s.

    python -m mapdit_tpu_torch.bench [--mode sample] [--model DiT-S/2] [--batch 32] [--steps 250]
                                     [--dtype bfloat16] [--block-kernel auto]
    python -m mapdit_tpu_torch.bench --mode train [--batch 32] [--steps 250] [--resident-data]
                                     [--block-kernel mega_attn] [--attn-bwd pallas]

Sample mode is the protocol of the JAX package's ``bench.py`` sample mode:
4x16x16 latents, 1000 classes, random weights drawn from seed 0 and folded,
batched CFG at scale 1.5 over batch x 2 rows through the half-CFG chain, the
respaced DDPM chain of ``--steps`` steps, ``block_kernel`` resolved with the
batch as hint; ``value`` is the best of ``--repeats`` timed chains after one
warm-up chain. Train mode is its ``bench_train``: synthetic VAE-posterior
latents (1000 classes), Adam(0.9, 0.99) under warmup_flat_invsqrt(1e-2,
100, 1000), two EMAs, one warm-up step, then max(``--steps``, 10) timed
steps; ``--resident-data`` reuses one device-resident batch;
``--profile-dir`` then traces a few more steps with ``torch.profiler`` and
writes the device-time table there (the timed steps run untraced). Each mode
prints one JSON line with ``metric``, ``value``, ``unit`` and ``mfu_pct``
against the H100's 989 TFLOP/s dense bf16 peak (train: 3x the forward's
matrix-product FLOPs; the backward's recompute is not counted as useful
work).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time

import torch

from mapdit_tpu_torch.diffusion import create_diffusion
from mapdit_tpu_torch.models import build_config, init_model
from mapdit_tpu_torch.runtime import build_sample_fn

H100_BF16_FLOPS = 989e12  # dense, H100 SXM data sheet
CFG_SCALE = 1.5


def model_call_flops(cfg, rows: int) -> int:
    """Matrix-product FLOPs of one model call on ``rows`` samples: the block
    stack (the count of ``mapdit_tpu/ops/pallas/dit_block.py:2024-2029``)
    plus the layers outside it."""
    d, t, depth = cfg.hidden_size, cfg.num_patches, cfg.depth
    h = int(d * cfg.mlp_ratio)
    hd = d // cfg.num_heads
    p2c = cfg.patch_size**2 * cfg.in_channels
    blocks = depth * (2 * rows * d * 6 * d + 2 * rows * t * d * (3 * d + d + 2 * h) + 4 * rows * cfg.num_heads * t * t * hd)
    x_embed = 2 * rows * t * (p2c + 1) * d
    t_embed = 2 * rows * (256 * d + d * d)
    final = 2 * rows * d * 2 * d + 2 * rows * t * d * 2 * p2c + 2 * 2 * rows * d * 8
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
        profile = _profile_train(args.profile_dir, lambda: step_fn(state, next(batches)))
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms_per_step"] / (1e3 / value)
    return {
        "metric": "train_steps_per_sec",
        "value": value,
        "unit": f"steps/s ({args.model}, batch {args.batch}" + (", resident-data" if args.resident_data else "")
                + f", {args.dtype}, block_kernel {args.block_kernel}"
                + (f", attn_bwd {args.attn_bwd}" if args.block_kernel == "mega_attn" else "") + ")",
        "mfu_pct": 100.0 * 3 * model_call_flops(cfg, args.batch) * value / H100_BF16_FLOPS,
        "seconds": elapsed,
        "last_loss": loss,
        "profile": profile,
        "device": _device_info(),
    }


def _profile_train(out_dir: str, step, steps: int = 3) -> dict:
    """Trace ``steps`` train steps with torch.profiler (CPU + CUDA): write
    the table of device time by op and kernel to
    ``out_dir/train_key_averages.txt`` and return the traced wall ms per
    step, the device-busy ms per step (the kernels' and copies' own time;
    one stream, so they do not overlap) and the kernels with the most
    device time. The caller sets the idle share against the untraced step
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = prof.key_averages()
    with open(os.path.join(out_dir, "train_key_averages.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    # device-side events only: a CPU op's row repeats its kernels' time
    kernels = sorted(
        (
            (e.key, e.self_device_time_total)
            for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0
        ),
        key=lambda kv: -kv[1],
    )
    busy_us = sum(us for _, us in kernels)
    return {
        "steps": steps,
        "traced_wall_ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "top_kernels_ms_per_step": {name[:120]: us / 1e3 / steps for name, us in kernels[:15]},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["sample", "train"], default="sample")
    p.add_argument("--model", default="DiT-S/2")
    p.add_argument("--batch", type=int, default=32, help="pre-CFG samples (sample) or the train batch")
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--block-kernel", choices=["auto", "mega", "mega_attn", "mega_stack", "off"], default="auto")
    p.add_argument("--attn-bwd", choices=["pallas", "residual", "reference"], default="pallas",
                   help="train mode with --block-kernel mega_attn: the attention half-block's VJP")
    p.add_argument("--resident-data", action="store_true",
                   help="train mode: reuse one device-resident batch (no per-step host upload)")
    p.add_argument("--profile-dir", default=None,
                   help="train mode: trace a few steps with torch.profiler first and write the table here")
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)

    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark measures a GPU and none is available")
    cfg = build_config(args.model, in_channels=4, input_size=16, num_classes=1000, compute_dtype=args.dtype,
                       block_kernel=args.block_kernel, attn_bwd=args.attn_bwd)
    if args.mode == "train":
        print(json.dumps(bench_train(args, cfg, device)))
        return 0
    model = init_model(cfg, seed=0, device=device)
    diffusion = create_diffusion(str(args.steps), device=device)
    sample = build_sample_fn(cfg, model.state_dict(), diffusion, cfg_scale=CFG_SCALE, batch_hint=args.batch,
                             device=device)
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
    mfu = 100.0 * model_call_flops(cfg, 2 * n) * args.steps / best / H100_BF16_FLOPS
    print(json.dumps({
        "metric": "denoise_steps_per_sec_per_gpu",
        "value": value,
        "unit": f"DDPM steps/s ({args.model}, batch {n}x2 CFG, {args.steps} respaced steps, {args.dtype}, "
                f"block_kernel {sample.run_cfg.block_kernel})",
        "mfu_pct": mfu,
        "chain_seconds": times,
        "device": _device_info(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
