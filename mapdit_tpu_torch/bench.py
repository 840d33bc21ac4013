"""Headline sampling benchmark of the port: denoise steps per second on one GPU.

    python -m mapdit_tpu_torch.bench [--model DiT-S/2] [--batch 32] [--steps 250]
                                     [--dtype bfloat16] [--block-kernel auto]

The protocol of the JAX package's ``bench.py`` sample mode: 4x16x16 latents,
1000 classes, random weights drawn from seed 0 and folded, batched CFG at
scale 1.5 over batch x 2 rows through the half-CFG chain, the respaced DDPM
chain of ``--steps`` steps, ``block_kernel`` resolved with the batch as hint.
Prints one JSON line with ``metric``, ``value`` (steps/s, best of
``--repeats`` timed chains after one warm-up chain), ``unit`` and
``mfu_pct`` against the H100's 989 TFLOP/s dense bf16 peak. Train mode is
not ported yet.
"""

from __future__ import annotations

import argparse
import json
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="DiT-S/2")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--block-kernel", choices=["auto", "mega", "mega_stack", "off"], default="auto")
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)

    device = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("the benchmark measures a GPU and none is available")
    cfg = build_config(args.model, in_channels=4, input_size=16, num_classes=1000, compute_dtype=args.dtype,
                       block_kernel=args.block_kernel)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "metric": "denoise_steps_per_sec_per_gpu",
        "value": value,
        "unit": f"DDPM steps/s ({args.model}, batch {n}x2 CFG, {args.steps} respaced steps, {args.dtype}, "
                f"block_kernel {sample.run_cfg.block_kernel})",
        "mfu_pct": mfu,
        "chain_seconds": times,
        "device": {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "nvidia_smi": smi},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
