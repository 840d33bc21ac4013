"""Batched class-conditional sampling for FID evaluation, port of the JAX
package's ``sample_fid.py``.

    python -m mapdit_tpu_torch.sample_fid --result-dir results/000-DiT-S-2 --vae-path vae.safetensors \\
        --num-samples 10000 --batch-size 128

Writes ``<result-dir>/fid_samples/<output-file>``, a uint8 NHWC ``.npz``
(key ``arr_0``, the ADM evaluator's format) of ``--num-samples`` images.
CFG runs only when ``--cfg-scale`` is above 1. On one device: every batch's
latents, labels and step noise come from one ``torch.Generator`` seeded
with ``--seed``, in that order. Progress is printed a batch a line.

A distilled student (``mapdit_tpu_torch.distill``) samples on its own
nested DDIM grid at cfg 1 (guidance baked, no doubling), as in the JAX
script; ``--cfg-interval`` is refused for it.

``--n-model > 1``, ``--kernel-sharding shard_map`` and ``--pit-window > 0``
are the multi-device layouts and raise, naming the ROADMAP item "Multi-GPU
layouts, the rest".
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
from mapdit_tpu_torch.diffusion.distill import student_diffusion_from_config
from mapdit_tpu_torch.runtime import build_sample_fn
from mapdit_tpu_torch.sample import (
    _bool, add_common_flags, cfg_batch, check_experiment, decode_latents, load_variables, run_config, vae_decoder,
)
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.image import to_uint8


def _check_ported(args) -> None:
    if args.n_model > 1 or args.kernel_sharding == "shard_map" or args.pit_window:
        raise NotImplementedError(
            "--n-model > 1, --kernel-sharding shard_map and --pit-window are the multi-device sampling layouts "
            "(ROADMAP item 'Multi-GPU layouts, the rest'); the port samples FID batches on one device"
        )


def main(args) -> str:
    """Write the npz; returns its path."""
    _check_ported(args)
    device = resolve_device(args.device)
    train_args = check_experiment(args.result_dir)
    cfg = run_config(train_args, args.block_kernel)
    sd = load_variables(args.result_dir, train_args, args.ckpt, args.ema_std)
    if train_args.get("distill_rounds"):
        diffusion = student_diffusion_from_config(train_args, device=device)
        if args.sampler != "ddim" or args.cfg_scale > 1.0:
            print(f"distilled student: forcing ddim at its {diffusion.num_timesteps}-step grid, cfg 1 (guidance baked)")
        args.sampler, args.cfg_scale = "ddim", 1.0
        if args.cfg_interval is not None:
            raise ValueError("--cfg-interval does not apply to distilled students")
    else:
        diffusion = create_diffusion(
            respacing_string(args.num_sampling_steps, args.sampler, args.time_schedule), device=device)
    use_cfg = args.cfg_scale > 1.0
    n = args.batch_size
    sample_fn = build_sample_fn(
        cfg, sd, diffusion, cfg_scale=args.cfg_scale if use_cfg else None, sampler=args.sampler, eta=args.eta,
        cfg_interval=tuple(args.cfg_interval) if args.cfg_interval else None, clip_denoised=args.clip_denoised,
        batch_hint=n, dynamic_threshold=args.dynamic_threshold, device=device,
    )
    decoder = vae_decoder(args, device)

    gen = torch.Generator(device=device).manual_seed(args.seed if args.seed is not None else 0)
    n_batches = math.ceil(args.num_samples / n)
    gathered, t0 = [], time.perf_counter()
    for i in range(n_batches):
        z = torch.randn((n, train_args["in_channels"], train_args["input_size"], train_args["input_size"]),
                        generator=gen, device=device)
        y = torch.randint(0, args.num_classes, (n,), generator=gen, device=device)
        if use_cfg:
            z, y = cfg_batch(z, y, args.num_classes)
        samples = sample_fn(z, y, gen)[:n].cpu().numpy()
        samples = decode_latents(samples, train_args, decoder is not None, decoder=decoder, device=device)
        gathered.append(to_uint8(samples))
        print(f"[sample_fid] batch {i + 1}/{n_batches}, {(i + 1) * n} images, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    samples = np.concatenate(gathered, axis=0)[: args.num_samples]
    out_dir = os.path.join(args.result_dir, "fid_samples")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, args.output_file)
    np.savez(path, arr_0=samples)
    return path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(parser)
    parser.add_argument("--cfg-scale", type=float, default=1.5)
    parser.add_argument("--num-classes", type=int, default=1_000)
    parser.add_argument("--num-samples", type=int, default=10_000)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--clip-denoised", type=_bool, default=False, metavar="BOOL",
                        help="clamp pred_xstart to [-1, 1] each step (the reference FID protocol passes False)")
    parser.add_argument("--pit-window", type=int, default=0,
                        help="parallel-in-time sampling, a multi-device layout: not ported (raises)")
    parser.add_argument("--pit-sweeps", type=int, default=2)
    parser.add_argument("--pit-shift", type=int, default=None)
    parser.add_argument("--n-model", type=int, default=1,
                        help="tensor-parallel width, a multi-device layout: not ported past 1 (raises)")
    parser.add_argument("--kernel-sharding", choices=["auto", "gspmd", "shard_map"], default="auto",
                        help="multi-device layout; on one device auto and gspmd are the same chain, shard_map raises")
    parser.add_argument("--output-file", type=str, default="samples.npz")
    parser.add_argument("--ema-std", type=float, default=0.05)
    parser.add_argument("--ckpt", type=str, default=None)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
