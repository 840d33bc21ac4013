"""Compare post-hoc EMA stds side by side, port of the JAX package's
``sample_ema.py``.

    python -m mapdit_tpu_torch.sample_ema --result-dir results/000-DiT-S-2 --sampler dpm++ --num-sampling-steps 20

Reconstructs the model at five EMA stds, samples 8 images per std from the
same latents (the seed rule of ``mapdit_tpu_torch.sample``, the generator
re-seeded for each std) through one built sampler (``prepare`` per std),
and writes one grid, a row per image and a column per std.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
from mapdit_tpu_torch.runtime import build_shared_sample_fn
from mapdit_tpu_torch.sample import (
    add_common_flags, cfg_batch, check_experiment, decode_latents, load_variables, run_config, vae_decoder,
)
from mapdit_tpu_torch.utils.class_names import class_name
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.image import save_image_grid

EMA_STDS = [0.0075, 0.01, 0.05, 0.1, 0.15]


def main(args) -> str:
    """Write the grid; returns its path."""
    device = resolve_device(args.device)
    train_args = check_experiment(args.result_dir)
    cfg = run_config(train_args, args.block_kernel)
    diffusion = create_diffusion(
        respacing_string(args.num_sampling_steps, args.sampler, args.time_schedule), device=device)

    n = 8
    prepare, sample_fn = build_shared_sample_fn(
        cfg, diffusion, cfg_scale=args.cfg_scale, sampler=args.sampler, eta=args.eta,
        cfg_interval=tuple(args.cfg_interval) if args.cfg_interval else None,
        dynamic_threshold=args.dynamic_threshold, batch_hint=n, device=device,
    )
    res = []
    for std in EMA_STDS:
        prepared = prepare(load_variables(args.result_dir, train_args, None, std))
        gen = torch.Generator(device=device).manual_seed(args.seed if args.seed is not None else 0)
        z = torch.randn((n, train_args["in_channels"], train_args["input_size"], train_args["input_size"]),
                        generator=gen, device=device)
        z, y = cfg_batch(z, torch.full((n,), args.class_label, dtype=torch.int64, device=device), cfg.num_classes)
        res.append(sample_fn(prepared, z, y, gen)[:n].cpu().numpy())

    # (n, stds, C, H, W) -> row-major grid with one column per std
    samples = np.stack(res, axis=1).reshape(-1, *res[0].shape[1:])
    decoder = vae_decoder(args, device)
    samples = decode_latents(samples, train_args, decoder is not None, decoder=decoder, device=device)
    save_image_grid(samples, args.output_file, nrow=len(EMA_STDS))
    print(f"output class: {class_name(args.class_label)} ({args.class_label})")
    return args.output_file


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(parser)
    parser.add_argument("--output-file", type=str, default="sample.png")
    parser.add_argument("--class-label", type=int, default=88)
    parser.add_argument("--cfg-scale", type=float, default=4.0)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
