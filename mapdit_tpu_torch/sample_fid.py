"""Batched class-conditional sampling for FID evaluation, port of the JAX
package's ``sample_fid.py``.

    python -m mapdit_tpu_torch.sample_fid --result-dir results/000-DiT-S-2 --vae-path vae.safetensors \\
        --num-samples 10000 --batch-size 128
    python -m mapdit_tpu_torch.sample_fid ... --sampler ddim --pit-window 10 --pit-shift 2
    torchrun --standalone --nproc-per-node 2 -m mapdit_tpu_torch.sample_fid ... --kernel-sharding shard_map

Writes ``<result-dir>/fid_samples/<output-file>``, a uint8 NHWC ``.npz``
(key ``arr_0``, the ADM evaluator's format) of ``--num-samples`` images.
CFG runs only when ``--cfg-scale`` is above 1. Every batch's latents,
labels and step noise come from one ``torch.Generator`` seeded with
``--seed``, in that order; under ``torchrun`` every rank draws the same
global batch and rank 0 alone decodes and writes. Progress is printed a
batch a line.

The layouts (JAX ``sample_fid.py:72-113``):

  * one device: ``build_sample_fn``;
  * ``--pit-window K``: parallel-in-time DDIM (``build_pit_sample_fn``;
    ``--pit-sweeps`` Picard sweeps a window, or the sliding schedule of
    ``--pit-shift``), on one device or with the window's rows split over
    the ranks; needs ``--sampler ddim --eta 0``, no ``--cfg-interval`` and
    no ``shard_map``;
  * ``--kernel-sharding shard_map`` (and ``auto`` with two or more data
    ranks and ``--n-model 1``): each rank runs the one-device chain on its
    rows with its own stream (``build_dp_sharded_sample_fn``); on one
    device it is that chain on one rank;
  * ``gspmd`` and ``--n-model > 1``: ``build_sample_fn(mesh=)``, the batch
    split over the data axis, the tensor-parallel islands on a model axis
    (``--n-model > 1`` runs under ``torchrun`` only).

A distilled student (``mapdit_tpu_torch.distill``) samples on its own
nested DDIM grid at cfg 1 (guidance baked, no doubling), as in the JAX
script; ``--cfg-interval`` and ``--pit-*`` are refused for it.
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
from mapdit_tpu_torch.parallel.mesh import Mesh
from mapdit_tpu_torch.runtime import build_dp_sharded_sample_fn, build_pit_sample_fn, build_sample_fn
from mapdit_tpu_torch.sample import (
    _bool, add_common_flags, cfg_batch, check_experiment, decode_latents, load_variables, run_config, vae_decoder,
)
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.image import to_uint8


def _check_layout(args) -> None:
    """JAX ``sample_fid.py:82-106``'s refusals of the flags alone."""
    if args.n_model > 1 and args.kernel_sharding == "shard_map":
        raise SystemExit(
            "error: --kernel-sharding shard_map is data-parallel only (per-rank one-device chains); tensor "
            "parallelism (--n-model > 1) runs on the gspmd layout"
        )
    if args.pit_window:
        if args.sampler != "ddim" or args.eta != 0.0:
            raise SystemExit(
                "error: --pit-window needs --sampler ddim --eta 0 (the deterministic map block-Picard iterates on)"
            )
        if args.cfg_interval or args.kernel_sharding == "shard_map":
            raise SystemExit("error: --pit-window composes with the gspmd layout only (no cfg-interval/shard_map)")


def _join_mesh(args):
    """(mesh, whether this call started the process group): the ranks of a
    process group already started (a spawned rank) or of ``torchrun``'s
    environment; (None, False) in one process."""
    import torch.distributed as dist

    from mapdit_tpu_torch.parallel import init_distributed, make_mesh

    device = None if args.device == "cuda" else args.device
    if dist.is_available() and dist.is_initialized():
        return make_mesh(n_model=args.n_model, device=device), False
    if "RANK" in os.environ:
        device = init_distributed(device)
        return make_mesh(n_model=args.n_model, device=device), True
    if args.n_model > 1:
        raise SystemExit("error: --n-model > 1 runs under torchrun --nproc-per-node N (one process a rank)")
    return None, False


def main(args):
    """Write the npz; returns its path (on rank 0; None on the other ranks)."""
    train_args = check_experiment(args.result_dir)
    if train_args.get("distill_rounds"):
        if args.cfg_interval is not None or args.pit_window:
            raise ValueError("--cfg-interval/--pit-* do not apply to distilled students")
        if args.sampler != "ddim" or args.cfg_scale > 1.0:
            steps = student_diffusion_from_config(train_args, device="cpu").num_timesteps
            print(f"distilled student: forcing ddim at its {steps}-step grid, cfg 1 (guidance baked)")
        args.sampler, args.cfg_scale = "ddim", 1.0
    _check_layout(args)
    mesh, owned = _join_mesh(args)
    try:
        return _sample(args, train_args, mesh)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()


def _sample(args, train_args: dict, mesh):
    device = mesh.device if mesh is not None else resolve_device(args.device)
    rank, n_data = (mesh.rank, mesh.n_data) if mesh is not None else (0, 1)
    multi = mesh if mesh is not None and mesh.size > 1 else None
    cfg = run_config(train_args, args.block_kernel)
    sd = load_variables(args.result_dir, train_args, args.ckpt, args.ema_std)
    if train_args.get("distill_rounds"):
        diffusion = student_diffusion_from_config(train_args, device=device)
    else:
        diffusion = create_diffusion(
            respacing_string(args.num_sampling_steps, args.sampler, args.time_schedule), device=device)
    use_cfg = args.cfg_scale > 1.0
    cfg_scale = args.cfg_scale if use_cfg else None
    cfg_interval = tuple(args.cfg_interval) if args.cfg_interval else None
    n = args.batch_size
    use_shard_map = not args.pit_window and (
        args.kernel_sharding == "shard_map" or (args.kernel_sharding == "auto" and n_data > 1 and args.n_model == 1))
    if args.pit_window:
        sample_fn = build_pit_sample_fn(
            cfg, sd, diffusion, cfg_scale=cfg_scale, window=args.pit_window, sweeps=args.pit_sweeps,
            shift=args.pit_shift, clip_denoised=args.clip_denoised, dynamic_threshold=args.dynamic_threshold,
            mesh=multi, device=device,
        )
    elif use_shard_map:
        if n % n_data:
            raise SystemExit("error: batch size must divide the data ranks (per-rank CFG doubling)")
        sample_fn = build_dp_sharded_sample_fn(
            cfg, sd, diffusion, mesh if mesh is not None else Mesh(1, 1, 0, device), cfg_scale=cfg_scale,
            sampler=args.sampler, eta=args.eta, cfg_interval=cfg_interval, clip_denoised=args.clip_denoised,
            batch_hint=n, dynamic_threshold=args.dynamic_threshold, device=device,
        )
    else:
        if (2 * n if use_cfg else n) % n_data:
            raise SystemExit("error: batch size (incl. CFG doubling) must divide the data axis")
        sample_fn = build_sample_fn(
            cfg, sd, diffusion, cfg_scale=cfg_scale, sampler=args.sampler, eta=args.eta, cfg_interval=cfg_interval,
            clip_denoised=args.clip_denoised, batch_hint=n, dynamic_threshold=args.dynamic_threshold, mesh=multi,
            device=device,
        )
    decoder = vae_decoder(args, device) if rank == 0 else None

    gen = torch.Generator(device=device).manual_seed(args.seed if args.seed is not None else 0)
    n_batches = math.ceil(args.num_samples / n)
    gathered, t0 = [], time.perf_counter()
    for i in range(n_batches):
        z = torch.randn((n, train_args["in_channels"], train_args["input_size"], train_args["input_size"]),
                        generator=gen, device=device)
        y = torch.randint(0, args.num_classes, (n,), generator=gen, device=device)
        if use_cfg and not use_shard_map:
            z, y = cfg_batch(z, y, args.num_classes)
        samples = sample_fn(z, y, gen)[:n]
        if rank != 0:
            continue
        samples = decode_latents(samples.cpu().numpy(), train_args, decoder is not None, decoder=decoder,
                                 device=device)
        gathered.append(to_uint8(samples))
        print(f"[sample_fid] batch {i + 1}/{n_batches}, {(i + 1) * n} images, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rank != 0:
        return None

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
                        help="parallel-in-time sampling (block-Picard, ParaDiGMS family, arXiv 2305.16317): solve "
                             "the ddim chain in windows of this many steps, every position of a window in one "
                             "model call a sweep; must divide the step count; 0 = off; ddim at eta 0 only. On one "
                             "device it is slower than the sequential chain; under torchrun the window's rows "
                             "split over the ranks")
    parser.add_argument("--pit-sweeps", type=int, default=2,
                        help="block schedule: Picard sweeps a window; equal to the window it reproduces the "
                             "sequential chain, fewer is the lossy accelerated regime")
    parser.add_argument("--pit-shift", type=int, default=None,
                        help="sliding schedule instead: accept this many positions a sweep (T/shift sweeps after "
                             "window/shift - 1 warm-up sweeps); shift 1 is exact. Overrides --pit-sweeps")
    parser.add_argument("--n-model", type=int, default=1,
                        help="tensor-parallel width under torchrun: ranks on the mesh's model axis (the "
                             "tensor-parallel islands); the data axis takes the rest")
    parser.add_argument("--kernel-sharding", choices=["auto", "gspmd", "shard_map"], default="auto",
                        help="layout over the ranks: gspmd = build_sample_fn(mesh=), the batch split over the data "
                             "axis; shard_map = each rank runs the one-device chain on its rows with its own "
                             "stream; auto = shard_map with two or more data ranks and --n-model 1, else gspmd")
    parser.add_argument("--output-file", type=str, default="samples.npz")
    parser.add_argument("--ema-std", type=float, default=0.05)
    parser.add_argument("--ckpt", type=str, default=None)
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
