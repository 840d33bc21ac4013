"""Sample a grid of images from a trained run, port of the JAX package's
``sample.py``.

    python -m mapdit_tpu_torch.sample --result-dir results/000-DiT-S-2 --vae-path vae.safetensors
    python -m mapdit_tpu_torch.sample --device cpu --result-dir results/000-DiT-XS-8 --use-vae false

The model comes from the experiment's ``config.yaml``, its weights from the
post-hoc EMA at ``--ema-std`` (reconstructed from ``ema/*.npz``) or from a
checkpoint (``--ckpt <step>``). The chain is one of ddpm, ddim, dpm++ or
unipc (``--time-schedule karras``, ``--cfg-interval``,
``--dynamic-threshold``, ``--cache-interval``), with batched CFG. The
samples are denormalized by the dataset statistics, decoded through the
SD-VAE (``--vae-path``; without weights the raw latents are written, with a
warning) and written as a PNG grid.

Seed rule: one ``torch.Generator`` on the run's device, seeded with
``--seed``, draws the initial latents z first and then the chain's step
noise; the class labels are fixed (``--class-label``). The JAX package's
PRNG bits are not reproduced, so the two packages draw different images
from the same seed.

The run is on one CUDA device unless ``--device`` says otherwise.
``--block-kernel`` overrides the training config's block kernel (the
sampling CLIs pass a batch hint, so ``auto`` runs the whole-stack kernel on
the card). A distilled student (``mapdit_tpu_torch.distill``; its config
holds ``distill_rounds``) samples on its own nested grid only: the chain is
pinned to DDIM at its step count, ``--cfg-scale`` to 1 where guidance was
baked, and a chain at cfg 1 runs the n conditional rows alone (no [z; z]
doubling; the JAX script doubles there and combines at scale 1).
``--cache-interval``, ``--cfg-interval`` and ``--save-trajectory`` are
refused for it.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Optional

import numpy as np
import torch

from mapdit_tpu_torch.diffusion import create_diffusion, respacing_string
from mapdit_tpu_torch.diffusion.distill import student_diffusion_from_config
from mapdit_tpu_torch.models.config import BLOCK_KERNELS
from mapdit_tpu_torch.runtime import SAMPLERS, build_cached_sample_fn, build_model_fn, build_sample_fn
from mapdit_tpu_torch.training.checkpoint import latest_checkpoint
from mapdit_tpu_torch.training.ema import calculate_posthoc_ema, list_snapshots, load_snapshot
from mapdit_tpu_torch.utils.class_names import class_name
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.experiment import config_from_args, load_config, percentile_arg
from mapdit_tpu_torch.utils.image import save_image_grid


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _load_tree(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _strip(sd) -> Dict[str, torch.Tensor]:
    """A state dict (tensors or arrays) without torch.compile's
    ``_orig_mod.`` prefix, in f32."""
    return {
        k.removeprefix("_orig_mod."): v.float() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
        for k, v in sd.items()
    }


def _load_constants(result_dir: str) -> Dict[str, torch.Tensor]:
    """The model's buffers (Fourier constants, positional table):
    ``constants.pt`` written at train start, else the latest checkpoint's,
    else, in an experiment directory carried over from the reference, a
    torch EMA snapshot's or checkpoint's (the reference's state dicts hold
    them)."""
    path = os.path.join(result_dir, "constants.pt")
    if os.path.exists(path):
        return _strip(_load_tree(path))
    ck = latest_checkpoint(result_dir)
    if ck:
        return _strip(_load_tree(ck)["model"])
    ema_dir = os.path.join(result_dir, "ema")
    if os.path.isdir(ema_dir):
        for _, _, snap in list_snapshots(ema_dir):
            if snap.endswith(".pt"):
                return _strip(load_snapshot(snap))
    for pt in sorted(glob.glob(os.path.join(result_dir, "checkpoints", "*.pt"))):
        return _strip(_load_tree(pt)["model"])
    raise SystemExit(f"error: need constants.pt, a checkpoint, or a reference torch EMA ledger in {result_dir}")


def load_variables(result_dir: str, train_args: dict, ckpt: Optional[str] = None, ema_std: float = 0.05):
    """The model's state dict (f32 CPU tensors): the post-hoc EMA at
    ``ema_std`` (default), or checkpoint ``ckpt``. ``--ckpt`` takes the
    port's ``checkpoints/<step>.pt`` and the reference's ``{"model":
    state_dict}`` ``.pt`` (the port's names are the reference's); a JAX
    ``.msgpack`` checkpoint goes through ``tools/convert_jax_checkpoint.py``
    first."""
    from mapdit_tpu_torch.models.dit import DiT, pos_embed_buffer

    cfg = config_from_args(train_args)
    if ckpt is not None:
        pt = os.path.join(result_dir, "checkpoints", f"{ckpt}.pt")
        if not os.path.exists(pt):
            hint = ""
            if os.path.exists(pt[: -len(".pt")] + ".msgpack"):
                hint = "; it is a JAX checkpoint: convert it with tools/convert_jax_checkpoint.py"
            raise FileNotFoundError(f"--ckpt: {pt} not found{hint}")
        sd = _strip(_load_tree(pt)["model"])
    else:
        sd = _strip(calculate_posthoc_ema(ema_std, os.path.join(result_dir, "ema")))
        with torch.device("meta"):
            params = {name for name, _ in DiT(cfg).named_parameters()}
        constants = {k: v for k, v in _load_constants(result_dir).items() if k not in params}
        sd = {**constants, **{k: v for k, v in sd.items() if k in params}}
    sd.setdefault("pos_embed", pos_embed_buffer(cfg))
    return sd


def decode_latents(
    samples: np.ndarray, train_args: dict, use_vae: bool, vae_path=None, decoder=None, clip: bool = True, device=None,
) -> np.ndarray:
    """Denormalize by the dataset statistics and decode through the VAE
    when ``use_vae`` (``decoder`` short-circuits the weight load; without
    weights the raw latents are returned, with a warning). ``clip`` clamps
    to the image range [-1, 1]; pass False where the caller reads raw
    latents as numbers (denormalized latents are not range-bounded)."""
    mean = np.asarray(train_args["stats_mean"], np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(train_args["stats_std"], np.float32).reshape(1, -1, 1, 1)
    samples = samples * std + mean
    if use_vae:
        if decoder is None:
            from mapdit_tpu_torch.models.vae import load_decoder

            decoder = load_decoder(vae_path, device)
        if decoder is None:
            print("warning: no VAE weights available (--vae-path); writing raw latents")
        else:
            samples = decoder(torch.from_numpy(np.ascontiguousarray(samples)).to(device)).float().cpu().numpy()
    return np.clip(samples, -1.0, 1.0) if clip else samples


def vae_decoder(args, device):
    """The decoder of ``--vae-path`` when ``--use-vae``, built once; None
    (with a warning where the weights are missing) otherwise."""
    if not args.use_vae:
        return None
    from mapdit_tpu_torch.models.vae import load_decoder

    decoder = load_decoder(args.vae_path, device)
    if decoder is None:
        print("warning: no VAE weights available (--vae-path); writing raw latents")
    return decoder


def check_experiment(result_dir: str) -> dict:
    """The run's config.yaml; raises where the directory holds none."""
    cfg_path = os.path.join(result_dir, "config.yaml")
    if not os.path.exists(cfg_path):
        raise SystemExit(
            f"error: {cfg_path} not found — --result-dir must point at an experiment directory created by train.py"
        )
    return load_config(result_dir)


def pin_student_protocol(args, train_args: dict, device):
    """A distilled student's diffusion, its own nested DDIM grid, with the
    protocol pinned in ``args`` as the JAX script pins it: ``--sampler
    ddim``, and ``--cfg-scale 1`` where guidance was baked (applying it
    again would compound it); the accelerator flags are refused."""
    diffusion = student_diffusion_from_config(train_args, device=device)
    steps = diffusion.num_timesteps
    if args.sampler != "ddim" or args.num_sampling_steps != steps:
        print(f"distilled student: forcing --sampler ddim at its {steps}-step grid "
              f"(requested {args.sampler}/{args.num_sampling_steps})")
        args.sampler = "ddim"
    if train_args.get("distill_cfg_scale", 1.0) > 1.0 and args.cfg_scale != 1.0:
        print(f"distilled student: guidance baked at scale {train_args['distill_cfg_scale']}; forcing --cfg-scale 1")
        args.cfg_scale = 1.0
    if args.cache_interval > 1 or args.cfg_interval is not None or args.save_trajectory:
        raise ValueError("--cache-interval/--cfg-interval/--save-trajectory do not apply to distilled students")
    return diffusion


def run_config(train_args: dict, block_kernel: Optional[str]):
    cfg = config_from_args(train_args)
    return cfg.replace(block_kernel=block_kernel) if block_kernel else cfg


def cfg_batch(z: torch.Tensor, labels: torch.Tensor, null_class: int):
    """The CFG batch: [z; z] with [labels; null]."""
    return torch.cat([z, z]), torch.cat([labels, torch.full_like(labels, null_class)])


def main(args) -> str:
    """Write the grid (and the trajectory grid); returns the grid's path."""
    device = resolve_device(args.device)
    train_args = check_experiment(args.result_dir)
    cfg = run_config(train_args, args.block_kernel)
    steps = args.num_sampling_steps
    if train_args.get("distill_rounds"):
        diffusion = pin_student_protocol(args, train_args, device)
    else:
        diffusion = create_diffusion(respacing_string(steps, args.sampler, args.time_schedule), device=device)
    # a student at cfg 1 samples its n conditional rows alone
    cfg_scale = None if train_args.get("distill_rounds") and args.cfg_scale == 1.0 else args.cfg_scale
    if args.save_trajectory and (args.sampler != "ddpm" or args.cfg_interval is not None):
        raise ValueError("--save-trajectory renders the full-CFG ddpm chain: it needs --sampler ddpm and no --cfg-interval")
    if args.cache_interval > 1 and args.sampler not in ("ddpm", "dpm++"):
        raise ValueError("--cache-interval composes with --sampler ddpm or dpm++")
    sd = load_variables(args.result_dir, train_args, args.ckpt, args.ema_std)

    n = 4
    gen = torch.Generator(device=device).manual_seed(args.seed if args.seed is not None else 0)
    z = torch.randn((n, train_args["in_channels"], train_args["input_size"], train_args["input_size"]),
                    generator=gen, device=device)
    chain_state = gen.get_state()
    y = torch.full((n,), args.class_label, dtype=torch.int64, device=device)
    if cfg_scale is not None:
        z, y = cfg_batch(z, y, cfg.num_classes)

    cfg_interval = tuple(args.cfg_interval) if args.cfg_interval else None
    if args.cache_interval > 1:
        sample_fn = build_cached_sample_fn(
            cfg, sd, diffusion, cfg_scale=cfg_scale, cache_interval=args.cache_interval, sampler=args.sampler,
            cfg_interval=cfg_interval, cache_mode=args.cache_mode, clip_denoised=args.clip_denoised,
            dynamic_threshold=args.dynamic_threshold, device=device,
        )
    else:
        sample_fn = build_sample_fn(
            cfg, sd, diffusion, cfg_scale=cfg_scale, sampler=args.sampler, eta=args.eta,
            cfg_interval=cfg_interval, clip_denoised=args.clip_denoised, batch_hint=n,
            dynamic_threshold=args.dynamic_threshold, device=device,
        )
    samples = sample_fn(z, y, gen)[:n].cpu().numpy()  # the null-class half (if any) dropped

    decoder = vae_decoder(args, device)
    samples = decode_latents(samples, train_args, decoder is not None, decoder=decoder, device=device)
    save_image_grid(samples, args.output_file, nrow=2)
    print(f"output class: {class_name(args.class_label)} ({args.class_label})")

    if args.save_trajectory:
        # pred_xstart at ~8 evenly spaced chain positions of the progressive
        # chain, one row a sample; the chain starts from the same generator
        # state as the main one
        model_fn = build_model_fn(cfg, sd, cfg_scale=args.cfg_scale, device=device)
        frames_t = np.linspace(0, steps - 1, min(8, steps)).round().astype(int)
        gen.set_state(chain_state)
        with torch.no_grad():
            outs = diffusion.p_sample_loop_progressive(
                model_fn, z, gen, clip_denoised=args.clip_denoised, model_kwargs={"y": y})
        traj = outs["pred_xstart"][torch.as_tensor(frames_t, device=device)][:, :n].transpose(0, 1)
        n_frames = traj.shape[1]
        traj = traj.reshape(n * n_frames, *traj.shape[2:]).cpu().numpy()
        traj = decode_latents(traj, train_args, decoder is not None, decoder=decoder, device=device)
        save_image_grid(traj, args.save_trajectory, nrow=n_frames)
        print(f"trajectory grid ({n_frames} frames/sample): {args.save_trajectory}")
    return args.output_file


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    """The flags the three sampling CLIs share."""
    parser.add_argument("--result-dir", type=str, required=True)
    parser.add_argument("--use-vae", type=_bool, default=True, metavar="BOOL")
    parser.add_argument("--vae-path", type=str, default=None,
                        help="local SD-VAE weights (.safetensors or .pt/.bin, diffusers names)")
    parser.add_argument("--num-sampling-steps", type=int, default=250)
    parser.add_argument("--sampler", choices=list(SAMPLERS), default="ddpm")
    parser.add_argument("--time-schedule", choices=["uniform", "karras"], default="uniform",
                        help="timestep grid: uniform sections (reference) or the EDM rho-7 sigma spacing")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="DDIM stochasticity (0 = deterministic ODE, 1 = DDPM-like)")
    parser.add_argument("--cfg-interval", type=float, nargs=2, default=None, metavar=("SIGMA_LO", "SIGMA_HI"),
                        help="limited-interval guidance: CFG only on steps whose noise level sigma(t) lies in "
                             "[LO, HI], the cond-only model at half the batch elsewhere; ddpm, dpm++, unipc")
    parser.add_argument("--dynamic-threshold", type=percentile_arg, default=None, metavar="P",
                        help="clip each sample's x0 estimate to its own P-quantile of |x0| (floor 1.0)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda", help="torch device; cuda unless given")
    parser.add_argument("--block-kernel", choices=list(BLOCK_KERNELS), default=None,
                        help="block kernel of the sampling chain (default: the training config's)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(parser)
    parser.add_argument("--output-file", type=str, default="sample.png")
    parser.add_argument("--class-label", type=int, default=88)
    parser.add_argument("--cfg-scale", type=float, default=4.0)
    parser.add_argument("--cache-interval", type=int, default=0,
                        help="Delta-DiT block-span caching every N steps (0 = exact chain; lossy); ddpm, dpm++")
    parser.add_argument("--cache-mode", choices=["hold", "forecast"], default="forecast",
                        help="skip-step span delta: held constant, or extrapolated from the last two full steps")
    parser.add_argument("--save-trajectory", type=str, default=None,
                        help="also write pred_xstart at 8 chain positions to this PNG (ddpm; a second chain)")
    parser.add_argument("--clip-denoised", type=_bool, default=False, metavar="BOOL",
                        help="clamp pred_xstart to [-1, 1] each step (the reference scripts pass False)")
    parser.add_argument("--ema-std", type=float, default=0.05)
    parser.add_argument("--ckpt", type=str, default=None, help="checkpoint step to load instead of EMA (no extension)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
