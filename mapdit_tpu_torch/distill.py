"""Progressively distill a trained DiT to few-step DDIM sampling, port of the
JAX package's ``distill.py``.

    python -m mapdit_tpu_torch.distill --teacher results/000-DiT-S-2 --data-path synthetic:1024 \\
        --results-dir distilled --base-steps 64 --stages 4 --steps-per-stage 2000 --cfg-scale 1.5
    python -m mapdit_tpu_torch.distill --device cpu --teacher results/000-DiT-XS-8 ...   # plain PyTorch

Each stage trains a student, initialised from the teacher, whose ONE DDIM
step reproduces TWO teacher DDIM steps (``diffusion/distill.py``), with
classifier-free guidance optionally baked in at a fixed scale on the first
stage, so the student samples without CFG doubling. Every stage writes one
experiment directory in the train CLI's layout (``config.yaml``,
``checkpoints/``, ``constants.pt``, ``ema/``) whose ``distill_*`` fields
make ``sample``, ``sample_fid`` and ``serve`` rebuild the student's grid
and pin its protocol; the next stage's teacher is this stage's raw student.
The stage directories are printed, one a line.

A stage's step is ``training/state.py``'s: the teacher pair (two DDIM steps
of the frozen teacher, under ``torch.no_grad()``), the student's forward and
backward, Adam under a fresh schedule, both power EMAs and the forced weight
normalization, eager on one device (the JAX script jits it as one donated
program). A tensor-parallel kernel of the teacher's config drops to
``auto``: the islands have no backward. Runs on CUDA unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import torch

from mapdit_tpu_torch.diffusion.distill import (
    base_timestep_map,
    diffusion_from_map,
    distilled_map,
    halved_map,
    make_distill_losses,
    make_teacher_fn,
)
from mapdit_tpu_torch.models import init_model
from mapdit_tpu_torch.models.config import TP_KERNELS
from mapdit_tpu_torch.sample import check_experiment, load_variables
from mapdit_tpu_torch.train import build_dataset
from mapdit_tpu_torch.training import (
    EMA_STDS,
    create_optimizer,
    create_train_state,
    default_schedule_steps,
    ema_key,
    make_train_step,
    warmup_flat_invsqrt,
)
from mapdit_tpu_torch.training import ema as ema_lib
from mapdit_tpu_torch.training.checkpoint import save_state
from mapdit_tpu_torch.training.device_prefetch import make_stage_fn
from mapdit_tpu_torch.utils.device import resolve_device
from mapdit_tpu_torch.utils.experiment import config_from_args, save_config
from mapdit_tpu_torch.utils.logging import create_logger


def stage_grids(args, teacher_args: dict, logger):
    """(stage-0 map, base steps, rounds so far, base schedule). A distilled
    teacher continues its own nested grid: a fresh subset of the same length
    would mis-span its steps."""
    if not teacher_args.get("distill_rounds"):
        return base_timestep_map(args.base_steps, args.base_schedule), args.base_steps, 0, args.base_schedule
    base_steps0 = int(teacher_args["distill_base_steps"])
    rounds0 = int(teacher_args["distill_rounds"])
    base_schedule0 = teacher_args.get("distill_base_schedule", "uniform")
    if float(teacher_args.get("distill_cfg_scale", 1.0)) > 1.0 and args.cfg_scale != 1.0:
        # a second bake would compound guidance in the weights, while
        # distill_cfg_scale can carry one number only
        raise SystemExit(
            f"teacher already baked cfg_scale {teacher_args['distill_cfg_scale']}; guidance is baked exactly once — "
            "rerun with --cfg-scale 1.0 (the baked scale stays in effect)"
        )
    if args.base_schedule != base_schedule0:
        logger.warning(
            f"--base-schedule {args.base_schedule} ignored: chained distillation continues the teacher's recorded "
            f"{base_schedule0} grid"
        )
    m = distilled_map(base_steps0, rounds0, base_schedule0)
    if args.base_steps != len(m):
        raise SystemExit(
            f"--base-steps {args.base_steps} != the distilled teacher's grid ({len(m)} steps: {base_steps0} halved "
            f"{rounds0}x); chained distillation continues the teacher's own grid"
        )
    return m, base_steps0, rounds0, base_schedule0


def main(args) -> List[str]:
    """Run the stages the parsed ``args`` describe; returns the stage
    directories."""
    device = resolve_device(args.device)
    teacher_args = check_experiment(args.teacher)
    if args.compute_dtype:
        teacher_args = dict(teacher_args, compute_dtype=args.compute_dtype)
    cfg = config_from_args(teacher_args)
    if cfg.block_kernel in TP_KERNELS:
        cfg = cfg.replace(block_kernel="auto")
    teacher_sd = load_variables(args.teacher, teacher_args, args.teacher_ckpt, args.teacher_ema)

    os.makedirs(args.results_dir, exist_ok=True)
    logger = create_logger(None, verbose=1)

    dataset = build_dataset(args.data_path)
    if (dataset.channels, dataset.data_size) != (teacher_args["in_channels"], teacher_args["input_size"]):
        raise ValueError(
            f"distill data ({dataset.channels}x{dataset.data_size}x{dataset.data_size}) must live in the teacher's "
            f"latent space ({teacher_args['in_channels']}x{teacher_args['input_size']}x{teacher_args['input_size']})"
        )
    # the teacher's training statistics, not the distill dataset's own: the
    # teacher's input space is the contract
    stats_mean, stats_std = teacher_args["stats_mean"], teacher_args["stats_std"]

    m, base_steps0, rounds0, base_schedule0 = stage_grids(args, teacher_args, logger)
    ema_stds = tuple(args.ema_stds)
    exp_index = len(os.listdir(args.results_dir))
    stage_batch = make_stage_fn(device)
    stage_dirs = []
    for stage in range(1, args.stages + 1):
        m_s = halved_map(m)
        d_teacher = diffusion_from_map(m, device=device)
        d_student = diffusion_from_map(m_s, device=device)
        # guidance is baked once (stage 1); later stages distill the guided
        # student at scale 1
        stage_cfg_scale = args.cfg_scale if stage == 1 else 1.0

        warmup, decay = default_schedule_steps(args.steps_per_stage)
        tx = create_optimizer(warmup_flat_invsqrt(args.lr, warmup, decay))
        # the student and every EMA copy load their own copies of the
        # teacher's tensors: the step updates them in place
        state = create_train_state(cfg, tx, seed=args.seed, ema_stds=ema_stds, device=device, state_dict=teacher_sd)
        teacher = init_model(cfg, seed=args.seed, device=device)
        teacher.load_state_dict(teacher_sd)
        teacher.requires_grad_(False)
        step_fn = make_train_step(
            cfg, d_student, tx, stats_mean=stats_mean, stats_std=stats_std, ema_stds=ema_stds,
            losses_fn=make_distill_losses(d_teacher, d_student,
                                          make_teacher_fn(teacher, cfg.num_classes, stage_cfg_scale)),
            # no label dropout: the teacher target sees the true label, so a
            # dropped student label would break the pairing
            model_train=False,
        )

        batches = dataset.batches(batch_size=args.batch_size, seed=args.seed + stage)
        logger.info(
            f"[stage {stage}/{args.stages}] {len(m)} -> {len(m_s)} steps, cfg_scale {stage_cfg_scale}, "
            f"{args.steps_per_stage} updates"
        )
        loss_buf, t0 = [], time.time()
        for it in range(1, args.steps_per_stage + 1):
            loss_buf.append(step_fn(state, stage_batch(next(batches)))["loss"])
            if it % args.log_every == 0 or it == args.steps_per_stage:
                avg = torch.stack(loss_buf).mean().item()  # one host sync a log interval
                logger.info(
                    f"[stage {stage}] step {it:06d} distill loss {avg:.5f} "
                    f"({len(loss_buf) / (time.time() - t0):.2f} steps/s)"
                )
                loss_buf, t0 = [], time.time()

        stage_dir = os.path.join(
            args.results_dir, f"{exp_index:03d}-{teacher_args['model'].replace('/', '-')}-distill{len(m_s)}")
        exp_index += 1
        os.makedirs(os.path.join(stage_dir, "checkpoints"), exist_ok=True)
        stage_args = dict(teacher_args)
        stage_args.update(
            results_dir=args.results_dir,
            distill_base_steps=base_steps0,
            distill_base_schedule=base_schedule0,
            distill_rounds=rounds0 + stage,
            # guidance composes across chained runs: a scale baked by a
            # distilled teacher stays in effect when this run adds none
            distill_cfg_scale=(float(teacher_args.get("distill_cfg_scale", 1.0)) if args.cfg_scale == 1.0
                               else float(args.cfg_scale)),
            distill_teacher=os.path.abspath(args.teacher),
            distill_num_steps=len(m_s),
        )
        save_config(stage_dir, stage_args)
        torch.save({k: v.detach().cpu() for k, v in state.model.named_buffers()},
                   os.path.join(stage_dir, "constants.pt"))
        save_state(stage_dir, args.steps_per_stage, state)
        for s in ema_stds:
            ema_lib.save_snapshot(os.path.join(stage_dir, "ema"), s, args.steps_per_stage, state.ema[ema_key(s)])
        logger.info(f"[stage {stage}] saved {stage_dir} ({len(m_s)}-step student)")
        stage_dirs.append(stage_dir)

        teacher_sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        m = m_s
        del state, teacher, step_fn

    print("\n".join(stage_dirs))
    return stage_dirs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--teacher", type=str, required=True, help="trained experiment dir (train CLI layout)")
    parser.add_argument("--teacher-ckpt", type=str, default=None,
                        help="teacher checkpoint step (default: post-hoc EMA)")
    parser.add_argument("--teacher-ema", type=float, default=0.05, help="post-hoc EMA std for the teacher weights")
    parser.add_argument("--data-path", type=str, required=True, help="latent dataset dir, or 'synthetic[:N]'")
    parser.add_argument("--results-dir", type=str, required=True)
    parser.add_argument("--base-steps", type=int, default=64,
                        help="stage-0 DDIM grid size; must be divisible by 2**stages (each stage halves it)")
    parser.add_argument("--base-schedule", choices=["uniform", "karras"], default="uniform")
    parser.add_argument("--stages", type=int, default=4, help="number of halvings (64 -> 32 -> 16 -> 8 -> 4)")
    parser.add_argument("--steps-per-stage", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=2e-3,
                        help="per-stage peak LR (the train LR is 1e-2; distillation fine-tunes, so lower)")
    parser.add_argument("--cfg-scale", type=float, default=1.0,
                        help="bake classifier-free guidance at this fixed scale into the stage-1 student (>1 = "
                             "guided distillation; the result samples WITHOUT CFG doubling)")
    parser.add_argument("--ema-stds", type=float, nargs="*", default=list(EMA_STDS))
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None,
                        help="override the teacher's compute dtype")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to distill on; 'cpu' runs the plain PyTorch path")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
