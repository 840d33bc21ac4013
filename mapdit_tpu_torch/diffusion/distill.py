"""Progressive distillation (Salimans & Ho, arXiv 2202.00512), port of
``mapdit_tpu/diffusion/distill.py``.

Each stage halves the sampling-step count of a trained DiT: a student,
initialised from the teacher, learns to reproduce TWO teacher DDIM steps
with ONE of its own. Every grid is a nested subset of the one before, so the
teacher's and the student's steps align exactly:

  M_0 = uniform-section (or Karras) subset of the 1000-step process
  M_{k+1} = M_k[1::2]   (every other point, the top timestep kept; |M_k| even)

On ascending maps the student diffusion of M_{k+1} has ``acp_student[i] =
acp_teacher[2i+1]`` and ``acp_prev_student[i] = acp_prev_teacher[2i]``: the
student step at index i spans the teacher pair (2i+1, 2i), the last one
down to the ``alpha_bar_prev = 1`` boundary.

The loss is the x0-space regression with the truncated-SNR weight ``w =
max(acp/(1-acp), 1)``. Classifier-free guidance may be baked into the
student at a fixed scale (the teacher target takes the CFG-combined eps),
and the distilled student then samples without batch doubling.

Two diffusions, two index spaces: ``t`` is the student's index in
``[0, d_student.num_timesteps)``; the teacher pair runs at teacher indices
2t+1 and 2t; the model sees each diffusion's mapped original timestep. The
teacher runs under ``torch.no_grad()`` (JAX's ``stop_gradient``) and its
target is f32, whatever the model's compute type: the model returns f32 and
the tables are f32.

RNG: DDIM at eta 0 draws no step noise, so the teacher pair leaves the train
step's generator untouched, and a distill step draws t and the q-sample
noise as a train step on the same seed does (``training/state.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from mapdit_tpu_torch.diffusion import gaussian as gd
from mapdit_tpu_torch.diffusion.dmath import mean_flat
from mapdit_tpu_torch.diffusion.gaussian import GaussianDiffusion
from mapdit_tpu_torch.diffusion.respace import karras_timesteps, respaced_betas, space_timesteps
from mapdit_tpu_torch.diffusion.schedules import get_named_beta_schedule

# ---------------------------------------------------------------------- grids


def base_timestep_map(
    base_steps: int, schedule: str = "uniform", diffusion_steps: int = 1000, noise_schedule: str = "linear"
) -> List[int]:
    """Stage-0 grid M_0: an ascending subset of the original timesteps."""
    if schedule == "karras":
        steps = karras_timesteps(get_named_beta_schedule(noise_schedule, diffusion_steps), base_steps)
    else:
        steps = space_timesteps(diffusion_steps, str(base_steps))
    m = sorted(steps)
    if len(m) != base_steps:
        raise ValueError(f"a {schedule} grid of {base_steps} steps has {len(m)} distinct timesteps")
    return m


def halved_map(m: Sequence[int]) -> List[int]:
    """M -> M[1::2]: every other point, keeping the TOP timestep (ascending
    maps of even length; an odd length would drop the chain's start)."""
    m = list(m)
    if len(m) % 2 != 0:
        raise ValueError(
            f"cannot halve an odd-length grid ({len(m)} steps); pick --base-steps divisible by 2**stages"
        )
    return m[1::2]


def distilled_map(base_steps: int, rounds: int, schedule: str = "uniform", diffusion_steps: int = 1000) -> List[int]:
    m = base_timestep_map(base_steps, schedule, diffusion_steps)
    for _ in range(rounds):
        m = halved_map(m)
    return m


def diffusion_from_map(
    m: Sequence[int], diffusion_steps: int = 1000, noise_schedule: str = "linear", device=None
) -> GaussianDiffusion:
    """The process on an explicit timestep subset (``create_diffusion``'s
    tables, from a map where it takes a respacing string), on ``device``
    (default CUDA)."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    new_betas, timestep_map = respaced_betas(betas, set(m))
    return GaussianDiffusion.create(
        new_betas, mean_type=gd.EPSILON, var_type=gd.LEARNED_RANGE, loss_type=gd.MSE, timestep_map=timestep_map,
        original_num_steps=diffusion_steps, device=device,
    )


def student_diffusion_from_config(train_args: dict, device=None) -> GaussianDiffusion:
    """A distilled experiment's sampling grid, rebuilt from its config.yaml
    (``distill_base_steps``, ``distill_base_schedule``, ``distill_rounds``,
    written by ``mapdit_tpu_torch.distill``)."""
    m = distilled_map(
        int(train_args["distill_base_steps"]),
        int(train_args["distill_rounds"]),
        train_args.get("distill_base_schedule", "uniform"),
    )
    return diffusion_from_map(m, device=device)


# ----------------------------------------------------------------------- loss


def make_teacher_fn(model: torch.nn.Module, num_classes: int, cfg_scale: float = 1.0) -> Callable:
    """The frozen teacher's eps + variance output, ``teacher_fn(x, t, y)``,
    run under ``torch.no_grad()``. ``model`` holds the teacher's weights
    (the JAX function takes the parameter tree). At ``cfg_scale != 1`` it is
    CFG-combined at that fixed scale: eps = eps_u + w (eps_c - eps_u), the
    variance half from the conditional pass (``forward_with_cfg``'s
    convention), from one model call on [x; x] with [y; null]."""

    def teacher_fn(x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            if cfg_scale == 1.0:
                return model(x, t, y)
            out = model(torch.cat([x, x]), torch.cat([t, t]), torch.cat([y, torch.full_like(y, num_classes)]))
            cond, uncond = out.chunk(2)
            eps_c, var_c = cond.chunk(2, dim=1)
            eps_u, _ = uncond.chunk(2, dim=1)
            return torch.cat([eps_u + cfg_scale * (eps_c - eps_u), var_c], dim=1)

    return teacher_fn


def two_step_target(
    d_teacher: GaussianDiffusion,
    d_student: GaussianDiffusion,
    teacher_fn: Callable,
    x_t: torch.Tensor,
    i: torch.Tensor,
    model_kwargs: Optional[dict] = None,
) -> torch.Tensor:
    """The x0 the student must predict at student index ``i`` so that one
    student DDIM step from x_t lands where two teacher DDIM steps land:
    ``x'' = sqrt(a_s) x~0 + sqrt((1-a_s)/(1-a_t)) (x_t - sqrt(a_t) x~0)``
    solved for x~0. At the last step (a_s = 1) c is 0 and x~0 = x''
    exactly. No gradient flows through it."""
    if 2 * d_student.num_timesteps != d_teacher.num_timesteps:
        raise ValueError(
            f"the teacher's grid ({d_teacher.num_timesteps}) must be twice the student's ({d_student.num_timesteps})"
        )
    with torch.no_grad():
        u = 2 * i + 1
        o1 = d_teacher.ddim_sample(teacher_fn, x_t, u, clip_denoised=False, model_kwargs=model_kwargs)
        o2 = d_teacher.ddim_sample(teacher_fn, o1["sample"], u - 1, clip_denoised=False, model_kwargs=model_kwargs)
        nd = x_t.ndim
        a_t = d_student._extract(d_student.alphas_cumprod, i, nd)
        a_s = d_student._extract(d_student.alphas_cumprod_prev, i, nd)
        c = torch.sqrt((1.0 - a_s) / (1.0 - a_t))
        denom = torch.sqrt(a_s) - c * torch.sqrt(a_t)
        return (o2["sample"] - c * x_t) / denom


def make_distill_losses(d_teacher: GaussianDiffusion, d_student: GaussianDiffusion, teacher_fn: Callable) -> Callable:
    """``training_losses``' replacement (``make_train_step(losses_fn=)``):
    the per-sample truncated-SNR x0 regression against the two-teacher-step
    target. ``t`` is the STUDENT index in [0, d_student.num_timesteps)."""

    def distill_losses(model_fn, x_start, t, model_kwargs=None, noise=None) -> Dict[str, torch.Tensor]:
        if noise is None:
            raise ValueError("distill_losses requires pre-drawn noise")
        x_t = d_student.q_sample(x_start, t, noise)
        x0_target = two_step_target(d_teacher, d_student, teacher_fn, x_t, t, model_kwargs)
        out = d_student.p_mean_variance(model_fn, x_t, t, clip_denoised=False, model_kwargs=model_kwargs)
        a_t = d_student._extract(d_student.alphas_cumprod, t, x_t.ndim)
        w = torch.clamp(a_t / (1.0 - a_t), min=1.0)  # truncated SNR
        loss = mean_flat(w * (x0_target - out["pred_xstart"]) ** 2)
        return {"loss": loss, "mse": loss}

    return distill_losses
