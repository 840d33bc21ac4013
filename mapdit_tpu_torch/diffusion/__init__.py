"""Diffusion process factory, port of ``mapdit_tpu/diffusion/__init__.py``.

``create_diffusion("250")`` is the 250-step respaced sampling process,
``create_diffusion("")`` the full-step process.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from mapdit_tpu_torch.diffusion import gaussian as gd
from mapdit_tpu_torch.diffusion.gaussian import GaussianDiffusion
from mapdit_tpu_torch.diffusion.respace import karras_timesteps, respaced_betas, space_timesteps
from mapdit_tpu_torch.diffusion.schedules import get_named_beta_schedule


def create_diffusion(
    timestep_respacing: Optional[Union[str, Sequence[int]]],
    noise_schedule: str = "linear",
    use_kl: bool = False,
    sigma_small: bool = False,
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    rescale_learned_sigmas: bool = False,
    diffusion_steps: int = 1000,
    device=None,
) -> GaussianDiffusion:
    """A diffusion process with its tables on ``device`` (default CUDA)."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)

    if use_kl:
        loss_type = gd.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = gd.RESCALED_MSE
    else:
        loss_type = gd.MSE

    mean_type = gd.START_X if predict_xstart else gd.EPSILON
    if learn_sigma:
        var_type = gd.LEARNED_RANGE
    else:
        var_type = gd.FIXED_SMALL if sigma_small else gd.FIXED_LARGE

    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    if isinstance(timestep_respacing, str) and timestep_respacing.startswith("karras"):
        use_timesteps = karras_timesteps(betas, int(timestep_respacing[len("karras"):]))
    else:
        use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)
    new_betas, timestep_map = respaced_betas(betas, use_timesteps)

    return GaussianDiffusion.create(
        new_betas,
        mean_type=mean_type,
        var_type=var_type,
        loss_type=loss_type,
        timestep_map=timestep_map,
        original_num_steps=diffusion_steps,
        device=device,
    )


def respacing_string(steps: int, sampler: str = "ddpm", schedule: str = "uniform") -> str:
    """The timestep_respacing string for a sampling protocol."""
    if schedule == "karras":
        return f"karras{steps}"
    return f"ddim{steps}" if sampler == "ddim" else str(steps)


__all__ = [
    "GaussianDiffusion",
    "create_diffusion",
    "karras_timesteps",
    "respacing_string",
    "space_timesteps",
    "respaced_betas",
    "gd",
]
