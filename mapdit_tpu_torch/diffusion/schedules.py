"""Beta schedules, computed on the host in numpy float64.

The port's own copy of ``mapdit_tpu/diffusion/schedules.py`` (the IDDPM/ADM
schedule library); ``GaussianDiffusion.create`` casts the tables to float32
tensors.
"""

from __future__ import annotations

import math

import numpy as np


def linear_beta_schedule(num_timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def quad_beta_schedule(num_timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    return (
        np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps, dtype=np.float64) ** 2
    )


def warmup_beta_schedule(
    num_timesteps: int, beta_start: float, beta_end: float, warmup_frac: float
) -> np.ndarray:
    betas = np.full(num_timesteps, beta_end, dtype=np.float64)
    warmup_time = int(num_timesteps * warmup_frac)
    betas[:warmup_time] = np.linspace(beta_start, beta_end, warmup_time, dtype=np.float64)
    return betas


def const_beta_schedule(num_timesteps: int, beta_end: float) -> np.ndarray:
    return np.full(num_timesteps, beta_end, dtype=np.float64)


def jsd_beta_schedule(num_timesteps: int) -> np.ndarray:
    # 1/T, 1/(T-1), ..., 1
    return 1.0 / np.linspace(num_timesteps, 1.0, num_timesteps, dtype=np.float64)


def betas_for_alpha_bar(num_timesteps: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    """Discretize a cumulative alpha-bar function into per-step betas."""
    t = np.arange(num_timesteps, dtype=np.float64)
    a1 = np.array([alpha_bar(ti / num_timesteps) for ti in t])
    a2 = np.array([alpha_bar((ti + 1) / num_timesteps) for ti in t])
    return np.minimum(1.0 - a2 / a1, max_beta)


def get_beta_schedule(
    beta_schedule: str, *, beta_start: float, beta_end: float, num_diffusion_timesteps: int
) -> np.ndarray:
    """Deprecated-API schedule library (reference `gaussian_diffusion.py:67-97`)."""
    n = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = quad_beta_schedule(n, beta_start, beta_end)
    elif beta_schedule == "linear":
        betas = linear_beta_schedule(n, beta_start, beta_end)
    elif beta_schedule == "warmup10":
        betas = warmup_beta_schedule(n, beta_start, beta_end, 0.1)
    elif beta_schedule == "warmup50":
        betas = warmup_beta_schedule(n, beta_start, beta_end, 0.5)
    elif beta_schedule == "const":
        betas = const_beta_schedule(n, beta_end)
    elif beta_schedule == "jsd":
        betas = jsd_beta_schedule(n)
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (n,)
    return betas


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named schedule library (reference `gaussian_diffusion.py:100-124`).

    "linear": Ho et al. schedule rescaled so the continuous limit is
    independent of the step count; "squaredcos_cap_v2": Nichol & Dhariwal
    cosine schedule.
    """
    if schedule_name == "linear":
        scale = 1000.0 / num_diffusion_timesteps
        return get_beta_schedule(
            "linear",
            beta_start=scale * 0.0001,
            beta_end=scale * 0.02,
            num_diffusion_timesteps=num_diffusion_timesteps,
        )
    if schedule_name == "squaredcos_cap_v2":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")
