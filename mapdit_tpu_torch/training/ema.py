"""Karras power-function EMA, port of ``mapdit_tpu/training/ema.py``: the
numpy profile math (float64) copied as it is, and the per-step update, in
place on the EMA tensors. Snapshot IO and ``calculate_posthoc_ema`` are
ROADMAP A.5.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def std_to_gamma(std) -> np.ndarray:
    """Solve std^-2 = (gamma+1)/((gamma+2)^2 (gamma+3)) for the largest real
    root of the cubic gamma^3 + 7 gamma^2 + (16 - s) gamma + (12 - s) = 0."""
    std = np.asarray(std, dtype=np.float64)
    s = std.reshape(-1) ** -2.0
    gamma = np.array([np.roots([1.0, 7.0, 16.0 - si, 12.0 - si]).real.max() for si in s])
    return gamma.reshape(std.shape)


def gamma_to_std(gamma) -> np.ndarray:
    gamma = np.asarray(gamma, dtype=np.float64)
    return np.sqrt((gamma + 1.0) / (np.square(gamma + 2.0) * (gamma + 3.0)))


def calc_beta(std, t):
    """Per-step decay beta_t = (1 - 1/t)^(gamma+1) for the power EMA profile."""
    gamma = std_to_gamma(np.asarray(std))
    return (1.0 - 1.0 / t) ** (gamma + 1.0)


def p_dot_p(t_a, gamma_a, t_b, gamma_b):
    """Inner products of power-EMA profiles at snapshot times."""
    t_ratio = t_a / t_b
    t_exp = np.where(t_a < t_b, gamma_b, -gamma_a)
    t_max = np.maximum(t_a, t_b)
    num = (gamma_a + 1.0) * (gamma_b + 1.0) * t_ratio**t_exp
    return num / ((gamma_a + gamma_b + 1.0) * t_max)


def solve_weights(t_i, gamma_i, t_r, gamma_r) -> np.ndarray:
    """Least-squares weights reconstructing the target profile from the
    snapshot profiles."""

    def rv(x):
        return np.asarray(x, np.float64).reshape(-1, 1)

    def cv(x):
        return np.asarray(x, np.float64).reshape(1, -1)

    a = p_dot_p(rv(t_i), rv(gamma_i), cv(t_i), cv(gamma_i))
    b = p_dot_p(rv(t_i), rv(gamma_i), cv(t_r), cv(gamma_r))
    return np.linalg.solve(a, b)


def make_beta_fn(std: float):
    """beta(step) for the 1-indexed train step, evaluated in float32 as the
    JAX package evaluates it on the device; gamma is fixed per std."""
    exponent = np.float32(float(std_to_gamma(std)) + 1.0)
    one = np.float32(1.0)

    def beta_fn(step: int) -> float:
        t = max(np.float32(step), one)
        return float((one - one / t) ** exponent)

    return beta_fn


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], model_params: Dict[str, torch.Tensor], beta: float) -> None:
    """ema <- ema + (model - ema) * beta, in place (one foreach op per
    stage over all tensors): beta weights the model, so beta(1) = 0 keeps
    the EMA at its initial copy."""
    names = list(ema_params)
    ema = [ema_params[k] for k in names]
    diff = torch._foreach_sub([model_params[k].to(e.dtype) for k, e in zip(names, ema)], ema)
    torch._foreach_mul_(diff, beta)
    torch._foreach_add_(ema, diff)
