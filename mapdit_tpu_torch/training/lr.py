"""Learning-rate schedule: linear warmup -> flat -> inverse-sqrt decay, port of
``mapdit_tpu/training/lr.py`` (the reference's ``create_lr_lambda``).

The multiplier at optimizer step k (0-based) is
    (k+1)/warmup                    if k+1 < warmup
    1/sqrt(max(k/start_decay, 1))   if k >= start_decay
    1.0                             otherwise
Defaults derive from num_steps: warmup = steps//150, start_decay = steps//10.
"""

from __future__ import annotations

import numpy as np


def warmup_flat_invsqrt(base_lr: float, num_lin_warmup: int, start_decay: int):
    """Schedule ``step -> lr`` (a Python float), evaluated in float32 as the
    JAX package evaluates it."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if step + 1 < num_lin_warmup:
            mult = (step + f32(1.0)) / f32(max(num_lin_warmup, 1))
        elif step >= start_decay:
            mult = f32(1.0) / np.sqrt(max(step / f32(max(start_decay, 1)), f32(1.0)))
        else:
            mult = f32(1.0)
        return float(f32(base_lr) * mult)

    return schedule


def default_schedule_steps(num_steps: int, num_lin_warmup=None, start_decay=None):
    """Fill the reference defaults."""
    if num_lin_warmup is None:
        num_lin_warmup = num_steps // 150
    if start_decay is None:
        start_decay = num_steps // 10
    return num_lin_warmup, start_decay
