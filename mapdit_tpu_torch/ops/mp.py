"""Magnitude-preserving math primitives (plain tensor functions).

Port of ``mapdit_tpu/ops/mp.py``. At model call sites the lerp weight ``t``
of :func:`mp_sum` / :func:`modulate` is a learned 0-dim tensor (the
per-block gains); as in the reference, the magnitude-restoring denominator is
then a constant for autograd, so the gradient reaches ``t`` only through the
lerp numerator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def mp_sum(a: torch.Tensor, b: torch.Tensor, t=0.5) -> torch.Tensor:
    """``lerp(a, b, t) / sqrt((1-t)^2 + t^2)``; the denominator is detached
    when ``t`` is a tensor."""
    lerp = a + (b - a) * t
    if isinstance(t, torch.Tensor):
        denom = torch.sqrt((1.0 - t) ** 2 + t**2).detach()
    else:
        denom = math.sqrt((1.0 - t) ** 2 + t**2)
    return lerp / denom


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, t=0.5) -> torch.Tensor:
    """``mp_sum(x * scale[:, None], shift[:, None], t)`` over (N, T, D) x."""
    return mp_sum(x * scale[:, None, :], shift[:, None, :], t=t)


def normalize(x: torch.Tensor, eps: float = 1e-4, norm: Optional[torch.Tensor] = None,
              dim: Optional[int] = None) -> torch.Tensor:
    """Row-normalize the last dim to norm ``sqrt(dim)``:
    ``x * sqrt(dim) / (||x||_2 + eps)``. For a slice of the rows' columns,
    ``norm`` (keepdim) and ``dim`` give the whole rows' norm and length."""
    if norm is None:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x * (math.sqrt(x.shape[-1] if dim is None else dim) / (norm + eps))


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    """``silu(x) / 0.596``: SiLU rescaled to unit second moment."""
    return F.silu(x) / 0.596


def rotate_pairs(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotation modulation: rotate the channel pairs ``(x[..., 2i],
    x[..., 2i+1])`` of (N, T, D) ``x`` by the per-sample angles ``theta``
    (N, D/2), broadcast over the tokens. Each pair keeps its norm."""
    n, tok, d = x.shape
    xp = x.reshape(n, tok, d // 2, 2)
    cos = torch.cos(theta)[:, None, :]
    sin = torch.sin(theta)[:, None, :]
    x0, x1 = xp[..., 0], xp[..., 1]
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], dim=-1).reshape(n, tok, d)
