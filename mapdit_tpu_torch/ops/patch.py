"""Patchify / unpatchify, port of ``mapdit_tpu/ops/patch.py``.

Token features are ordered (p1, p2, c), channels fastest, as the reference's
``b c (h p1) (w p2) -> b (h w) (p1 p2 c)``.
"""

from __future__ import annotations

import torch


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, (H/P)*(W/P), P*P*C)."""
    b, c, h, w = x.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, gh * gw, p * p * c)


def unpatchify(x: torch.Tensor, input_size: int, patch_size: int) -> torch.Tensor:
    """(B, (H/P)*(W/P), P*P*C) -> (B, C, H, W); exact inverse of patchify."""
    b, _, f = x.shape
    p = patch_size
    g = input_size // p
    c = f // (p * p)
    x = x.reshape(b, g, g, p, p, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, c, g * p, g * p)
