"""Device choice for the port's entry points: CUDA unless the caller asks
for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, CUDA when None. Raises when CUDA is
    asked for (explicitly or by default) and none is available; there is no
    silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mapdit_tpu_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
