"""Timestep respacing, the port's own copy of ``mapdit_tpu/diffusion/respace.py``.

`space_timesteps` selects a subset of the original process; the rebuilt
process carries (a) betas recomputed so cumulative alphas land on the kept
steps and (b) a `timestep_map` array folding compressed indices back to
original timesteps, a table the chain reads per step
(`GaussianDiffusion.model_timesteps`).
"""

from __future__ import annotations

from typing import Collection, Sequence, Set, Tuple, Union

import numpy as np


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Pick timesteps from equally-sized sections of the original process.

    ``section_counts`` is a list of per-section step counts, a comma-separated
    string of them, or ``"ddimN"`` for the DDIM paper's fixed striding.
    (Behavioral parity with reference `respace.py:12-62`.)
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim") :])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


def karras_timesteps(
    betas: np.ndarray, n: int, rho: float = 7.0
) -> Set[int]:
    """Karras et al. (EDM, arXiv 2206.00364 eq. 5) sigma-spaced subset.

    Beyond-reference schedule: timesteps are chosen so the noise-to-signal
    ratios sigma(t) = sqrt(1-acp)/sqrt(acp) follow the rho-7 power ramp —
    denser near low noise, where few-step samplers (DPM-Solver++) spend
    their discretization-error budget. Each target sigma maps to the
    nearest discrete timestep; collisions shift to the nearest unused step
    so exactly ``n`` model calls remain.
    """
    acp = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    sigma = np.sqrt((1.0 - acp) / acp)  # increasing in t
    if n >= sigma.shape[0]:
        return set(range(sigma.shape[0]))
    inv = 1.0 / rho
    ramp = np.linspace(0.0, 1.0, n)
    targets = (sigma[-1] ** inv + ramp * (sigma[0] ** inv - sigma[-1] ** inv)) ** rho
    idx = np.abs(sigma[None, :] - targets[:, None]).argmin(axis=1)  # descending t
    used: Set[int] = set()
    for i in idx:
        j = int(i)
        step = 0
        while j in used:  # nearest unused, alternating outward
            step += 1
            for cand in (j - step, j + step):
                if 0 <= cand < sigma.shape[0] and cand not in used:
                    j = cand
                    break
            else:
                continue
        used.add(j)
    assert len(used) == n
    return used


def respaced_betas(
    betas: np.ndarray, use_timesteps: Collection[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """(new_betas, timestep_map) for the kept subset.

    New betas are chosen so the respaced process's alpha-cumprod visits
    exactly the original values at the kept steps:
    ``1 - acp_i / acp_last_kept`` (reference `respace.py:79-87`).
    """
    use = set(use_timesteps)
    acp = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    last = 1.0
    new_betas, timestep_map = [], []
    for i, a in enumerate(acp):
        if i in use:
            new_betas.append(1.0 - a / last)
            last = a
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int64)
