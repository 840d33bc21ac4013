"""DPM-Solver++(2M), the multistep second-order ODE sampler, port of
``mapdit_tpu/diffusion/dpm_solver.py``.

Every per-step coefficient (sigma ratios, ``expm1(-h)``, the 2M history
weight) is computed on the host in float64 from the (respaced) schedule,
stored as float32 tensors on the chain's device and read as 0-d tensors, one
Python iteration a step. Deterministic: no step noise. The final step is
first-order to a virtual sigma=0 point, so the chain returns the last x0
combination, already clean.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def dpm_solver_pp_coefficients(alphas_cumprod: np.ndarray):
    """Per-step coefficients of the 2M chain over the full grid, float32
    arrays of length N in chain order (high t first):
      sigma_ratio[i] = sigma(t_next) / sigma(t_cur)   (0 on the final step)
      alpha_next[i]  = alpha(t_next)                  (1 on the final step)
      em1[i]         = expm1(-h_i), h_i = lambda(t_next) - lambda(t_cur)
                       (-1 on the final step)
      c2[i]          = h_i / (2 h_{i-1}), the 2M history weight; 0 on the
                       first and the final step."""
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    n = acp.shape[0]
    ts = np.arange(n - 1, -1, -1)
    alpha = np.sqrt(acp[ts])
    sigma = np.sqrt(1.0 - acp[ts])
    lam = np.log(alpha) - np.log(sigma)

    sigma_ratio = np.zeros(n)
    alpha_next = np.ones(n)
    em1 = np.full(n, -1.0)
    h = np.full(n, np.inf)
    if n > 1:
        sigma_ratio[:-1] = sigma[1:] / sigma[:-1]
        alpha_next[:-1] = alpha[1:]
        h[:-1] = lam[1:] - lam[:-1]
        em1[:-1] = np.expm1(-h[:-1])
    c2 = np.zeros(n)
    if n > 2:
        c2[1:-1] = h[1:-1] / (2.0 * h[:-2])
    return tuple(a.astype(np.float32) for a in (sigma_ratio, alpha_next, em1, c2))


def chain_tables(diffusion, device):
    """The tables every ODE chain reads at each step, in chain order: the
    model's timestep and the two eps -> x0 coefficients."""
    ts = torch.arange(diffusion.num_timesteps - 1, -1, -1, device=diffusion.timestep_map.device)
    return tuple(
        a.to(device)
        for a in (
            diffusion.timestep_map[ts].float(),
            diffusion.sqrt_recip_alphas_cumprod[ts],
            diffusion.sqrt_recipm1_alphas_cumprod[ts],
        )
    )


def dpm_solver_pp_tables(diffusion, device):
    """(model_t, sra, srm1, sigma_ratio, alpha_next, em1, c2): the chain's
    per-step tables on ``device``, in chain order."""
    coefs = dpm_solver_pp_coefficients(diffusion.alphas_cumprod.cpu().numpy())
    return chain_tables(diffusion, device) + tuple(torch.from_numpy(a).to(device) for a in coefs)


def dpm_solver_pp_update(tables, i: int, x: torch.Tensor, x0: torch.Tensor, prev_x0: torch.Tensor) -> torch.Tensor:
    """Step i of the 2M chain: x at the next grid point from this point's
    x0 estimate and the previous one."""
    _, _, _, sigma_ratio, alpha_next, em1, c2 = tables
    d = (1.0 + c2[i]) * x0 - c2[i] * prev_x0
    return sigma_ratio[i] * x - alpha_next[i] * em1[i] * d


def x0_of(diffusion, out: torch.Tensor, x: torch.Tensor, sra, srm1, clip_denoised: bool, denoised_fn) -> torch.Tensor:
    """The x0 estimate of one model output (the variance half dropped:
    the ODE does not use it), thresholded and clipped."""
    if diffusion.mean_type not in ("epsilon", "start_x"):
        raise ValueError(f"the ODE samplers take eps or x0 models, not {diffusion.mean_type!r}")
    if diffusion.var_type in ("learned", "learned_range"):
        out = torch.chunk(out, 2, dim=1)[0]
    x0 = out if diffusion.mean_type == "start_x" else sra * x - srm1 * out
    if denoised_fn is not None:
        x0 = denoised_fn(x0)
    if clip_denoised:
        x0 = x0.clamp(-1.0, 1.0)
    return x0


def dpm_solver_pp_loop(
    diffusion,
    model_fn,
    noise: torch.Tensor,
    generator=None,
    clip_denoised: bool = True,
    denoised_fn=None,
    model_kwargs=None,
    step_slice: Optional[Tuple[int, int]] = None,
    prev_x0: Optional[torch.Tensor] = None,
    return_carry: bool = False,
    tables=None,
):
    """The DPM-Solver++(2M) chain over ``diffusion``'s grid: N model calls
    for an N-step process. ``generator`` is taken for a sampler-uniform
    call and not used.

    ``step_slice=(a, b)`` runs chain positions [a, b); the 2M history
    enters through ``prev_x0`` and leaves through ``return_carry`` (the
    call then returns ``(x, prev_x0)``), so segments with different model
    functions stitch into the unsegmented chain. The coefficients are
    always those of the full grid, sliced. ``tables``
    (:func:`dpm_solver_pp_tables`, built once by the caller) saves the
    host work and the device-to-host read of building them at each call."""
    del generator
    n_batch = noise.shape[0]
    lo, hi = step_slice if step_slice is not None else (0, diffusion.num_timesteps)
    tables = dpm_solver_pp_tables(diffusion, noise.device) if tables is None else tables
    model_t, sra, srm1 = tables[:3]
    x = noise
    prev_x0 = torch.zeros_like(noise) if prev_x0 is None else prev_x0
    for i in range(lo, hi):
        out = model_fn(x, model_t[i].expand(n_batch), **(model_kwargs or {}))
        x0 = x0_of(diffusion, out, x, sra[i], srm1[i], clip_denoised, denoised_fn)
        x, prev_x0 = dpm_solver_pp_update(tables, i, x, x0, prev_x0), x0
    return (x, prev_x0) if return_carry else x
