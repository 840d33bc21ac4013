"""UniPC, the unified predictor-corrector multistep ODE sampler (bh2,
order 2 with its corrector), port of ``mapdit_tpu/diffusion/unipc.py``.

Each model evaluation serves the corrector of its own point and the
predictor to the next, so the chain makes one model call a kept timestep.
The per-step coefficients (sigma / alpha ratios, expm1 phis, the
predictor's and corrector's history weights) are computed on the host in
float64 on the full grid and read as 0-d float32 tensors, one Python
iteration a step. Deterministic: no step noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mapdit_tpu_torch.diffusion.dpm_solver import chain_tables, x0_of

NAMES = ("sr_p", "a_p", "phi1_p", "rho_p", "ir1_p", "use_c", "sr_c", "a_c", "phi1_c", "rho_cp", "rho_ct", "ir1_c")


def unipc_coefficients(alphas_cumprod: np.ndarray):
    """Per-step coefficients of the UniPC(bh2, order 2) chain, a dict of
    float32 arrays of length N in chain order (index i is the i-th model
    call). The predictor (s_i -> s_{i+1}, s_N the virtual sigma=0 point):
    ``sr_p``, ``a_p``, ``phi1_p`` = expm1(-h_i), the history weight
    ``rho_p`` (1/2 on interior steps, else 0) and ``ir1_p`` = 1 / r1. The
    corrector of point s_i (s_{i-1} -> s_i, run at iteration i >= 1):
    ``use_c``, ``sr_c``, ``a_c``, ``phi1_c``, ``rho_cp`` (weight of the
    history difference; 0 at i = 1), ``rho_ct`` (weight of m_i - m_{i-1})
    and ``ir1_c``. The order-2 corrector weights solve
    [[1, 1], [r1, 1]] rhos = [b1, b2] in closed form."""
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    n = acp.shape[0]
    ts = np.arange(n - 1, -1, -1)
    alpha = np.sqrt(acp[ts])
    sigma = np.sqrt(1.0 - acp[ts])
    lam = np.log(alpha) - np.log(sigma)

    sr_p = np.zeros(n)
    a_p = np.ones(n)
    phi1_p = np.full(n, -1.0)
    rho_p = np.zeros(n)
    ir1_p = np.zeros(n)
    if n > 1:
        h = lam[1:] - lam[:-1]
        sr_p[:-1] = sigma[1:] / sigma[:-1]
        a_p[:-1] = alpha[1:]
        phi1_p[:-1] = np.expm1(-h)
    if n > 2:
        rho_p[1:-1] = 0.5
        r1 = (lam[:-2] - lam[1:-1]) / h[1:]
        ir1_p[1:-1] = 1.0 / r1

    use_c = np.zeros(n)
    sr_c = np.ones(n)
    a_c = np.ones(n)
    phi1_c = np.zeros(n)
    rho_cp = np.zeros(n)
    rho_ct = np.zeros(n)
    ir1_c = np.zeros(n)
    if n > 1:
        use_c[1:] = 1.0
        sr_c[1:] = sigma[1:] / sigma[:-1]
        a_c[1:] = alpha[1:]
        phi1_c[1:] = np.expm1(-h)
        hh = -h
        b_h = phi1_c[1:]
        k1 = phi1_c[1:] / hh - 1.0
        b1 = k1 / b_h
        b2 = 2.0 * (k1 / hh - 0.5) / b_h
        rho_ct[1] = 0.5
        if n > 2:
            r1 = (lam[:-2] - lam[1:-1]) / h[1:]
            cp = (b1[1:] - b2[1:]) / (1.0 - r1)
            rho_cp[2:] = cp
            rho_ct[2:] = b1[1:] - cp
            ir1_c[2:] = 1.0 / r1

    values = (sr_p, a_p, phi1_p, rho_p, ir1_p, use_c, sr_c, a_c, phi1_c, rho_cp, rho_ct, ir1_c)
    return {name: v.astype(np.float32) for name, v in zip(NAMES, values)}


def unipc_tables(diffusion, device):
    """(model_t, sra, srm1, coefficients by name): the chain's per-step
    tables on ``device``, in chain order."""
    co = unipc_coefficients(diffusion.alphas_cumprod.cpu().numpy())
    return chain_tables(diffusion, device) + ({k: torch.from_numpy(v).to(device) for k, v in co.items()},)


def unipc_loop(
    diffusion,
    model_fn,
    noise: torch.Tensor,
    generator=None,
    clip_denoised: bool = True,
    denoised_fn=None,
    model_kwargs=None,
    step_slice: Optional[Tuple[int, int]] = None,
    prev_carry: Optional[tuple] = None,
    return_carry: bool = False,
    tables=None,
):
    """The UniPC chain over ``diffusion``'s grid, with the contract of
    :func:`dpm_solver_pp_loop`. The multistep history crossing a segment
    boundary enters through ``prev_carry``, the 4-tuple a
    ``return_carry=True`` call returns (predicted sample, last corrected
    sample, the two latest x0 outputs). ``tables`` is
    :func:`unipc_tables`, built once by the caller."""
    del generator
    n_batch = noise.shape[0]
    lo, hi = step_slice if step_slice is not None else (0, diffusion.num_timesteps)
    model_t, sra, srm1, co = unipc_tables(diffusion, noise.device) if tables is None else tables
    if prev_carry is None:
        z = torch.zeros_like(noise)
        prev_carry = (noise, z, z, z)
    x_pred, x_last, m0, m1 = prev_carry
    for i in range(lo, hi):
        sr_p, a_p, phi1_p, rho_p, ir1_p, use_c, sr_c, a_c, phi1_c, rho_cp, rho_ct, ir1_c = (co[k][i] for k in NAMES)
        out = model_fn(x_pred, model_t[i].expand(n_batch), **(model_kwargs or {}))
        m = x0_of(diffusion, out, x_pred, sra[i], srm1[i], clip_denoised, denoised_fn)
        # UniC: correct this point's sample with its own model output
        d1_prev = (m1 - m0) * ir1_c
        d1_t = m - m0
        x_corr = sr_c * x_last - a_c * (phi1_c * m0 + phi1_c * (rho_cp * d1_prev + rho_ct * d1_t))
        x_i = use_c * x_corr + (1.0 - use_c) * x_pred
        # UniP: predict the next point from the corrected sample
        d1 = (m0 - m) * ir1_p
        x_next = sr_p * x_i - a_p * phi1_p * (m + rho_p * d1)
        x_pred, x_last, m0, m1 = x_next, x_i, m, m0
    carry = (x_pred, x_last, m0, m1)
    return carry if return_carry else carry[0]
