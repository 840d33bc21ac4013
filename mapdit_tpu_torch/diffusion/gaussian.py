"""Gaussian diffusion: float32 coefficient tables on the device and the
ancestral (DDPM) sampling chains.

Port of the tables and of ``p_sample``, ``p_sample_loop`` and
``p_sample_loop_fast`` from ``mapdit_tpu/diffusion/gaussian.py``. The tables
are computed on the host in float64 and stored as float32 tensors. The step
noise comes from an explicit ``torch.Generator``; ``noise_fn(t, shape)``
replaces it, the hook that lets a test feed the same noise to the JAX
package and the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mapdit_tpu_torch.utils.device import resolve_device

START_X, EPSILON = "start_x", "epsilon"
LEARNED, FIXED_SMALL, FIXED_LARGE, LEARNED_RANGE = "learned", "fixed_small", "fixed_large", "learned_range"
MSE, RESCALED_MSE, KL, RESCALED_KL = "mse", "rescaled_mse", "kl", "rescaled_kl"

ModelFn = Callable[..., torch.Tensor]


@dataclasses.dataclass
class GaussianDiffusion:
    """Diffusion process: mode switches and float32 coefficient tables."""

    mean_type: str
    var_type: str
    loss_type: str
    num_timesteps: int
    original_num_steps: int

    betas: torch.Tensor
    log_betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    # compressed index -> original timestep (identity when not respaced)
    timestep_map: torch.Tensor

    @classmethod
    def create(
        cls,
        betas: np.ndarray,
        *,
        mean_type: str = EPSILON,
        var_type: str = LEARNED_RANGE,
        loss_type: str = MSE,
        timestep_map: Optional[np.ndarray] = None,
        original_num_steps: Optional[int] = None,
        device=None,
    ) -> "GaussianDiffusion":
        """Tables for ``betas`` on ``device`` (default CUDA)."""
        device = resolve_device(device)
        betas = np.asarray(betas, dtype=np.float64)
        assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
        n = betas.shape[0]

        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)

        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        # n == 1: the only posterior variance is 0 and its log is -inf, as
        # intended (the t == 0 step adds no noise)
        with np.errstate(divide="ignore"):
            post_logvar_clipped = np.log(np.append(post_var[1], post_var[1:])) if n > 1 else np.log(post_var)
        fixed_large_var = np.append(post_var[1], betas[1:]) if n > 1 else betas

        if timestep_map is None:
            timestep_map = np.arange(n)
        if original_num_steps is None:
            original_num_steps = n

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        return cls(
            mean_type=mean_type,
            var_type=var_type,
            loss_type=loss_type,
            num_timesteps=n,
            original_num_steps=int(original_num_steps),
            betas=f32(betas),
            log_betas=f32(np.log(betas)),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            alphas_cumprod_next=f32(acp_next),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(post_logvar_clipped),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            fixed_large_variance=f32(fixed_large_var),
            fixed_large_log_variance=f32(np.log(fixed_large_var)),
            timestep_map=torch.as_tensor(np.asarray(timestep_map, dtype=np.int64), device=device),
        )

    def _extract(self, table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        return table[t].reshape(t.shape[0], *([1] * (ndim - 1)))

    def model_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Compressed -> original timesteps as raw floats, what the model
        consumes."""
        return self.timestep_map[t].float()

    def p_mean_variance(
        self, model_fn: ModelFn, x, t, clip_denoised: bool = True, denoised_fn=None, model_kwargs=None
    ) -> Dict[str, torch.Tensor]:
        """p(x_{t-1} | x_t) statistics from one model call."""
        nd = x.ndim
        model_output = model_fn(x, self.model_timesteps(t), **(model_kwargs or {}))
        if self.var_type in (LEARNED, LEARNED_RANGE):
            model_output, var_values = torch.chunk(model_output, 2, dim=1)
            if self.var_type == LEARNED_RANGE:
                min_log = self._extract(self.posterior_log_variance_clipped, t, nd)
                max_log = self._extract(self.log_betas, t, nd)
                frac = (var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            else:
                model_log_variance = var_values
        elif self.var_type == FIXED_LARGE:
            model_log_variance = self._extract(self.fixed_large_log_variance, t, nd)
        else:
            model_log_variance = self._extract(self.posterior_log_variance_clipped, t, nd)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            return x0

        if self.mean_type == START_X:
            pred_xstart = process_xstart(model_output)
        else:
            pred_xstart = process_xstart(
                self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x
                - self._extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * model_output
            )
        mean = (
            self._extract(self.posterior_mean_coef1, t, nd) * pred_xstart
            + self._extract(self.posterior_mean_coef2, t, nd) * x
        )
        return {"mean": mean, "log_variance": model_log_variance, "pred_xstart": pred_xstart}

    def _step_noise(self, x, t, generator, noise_fn):
        if noise_fn is not None:
            return noise_fn(t, x.shape).to(x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def p_sample(
        self, model_fn: ModelFn, x, t, generator=None, clip_denoised: bool = True, denoised_fn=None,
        model_kwargs=None, noise_fn=None,
    ) -> Dict[str, torch.Tensor]:
        """One ancestral step: mean + 1{t != 0} exp(logvar / 2) eps."""
        out = self.p_mean_variance(
            model_fn, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn, model_kwargs=model_kwargs
        )
        noise = self._step_noise(x, t, generator, noise_fn)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def p_sample_loop(
        self, model_fn: ModelFn, noise, generator=None, clip_denoised: bool = True, denoised_fn=None,
        model_kwargs=None, noise_fn=None,
    ) -> torch.Tensor:
        """The full denoising chain, t = num_timesteps-1 down to 0."""
        x = noise
        for ti in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((x.shape[0],), ti, dtype=torch.int64, device=x.device)
            x = self.p_sample(
                model_fn, x, t, generator, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                model_kwargs=model_kwargs, noise_fn=noise_fn,
            )["sample"]
        return x

    def p_sample_loop_fast(
        self, model_fn: ModelFn, noise, generator=None, clip_denoised: bool = True, denoised_fn=None,
        model_kwargs=None, noise_fn=None,
    ) -> torch.Tensor:
        """The DDPM chain for the default EPSILON + LEARNED_RANGE mode: the
        same ops in the same order as :meth:`p_sample_loop`, with the step's
        coefficients read as 0-d device tensors instead of per-row gathers."""
        assert self.mean_type == EPSILON and self.var_type == LEARNED_RANGE
        n = noise.shape[0]
        x = noise
        for ti in range(self.num_timesteps - 1, -1, -1):
            model_t = self.timestep_map[ti].float().expand(n)
            out = model_fn(x, model_t, **(model_kwargs or {}))
            eps_hat, var_values = torch.chunk(out, 2, dim=1)
            frac = (var_values + 1.0) / 2.0
            log_variance = frac * self.log_betas[ti] + (1.0 - frac) * self.posterior_log_variance_clipped[ti]
            pred_xstart = self.sqrt_recip_alphas_cumprod[ti] * x - self.sqrt_recipm1_alphas_cumprod[ti] * eps_hat
            if denoised_fn is not None:
                pred_xstart = denoised_fn(pred_xstart)
            if clip_denoised:
                pred_xstart = pred_xstart.clamp(-1.0, 1.0)
            mean = self.posterior_mean_coef1[ti] * pred_xstart + self.posterior_mean_coef2[ti] * x
            t = torch.full((n,), ti, dtype=torch.int64, device=x.device)
            step_noise = self._step_noise(x, t, generator, noise_fn)
            x = mean + float(ti != 0) * torch.exp(0.5 * log_variance) * step_noise
        return x
