"""Gaussian diffusion: float32 coefficient tables on the device, the
ancestral (DDPM) and DDIM sampling chains, the training losses and the
full-chain VLB.

Port of ``mapdit_tpu/diffusion/gaussian.py``: the tables, ``q_sample`` and
``q_mean_variance``, the posterior, the guidance hooks, ``p_sample`` and
its loops (``p_sample_loop_fast`` with ``step_slice`` / ``return_carry``,
``p_sample_loop_progressive``), the DDIM steps and loop, the VB terms,
``training_losses``, ``prior_bpd`` / ``calc_bpd_loop`` and
``dynamic_threshold_fn``. The tables are computed on the host in float64 and
stored as float32 tensors. The chains are Python loops, one iteration a
step. The step noise comes from an explicit ``torch.Generator``, mutated in
place, so segments of a chain that share it draw the stream of one
unsegmented chain; ``noise_fn(t, shape)`` replaces it, the hook that lets a
test feed the same noise to the JAX package and the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mapdit_tpu_torch.diffusion.dmath import discretized_gaussian_log_likelihood, mean_flat, normal_kl
from mapdit_tpu_torch.utils.device import resolve_device

PREVIOUS_X, START_X, EPSILON = "previous_x", "start_x", "epsilon"
LEARNED, FIXED_SMALL, FIXED_LARGE, LEARNED_RANGE = "learned", "fixed_small", "fixed_large", "learned_range"
MSE, RESCALED_MSE, KL, RESCALED_KL = "mse", "rescaled_mse", "kl", "rescaled_kl"

ModelFn = Callable[..., torch.Tensor]


def dynamic_threshold_fn(percentile: float = 0.995, floor: float = 1.0):
    """Imagen-style dynamic thresholding in latent space, a ``denoised_fn``:
    each sample's x0 estimate is clipped to its own ``percentile``-quantile
    of |x0| (linear interpolation, as ``jnp.quantile``), floored at
    ``floor``, without the pixel-space rescale."""
    if not 0.0 < percentile <= 1.0:
        raise ValueError(f"dynamic threshold percentile {percentile} is not in (0, 1]")

    def fn(x0: torch.Tensor) -> torch.Tensor:
        flat = x0.reshape(x0.shape[0], -1).abs()
        s = torch.quantile(flat, percentile, dim=1)
        s = s.clamp_min(floor).reshape(-1, *([1] * (x0.ndim - 1)))
        return torch.clamp(x0, -s, s)

    return fn


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

    def q_mean_variance(self, x_start, t) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        nd = x_start.ndim
        return (
            self._extract(self.sqrt_alphas_cumprod, t, nd) * x_start,
            self._extract(1.0 - self.alphas_cumprod, t, nd),
            self._extract(self.log_one_minus_alphas_cumprod, t, nd),
        )

    def q_sample(self, x_start, t, noise) -> torch.Tensor:
        """sqrt(acp) x0 + sqrt(1 - acp) eps."""
        nd = x_start.ndim
        return (
            self._extract(self.sqrt_alphas_cumprod, t, nd) * x_start
            + self._extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        nd = x_t.ndim
        mean = (
            self._extract(self.posterior_mean_coef1, t, nd) * x_start
            + self._extract(self.posterior_mean_coef2, t, nd) * x_t
        )
        return (
            mean,
            self._extract(self.posterior_variance, t, nd),
            self._extract(self.posterior_log_variance_clipped, t, nd),
        )

    def _predict_xstart_from_eps(self, x_t, t, eps) -> torch.Tensor:
        nd = x_t.ndim
        return (
            self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - self._extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps
        )

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart) -> torch.Tensor:
        nd = x_t.ndim
        return (self._extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart) / self._extract(
            self.sqrt_recipm1_alphas_cumprod, t, nd
        )

    def p_mean_variance_from_output(
        self, model_output, x, t, clip_denoised: bool = True, denoised_fn=None
    ) -> Dict[str, torch.Tensor]:
        """p(x_{t-1} | x_t) statistics from a raw model output."""
        nd = x.ndim
        if self.var_type in (LEARNED, LEARNED_RANGE):
            model_output, var_values = torch.chunk(model_output, 2, dim=1)
            if self.var_type == LEARNED_RANGE:
                min_log = self._extract(self.posterior_log_variance_clipped, t, nd)
                max_log = self._extract(self.log_betas, t, nd)
                frac = (var_values + 1.0) / 2.0
                model_log_variance = frac * max_log + (1.0 - frac) * min_log
            else:
                model_log_variance = var_values
            model_variance = torch.exp(model_log_variance)
        elif self.var_type == FIXED_LARGE:
            model_variance = self._extract(self.fixed_large_variance, t, nd)
            model_log_variance = self._extract(self.fixed_large_log_variance, t, nd)
        else:
            model_variance = self._extract(self.posterior_variance, t, nd)
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
            pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    def _vb_terms_from_output(self, model_output, x_start, x_t, t, clip_denoised: bool):
        """KL(q || p) in bits, the decoder NLL at t = 0."""
        true_mean, _, true_logvar = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance_from_output(model_output, x_t, t, clip_denoised=clip_denoised)
        kl = mean_flat(normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"])) / math.log(2.0)
        decoder_nll = mean_flat(
            -discretized_gaussian_log_likelihood(x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        ) / math.log(2.0)
        return torch.where(t == 0, decoder_nll, kl), out["pred_xstart"]

    def vb_terms_bpd(
        self, model_fn: ModelFn, x_start, x_t, t, clip_denoised: bool = True, model_kwargs=None
    ) -> Dict[str, torch.Tensor]:
        out = model_fn(x_t, self.model_timesteps(t), **(model_kwargs or {}))
        output, pred_xstart = self._vb_terms_from_output(out, x_start, x_t, t, clip_denoised)
        return {"output": output, "pred_xstart": pred_xstart}

    def training_losses(
        self, model_fn: ModelFn, x_start, t, model_kwargs=None, noise=None, generator=None
    ) -> Dict[str, torch.Tensor]:
        """Per-sample training loss. LEARNED_RANGE: loss = mse(eps) + vb,
        the VB term seeing a detached eps half, so variance learning cannot
        move the eps objective (the reference's frozen output)."""
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device, dtype=x_start.dtype)
        x_t = self.q_sample(x_start, t, noise)
        terms: Dict[str, torch.Tensor] = {}
        if self.loss_type in (KL, RESCALED_KL):
            terms["loss"] = self.vb_terms_bpd(
                model_fn, x_start, x_t, t, clip_denoised=False, model_kwargs=model_kwargs
            )["output"]
            if self.loss_type == RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
            return terms

        model_output = model_fn(x_t, self.model_timesteps(t), **(model_kwargs or {}))
        if self.var_type in (LEARNED, LEARNED_RANGE):
            eps_out, var_values = torch.chunk(model_output, 2, dim=1)
            frozen = torch.cat([eps_out.detach(), var_values], dim=1)
            vb, _ = self._vb_terms_from_output(frozen, x_start, x_t, t, clip_denoised=False)
            if self.loss_type == RESCALED_MSE:
                vb = vb * (self.num_timesteps / 1000.0)
            terms["vb"] = vb
            model_output = eps_out

        if self.mean_type == PREVIOUS_X:
            target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
        elif self.mean_type == START_X:
            target = x_start
        else:
            target = noise
        terms["mse"] = mean_flat((target - model_output) ** 2)
        terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
        return terms

    def p_mean_variance(
        self, model_fn: ModelFn, x, t, clip_denoised: bool = True, denoised_fn=None, model_kwargs=None
    ) -> Dict[str, torch.Tensor]:
        """p(x_{t-1} | x_t) statistics from one model call."""
        model_output = model_fn(x, self.model_timesteps(t), **(model_kwargs or {}))
        return self.p_mean_variance_from_output(model_output, x, t, clip_denoised, denoised_fn)

    def condition_mean(self, cond_fn, p_mean_var, x, t, model_kwargs=None) -> torch.Tensor:
        """The mean shifted by variance * grad log p(y | x) (``cond_fn``)."""
        gradient = cond_fn(x, self.model_timesteps(t), **(model_kwargs or {}))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t, model_kwargs=None) -> Dict[str, torch.Tensor]:
        """The statistics with eps moved by -sqrt(1 - acp) * ``cond_fn``
        (score conditioning, for DDIM)."""
        nd = x.ndim
        alpha_bar = self._extract(self.alphas_cumprod, t, nd)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1.0 - alpha_bar) * cond_fn(x, self.model_timesteps(t), **(model_kwargs or {}))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    def _step_noise(self, x, t, generator, noise_fn):
        if noise_fn is not None:
            return noise_fn(t, x.shape).to(x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    def p_sample(
        self, model_fn: ModelFn, x, t, generator=None, clip_denoised: bool = True, denoised_fn=None,
        model_kwargs=None, noise_fn=None, cond_fn=None,
    ) -> Dict[str, torch.Tensor]:
        """One ancestral step: mean + 1{t != 0} exp(logvar / 2) eps."""
        out = self.p_mean_variance(
            model_fn, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn, model_kwargs=model_kwargs
        )
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t, model_kwargs)
        noise = self._step_noise(x, t, generator, noise_fn)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def _chain(self, x):
        """(t_index, (N,) int64 timestep tensor) in chain order."""
        for ti in range(self.num_timesteps - 1, -1, -1):
            yield ti, torch.full((x.shape[0],), ti, dtype=torch.int64, device=x.device)

    def p_sample_loop(
        self, model_fn: ModelFn, noise, generator=None, clip_denoised: bool = True, denoised_fn=None,
        model_kwargs=None, noise_fn=None, cond_fn=None,
    ) -> torch.Tensor:
        """The full denoising chain, t = num_timesteps-1 down to 0."""
        x = noise
        for _, t in self._chain(noise):
            x = self.p_sample(
                model_fn, x, t, generator, clip_denoised=clip_denoised, denoised_fn=denoised_fn,
                model_kwargs=model_kwargs, noise_fn=noise_fn, cond_fn=cond_fn,
            )["sample"]
        return x

    def p_sample_loop_progressive(self, model_fn: ModelFn, noise, generator=None, **kw) -> Dict[str, torch.Tensor]:
        """The chain of :meth:`p_sample_loop` that also returns every step's
        ``sample`` and ``pred_xstart``, stacked to (T, N, C, H, W) in chain
        order."""
        x, outs = noise, []
        for _, t in self._chain(noise):
            out = self.p_sample(model_fn, x, t, generator, **kw)
            outs.append(out)
            x = out["sample"]
        return {key: torch.stack([o[key] for o in outs]) for key in ("sample", "pred_xstart")}

    def p_sample_loop_fast(
        self, model_fn: ModelFn, noise, generator=None, clip_denoised: bool = True, denoised_fn=None,
        model_kwargs=None, noise_fn=None, step_slice: Optional[Tuple[int, int]] = None, return_carry: bool = False,
    ):
        """The DDPM chain for the default EPSILON + LEARNED_RANGE mode: the
        same ops in the same order as :meth:`p_sample_loop`, with the step's
        coefficients read as 0-d device tensors instead of per-row gathers.

        ``step_slice=(a, b)`` runs only chain positions [a, b) (position 0
        is t = num_timesteps-1). With ``return_carry`` the call returns
        ``(x, generator)``: the generator is the carried state, drawn from
        in place, so segments with different model functions stitch into
        the unsegmented chain, its noise stream included. An empty slice
        passes the carry through."""
        assert self.mean_type == EPSILON and self.var_type == LEARNED_RANGE
        n = noise.shape[0]
        x = noise
        lo, hi = step_slice if step_slice is not None else (0, self.num_timesteps)
        for ti in list(range(self.num_timesteps - 1, -1, -1))[lo:hi]:
            out = model_fn(x, self.timestep_map[ti].float().expand(n), **(model_kwargs or {}))
            x = self.fast_step(out, x, ti, generator, clip_denoised, denoised_fn, noise_fn)
        return (x, generator) if return_carry else x

    def fast_step(self, out, x, ti: int, generator=None, clip_denoised: bool = True, denoised_fn=None, noise_fn=None):
        """One step of :meth:`p_sample_loop_fast` at timestep index ``ti``
        from the model's output ``out`` at ``x``."""
        eps_hat, var_values = torch.chunk(out, 2, dim=1)
        frac = (var_values + 1.0) / 2.0
        log_variance = frac * self.log_betas[ti] + (1.0 - frac) * self.posterior_log_variance_clipped[ti]
        pred_xstart = self.sqrt_recip_alphas_cumprod[ti] * x - self.sqrt_recipm1_alphas_cumprod[ti] * eps_hat
        if denoised_fn is not None:
            pred_xstart = denoised_fn(pred_xstart)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean = self.posterior_mean_coef1[ti] * pred_xstart + self.posterior_mean_coef2[ti] * x
        t = torch.full((x.shape[0],), ti, dtype=torch.int64, device=x.device)
        step_noise = self._step_noise(x, t, generator, noise_fn)
        return mean + float(ti != 0) * torch.exp(0.5 * log_variance) * step_noise

    def ddim_sample(
        self, model_fn: ModelFn, x, t, generator=None, clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
        model_kwargs=None, eta: float = 0.0, noise_fn=None,
    ) -> Dict[str, torch.Tensor]:
        """One DDIM step. At ``eta == 0`` the step draws no noise (its
        coefficient is 0); otherwise it draws from ``generator`` or takes
        ``noise_fn(t, shape)``."""
        out = self.p_mean_variance(
            model_fn, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn, model_kwargs=model_kwargs
        )
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        nd = x.ndim
        alpha_bar = self._extract(self.alphas_cumprod, t, nd)
        alpha_bar_prev = self._extract(self.alphas_cumprod_prev, t, nd)
        sigma = (
            eta * torch.sqrt((1.0 - alpha_bar_prev) / (1.0 - alpha_bar)) * torch.sqrt(1.0 - alpha_bar / alpha_bar_prev)
        )
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(1.0 - alpha_bar_prev - sigma**2) * eps
        if eta == 0.0:
            return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}
        noise = self._step_noise(x, t, generator, noise_fn)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (nd - 1)))
        return {"sample": mean_pred + nonzero * sigma * noise, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(
        self, model_fn: ModelFn, x, t, clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
        model_kwargs=None, eta: float = 0.0,
    ) -> Dict[str, torch.Tensor]:
        """One step of the deterministic DDIM ODE towards higher t."""
        if eta != 0.0:
            raise ValueError("the reverse ODE is only the deterministic path (eta=0)")
        out = self.p_mean_variance(
            model_fn, x, t, clip_denoised=clip_denoised, denoised_fn=denoised_fn, model_kwargs=model_kwargs
        )
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t, model_kwargs)
        nd = x.ndim
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar_next = self._extract(self.alphas_cumprod_next, t, nd)
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_next) + torch.sqrt(1.0 - alpha_bar_next) * eps
        return {"sample": mean_pred, "pred_xstart": out["pred_xstart"]}

    def ddim_sample_loop(
        self, model_fn: ModelFn, noise, generator=None, clip_denoised: bool = True, denoised_fn=None, cond_fn=None,
        model_kwargs=None, eta: float = 0.0, noise_fn=None,
    ) -> torch.Tensor:
        """The full DDIM chain, t = num_timesteps-1 down to 0."""
        x = noise
        for _, t in self._chain(noise):
            x = self.ddim_sample(
                model_fn, x, t, generator, clip_denoised=clip_denoised, denoised_fn=denoised_fn, cond_fn=cond_fn,
                model_kwargs=model_kwargs, eta=eta, noise_fn=noise_fn,
            )["sample"]
        return x

    def prior_bpd(self, x_start) -> torch.Tensor:
        """KL(q(x_T | x_0) || N(0, I)) in bits per dimension."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.int64, device=x_start.device)
        qt_mean, _, qt_logvar = self.q_mean_variance(x_start, t)
        zero = torch.zeros((), device=x_start.device)
        return mean_flat(normal_kl(qt_mean, qt_logvar, zero, zero)) / math.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(
        self, model_fn: ModelFn, x_start, generator=None, clip_denoised: bool = True, model_kwargs=None,
        noise_fn=None,
    ) -> Dict[str, torch.Tensor]:
        """The VLB over the whole chain: each step's VB term, x0 and eps
        errors ((N, T), chain order), the prior term and their total."""
        vb, xstart_mse, mse = [], [], []
        for _, t in self._chain(x_start):
            noise = self._step_noise(x_start, t, generator, noise_fn)
            x_t = self.q_sample(x_start, t, noise)
            out = self.vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=clip_denoised, model_kwargs=model_kwargs)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - noise) ** 2))
        vb, xstart_mse, mse = (torch.stack(a, dim=1) for a in (vb, xstart_mse, mse))
        prior = self.prior_bpd(x_start)
        return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb, "xstart_mse": xstart_mse, "mse": mse}
