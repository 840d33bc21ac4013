"""Distribution math for the variational bound, port of
``mapdit_tpu/diffusion/dmath.py`` (the reference's
``diffusion/diffusion_utils.py``: normal_kl, approx_standard_normal_cdf and
the discretized gaussian log-likelihood, evaluated in log space)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))), broadcasting."""
    mean1, logvar1, mean2, logvar2 = (torch.as_tensor(v) for v in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2) + (mean1 - mean2) ** 2 * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def _log_cosh(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


def _log_sinh(d: torch.Tensor) -> torch.Tensor:
    # d > 0 assumed; stable for both tiny and large d
    return d + torch.log(-torch.expm1(-2.0 * d)) - math.log(2.0)


def discretized_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to 1/255 bins on [-1, 1],
    the edge bins integrating the tails. The tanh-approximated CDF is
    ``sigmoid(2a)``, so the bin mass is ``sinh(a+ - a-) / (2 cosh a+ cosh
    a-)`` and the edge masses are log-sigmoids; the 1e-12 floor of the
    reference's direct form is kept."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    z_plus = inv_stdv * (centered + 1.0 / 255.0)
    z_min = inv_stdv * (centered - 1.0 / 255.0)

    def g(z):
        return math.sqrt(2.0 / math.pi) * (z + 0.044715 * z**3)

    a_plus, a_min = g(z_plus), g(z_min)
    log_cdf_plus = -F.softplus(-2.0 * a_plus)
    log_one_minus_cdf_min = -F.softplus(2.0 * a_min)
    log_cdf_delta = _log_sinh(a_plus - a_min) - _log_cosh(a_plus) - _log_cosh(a_min) - math.log(2.0)

    floor = math.log(1e-12)
    return torch.where(
        x < -0.999,
        log_cdf_plus.clamp(min=floor),
        torch.where(x > 0.999, log_one_minus_cdf_min.clamp(min=floor), log_cdf_delta.clamp(min=floor)),
    )
