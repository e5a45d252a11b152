"""Tweedie denoising and the DDIM step.

Port of `ops/diffusion.py` of the JAX package.  Images are NHWC; time
tensors are per batch (B,).  `ddim` takes its standard-normal `noise`
explicitly, so that a test can hand it the JAX package's draw.
"""
from __future__ import annotations

import torch

from .sde import DDPM, SDE, VESDE, VPSDE

__all__ = ["eps_pred_from_s", "tweedy", "ddim"]


def _b(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def eps_pred_from_s(s: torch.Tensor, std_t: torch.Tensor) -> torch.Tensor:
    """Score prediction -> epsilon prediction: eps = -std * s."""
    return -std_t * s


def tweedy(s: torch.Tensor, x: torch.Tensor, sde: SDE, t: torch.Tensor) -> torch.Tensor:
    """Tweedie denoiser: xhat0 = (x - eps * std_t) / mean_t."""
    div = _b(sde.marginal_prob_mean(t), x.ndim) ** -1
    std_t = _b(sde.marginal_prob_std(t), x.ndim)
    eps = eps_pred_from_s(s, std_t) if sde.prediction_type == "score" else s
    return (x - eps * std_t) * div


def ddim(sde: SDE, s: torch.Tensor, xhat: torch.Tensor, t: torch.Tensor,
         t_prev: torch.Tensor, eta: float, noise: torch.Tensor,
         use_simplified_eqn: bool = False) -> torch.Tensor:
    """One DDIM update from t to t_prev; `s` is the raw model output, `xhat`
    the data-consistent denoised estimate, `noise` a standard-normal draw of
    xhat's shape."""
    std_t = _b(sde.marginal_prob_std(t), xhat.ndim)
    if isinstance(sde, VESDE):
        std_prev = _b(sde.marginal_prob_std(t_prev), xhat.ndim)
        if use_simplified_eqn:
            tbeta = torch.ones_like(std_t)
        else:
            tbeta = 1.0 - std_prev ** 2 / std_t ** 2
        noise_det = -std_prev * std_t * torch.sqrt(1.0 - tbeta ** 2 * eta ** 2) * s
        noise_sto = std_prev * eta * tbeta * noise
        return xhat + noise_det + noise_sto
    if isinstance(sde, (VPSDE, DDPM)):
        mean_prev = _b(sde.marginal_prob_mean(t_prev), xhat.ndim)
        mean_t = _b(sde.marginal_prob_mean(t), xhat.ndim)
        tbeta = torch.sqrt((1.0 - mean_prev ** 2) / (1.0 - mean_t ** 2)) * torch.sqrt(
            1.0 - mean_t ** 2 / mean_prev ** 2)
        # NaN guard for the t_prev = -1 endpoint
        tbeta = torch.where(torch.isnan(tbeta), torch.zeros_like(tbeta), tbeta)
        eps = eps_pred_from_s(s, std_t) if isinstance(sde, VPSDE) else s
        noise_det = torch.sqrt(1.0 - mean_prev ** 2 - tbeta ** 2 * eta ** 2) * eps
        noise_sto = eta * tbeta * noise
        return xhat * mean_prev + noise_det + noise_sto
    raise NotImplementedError(type(sde))
