"""Diffusion SDEs (VE, VP, discrete DDPM) on torch tensors.

Port of `ops/sde.py` of the JAX package: frozen dataclasses of floats whose
methods take per-batch time tensors (B,).  The DDPM beta cumprod is computed
in float64 on the host and stored as float32, with a leading 1.0 so that
t = -1 maps to alpha_bar = 1.  `prediction_type` is 'score' for VE/VP and
'epsilon' for DDPM.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["SDE", "VESDE", "VPSDE", "DDPM", "get_standard_sde"]


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


@dataclasses.dataclass(frozen=True)
class SDE:
    """Base class; continuous time in [0, 1] (VE/VP) or integer steps (DDPM)."""

    prediction_type: str = dataclasses.field(default="score", init=False)

    def sde(self, x: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(drift, diffusion) of the forward SDE; drift has x's shape,
        diffusion is (B,)."""
        raise NotImplementedError

    def marginal_prob_std(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def marginal_prob_mean(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def marginal_prob(self, x: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return x * _bcast(self.marginal_prob_mean(t), x.ndim), self.marginal_prob_std(t)

    def prior_sampling(self, shape, generator: Optional[torch.Generator] = None,
                       device="cpu", noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A draw from the prior; `noise` (standard normal) replaces the draw."""
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        return noise * self._prior_scale()

    def _prior_scale(self) -> float:
        return 1.0


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    prediction_type: str = dataclasses.field(default="score", init=False)

    def marginal_prob_std(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def marginal_prob_mean(self, t):
        return torch.ones_like(t)

    def diffusion_coeff(self, t):
        sigma = self.marginal_prob_std(t)
        return sigma * math.sqrt(2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))

    def sde(self, x, t):
        return torch.zeros_like(x), self.diffusion_coeff(t)

    def _prior_scale(self):
        return self.sigma_max


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE):
    beta_min: float = 0.1
    beta_max: float = 20.0
    prediction_type: str = dataclasses.field(default="score", init=False)

    def _log_mean_coeff(self, t):
        return -0.25 * t ** 2 * (self.beta_max - self.beta_min) - 0.5 * t * self.beta_min

    def marginal_prob_std(self, t):
        # -expm1 avoids the fp32 cancellation of 1 - exp(2 lm) at small t
        return torch.sqrt(-torch.expm1(2.0 * self._log_mean_coeff(t)))

    def marginal_prob_mean(self, t):
        return torch.exp(self._log_mean_coeff(t))

    def diffusion_coeff(self, t):
        return torch.sqrt(self.beta_min + t * (self.beta_max - self.beta_min))

    def sde(self, x, t):
        beta_t = self.beta_min + t * (self.beta_max - self.beta_min)
        return -0.5 * _bcast(beta_t, x.ndim) * x, self.diffusion_coeff(t)


@dataclasses.dataclass(frozen=True, eq=False)
class DDPM(SDE):
    """Discrete DDPM with a linear beta schedule; t are integer step indices
    in [-1, num_steps-1]."""

    beta_min: float = 0.0001
    beta_max: float = 0.02
    num_steps: int = 1000
    prediction_type: str = dataclasses.field(default="epsilon", init=False)
    alpha_cumprod: np.ndarray = dataclasses.field(init=False, repr=False)
    alphas: np.ndarray = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        betas = np.linspace(self.beta_min, self.beta_max, self.num_steps, dtype=np.float64)
        if not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("DDPM betas must lie in (0, 1]")
        padded = np.concatenate([np.zeros(1), betas])
        object.__setattr__(self, "alpha_cumprod",
                           np.cumprod(1.0 - padded).astype(np.float32))
        object.__setattr__(self, "alphas", (1.0 - betas).astype(np.float32))

    def _compute_alpha_cumprod(self, t):
        table = torch.from_numpy(self.alpha_cumprod).to(t.device)
        return table[t.long() + 1]

    def marginal_prob_std(self, t):
        return torch.sqrt(1.0 - self._compute_alpha_cumprod(t))

    def marginal_prob_mean(self, t):
        return torch.sqrt(self._compute_alpha_cumprod(t))


def get_standard_sde(config) -> SDE:
    name = config.sde.type.lower()
    if name == "vesde":
        return VESDE(sigma_min=config.sde.sigma_min, sigma_max=config.sde.sigma_max)
    if name == "vpsde":
        return VPSDE(beta_min=config.sde.beta_min, beta_max=config.sde.beta_max)
    if name == "ddpm":
        return DDPM(beta_min=config.sde.beta_min, beta_max=config.sde.beta_max,
                    num_steps=config.sde.num_steps)
    raise NotImplementedError(name)
