"""Training losses for score- and epsilon-prediction diffusion models.

Port of `training/losses.py` of the JAX package:
- `score_matching_loss`: denoising score matching with continuous time
  t ~ U(eps, 1), loss = mean_b sum_pix (score * std + z)², optionally
  reweighted per sample by 1 + sigma_alpha * (std / std_max)²;
- `epsilon_matching_loss`: DDPM's epsilon MSE with t ~ U{1 .. N-1},
  loss = mean_b sum_pix (z - ẑ)².

Images are NHWC.  The JAX losses split a `jax.random` key for t and z; torch
cannot reproduce those bits, so each loss draws t, then z, from an explicit
`torch.Generator`, or takes them injected (the tests pass the JAX draws).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.sde import DDPM, SDE

__all__ = ["draw_time_and_noise", "epsilon_matching_loss", "score_matching_loss"]


def _bc(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def draw_time_and_noise(x: torch.Tensor, sde: SDE, generator: Optional[torch.Generator] = None,
                        eps: float = 1e-5):
    """(t, z) for one loss evaluation on the batch x: t ~ U(eps, 1) per
    image (integer t ~ U{1 .. N-1} for DDPM), then z ~ N(0, 1) of x's shape,
    both from `generator` on x's device."""
    b = x.shape[0]
    if isinstance(sde, DDPM):
        t = torch.randint(1, sde.num_steps, (b,), generator=generator, device=x.device)
    else:
        t = torch.rand((b,), generator=generator, device=x.device) * (1.0 - eps) + eps
    z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return t, z


def score_matching_loss(x: torch.Tensor, model_fn: Callable, sde: SDE, eps: float = 1e-5,
                        sigma_alpha: float = 0.0, generator: Optional[torch.Generator] = None,
                        t: Optional[torch.Tensor] = None,
                        z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Denoising score matching (JAX `score_matching_loss`); `t` and `z`,
    when given, replace the draws from `generator`.  `sigma_alpha` > 0
    multiplies each image's loss by 1 + sigma_alpha * (std / std_max)²;
    0 is the reference loss."""
    if t is None or z is None:
        t, z = draw_time_and_noise(x, sde, generator, eps)
    mean, std = sde.marginal_prob(x, t)
    std_b = _bc(std, x.ndim)
    score = model_fn(mean + z * std_b, t)
    per_sample = (score * std_b + z).square().sum(dim=(1, 2, 3))
    if sigma_alpha:
        std_max = sde.marginal_prob_std(torch.ones((), device=x.device))
        per_sample = per_sample * (1.0 + sigma_alpha * (std / std_max).square())
    return per_sample.mean()


def epsilon_matching_loss(x: torch.Tensor, model_fn: Callable, sde: DDPM,
                          generator: Optional[torch.Generator] = None,
                          t: Optional[torch.Tensor] = None,
                          z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDPM's epsilon matching (JAX `epsilon_matching_loss`), integer t."""
    if t is None or z is None:
        t, z = draw_time_and_noise(x, sde, generator)
    mean, std = sde.marginal_prob(x, t)
    zhat = model_fn(mean + z * _bc(std, x.ndim), t)
    return (z - zhat).square().sum(dim=(1, 2, 3)).mean()
