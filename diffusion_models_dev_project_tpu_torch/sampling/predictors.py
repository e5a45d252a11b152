"""Posterior-sampling predictor steps: DDS (this slice of the port).

Port of `make_dc_op` and `dds_step` of `sampling/predictors.py` of the JAX
package.  The naive, DPS, ancestral and Langevin steps are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops.cg import cg
from ..ops.diffusion import ddim, tweedy
from ..ops.sde import SDE

__all__ = ["make_dc_op", "dds_step"]


def make_dc_op(ray_trafo, gamma: float) -> Callable:
    """x -> x + gamma AᵀA x, the CG system operator; through the fused
    `gram` when the operator carries its tables."""
    if getattr(ray_trafo, "gram_q", None) is not None:
        return lambda x: x + gamma * ray_trafo.gram(x)
    return lambda x: x + gamma * ray_trafo.adjoint(ray_trafo.apply(x))


def dds_step(score_fn: Callable, sde: SDE, x: torch.Tensor, t: torch.Tensor,
             t_prev: torch.Tensor, rhs: torch.Tensor, ray_trafo, gamma: float,
             eta: float, cg_iter: int, noise: torch.Tensor,
             use_simplified_eqn: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decomposed Diffusion Sampling: one score forward, Tweedie, `cg_iter`
    CG iterations on (I + gamma AᵀA) xhat = xhat0 + gamma Aᵀy (`rhs` = Aᵀy),
    then DDIM with the standard-normal `noise`.  Returns (x_next, xhat0)."""
    s = score_fn(x, t)
    xhat0 = tweedy(s, x, sde, t)
    op = make_dc_op(ray_trafo, gamma)
    xhat = cg(op, xhat0, xhat0 + gamma * rhs, n_iter=cg_iter)
    x_next = ddim(sde, s, xhat, t, t_prev, eta, noise, use_simplified_eqn=use_simplified_eqn)
    return x_next, xhat0
