"""Posterior-sampling predictor steps on torch tensors.

Port of `sampling/predictors.py` of the JAX package:

- `euler_maruyama_step`: naive score-SDE posterior sampling, and DPS
  (`aTweedy=True`) for VE/VP models;
- `ancestral_step`: DPS in the discrete DDPM framework;
- `dds_step`: Decomposed Diffusion Sampling, Tweedie -> CG or Woodbury -> DDIM;
- `langevin_corrector`: the Langevin MCMC corrector;
- `wrapper_ddim_step`: the unconditional DDIM step.

Each step takes its standard-normal draws as tensors (`noise`, or `noises`
for the corrector), the port's convention for noise (`engine.py`).
Gradients of the data-fit term `nloglik` are taken with
`torch.autograd.grad` with respect to x alone, in a grad-enabled region
around a detached copy of x, and come back detached: a chain of steps under
`torch.no_grad` then holds no autograd graph from one step to the next.
For DPS the gradient runs back through Tweedie and the score network, so
the network's parameters must not require a gradient (`factory.
get_standard_score` returns them frozen; on a CUDA tensor a conv3x3 weight
that requires one raises).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..ops.cg import cg
from ..ops.diffusion import ddim, tweedy
from ..ops.sde import DDPM, SDE
from ..ops.woodbury import woodbury_dc
from ..parallel.mesh import all_reduce_sum

__all__ = ["make_nloglik", "make_dc_op", "euler_maruyama_step", "ancestral_step", "dds_step",
           "langevin_corrector", "wrapper_ddim_step"]


def _b(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def make_nloglik(ray_trafo, observation: torch.Tensor, mesh=None) -> Callable:
    """x -> ||y - A x||_2 over the whole tensor; with a `mesh` of several
    ranks, each holding its rows of the batch, over the whole batch."""
    if mesh is None or mesh.world == 1:
        return lambda x: torch.linalg.vector_norm(observation - ray_trafo.apply(x))
    return lambda x: all_reduce_sum(mesh, (observation - ray_trafo.apply(x)).square().sum()).sqrt()


def make_dc_op(ray_trafo, gamma: float) -> Callable:
    """x -> x + gamma AᵀA x, the CG system operator; through the fused
    `gram` when the operator carries its tables."""
    if getattr(ray_trafo, "gram_q", None) is not None:
        return lambda x: x + gamma * ray_trafo.gram(x)
    return lambda x: x + gamma * ray_trafo.adjoint(ray_trafo.apply(x))


def _value_and_grad(fn: Callable, x: torch.Tensor):
    """(value, aux, d value / d x) of `value, aux = fn(x)`, all detached; the
    gradient is taken with respect to x alone."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        value, aux = fn(xx)
        (grad,) = torch.autograd.grad(value, xx)
    detach = lambda a: tuple(v.detach() for v in a) if isinstance(a, tuple) else a.detach()  # noqa: E731
    return value.detach(), detach(aux), grad


def _grad(nloglik: Callable, x: torch.Tensor) -> torch.Tensor:
    return _value_and_grad(lambda xx: (nloglik(xx), xx), x)[2]


def euler_maruyama_step(score_fn: Callable, sde: SDE, x: torch.Tensor, t: torch.Tensor,
                        step_size: float, noise: torch.Tensor,
                        nloglik: Optional[Callable] = None,
                        datafitscale: Optional[float] = None, penalty: float = 1.0,
                        aTweedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Euler-Maruyama predictor step for VE/VP: unconditional without
    `nloglik`, naive (the data-fit gradient in x added to the score) with
    it, DPS with `aTweedy` (the gradient of nloglik(Tweedie(score(x), x)) in
    x, through the score network).  Returns (x_next, x_mean)."""
    if sde.prediction_type != "score":
        raise ValueError("euler_maruyama_step needs a score model (VE/VP)")
    if nloglik is not None and aTweedy:
        def loss_of_x(xx):
            s_inner = score_fn(xx, t)
            return nloglik(tweedy(s_inner, xx, sde, t)), s_inner

        loss, s, grad = _value_and_grad(loss_of_x, x)
    else:
        s = score_fn(x, t)
        grad = _grad(nloglik, x) if nloglik is not None else None

    drift, diffusion = sde.sde(x, t)
    diff2 = _b(diffusion, x.ndim) ** 2
    if grad is not None and not aTweedy:
        s = s - penalty * grad * datafitscale
    x_mean = x - (drift - diff2 * s) * step_size
    x_next = x_mean + torch.sqrt(diff2 * step_size) * noise
    if grad is not None and aTweedy:
        x_next = x_next - penalty * grad * loss ** -1
    return x_next, x_mean


def ancestral_step(score_fn: Callable, sde: DDPM, x: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor, nloglik: Optional[Callable] = None,
                   penalty: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPS by ancestral sampling for DDPM (unconditional without `nloglik`);
    `t` is the integer step per batch entry.  Returns (x_next, xhat0)."""
    if sde.prediction_type != "epsilon":
        raise ValueError("ancestral_step needs an epsilon model (DDPM)")
    if nloglik is None:
        s = score_fn(x, t)
        xhat0 = tweedy(s, x, sde, t)
        grad = None
    else:
        def loss_of_x(xx):
            s_inner = score_fn(xx, t)
            xh = tweedy(s_inner, xx, sde, t)
            return nloglik(xh), (s_inner, xh)

        loss, (s, xhat0), grad = _value_and_grad(loss_of_x, x)
    std_t = _b(sde.marginal_prob_std(t), x.ndim)
    alpha_t = _b(torch.from_numpy(sde.alphas).to(x.device)[t.long()], x.ndim)
    x_mean = (x - (1.0 - alpha_t) / std_t * s) / torch.sqrt(alpha_t)
    if grad is not None:
        x_mean = x_mean - penalty * grad * loss ** -1
    return x_mean + torch.sqrt(1.0 - alpha_t) * noise, xhat0


def dds_step(score_fn: Callable, sde: SDE, x: torch.Tensor, t: torch.Tensor,
             t_prev: torch.Tensor, rhs: torch.Tensor, ray_trafo, gamma: float,
             eta: float, cg_iter: int, noise: torch.Tensor,
             use_simplified_eqn: bool = True, observation: Optional[torch.Tensor] = None,
             dc_sinv: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decomposed Diffusion Sampling: one score forward, Tweedie, the data
    consistency (I + gamma AᵀA) xhat = xhat0 + gamma Aᵀy (`rhs` = Aᵀy) by
    `cg_iter` CG iterations, or exactly by the Woodbury identity when
    `dc_sinv` ((gamma⁻¹ I + A Aᵀ)⁻¹) and `observation` are given, then DDIM
    with the standard-normal `noise`.  Returns (x_next, xhat0)."""
    s = score_fn(x, t)
    xhat0 = tweedy(s, x, sde, t)
    if dc_sinv is not None:
        xhat = woodbury_dc(ray_trafo, dc_sinv, xhat0, observation)
    else:
        op = make_dc_op(ray_trafo, gamma)
        xhat = cg(op, xhat0, xhat0 + gamma * rhs, n_iter=cg_iter)
    x_next = ddim(sde, s, xhat, t, t_prev, eta, noise, use_simplified_eqn=use_simplified_eqn)
    return x_next, xhat0


def langevin_corrector(score_fn: Callable, sde: SDE, x: torch.Tensor, t: torch.Tensor,
                       noises: Sequence[torch.Tensor], nloglik: Optional[Callable] = None,
                       datafitscale: Optional[float] = None, penalty: float = 1.0,
                       snr: float = 0.16, mesh=None) -> torch.Tensor:
    """Langevin MCMC corrector, one step per standard-normal draw in
    `noises`: x += eps * g + sqrt(2 eps) z, with g the score (less the
    penalised data-fit gradient with `nloglik`) and eps set from `snr` and
    the mean over the batch of |g| (with a `mesh` of several ranks, each
    holding its rows, over the whole batch)."""
    if sde.prediction_type != "score":
        raise ValueError("langevin_corrector needs a score model (VE/VP)")
    noise_norm = math.sqrt(math.prod(x.shape[1:]))
    for z in noises:
        overall = score_fn(x, t)
        if nloglik is not None:
            overall = overall - penalty * _grad(nloglik, x) * datafitscale
        norms = torch.linalg.vector_norm(overall.reshape(overall.shape[0], -1), dim=-1)
        if mesh is None or mesh.world == 1:
            gnorm = norms.mean()
        else:
            gnorm = all_reduce_sum(mesh, norms.sum()) / (norms.shape[0] * mesh.world)
        step = 2.0 * (snr * noise_norm / gnorm) ** 2
        x = x + step * overall + torch.sqrt(2.0 * step) * z
    return x


def wrapper_ddim_step(score_fn: Callable, sde: SDE, x: torch.Tensor, t: torch.Tensor,
                      t_prev: torch.Tensor, noise: torch.Tensor,
                      eta: float = 0.85) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unconditional DDIM step.  Returns (x_next, xhat0)."""
    s = score_fn(x, t)
    xhat0 = tweedy(s, x, sde, t)
    return ddim(sde, s, xhat0, t, t_prev, eta, noise, use_simplified_eqn=False), xhat0
