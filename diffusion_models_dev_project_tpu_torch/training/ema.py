"""Exponential moving average of a model's parameters.

Port of `training/ema.py` of the JAX package, in place on fp32 tensors: the
shadow moves toward the parameters by 1 - d with the decay ramp
d = min(decay, (1 + n) / (10 + n)), n the update's count from 1.  The warm
start of the JAX trainer (the shadow copies the parameters and the count
stays 0 while the optimizer step is below `ema_warm_start_steps`) lives in
`training.trainer.make_train_step`.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["EmaState", "ema_copy", "ema_init", "ema_update"]


class EmaState:
    """The shadow (parameter name -> fp32 tensor) and its update count."""

    def __init__(self, shadow: Dict[str, torch.Tensor], num_updates: int = 0):
        self.shadow = shadow
        self.num_updates = int(num_updates)


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    """A shadow that copies `params`, count 0."""
    return EmaState({n: p.detach().clone() for n, p in params.items()}, 0)


@torch.no_grad()
def ema_copy(state: EmaState, params: Dict[str, torch.Tensor]) -> None:
    """The warm start: the shadow becomes `params`, the count 0."""
    torch._foreach_copy_(list(state.shadow.values()), [params[n].detach() for n in state.shadow])
    state.num_updates = 0


@torch.no_grad()
def ema_update(state: EmaState, params: Dict[str, torch.Tensor], decay: float) -> EmaState:
    """shadow <- shadow - (1 - d) (shadow - params), in place; returns `state`."""
    n = state.num_updates + 1
    d = min(decay, (1.0 + n) / (10.0 + n))
    shadow = list(state.shadow.values())
    diff = torch._foreach_sub(shadow, [params[name].detach() for name in state.shadow])
    torch._foreach_mul_(diff, 1.0 - d)
    torch._foreach_sub_(shadow, diff)
    state.num_updates = n
    return state
