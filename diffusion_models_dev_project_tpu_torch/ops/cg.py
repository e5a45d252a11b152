"""Batched conjugate gradients for op(x) = rhs with a fixed iteration count.

Port of `ops/cg.py` of the JAX package, with its guards: a batch entry whose
residual has vanished (|r|² <= 1e-30) takes no further step, and a zero
denominator never divides.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cg"]


def _batch_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).reshape(a.shape[0], -1).sum(dim=1)


def cg(op: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, rhs: torch.Tensor,
       n_iter: int = 5) -> torch.Tensor:
    """`n_iter` CG iterations from the initial guess `x`; batch axis 0."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    r = rhs - op(x)
    p = r
    sq_old = _batch_dot(r, r)
    for _ in range(n_iter):
        d = op(p)
        inner_p_d = _batch_dot(p, d)
        live = sq_old > 1e-30
        alpha = torch.where(live, sq_old / torch.where(inner_p_d == 0, 1.0, inner_p_d), 0.0)
        x = x + alpha.reshape(shape) * p
        r = r - alpha.reshape(shape) * d
        sq_new = _batch_dot(r, r)
        beta = torch.where(live, sq_new / torch.where(sq_old == 0, 1.0, sq_old), 0.0)
        p = r + beta.reshape(shape) * p
        sq_old = sq_new
    return x
