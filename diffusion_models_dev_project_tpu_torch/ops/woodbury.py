"""Exact DDS data consistency by the Woodbury identity, in sinogram space.

Port of `ops/woodbury.py` of the JAX package.  The DDS proximal system

    (I + gamma AᵀA) x = xhat0 + gamma Aᵀ y

has the closed form

    x* = xhat0 + Aᵀ (gamma⁻¹ I + A Aᵀ)⁻¹ (y − A xhat0),

where S = gamma⁻¹ I + A Aᵀ lives in sinogram space: 7680² for the walnut
protocol against 65,536 model pixels.  S⁻¹ is formed once per (operator,
gamma) for an operator with an explicit dense `.matrix`
(`physics/ray_trafo.py::DenseRayTransform`), in fp32 on the operator's
device (TF32 stays off, `utils/device.py`; gamma⁻¹ I >= 100 I at gamma =
0.01 keeps S well conditioned).  Each step then costs one apply, one
adjoint and one product with S⁻¹, where CG(n) costs n + 1 Gram applies.
"""
from __future__ import annotations

import torch

__all__ = ["build_woodbury_sinv", "woodbury_dc"]


def build_woodbury_sinv(trafo, gamma: float) -> torch.Tensor:
    """(gamma⁻¹ I + A Aᵀ)⁻¹ of a matrix-backed operator, on its device."""
    A = trafo.matrix
    S = A @ A.T
    S.diagonal().add_(1.0 / gamma)
    return torch.linalg.inv(S)


def woodbury_dc(trafo, sinv: torch.Tensor, xhat0: torch.Tensor,
                observation: torch.Tensor) -> torch.Tensor:
    """xhat0 -> the exact minimiser of ||x − xhat0||² + gamma ||A x − y||²."""
    b, c = observation.shape[0], observation.shape[-1]
    d = observation - trafo.apply(xhat0)                  # (B, *obs_shape, C)
    z = d.movedim(-1, 1).reshape(b * c, -1) @ sinv         # S⁻¹ is symmetric
    z = z.reshape(b, c, *observation.shape[1:-1]).movedim(1, -1)
    return xhat0 + trafo.adjoint(z)
