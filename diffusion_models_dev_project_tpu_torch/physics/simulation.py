"""Measurement simulation: y = A x + white noise of std rel * mean(|A x|).

Port of `simulate` of the JAX package's `physics/simulation.py`.  The
noise is drawn from `generator` (a `torch.Generator` on the data's device),
or given as `noise`, a standard-normal array of the observation's shape.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["simulate"]


def simulate(x: torch.Tensor, ray_trafo, white_noise_rel_stddev: float,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noisy observation (B, A, D, C) of the NHWC ground truth `x`."""
    observation = ray_trafo.apply(x)
    noise_level = white_noise_rel_stddev * observation.abs().mean()
    if noise is None:
        noise = torch.randn(observation.shape, generator=generator,
                            dtype=observation.dtype, device=observation.device)
    elif noise.shape != observation.shape:
        raise ValueError(f"noise {tuple(noise.shape)} vs observation {tuple(observation.shape)}")
    return observation + noise_level * noise.to(observation)
