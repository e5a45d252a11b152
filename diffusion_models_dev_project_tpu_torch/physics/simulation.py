"""Measurement simulation: y = A x + white noise of std rel * mean(|A x|).

Port of `simulate` and `SimulatedDataset` of the JAX package's
`physics/simulation.py`.  The noise is drawn from `generator` (a
`torch.Generator` on the data's device), or given as `noise`, a
standard-normal array of the observation's shape.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["simulate", "SimulatedDataset", "seed_of"]


def seed_of(*path: int) -> int:
    """A generator seed from a path of integers, e.g. (seed, index, stream):
    numpy's `SeedSequence` hash of the path, where the JAX package folds
    each integer into its key (`jax.random.fold_in`)."""
    return int(np.random.SeedSequence([int(p) for p in path]).generate_state(1)[0])


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


class SimulatedDataset:
    """An image dataset as (observation, ground truth, FBP) triplets, NHWC on
    the operator's device, with noise that is fixed per index: image `idx`
    draws it from a `torch.Generator` seeded from (seed, idx) (`seed_of`;
    JAX folds the index into its key), so every read of an index gives the
    same observation."""

    def __init__(self, image_dataset, ray_trafo, white_noise_rel_stddev: float = 0.05,
                 seed: int = 1):
        self.images = image_dataset
        self.ray_trafo = ray_trafo
        self.white_noise_rel_stddev = white_noise_rel_stddev
        self.seed = seed

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        device = self.ray_trafo.device
        x = torch.as_tensor(np.asarray(self.images[idx]), dtype=torch.float32, device=device)
        if x.ndim == 3:
            x = x[None]
        gen = torch.Generator(device=device).manual_seed(seed_of(self.seed, idx))
        y = simulate(x, self.ray_trafo, self.white_noise_rel_stddev, generator=gen)
        return y, x, self.ray_trafo.fbp(y)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
