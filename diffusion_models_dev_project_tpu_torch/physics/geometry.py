"""Parallel-beam CT geometry (host-side numpy).

Copy of `parallel_beam_geometry` of the JAX package's `physics/geometry.py`,
which follows `odl.tomo.parallel_beam_geometry`: unit image cells centred at
the origin, rho = half the image diagonal, `2*ceil(rho) + 1` detector bins
spanning [-rho, rho], and angles at the midpoints of a uniform partition of
[0, pi).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["ParallelBeamGeometry", "parallel_beam_geometry"]


@dataclasses.dataclass(frozen=True)
class ParallelBeamGeometry:
    im_shape: Tuple[int, int]
    angles: np.ndarray  # radians, shape (num_angles,)
    det_count: int
    det_spacing: float

    @property
    def obs_shape(self) -> Tuple[int, int]:
        return (len(self.angles), self.det_count)


def parallel_beam_geometry(im_shape: Tuple[int, int], num_angles: int) -> ParallelBeamGeometry:
    h, w = im_shape
    corners = np.array([[h / 2, w / 2]])
    rho = float(np.linalg.norm(corners, axis=1).max())
    det_count = 2 * int(np.ceil(rho)) + 1
    det_spacing = 2 * rho / det_count
    angles = (np.arange(num_angles) + 0.5) * np.pi / num_angles
    return ParallelBeamGeometry(im_shape=(h, w), angles=angles.astype(np.float64),
                                det_count=det_count, det_spacing=det_spacing)
