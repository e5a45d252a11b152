"""Random-ellipse phantom datasets, rasterised with torch.

Port of `data/ellipses.py` of the JAX package.  The host samples each
image's ellipse table with numpy (`sample_ellipse_params`, a copy of the
JAX package's, with the same per-fold `np.random.RandomState` seeding), so
both packages draw the same phantoms; `rasterize_ellipses` draws a batch of
tables on the tables' device, adding the ellipses in table order as the
JAX package's scan does.

Parameter distributions:
  v   ~ U(-0.4, 1)        value of each ellipse (summed where overlapping)
  a1,a2 ~ 0.2[*diameter] * Exp(1)   half-axes
  centre: uniform square (plain) or triangular-radius disk (disk variant)
  rot ~ U(0, 2pi); number of active ellipses ~ min(Poisson(E), E)
Normalization: subtract the global min from all non-zero pixels, divide by
the max.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["sample_ellipse_params", "rasterize_ellipses", "EllipsesDataset",
           "DiskDistributedEllipsesDataset", "get_disk_dist_ellipses_dataset",
           "get_ellipses_dataset"]


def sample_ellipse_params(rng: np.random.RandomState, max_n_ellipse: int,
                          diameter: Optional[float] = None) -> np.ndarray:
    """One image's ellipse table (E, 6): columns (v, a1, a2, cx, cy, rot)."""
    E = max_n_ellipse
    v = rng.uniform(-0.4, 1.0, (E,))
    if diameter is None:
        a1 = 0.2 * rng.exponential(1.0, (E,))
        a2 = 0.2 * rng.exponential(1.0, (E,))
        x = rng.uniform(-0.9, 0.9, (E,))
        y = rng.uniform(-0.9, 0.9, (E,))
    else:
        a1 = 0.2 * diameter * rng.exponential(1.0, (E,))
        a2 = 0.2 * diameter * rng.exponential(1.0, (E,))
        c_r = rng.triangular(0.0, diameter, diameter, size=(E,))
        c_a = rng.uniform(0.0, 2 * np.pi, (E,))
        x = np.cos(c_a) * c_r
        y = np.sin(c_a) * c_r
    rot = rng.uniform(0.0, 2 * np.pi, (E,))
    n = min(rng.poisson(E), E)
    v[n:] = 0.0
    return np.stack((v, a1, a2, x, y, rot), axis=1).astype(np.float32)


def rasterize_ellipses(params: torch.Tensor, im_size: int) -> torch.Tensor:
    """params (B, E, 6) fp32 -> images (B, im_size, im_size, 1) in [0, 1], on
    params' device.  Normalized coordinates in [-1, 1]^2 at pixel centres,
    x along columns (left to right), y along rows (top row = +1)."""
    dev = params.device
    cs = (torch.arange(im_size, device=dev, dtype=torch.float32) + 0.5) / im_size * 2.0 - 1.0
    px, py = cs[None, :], -cs[:, None]
    v, a1, a2, cx, cy, rot = params.unbind(-1)                       # (B, E) each
    ct, st = torch.cos(rot), torch.sin(rot)
    a1, a2 = a1.clamp(min=1e-8), a2.clamp(min=1e-8)
    b = params.shape[0]
    img = torch.zeros((b, im_size, im_size), device=dev)
    col = lambda a, e: a[:, e, None, None]  # noqa: E731
    for e in range(params.shape[1]):                                 # in table order
        dx, dy = px - col(cx, e), py - col(cy, e)
        u = (col(ct, e) * dx + col(st, e) * dy) / col(a1, e)
        w = (-col(st, e) * dx + col(ct, e) * dy) / col(a2, e)
        img = img + col(v, e) * (u * u + w * w <= 1.0)
    flat = img.reshape(b, -1)
    minv = flat.min(dim=1).values[:, None, None]
    img = torch.where(img != 0.0, img - minv, img)
    maxv = img.reshape(b, -1).max(dim=1).values[:, None, None]
    return (img / torch.where(maxv > 0, maxv, torch.ones_like(maxv)))[..., None]


class EllipsesDataset:
    """Iterable dataset of ellipse phantoms; images come back as numpy (H, W, 1)
    fp32, rasterised on `device` (default CUDA)."""

    diameter: Optional[float] = None

    def __init__(self, shape: Tuple[int, int] = (128, 128), length: int = 3200,
                 fixed_seed: int = 1, fold: str = "train", max_n_ellipse: int = 70,
                 device=None):
        if shape[0] != shape[1]:
            raise ValueError(f"square images only, not {shape}")
        self.shape = shape
        self.length = length
        self.max_n_ellipse = max_n_ellipse
        self.device = resolve_device(device)
        fixed_seed = None if fixed_seed in (False, None) else int(fixed_seed)
        if fixed_seed is not None and fold == "validation":
            fixed_seed += 1
        self.rng = np.random.RandomState(fixed_seed)
        self._params_cache: list = []

    def __len__(self) -> int:
        return self.length

    def _ensure_params(self, n: int):
        while len(self._params_cache) < n:
            self._params_cache.append(
                sample_ellipse_params(self.rng, self.max_n_ellipse, self.diameter))

    def params_batch(self, start: int, n: int) -> np.ndarray:
        self._ensure_params(start + n)
        return np.stack(self._params_cache[start:start + n])

    def __getitem__(self, idx: int) -> np.ndarray:
        params = torch.from_numpy(self.params_batch(idx, 1)).to(self.device)
        return rasterize_ellipses(params, self.shape[0])[0].cpu().numpy()

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self.length):
            yield self[i]

    def batches(self, batch_size: int, *, repeat: bool = True):
        """Endless (or single-pass) iterator of NHWC batches on the device."""
        i = 0
        while True:
            if i + batch_size > self.length:
                if not repeat:
                    return
                i = 0
            params = torch.from_numpy(self.params_batch(i, batch_size)).to(self.device)
            yield rasterize_ellipses(params, self.shape[0])
            i += batch_size


class DiskDistributedEllipsesDataset(EllipsesDataset):
    """Centres triangular-distributed in a disk."""

    def __init__(self, shape=(128, 128), length=3200, fixed_seed=1, fold="train",
                 diameter: float = 0.4745, max_n_ellipse: int = 70, device=None):
        super().__init__(shape=shape, length=length, fixed_seed=fixed_seed, fold=fold,
                         max_n_ellipse=max_n_ellipse, device=device)
        self.diameter = diameter


def get_ellipses_dataset(fold="train", im_size=128, length=3200, max_n_ellipse=70,
                         device=None) -> EllipsesDataset:
    return EllipsesDataset((im_size, im_size), length=length, fold=fold,
                           max_n_ellipse=max_n_ellipse, device=device)


def get_disk_dist_ellipses_dataset(fold="train", im_size=128, length=3200, diameter=0.4745,
                                   max_n_ellipse=70, device=None) -> DiskDistributedEllipsesDataset:
    return DiskDistributedEllipsesDataset((im_size, im_size), length=length, fold=fold,
                                          diameter=diameter, max_n_ellipse=max_n_ellipse,
                                          device=device)
