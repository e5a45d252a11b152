"""AAPM LDCT (L067) slice dataset.

Port of `data/aapm.py` of the JAX package: slices are `.npy` files named by
a float prefix; the test fold is every 8th slice, the validation fold every
40th of the rest, and the training fold the rest of the rest.  Items are
NHWC (H, W, 1) float32 numpy arrays; `batches` yields torch batches on a
device (CUDA unless the caller asks for another), shuffled and flipped from
numpy's generator seeded 1234, as the JAX package draws them.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..utils.device import resolve_device

__all__ = ["AAPMDataset"]


class AAPMDataset:
    def __init__(self, part: str, base_path: str, seed: int = 1):
        assert part in ("val", "test", "train")
        self.part = part
        self.base_path = base_path
        files = os.listdir(base_path)
        files.sort(key=lambda n: float(n.split(".")[0]))
        test = files[::8]
        rest = sorted(set(files) - set(test), key=lambda n: float(n.split(".")[0]))
        if part == "test":
            self.slices = test
        elif part == "val":
            self.slices = rest[::40]
        else:
            # the reference ships no train fold; here it is every non-test
            # slice outside the val fold, as in the JAX package
            self.slices = [s for i, s in enumerate(rest) if i % 40]

    def __len__(self) -> int:
        return len(self.slices)

    def __getitem__(self, idx: int) -> np.ndarray:
        x = np.load(os.path.join(self.base_path, self.slices[idx]))
        return np.asarray(x, dtype=np.float32)[..., None]   # (H, W, 1)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]

    def batches(self, batch_size: int, *, repeat: bool = True, augment: bool = True,
                device=None) -> Iterator:
        """Endless iterator of shuffled NHWC float32 batches on `device`
        (CUDA unless the caller asks for another; see `resolve_device`), each
        image flipped left-right with probability 1/2 when `augment`."""
        return self._batches(batch_size, repeat, augment, resolve_device(device))

    def _batches(self, batch_size, repeat, augment, device):
        import torch

        cache = np.stack([self[i] for i in range(len(self))])   # (N, H, W, 1)
        rng = np.random.default_rng(1234)
        order = rng.permutation(len(cache))
        i = 0
        while True:
            if i + batch_size > len(cache):
                if not repeat:
                    return
                order = rng.permutation(len(cache))
                i = 0
            batch = cache[order[i:i + batch_size]]
            if augment:
                flips = rng.random(batch.shape[0]) < 0.5
                batch = np.where(flips[:, None, None, None], batch[:, :, ::-1], batch)
            yield torch.from_numpy(np.ascontiguousarray(batch)).to(device)
            i += batch_size
