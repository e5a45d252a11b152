"""Device mesh and batch placement (JAX `parallel/mesh.py`).

The JAX package scales by SPMD: a `jax.sharding.Mesh` with a `data` axis,
over which the CLIs shard their batch of images when more than one device
is visible.  The port runs on one card.  Its mesh is that device, with a
`data` axis of size 1: `shard_batch` moves every tensor of a batch there
and `replicate` does the same for parameters.  A mesh over more than one
device raises NotImplementedError: sharding over several cards is not
ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "replicate", "shard_batch"]


class Mesh(NamedTuple):
    """The devices of a mesh and its axis names; the port's holds one."""
    devices: tuple
    axis_names: tuple = ("data",)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self) -> dict:
        return {name: (len(self.devices) if i == 0 else 1)
                for i, name in enumerate(self.axis_names)}


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              device=None) -> Mesh:
    """A mesh over `n_devices` of the visible CUDA devices (all by default),
    or over `device` when the caller names one (`"cpu"`).  More than one
    device raises NotImplementedError."""
    if device is not None:
        visible = [resolve_device(device)]
    else:
        resolve_device()                         # raises without CUDA
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_devices or len(visible)
    if n > 1:
        raise NotImplementedError(f"a mesh over {n} devices: the port runs on one card, and "
                                  "sharding a batch over several cards is not ported")
    if n < 1 or n > len(visible):
        raise ValueError(f"{n} devices asked for, {len(visible)} visible")
    return Mesh(tuple(visible[:1]), tuple(axis_names))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Every tensor of `batch` (a tensor, or dicts, lists and tuples of them)
    with its leading axis over `axis` of `mesh`: on one device, moved there."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    return _tree_map(lambda a: torch.as_tensor(a).to(mesh.device), batch)


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` on each device of `mesh`: on one device, moved there."""
    return _tree_map(lambda a: torch.as_tensor(a).to(mesh.device), tree)
