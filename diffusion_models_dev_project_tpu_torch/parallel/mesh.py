"""Device mesh and batch placement over a process group (JAX `parallel/mesh.py`).

The JAX package scales by SPMD: a `jax.sharding.Mesh` with a `data` axis,
over which the CLIs shard their batch of images and the trainer its batch,
in one process.  The port runs one process per card (`parallel/launch.py`),
so its mesh is this process's rank of a `torch.distributed` group, with a
`data` axis of the group's size:

- `shard_batch` keeps this rank's rows of the leading axis (the rows the
  JAX mesh places on its device);
- `gather_batch` is the full batch on every rank, in rank order (what a
  JAX global array holds);
- `replicate` moves a tree to the rank's device, equal to rank 0's;
- `all_reduce_mean_` and `all_reduce_sum` are the reductions that XLA
  inserts for a sharded program (the gradient psum; a norm over the batch).

Outside a process group the mesh is one device, with a `data` axis of
size 1: every helper moves the tensors there and does nothing else.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["Mesh", "all_reduce_mean_", "all_reduce_sum", "gather_batch", "make_mesh",
           "replicate", "shard_batch"]


class Mesh(NamedTuple):
    """This process's place in a mesh: its device, the axis names, its rank
    among `world` ranks, and the process group (None for one device)."""
    devices: tuple                  # the device this process drives
    axis_names: tuple = ("data",)
    rank: int = 0
    world: int = 1
    group: Any = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self) -> dict:
        return {name: (self.world if i == 0 else 1) for i, name in enumerate(self.axis_names)}

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of `n`; raises unless the ranks divide it."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not divide over the mesh's {self.world} ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              device=None) -> Mesh:
    """Inside an initialised process group, the mesh of that group: this
    rank on `device` (by default the CUDA device `parallel/launch.py` set
    for it).  Outside one, a mesh over one device: `device` when the caller
    names one (`"cpu"`), else the current CUDA device.  `n_devices`, when
    given, must be the group's size (1 without a group): a mesh over more
    devices needs one process per device (`parallel/launch.py::launch`)."""
    if device is not None:
        dev = resolve_device(device)
    else:
        resolve_device()                         # raises without CUDA
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh over {n_devices} devices asked for in a process group of "
                         f"{world}: a mesh over several devices takes one process per device "
                         "(parallel/launch.py)")
    return Mesh((dev,), tuple(axis_names), rank, world, group)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Every tensor of `batch` (a tensor, or dicts, lists and tuples of them)
    with its leading axis over `axis` of `mesh`: this rank's rows, on its
    device.  A leading axis that the ranks do not divide raises."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    return _tree_map(lambda a: torch.as_tensor(a)[mesh.rows(len(a))].to(mesh.device), batch)


def gather_batch(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The full batch of which every rank holds its rows `local`, on every
    rank, in rank order.  Gloo has no all-gather of CUDA tensors, so each
    rank writes its rows into a zero-filled full tensor and the ranks
    all-reduce it: every element is one rank's value plus zeros, exactly."""
    if mesh.world == 1:
        return local
    full = local.new_zeros((local.shape[0] * mesh.world, *local.shape[1:]))
    full[mesh.rows(full.shape[0])] = local
    dist.all_reduce(full, group=mesh.group)
    return full


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` on this rank's device, equal to rank 0's: moved
    there, then broadcast from rank 0 in place (into the caller's tensor
    when it already lay on the device)."""
    def put(a):
        a = torch.as_tensor(a).to(mesh.device)
        if mesh.world > 1:
            dist.broadcast(a.detach(), src=0, group=mesh.group)
        return a
    return _tree_map(put, tree)


@torch.no_grad()
def all_reduce_mean_(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor (fp32) replaced in place by its mean over the ranks,
    through one all-reduce of their concatenation; every rank gets the same
    bits."""
    if mesh.world == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors), [p.view_as(t) for p, t in zip(parts, tensors)])


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; the gradient of each rank's term is the
    upstream gradient (every rank's copy of the sum is the same function of
    this rank's term)."""

    @staticmethod
    def forward(ctx, value, group):
        out = value.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """`value` summed over the ranks; differentiable in this rank's `value`
    (a loss over the whole batch, as JAX's global arrays give it)."""
    if mesh.world == 1:
        return value
    return _AllReduceSum.apply(value, mesh.group)
