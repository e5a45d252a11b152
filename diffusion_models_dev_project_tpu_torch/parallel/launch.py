"""One process per rank: how the port runs a mesh over several cards.

The JAX package drives every device of its mesh from one process.  The
port's loops are paced by the host (an eager op costs 25-35 µs of Python
and launch), so each card gets a process of its own, and the processes
form a `torch.distributed` group (`parallel/mesh.py::make_mesh` reads it):

- `rank_devices` gives the ranks of a sharded run: one per visible card, or
  the ranks of the group this process already belongs to;
- `launch(fn, devices, backend, *args)` runs `fn(*args)` once per rank and
  returns rank 0's result.  It spawns one process per entry of `devices`
  (the `spawn` start method: the caller may hold CUDA), which meet at a
  `file://` store in a temporary directory, set their device and join the
  group with the named backend (`nccl` for cards, `gloo` for the CPU by
  default; two ranks on one card need `gloo`, named by the caller).  When
  a rank raises, dies or times out in a collective, the others are killed
  and `launch` raises.  Inside a group already (a rank of `launch`, or a
  process of `torchrun`, whose `RANK`, `WORLD_SIZE` and `LOCAL_RANK` it
  reads) it runs `fn` in this process, in that group.

Nothing falls back: a failed `init_process_group`, rank or kernel raises,
and no backend is switched and no rank moved to the CPU after a failure.
The kernels are built (or found built) before the ranks start, so that the
ranks only load the library.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = ["DEFAULT_TIMEOUT_S", "is_rank0", "launch", "rank_devices"]

DEFAULT_TIMEOUT_S = 600.0       # a collective that waits longer raises in its rank
_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_rank0() -> bool:
    """True outside a process group and on its rank 0."""
    return not _in_group() or dist.get_rank() == 0


def _torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN) and not _in_group()


def rank_devices(device=None) -> List[str]:
    """The devices of a sharded run, one entry per rank.  Inside a process
    group (a rank of `launch`) or under `torchrun`, the group's ranks, each
    entry this process's device (the ranks exist; `launch` joins them).
    Otherwise one rank per visible card (`device` None or "cuda"), or one
    rank on the CPU (`device="cpu"`)."""
    dev = resolve_device(device)
    if _in_group():
        own = "cpu" if dev.type == "cpu" else f"cuda:{torch.cuda.current_device()}"
        return [own] * dist.get_world_size()
    if _torchrun():
        own = "cpu" if dev.type == "cpu" else f"cuda:{os.environ['LOCAL_RANK']}"
        return [own] * int(os.environ["WORLD_SIZE"])
    if dev.type == "cpu":
        return ["cpu"]
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _default_backend(devices: Sequence[str]) -> str:
    return "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"


def _set_device(device: str) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


def _rank_main(rank: int, devices: Sequence[str], backend: str, store: str, timeout_s: float,
               fn: Callable, args: tuple, results) -> None:
    """One spawned rank: join the group, run `fn`, report to the parent."""
    try:
        _set_device(devices[rank])
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=len(devices),
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out if rank == 0 else None)))
    except BaseException:       # reported to the parent, which kills the other ranks and raises
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1) from None


def launch(fn: Callable, devices: Sequence[str], backend: Optional[str] = None, *args,
           timeout_s: float = DEFAULT_TIMEOUT_S):
    """`fn(*args)` on one rank per entry of `devices`; returns rank 0's result
    (pickled across, so keep it small and on the host).  `backend` defaults
    to `nccl` for CUDA devices and `gloo` for the CPU; NCCL refuses two
    ranks on one card, so that layout must name `gloo`.  `timeout_s` bounds
    each collective.  `fn` must be importable by name (a module-level
    function), as the `spawn` start method sends it by reference."""
    devices = [str(d) for d in devices]
    if not devices:
        raise ValueError("launch: no devices")
    backend = backend or _default_backend(devices)
    if _in_group():
        if dist.get_world_size() != len(devices):
            raise ValueError(f"{len(devices)} ranks asked for inside a group of "
                             f"{dist.get_world_size()}")
        return fn(*args)
    if _torchrun():
        if int(os.environ["WORLD_SIZE"]) != len(devices):
            raise ValueError(f"{len(devices)} ranks asked for under torchrun's "
                             f"{os.environ['WORLD_SIZE']}")
        _set_device(devices[int(os.environ["RANK"])])
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        return out
    if backend == "nccl" and len(set(devices)) < len(devices):
        raise ValueError(f"NCCL takes one rank per card, not {devices}; name backend 'gloo' "
                         "to put several ranks on one card")
    if any(torch.device(d).type == "cuda" for d in devices):
        from ..ops import _build

        _build.build()                     # here, so that the ranks only load the library
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="launch_store_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, devices, backend,
                                                   os.path.join(store_dir, "store"), timeout_s,
                                                   fn, args, results), daemon=True)
             for r in range(len(devices))]
    try:
        for p in procs:
            p.start()
        out = _collect(procs, results)
        for p in procs:
            p.join(timeout=60)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)


def _collect(procs, results):
    """Rank 0's result once every rank has reported success; raises at the
    first rank that reports a failure or dies without a report."""
    done, out = set(), None
    while len(done) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in done and not p.is_alive()]
            if not dead:
                continue
            time.sleep(1.0)               # a report put just before the exit is read first
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                codes = {r: procs[r].exitcode for r in dead}
                raise RuntimeError(f"launch: rank(s) {dead} ended without a report "
                                   f"(exit codes {codes})") from None
        if not ok:
            raise RuntimeError(f"launch: rank {rank} of {len(procs)} failed:\n{payload}")
        done.add(rank)
        if rank == 0:
            out = pickle.loads(payload)
    return out
