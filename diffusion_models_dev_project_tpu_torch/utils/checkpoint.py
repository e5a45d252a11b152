"""Checkpoints of the whole training state, for exact resume.

Counterpart of `utils/checkpoint.py` of the JAX package, which keeps orbax
checkpoints of its `TrainState`.  Here each save is one `torch.save` file,
`<directory>/<step>/state.pt`, of a dict of CPU tensors and numbers: the
parameters (fp32 masters), the EMA shadow and its count, the Adam state
(moments and step) and the step; the newest `max_to_keep` are kept.  Orbax's
format is not a goal: the flax msgpack export (`models/convert.py`) is the
format both packages read.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Checkpointer"]


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class Checkpointer:
    """Numbered checkpoints under `directory`, the newest `max_to_keep` kept."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The steps saved, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(self._path(int(d))))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), "state.pt")

    def save(self, state: Dict[str, Any], step: int) -> str:
        """Write `state` (a dict of tensors, numbers and nested dicts) as
        step `step`, then drop the oldest beyond `max_to_keep`."""
        path = self._path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return path

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state saved at `step` (the latest by default), on the CPU, or
        None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None
