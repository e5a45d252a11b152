"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another.  Raises when CUDA is wanted but absent — nothing falls back to
    the CPU unasked.

    On CUDA this also turns TF32 off for matmuls and cuDNN: the physics, CG
    and DDS algebra are specified in full fp32 (the UNet's bf16 path does
    not read these flags).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op off CUDA): the entry
    points time their images between two of these."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
