"""Matmul and conv FLOP counting of a PyTorch function (JAX `utils/flops.py`).

The JAX package walks a jaxpr and counts 2·M·N·K for every `dot_general`
and 2·|out|·(Cin/groups)·kh·kw for every `conv_general_dilated`.  Here
`torch.utils.flop_counter.FlopCounterMode` counts the same for every
matmul and convolution that PyTorch dispatches, with the same rule
(multiply-adds as 2 FLOPs, elementwise work excluded).

The port's hand kernels are launched through ctypes, where no torch counter
sees them, so their wrappers report their work here while a count is
active (`report`), and only when they launch a kernel (their plain
versions are matmuls that the counter sees):
- conv3x3: 2·B·H·W·9·Cin·Cout per forward launch, the same per input- and
  weight-gradient launch, whatever the variant (`tf32x3` reports the fp32
  work, not its three TF32 products: the function's FLOPs, not the
  kernel's);
- attention: 4·BH·T²·d per forward launch, 8·BH·T²·d per backward launch.

`fn_flops` runs the function once (PyTorch has no abstract tracing that
reaches the kernels' wrappers); with `breakdown=True` it also returns the
FLOPs by source: "torch" (the counter's) and each kernel's name.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["fn_flops", "report"]

_active: List[Dict[str, float]] = []     # kernel FLOPs by name, one per `fn_flops` in progress


def report(flops: float, kernel: str) -> None:
    """Add `flops` of a launch of the hand kernel `kernel` to every count
    in progress."""
    for parts in _active:
        parts[kernel] = parts.get(kernel, 0.0) + flops


def fn_flops(fn, *args, breakdown: bool = False, **kwargs):
    """Matmul and conv FLOPs of one call `fn(*args, **kwargs)`, the hand
    kernels' launches included; with `breakdown`, (total, FLOPs by source)."""
    from torch.utils.flop_counter import FlopCounterMode

    parts: Dict[str, float] = {}
    _active.append(parts)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    finally:
        _active.remove(parts)
    parts = {"torch": float(counter.get_total_flops()), **parts}
    total = sum(parts.values())
    return (total, parts) if breakdown else total
