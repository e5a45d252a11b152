"""3x3 stride-1 zero-padding-1 convolution, NHWC x HWIO + bias -> NHWC.

Port of the Pallas TPU kernel `ops/conv3x3.py::conv3x3_same` of the JAX
package.  On a CUDA tensor `conv3x3` launches the hand-written kernel of
`csrc/conv3x3.cu` (fp32 or bf16 I/O, fp32 accumulation); on a CPU tensor,
or when the caller passes `use_kernel=False`, it runs `conv3x3_reference`,
the same nine shifted-tap matmuls written in PyTorch.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["conv3x3", "conv3x3_reference", "launches"]

launches = 0    # kernel launches since the caller last set this to 0


def conv3x3_reference(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Sum over the nine taps of x[h+di-1, w+dj-1, :] @ K[di, dj], in fp32,
    plus bias; the result in x's dtype (the TPU kernel's arithmetic)."""
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = weight.float()
    acc = None
    for di in range(3):
        for dj in range(3):
            tap = xp[:, di:di + h, dj:dj + w, :].reshape(-1, cin) @ wf[di, dj]
            acc = tap if acc is None else acc + tap
    return (acc.reshape(b, h, w, cout) + bias.float()).to(x.dtype)


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            use_kernel: bool = True) -> torch.Tensor:
    """x (B, H, W, Cin), weight (3, 3, Cin, Cout), bias (Cout,) -> (B, H, W, Cout)."""
    global launches
    if x.ndim != 4 or weight.shape[:3] != (3, 3, x.shape[-1]) or bias.shape != weight.shape[3:]:
        raise ValueError(f"conv3x3: bad shapes x {tuple(x.shape)} weight "
                         f"{tuple(weight.shape)} bias {tuple(bias.shape)}")
    if x.device.type == "cpu" or not use_kernel:
        return conv3x3_reference(x, weight, bias)
    if x.device.type != "cuda" or weight.device != x.device or bias.device != x.device:
        raise ValueError(f"conv3x3: tensors on {x.device}, {weight.device}, {bias.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or weight.dtype != x.dtype:
        raise TypeError(f"conv3x3: dtypes {x.dtype}, {weight.dtype}; want fp32 or bf16, equal")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("conv3x3: x and weight must be contiguous")
    bsz, h, w, cin = x.shape
    cout = weight.shape[-1]
    bias32 = bias.float().contiguous()
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_forward(x.data_ptr(), weight.data_ptr(), bias32.data_ptr(),
                                 out.data_ptr(), bsz, h, w, cin, cout,
                                 int(x.dtype == torch.bfloat16), stream)
    _build.check(rc, "conv3x3")
    launches += 1
    return out
