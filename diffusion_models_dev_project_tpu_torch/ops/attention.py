"""Self-attention with the ADM legacy scaling over (B·heads, T, d).

Port of the Pallas TPU kernel `ops/attention.py::flash_attention` of the
JAX package: q and k are each scaled by d^-1/4 and the softmax runs in
fp32.  On a CUDA tensor `attention` launches the hand-written kernel of
`csrc/attention.cu` (any T, d <= 128, fp32 or bf16 I/O); on a CPU tensor, or
when the caller passes `use_kernel=False`, it runs `attention_reference`.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["attention", "attention_reference", "launches"]

launches = 0    # kernel launches since the caller last set this to 0
MAX_HEAD_DIM = 128


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain einsum attention in fp32, the result in q's dtype (for fp32
    inputs this is the JAX package's `attention_reference`)."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.einsum("btc,bsc->bts", q.float() * scale, k.float() * scale)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsc->btc", weights, v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_kernel: bool = True) -> torch.Tensor:
    """q, k, v (B·heads, T, d) -> (B·heads, T, d)."""
    global launches
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu" or not use_kernel:
        return attention_reference(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"attention: tensors on {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention: q, k and v must be contiguous")
    bh, t, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention: head width {d} outside 1..{MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.attention_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   bh, t, d, 1.0 / math.sqrt(math.sqrt(d)),
                                   int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, "attention")
    launches += 1
    return out
