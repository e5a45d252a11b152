"""Self-attention with the ADM legacy scaling over (B·heads, T, d).

Port of the Pallas TPU kernel `ops/attention.py::flash_attention` of the
JAX package: q and k are each scaled by d^-1/4 and the softmax runs in
fp32.  On a CUDA tensor `attention` launches one of two hand-written
kernels, chosen by `plan` from the dtype and the shape alone:

- `mma` (`csrc/attention_mma.cu`): bf16 with d <= 128, the UNet's path.  A
  flash kernel on the tensor cores (`mma.sync` m16n8k16), 16 query rows per
  warp, the keys of a row group split over the block's warps and merged in
  order, P rounded to bf16 in registers for the P·V product;
- `simt` (`csrc/attention.cu`): fp32, and bf16 with d > 128; fp32 dot
  products on the CUDA cores.

Both take any T and d up to `MAX_HEAD_DIM` = 256; wider heads raise.  On a
CPU tensor, or when the caller passes `use_kernel=False`, `attention` runs
`attention_reference`.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

__all__ = ["MAX_HEAD_DIM", "Plan", "VARIANTS", "attention", "attention_reference",
           "attention_tiled_reference", "launches", "launches_by_variant", "plan"]

VARIANTS = ("mma", "simt")
launches = 0    # attention calls that launched a kernel since the caller last set this to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant

MAX_HEAD_DIM = 256       # the widest head `simt` takes
MMA_MAX_HEAD_DIM = 128   # the widest head `mma` takes
MMA_KEY_TILE = 64        # keys per shared-memory tile of `mma`
MMA_ROWS = 16            # query rows per warp of `mma` (one m16n8k16 row block)
MMA_WARPS = 4            # warps per block of `mma`: row groups x key splits
SIMT_ROWS = 64           # query rows per block of `simt` (8 warps, 4 lanes a row)
LOG2E = 1.4426950408889634


class Plan(NamedTuple):
    """How `attention` runs one shape: `warps` per block; for `mma` they are
    warps / `key_splits` row groups of `MMA_ROWS` query rows, and the
    `key_splits` warps of a row group take every key_splits-th key tile
    each (`simt`: 8 warps over `SIMT_ROWS` rows, no split).  Keys stream in
    tiles of `key_tile`, the head is zero-padded to `d_pad` columns in
    shared memory, and `grid` = (query blocks, B·heads)."""
    variant: str
    warps: int
    key_splits: int
    key_tile: int
    d_pad: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=None)
def plan(bh: int, t: int, d: int, dtype: torch.dtype, variant: Optional[str] = None) -> Plan:
    """The kernel and tiling for (bh, t, d) in `dtype`: `mma` for bf16 with
    d <= 128, else `simt`.  `mma` runs `MMA_WARPS` warps per block and splits
    the keys of a row group over as many of them (4, 2, then 1) as leave
    every split a key tile: a warp's chain of tiles, not the card's rate,
    sets the time at these sizes.  Two rounds of split tiles must fit in
    shared memory, so d > 64 splits at most 2 ways.  `variant` forces the
    kernel (measurements only); one that cannot take the shape raises."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention: head width {d} outside 1..{MAX_HEAD_DIM}, "
                         f"the widest the port's kernels take")
    mma_ok = dtype == torch.bfloat16 and d <= MMA_MAX_HEAD_DIM
    if variant is None:
        variant = "mma" if mma_ok else "simt"
    if variant == "mma":
        if not mma_ok:
            raise ValueError(f"attention: mma takes bf16 with d <= {MMA_MAX_HEAD_DIM}, "
                             f"not {dtype} d = {d}")
        most = min(-(-t // MMA_KEY_TILE), 4 if d <= 64 else 2)
        key_splits = 4 if most >= 4 else 2 if most >= 2 else 1
        rows = MMA_ROWS * MMA_WARPS // key_splits
        return Plan("mma", MMA_WARPS, key_splits, MMA_KEY_TILE, -(-d // 16) * 16,
                    (-(-t // rows), bh))
    if variant == "simt":
        d_max = 64 if d <= 64 else 128 if d <= 128 else 256
        return Plan("simt", 8, 1, 32 if d_max <= 128 else 16, d_max, (-(-t // SIMT_ROWS), bh))
    raise ValueError(f"attention: unknown variant {variant!r}")


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain einsum attention in fp32, the result in q's dtype (for fp32
    inputs this is the JAX package's `attention_reference`)."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.einsum("btc,bsc->bts", q.float() * scale, k.float() * scale)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bts,bsc->btc", weights, v.float()).to(q.dtype)


def attention_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              p: Plan) -> torch.Tensor:
    """`mma`'s arithmetic, step by step as plan `p` lays it out (for tests):
    bf16 operands, d zero-padded to `p.d_pad`.  Key split s takes tiles s,
    s + key_splits, ...; per tile, S in fp32 from the unscaled q and k,
    times d^-1/2·log2(e), keys past T at -1e30, then the online softmax
    with exp2, the row sums from fp32 P, P rounded to bf16 for P·V.  The
    splits' (O, m, l) are merged in split order; one division and one
    rounding to bf16 at the end."""
    if p.variant != "mma":
        raise ValueError(f"attention_tiled_reference emulates mma, not {p.variant}")
    bh, t, d = q.shape
    kt = p.key_tile
    t_keys = -(-t // kt) * kt

    def operand(a, rows):
        return torch.nn.functional.pad(a.to(torch.bfloat16).float(), (0, p.d_pad - d, 0, rows - t))

    qf, kf, vf = operand(q, t), operand(k, t_keys), operand(v, t_keys)
    scale = LOG2E / math.sqrt(d)
    parts = []
    for split in range(p.key_splits):
        m = qf.new_full((bh, t, 1), -math.inf)
        l = qf.new_zeros((bh, t, 1))
        acc = qf.new_zeros((bh, t, p.d_pad))
        for j0 in range(split * kt, t_keys, p.key_splits * kt):
            s = (qf @ kf[:, j0:j0 + kt].transpose(1, 2)) * scale
            s[..., max(t - j0, 0):] = -1e30
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            pm = torch.exp2(s - m_new)
            l = l * alpha + pm.sum(-1, keepdim=True)
            acc = acc * alpha + pm.to(torch.bfloat16).float() @ vf[:, j0:j0 + kt]
            m = m_new
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l = acc = 0
    for m, l_s, acc_s in parts:
        c = torch.exp2(m - m_all)
        l, acc = l + l_s * c, acc + acc_s * c
    return (acc[..., :d] / l).to(torch.bfloat16)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_kernel: bool = True, *, variant: Optional[str] = None) -> torch.Tensor:
    """q, k, v (B·heads, T, d) -> (B·heads, T, d), d <= `MAX_HEAD_DIM`.

    `variant` (measurements only) forces the kernel that `plan` would
    choose from dtype and shape."""
    global launches
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, t, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention: head width {d} outside 1..{MAX_HEAD_DIM}, "
                         f"the widest the port's kernels take")
    if q.device.type == "cpu" or not use_kernel:
        return attention_reference(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"attention: tensors on {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention: q, k and v must be contiguous")
    p = plan(bh, t, d, q.dtype, variant)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t, d)
        if p.variant == "mma":
            rc = lib.attention_mma_forward(*args, LOG2E / math.sqrt(d), p.key_splits, stream)
        else:
            rc = lib.attention_forward(*args, 1.0 / math.sqrt(math.sqrt(d)),
                                       int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, f"attention ({p.variant})")
    launches += 1
    launches_by_variant[p.variant] += 1
    return out
