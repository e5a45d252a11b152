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

Gradients (the JAX package differentiates its einsum attention with XLA):
when q, k or v needs one, `attention` runs as a `torch.autograd.Function`
that saves q, k, v, the output and, on the `mma` route, the rows'
log-sum-exp that the forward kernel writes beside the output (lse2, in the
kernel's log2 domain).  Its backward, `attention_backward`, launches one of
two pairs of kernels on a CUDA tensor, chosen by `backward_plan` from the
dtype and the shape; each pair is a query pass and a key pass with no
atomics, so every launch gives the same bits:

- `mma` (`csrc/attention_bwd_mma.cu`): bf16 with d <= 128, the UNet's path.
  All five products on the tensor cores (`mma.sync` m16n8k16), P from the
  forward's lse2, P and dS rounded to bf16 in registers where they feed a
  product, the 4 warps of a block splitting the walked dimension and their
  partial sums added in order;
- `simt` (`csrc/attention_bwd.cu`): fp32, and bf16 with d > 128; fp32 dot
  products on the CUDA cores, the rows' statistics recomputed.

On a CPU tensor, or with `use_kernel=False`, it runs
`attention_backward_reference`, the same formula in plain PyTorch.  Forward
and backward launches are counted apart, and each by variant.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import flops as _flops
from . import _build

__all__ = ["BackwardPlan", "MAX_HEAD_DIM", "Plan", "VARIANTS", "attention",
           "attention_backward", "attention_backward_mma_tiled_reference",
           "attention_backward_reference", "attention_backward_tiled_reference",
           "attention_lse_reference", "attention_reference", "attention_tiled_reference",
           "attention_with_lse", "backward_launches", "backward_launches_by_variant",
           "backward_plan", "launches", "launches_by_variant", "plan"]

VARIANTS = ("mma", "simt")
launches = 0    # forward calls that launched a kernel since the caller last set this to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant
backward_launches = 0    # backward calls that launched the kernels, the same way
backward_launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant

MAX_HEAD_DIM = 256       # the widest head `simt` takes
MMA_MAX_HEAD_DIM = 128   # the widest head `mma` takes
MMA_KEY_TILE = 64        # keys per shared-memory tile of `mma`
MMA_ROWS = 16            # query rows per warp of `mma` (one m16n8k16 row block)
MMA_WARPS = 4            # warps per block of `mma`: row groups x key splits
SIMT_ROWS = 64           # query rows per block of `simt` (8 warps, 4 lanes a row)
BWD_THREADS = 128        # threads per block of the `simt` backward kernels
BWD_GROUP = 4            # keys (queries) per group of independent chains in the `simt` backward
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
                              p: Plan, with_lse: bool = False):
    """`mma`'s arithmetic, step by step as plan `p` lays it out (for tests):
    bf16 operands, d zero-padded to `p.d_pad`.  Key split s takes tiles s,
    s + key_splits, ...; per tile, S in fp32 from the unscaled q and k,
    times d^-1/2·log2(e), keys past T at -1e30, then the online softmax
    with exp2, the row sums from fp32 P, P rounded to bf16 for P·V.  The
    splits' (O, m, l) are merged in split order; one division and one
    rounding to bf16 at the end.  With `with_lse`, also the rows' lse2 =
    m + log2(l) that the kernel writes for the backward: (out, lse2)."""
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
    out = (acc[..., :d] / l).to(torch.bfloat16)
    return (out, (m_all + torch.log2(l))[..., 0]) if with_lse else out


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled logits (q s)(k s)ᵀ, s = d^-1/4, in
    fp32 and in the log2 domain of the `mma` kernels: lse2 = log2(Σ exp(S))."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.einsum("btc,bsc->bts", q.float() * scale, k.float() * scale)
    return torch.logsumexp(logits, dim=-1) * LOG2E


class BackwardPlan(NamedTuple):
    """How `attention_backward` lays out one shape: the same `grid` = (row
    blocks, B·heads) for the query pass and the key pass, `rows` query (key)
    rows per block, the head zero-padded to `d_pad` channels.

    `mma` (csrc/attention_bwd_mma.cu): `splits` = 4 warps share a block's 16
    rows and split the walked keys (queries) in chunks of `tile` rows, warp
    w taking chunks w, w + 4, ...; `channels` is 0.
    `simt` (csrc/attention_bwd.cu): each row is held by d_pad / `channels`
    threads, tiles of `tile` keys (queries) go through shared memory;
    `splits` is 1."""
    variant: str
    d_pad: int
    tile: int
    rows: int
    splits: int
    channels: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=None)
def backward_plan(bh: int, t: int, d: int, dtype: torch.dtype, variant: Optional[str] = None,
                  tile: Optional[int] = None) -> BackwardPlan:
    """The backward kernels and their layout for (bh, t, d) in `dtype`: `mma`
    for bf16 with d <= 128, else `simt`.  `mma` takes the narrowest chunk
    (16, 32 or 64 rows; at most 32 for d > 64, whose two stages per warp
    must fit in shared memory) that leaves each of its 4 warps at most one
    chunk: a warp's chain of chunks sets the time at these sizes.
    `variant` and `tile` force the kernels and the `mma` chunk
    (measurements only); a forced choice that cannot take the shape raises."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention: head width {d} outside 1..{MAX_HEAD_DIM}, "
                         f"the widest the port's kernels take")
    mma_ok = dtype == torch.bfloat16 and d <= MMA_MAX_HEAD_DIM
    if variant is None:
        variant = "mma" if mma_ok else "simt"
    if variant == "mma":
        if not mma_ok:
            raise ValueError(f"attention_backward: mma takes bf16 with d <= {MMA_MAX_HEAD_DIM}, "
                             f"not {dtype} d = {d}")
        widest = 64 if d <= 64 else 32
        if tile is None:
            tile = next((w for w in (16, 32) if MMA_WARPS * w >= t), widest)
        elif tile not in (16, 32, 64) or tile > widest:
            raise ValueError(f"attention_backward: mma chunk {tile} not in 16, 32, ..., {widest}")
        return BackwardPlan("mma", -(-d // 16) * 16, tile, MMA_ROWS, MMA_WARPS, 0,
                            (-(-t // MMA_ROWS), bh))
    if variant == "simt":
        if tile is not None:
            raise ValueError("attention_backward: simt takes no chunk")
        d_pad = 64 if d <= 64 else 128 if d <= 128 else 256
        channels = 8 if d_pad == 64 else 16
        rows = BWD_THREADS // (d_pad // channels)
        return BackwardPlan("simt", d_pad, 32 if d_pad <= 128 else 16, rows, 1, channels,
                            (-(-t // rows), bh))
    raise ValueError(f"attention_backward: unknown variant {variant!r}")


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 out: torch.Tensor, dout: torch.Tensor):
    """(dq, dk, dv) of `attention_reference` in plain PyTorch, in fp32 and
    rounded once to q's dtype: P = softmax((q s)(k s)ᵀ), s = d^-1/4;
    D = rowsum(dout ∘ out); dS = P ∘ (dout vᵀ − D); dq = s² dS k,
    dk = s² dSᵀ q, dv = Pᵀ dout."""
    qf, kf, vf, of, gf = (a.float() for a in (q, k, v, out, dout))
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    p = torch.softmax(torch.einsum("btc,bsc->bts", qf * scale, kf * scale), dim=-1)
    dp = torch.einsum("btc,bsc->bts", gf, vf)
    ds = p * (dp - (gf * of).sum(-1, keepdim=True))
    s2 = scale * scale
    dq = torch.einsum("bts,bsc->btc", ds, kf) * s2
    dk = torch.einsum("bts,btc->bsc", ds, qf) * s2
    dv = torch.einsum("bts,btc->bsc", p, gf)
    return tuple(a.to(q.dtype) for a in (dq, dk, dv))


def attention_backward_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       out: torch.Tensor, dout: torch.Tensor,
                                       p: BackwardPlan):
    """The `simt` backward kernels' arithmetic, step by step as `p` lays it
    out (for tests), in fp32: the head zero-padded to `p.d_pad`; the query pass
    keeps a running max and sum of exp over groups of `BWD_GROUP` keys,
    then D = rowsum(dout ∘ out) and, tile by tile of `p.tile` keys,
    dq += dS (k s); the key pass
    takes lse and D from the query pass and, tile by tile of queries,
    dv += P dout and dk += dS (q s).  Rows and keys past T never enter a
    sum; dq and dk take their last factor s at the end."""
    if p.variant != "simt":
        raise ValueError(f"attention_backward_tiled_reference emulates simt, not {p.variant}")
    bh, t, d = q.shape
    scale = 1.0 / math.sqrt(math.sqrt(d))

    def pad(a, mul=1.0):
        return torch.nn.functional.pad(a.float() * mul, (0, p.d_pad - d))

    qs, ks, vf, gf = pad(q, scale), pad(k, scale), pad(v), pad(dout)
    delta = (gf * pad(out)).sum(-1)                          # (bh, t)
    m = torch.full((bh, t), -math.inf)
    l = torch.zeros(bh, t)
    for j in range(0, t, BWD_GROUP):                         # pass 1, a group at a time
        s = qs @ ks[:, j:j + BWD_GROUP].transpose(1, 2)      # the group's keys (< T)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    lse = m + torch.log(l)
    dq = torch.zeros(bh, t, p.d_pad)
    for j0 in range(0, t, p.tile):                          # pass 2, key tiles
        kt, vt = ks[:, j0:j0 + p.tile], vf[:, j0:j0 + p.tile]
        pm = torch.exp(qs @ kt.transpose(1, 2) - lse[..., None])
        dq += (pm * (gf @ vt.transpose(1, 2) - delta[..., None])) @ kt
    dk = torch.zeros(bh, t, p.d_pad)
    dv = torch.zeros(bh, t, p.d_pad)
    for i0 in range(0, t, p.tile):                          # key pass, query tiles
        qt, gt = qs[:, i0:i0 + p.tile], gf[:, i0:i0 + p.tile]
        pm = torch.exp(ks @ qt.transpose(1, 2) - lse[:, None, i0:i0 + p.tile])
        dv += pm @ gt
        dk += (pm * (vf @ gt.transpose(1, 2) - delta[:, None, i0:i0 + p.tile])) @ qt
    return tuple((a[..., :d] * mul).to(q.dtype) for a, mul in ((dq, scale), (dk, scale), (dv, 1.0)))


def attention_backward_mma_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                           out: torch.Tensor, dout: torch.Tensor,
                                           lse2: torch.Tensor, p: BackwardPlan):
    """The `mma` backward kernels' arithmetic, step by step as `p` lays it
    out (for tests): bf16 operands, the head zero-padded to `p.d_pad`, rows
    past T zero; lse2 (B·heads, T) from the forward, in its log2 domain.
    D = rowsum(dout ∘ out) in fp32.  Query pass: warp w of `p.splits` walks
    key chunks w, w + splits, ... of `p.tile` keys; per chunk S and dP in
    fp32, P = exp2(S·d^-1/2·log2(e) − lse2) (0 for keys past T),
    dS = P (dP − D) rounded to bf16 for dS·K.  Key pass: the same over query
    chunks, P rounded to bf16 for Pᵀ·dout, dS for dSᵀ·q.  The warps'
    partial sums are added in warp order, then dq and dk take the factor
    d^-1/2 and every output one rounding to bf16."""
    if p.variant != "mma":
        raise ValueError(f"attention_backward_mma_tiled_reference emulates mma, not {p.variant}")
    bh, t, d = q.shape
    w = p.tile
    chunks = -(-t // w)
    t_pad = chunks * w

    def operand(a):
        return torch.nn.functional.pad(a.to(torch.bfloat16).float(), (0, p.d_pad - d, 0, t_pad - t))

    def bf16(a):
        return a.to(torch.bfloat16).float()

    qf, kf, vf, of, gf = (operand(a) for a in (q, k, v, out, dout))
    lse = torch.nn.functional.pad(lse2.float(), (0, t_pad - t))
    delta = (gf * of).sum(-1)                                   # (bh, t_pad)
    live = torch.arange(t_pad, device=q.device) < t
    scale_log2, scale = LOG2E / math.sqrt(d), 1.0 / math.sqrt(d)
    dq = dk = dv = 0
    for warp in range(p.splits):
        dq_w = dk_w = dv_w = qf.new_zeros(bh, t_pad, p.d_pad)
        for c in range(warp, chunks, p.splits):
            rows = slice(c * w, (c + 1) * w)
            # query pass: all query rows, this chunk's keys
            pm = torch.exp2(qf @ kf[:, rows].transpose(1, 2) * scale_log2 - lse[..., None])
            pm = pm * live[rows]
            ds = pm * (gf @ vf[:, rows].transpose(1, 2) - delta[..., None])
            dq_w = dq_w + bf16(ds) @ kf[:, rows]
            # key pass: all key rows, this chunk's queries (Pᵀ, dSᵀ)
            pt = torch.exp2(kf @ qf[:, rows].transpose(1, 2) * scale_log2 - lse[:, None, rows])
            pt = pt * live[rows]
            dst = pt * (vf @ gf[:, rows].transpose(1, 2) - delta[:, None, rows])
            dv_w = dv_w + bf16(pt) @ gf[:, rows]
            dk_w = dk_w + bf16(dst) @ qf[:, rows]
        dq, dk, dv = dq + dq_w, dk + dk_w, dv + dv_w
    return tuple((a[:, :t, :d] * mul).to(torch.bfloat16)
                 for a, mul in ((dq, scale), (dk, scale), (dv, 1.0)))


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       dout: torch.Tensor, lse: Optional[torch.Tensor] = None,
                       use_kernel: bool = True, *, variant: Optional[str] = None,
                       tile: Optional[int] = None):
    """(dq, dk, dv) of out = attention(q, k, v) given dL/dout, all
    (B·heads, T, d) in q's dtype.  On a CUDA tensor the kernels that
    `backward_plan` picks: `mma` needs `lse`, the (B·heads, T) fp32 lse2 of
    the forward kernel (`attention_with_lse`), and raises without it; `simt`
    takes none.  On a CPU tensor, or with `use_kernel=False`,
    `attention_backward_reference`.  `variant` and `tile` force the kernels
    (measurements only)."""
    global backward_launches
    bh, t, d = q.shape
    if not all(a.shape == q.shape for a in (k, v, out, dout)):
        raise ValueError(f"attention_backward: shapes {[tuple(a.shape) for a in (q, k, v, out, dout)]}")
    bp = backward_plan(bh, t, d, q.dtype, variant, tile)
    if q.device.type == "cpu" or not use_kernel:
        return attention_backward_reference(q, k, v, out, dout)
    if bp.variant == "mma" and (lse is None or lse.shape != (bh, t) or lse.dtype != torch.float32):
        raise ValueError("attention_backward: mma needs the forward's lse2, (B·heads, T) fp32, "
                         f"not {None if lse is None else (tuple(lse.shape), lse.dtype)}")
    others = (k, v, out, dout) + ((lse,) if bp.variant == "mma" else ())
    if any(a.device != q.device for a in others) or q.device.type != "cuda":
        raise ValueError("attention_backward: tensors on more than one device, or not on CUDA")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            a.dtype != q.dtype for a in (k, v, out, dout)):
        raise TypeError(f"attention_backward: dtypes {[a.dtype for a in (q, k, v, out, dout)]}")
    q, k, v, out, dout = (a.contiguous() for a in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tensors = (q, k, v, out, dout)
        if bp.variant == "mma":
            delta = torch.empty(bh * t, dtype=torch.float32, device=q.device)
            rc = lib.attention_mma_backward(*(a.data_ptr() for a in tensors),
                                            lse.contiguous().data_ptr(), dq.data_ptr(),
                                            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), bh,
                                            t, d, LOG2E / math.sqrt(d), 1.0 / math.sqrt(d),
                                            bp.tile, stream)
        else:
            ws = torch.empty(2 * bh * t, dtype=torch.float32, device=q.device)
            rc = lib.attention_backward(*(a.data_ptr() for a in tensors), dq.data_ptr(),
                                        dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), bh, t, d,
                                        1.0 / math.sqrt(math.sqrt(d)),
                                        int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, f"attention backward ({bp.variant}, grid {bp.grid})")
    backward_launches += 1
    backward_launches_by_variant[bp.variant] += 1
    _flops.report(8.0 * bh * t * t * d, "attention_backward")
    return dq, dk, dv


def _forward(q, k, v, kernel, variant, with_lse=False):
    """(out, lse2): lse2 only when `with_lse` and the `mma` kernel ran (the
    plain version and `simt` keep none), else None."""
    global launches
    if not kernel:
        return attention_reference(q, k, v), None
    bh, t, d = q.shape
    p = plan(bh, t, d, q.dtype, variant)
    out = torch.empty_like(q)
    lse = (torch.empty((bh, t), dtype=torch.float32, device=q.device)
           if with_lse and p.variant == "mma" else None)
    if out.numel() == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if p.variant == "mma":
            rc = lib.attention_mma_forward(*args, None if lse is None else lse.data_ptr(), bh, t,
                                           d, LOG2E / math.sqrt(d), p.key_splits, stream)
        else:
            rc = lib.attention_forward(*args, bh, t, d, 1.0 / math.sqrt(math.sqrt(d)),
                                       int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, f"attention ({p.variant})")
    launches += 1
    launches_by_variant[p.variant] += 1
    _flops.report(4.0 * bh * t * t * d, "attention")
    return out, lse


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kernel, variant):
        out, lse = _forward(q, k, v, kernel, variant, with_lse=True)
        ctx.kernel, ctx.variant = kernel, variant
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # a forced forward variant forces the backward's (the names coincide)
        grads = attention_backward(q, k, v, out, dout.to(q.dtype), lse, use_kernel=ctx.kernel,
                                   variant=ctx.variant)
        return (*grads, None, None)


def _check_inputs(q, k, v, use_kernel):
    """Raise on shapes, devices, dtypes or layouts the kernels cannot take;
    returns whether a kernel runs (a CUDA tensor and `use_kernel`)."""
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, t, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention: head width {d} outside 1..{MAX_HEAD_DIM}, "
                         f"the widest the port's kernels take")
    kernel = use_kernel and q.device.type != "cpu"
    if kernel:
        if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
            raise ValueError(f"attention: tensors on {q.device}, {k.device}, {v.device}")
        if q.dtype not in (torch.float32, torch.bfloat16) or not (k.dtype == v.dtype == q.dtype):
            raise TypeError(f"attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("attention: q, k and v must be contiguous")
    return kernel


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       use_kernel: bool = True, *, variant: Optional[str] = None):
    """(out, lse2) without a gradient: out as `attention` gives it, and the
    rows' (B·heads, T) fp32 log-sum-exp in the log2 domain that the `mma`
    kernel writes beside it (None on the `simt` route, which keeps none);
    on a CPU tensor, or with `use_kernel=False`, `attention_reference` and
    `attention_lse_reference`."""
    if not _check_inputs(q, k, v, use_kernel):
        return attention_reference(q, k, v), attention_lse_reference(q, k)
    return _forward(q, k, v, True, variant, with_lse=True)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_kernel: bool = True, *, variant: Optional[str] = None) -> torch.Tensor:
    """q, k, v (B·heads, T, d) -> (B·heads, T, d), d <= `MAX_HEAD_DIM`;
    differentiable in q, k and v.

    `variant` (measurements only) forces the kernel that `plan` would
    choose from dtype and shape, and with it the backward's."""
    kernel = _check_inputs(q, k, v, use_kernel)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, kernel, variant)
    return _forward(q, k, v, kernel, variant)[0]
