"""Self-attention with the ADM legacy scaling over (B·heads, T, d).

Port of the Pallas TPU kernel `ops/attention.py::flash_attention` of the
JAX package: q and k are each scaled by d^-1/4 and the softmax runs in
fp32.  On a CUDA tensor `attention` launches one of three hand-written
kernels, chosen by `plan` from the dtype and the shape alone:

- `mma` (`csrc/attention_mma.cu`): bf16 with d <= 128, the UNet's path.  A
  flash kernel on the tensor cores (`mma.sync` m16n8k16), 16 query rows per
  warp, the keys of a row group split over the block's warps and merged in
  order, P rounded to bf16 in registers for the P·V product;
- `tf32x3` (`csrc/attention_tf32x3.cu`): fp32 with d <= 128, the UNet's
  path at the CLIs' default compute dtype.  The same blocking in key tiles
  of 32, on `mma.sync` m16n8k8 tf32: each operand split into TF32 hi + lo
  in registers and each product taken as hi·hi + hi·lo + lo·hi, which keeps
  fp32's accuracy (`attention_tf32x3_tiled_reference`);
- `simt` (`csrc/attention.cu`): d > 128 in either dtype; fp32 dot products
  on the CUDA cores.

All take any T; `mma` and `tf32x3` d up to 128, `simt` any d: up to
`MAX_HEAD_DIM` = 256 in one pass, past it in column chunks of 256 (a third
grid axis over the output's chunks; each block recomputes the rows' softmax
over the full d, streaming the head through shared memory chunk by chunk).
On a CPU tensor, or when the caller passes `use_kernel=False`, `attention`
runs `attention_reference`.

Gradients (the JAX package differentiates its einsum attention with XLA):
when q, k or v needs one, `attention` runs as a `torch.autograd.Function`
that saves q, k, v, the output and, on the `mma` and `tf32x3` routes, the
rows' log-sum-exp that the forward kernel writes beside the output (lse2,
in the kernel's log2 domain).  Its backward, `attention_backward`, launches
one of three pairs of kernels on a CUDA tensor, chosen by `backward_plan`
from the dtype and the shape; each pair is a query pass and a key pass with
no atomics, so every launch gives the same bits:

- `mma` (`csrc/attention_bwd_mma.cu`): bf16 with d <= 128, the UNet's path.
  All five products on the tensor cores (`mma.sync` m16n8k16), P from the
  forward's lse2, P and dS rounded to bf16 in registers where they feed a
  product, the 4 warps of a block splitting the walked dimension and their
  partial sums added in order;
- `tf32x3` (`csrc/attention_bwd_tf32x3.cu`): fp32 with d <= 128.  The same
  layout on `mma.sync` m16n8k8 tf32, each of the five products taken as
  three TF32 products of split operands, P and dS split in registers;
- `simt` (`csrc/attention_bwd.cu`): d > 128 in either dtype; fp32 dot
  products on the CUDA cores, the rows' statistics recomputed; past
  `MAX_HEAD_DIM` in column chunks as the forward.

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
from .conv3x3 import SMS, tf32_split

__all__ = ["BackwardPlan", "MAX_HEAD_DIM", "Plan", "VARIANTS", "attention",
           "attention_backward", "attention_backward_mma_tiled_reference",
           "attention_backward_reference", "attention_backward_tf32x3_tiled_reference",
           "attention_backward_tiled_reference", "attention_lse_reference",
           "attention_reference", "attention_tf32x3_tiled_reference",
           "attention_tiled_reference", "attention_with_lse", "backward_launches",
           "backward_launches_by_variant", "backward_plan", "launches", "launches_by_variant",
           "plan"]

VARIANTS = ("mma", "tf32x3", "simt")
launches = 0    # forward calls that launched a kernel since the caller last set this to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant
backward_launches = 0    # backward calls that launched the kernels, the same way
backward_launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant

MAX_HEAD_DIM = 256       # the widest head `simt` takes in one pass; wider ones go in chunks of it
MMA_MAX_HEAD_DIM = 128   # the widest head `mma` and `tf32x3` take
MMA_KEY_TILE = 64        # keys per shared-memory tile of `mma`
TF32X3_KEY_TILE = 32     # keys per shared-memory tile of `tf32x3` (fp32: twice bf16's bytes)
MMA_ROWS = 16            # query rows per warp of `mma` (one m16n8k16 row block)
MMA_WARPS = 4            # warps per block of `mma`: row groups x key splits
SIMT_ROWS = 64           # query rows per block of `simt` (8 warps, 4 lanes a row)
BWD_THREADS = 128        # threads per block of the `simt` backward kernels
BWD_GROUP = 4            # keys (queries) per group of independent chains in the `simt` backward
LOG2E = 1.4426950408889634


class Plan(NamedTuple):
    """How `attention` runs one shape: `warps` per block; for `mma` and
    `tf32x3` they are warps / `key_splits` row groups of `MMA_ROWS` query
    rows, and the `key_splits` warps of a row group take every
    key_splits-th key tile each (`simt`: 8 warps over `SIMT_ROWS` rows, no
    split).  Keys stream in tiles of `key_tile`, the head is zero-padded to
    `d_pad` columns in shared memory, and `grid` = (query blocks, B·heads).
    `chunks` > 1 (`simt` past `MAX_HEAD_DIM`): the output's columns split
    into that many chunks of `MAX_HEAD_DIM` over a third grid axis.
    `stages` (`mma`, `tf32x3`): the shared-memory stages of a key split with
    more than one tile, 2 to stream the next tile in during this one (`mma`
    always; `simt` ignores it)."""
    variant: str
    warps: int
    key_splits: int
    key_tile: int
    d_pad: int
    grid: Tuple[int, int]
    chunks: int = 1
    stages: int = 2


@functools.lru_cache(maxsize=None)
def plan(bh: int, t: int, d: int, dtype: torch.dtype, variant: Optional[str] = None) -> Plan:
    """The kernel and tiling for (bh, t, d) in `dtype`: with d <= 128, `mma`
    for bf16 and `tf32x3` for fp32, else `simt`.  `mma` and `tf32x3` run
    `MMA_WARPS` warps per block and split the keys of a row group over as
    many of them (4, 2, then 1) as leave every split a key tile (64 keys for
    `mma`, 32 for `tf32x3`): a warp's chain of tiles, not the card's rate,
    sets the time at these sizes.  Two rounds of split tiles must fit in
    shared memory, so d > 64 splits at most 2 ways.  `tf32x3`'s two rounds
    fill an SM's shared memory: past one block per SM of the card (`SMS`) it
    takes one round, refilled after each tile, and several blocks share an
    SM.  Past `MAX_HEAD_DIM`, `simt` runs in ceil(d / 256) column chunks.
    `variant` forces the kernel (measurements only); one that cannot take
    the shape raises."""
    _check_head_width(d)
    variant = _tensor_core_variant(variant, dtype, d, "attention")
    if variant in ("mma", "tf32x3"):
        key_tile = MMA_KEY_TILE if variant == "mma" else TF32X3_KEY_TILE
        most = min(-(-t // key_tile), 4 if d <= 64 else 2)
        key_splits = 4 if most >= 4 else 2 if most >= 2 else 1
        rows = MMA_ROWS * MMA_WARPS // key_splits
        grid = (-(-t // rows), bh)
        stages = 2 if variant == "mma" or grid[0] * grid[1] <= SMS else 1
        return Plan(variant, MMA_WARPS, key_splits, key_tile, _d_pad(variant, d), grid,
                    stages=stages)
    if variant == "simt":
        chunks = -(-d // MAX_HEAD_DIM)
        d_max = 64 if d <= 64 else 128 if d <= 128 else MAX_HEAD_DIM * chunks
        return Plan("simt", 8, 1, 32 if d_max <= 128 else 16, d_max, (-(-t // SIMT_ROWS), bh),
                    chunks)
    raise ValueError(f"attention: unknown variant {variant!r}")


def _check_head_width(d: int) -> None:
    if d < 1:
        raise ValueError(f"attention: head width {d}, not at least 1")


def _tensor_core_variant(variant: Optional[str], dtype: torch.dtype, d: int, what: str) -> str:
    """The variant a plan takes: the forced one, else `mma` (bf16) or
    `tf32x3` (fp32) for d <= 128 and `simt` otherwise; raises for a forced
    tensor-core variant that cannot take the dtype or the width."""
    own = {torch.bfloat16: "mma", torch.float32: "tf32x3"}.get(dtype)
    if variant is None:
        return own if own and d <= MMA_MAX_HEAD_DIM else "simt"
    if variant in ("mma", "tf32x3") and (variant != own or d > MMA_MAX_HEAD_DIM):
        raise ValueError(f"{what}: {variant} takes {'bf16' if variant == 'mma' else 'fp32'} "
                         f"with d <= {MMA_MAX_HEAD_DIM}, not {dtype} d = {d}")
    return variant


def _d_pad(variant: str, d: int) -> int:
    """d zero-padded to the slices the products take: 16 wide in bf16 (`mma`),
    8 in TF32 (`tf32x3`)."""
    width = 16 if variant == "mma" else 8
    return -(-d // width) * width


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


def _tf32x3_matmul(a: torch.Tensor, b: torch.Tensor,
                   acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a @ b (fp32, batched) as the `tf32x3` kernels take it: both split into
    TF32 hi + lo (`tf32_split`), then per slice of 8 along the inner axis
    hi·hi, hi·lo and lo·hi added in that order into `acc` (or into the
    first of them)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    for k0 in range(0, a.shape[-1], 8):
        ka, kb = (..., slice(k0, k0 + 8)), (..., slice(k0, k0 + 8), slice(None))
        for term in (ah[ka] @ bh[kb], ah[ka] @ bl[kb], al[ka] @ bh[kb]):
            acc = term if acc is None else acc + term
    return acc


def attention_tf32x3_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     p: Plan, with_lse: bool = False):
    """`tf32x3`'s arithmetic, step by step as plan `p` lays it out (for
    tests): fp32 operands, d zero-padded to `p.d_pad`.  Key split s takes
    tiles s, s + key_splits, ...; per tile, S = Q Kᵀ from the unscaled q and
    k as three TF32 products per 8-wide slice of d (`_tf32x3_matmul`),
    times d^-1/2·log2(e), keys past T at -1e30, then the online softmax
    with exp2, the row sums from fp32 P, O rescaled and P·V added into it
    as three TF32 products per 8 keys.  The splits' (O, m, l) are merged in
    split order; O times 1 / l at the end.  With `with_lse`, also the rows'
    lse2 = m + log2(l) that the kernel writes for the backward: (out, lse2)."""
    if p.variant != "tf32x3":
        raise ValueError(f"attention_tf32x3_tiled_reference emulates tf32x3, not {p.variant}")
    bh, t, d = q.shape
    kt = p.key_tile
    t_keys = -(-t // kt) * kt

    def operand(a, rows):
        return torch.nn.functional.pad(a.float(), (0, p.d_pad - d, 0, rows - t))

    qf, kf, vf = operand(q, t), operand(k, t_keys), operand(v, t_keys)
    scale = LOG2E / math.sqrt(d)
    parts = []
    for split in range(p.key_splits):
        m = qf.new_full((bh, t, 1), -math.inf)
        l = qf.new_zeros((bh, t, 1))
        acc = qf.new_zeros((bh, t, p.d_pad))
        for j0 in range(split * kt, t_keys, p.key_splits * kt):
            s = _tf32x3_matmul(qf, kf[:, j0:j0 + kt].transpose(1, 2)) * scale
            s[..., max(t - j0, 0):] = -1e30
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            pm = torch.exp2(s - m_new)
            l = l * alpha + pm.sum(-1, keepdim=True)
            acc = _tf32x3_matmul(pm, vf[:, j0:j0 + kt], acc * alpha)
            m = m_new
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l = acc = 0
    for m, l_s, acc_s in parts:
        c = torch.exp2(m - m_all)
        l, acc = l + l_s * c, acc + acc_s * c
    out = acc[..., :d] * (1.0 / l)
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

    `mma` (csrc/attention_bwd_mma.cu) and `tf32x3`
    (csrc/attention_bwd_tf32x3.cu): `splits` = 4 warps share a block's 16
    rows and split the walked keys (queries) in chunks of `tile` rows, warp
    w taking chunks w, w + 4, ...; `channels` is 0.
    `simt` (csrc/attention_bwd.cu): each row is held by d_pad / `channels`
    threads, tiles of `tile` keys (queries) go through shared memory;
    `splits` is 1.  Past `MAX_HEAD_DIM`, `chunks` > 1 column chunks of 256
    on a third grid axis, each row held by 256 / `channels` threads.
    `stages` (`mma`, `tf32x3`): the shared-memory stages of a warp with more
    than one chunk, 2 to stream the next chunk in during this one (`mma`
    always; `simt` ignores it)."""
    variant: str
    d_pad: int
    tile: int
    rows: int
    splits: int
    channels: int
    grid: Tuple[int, int]
    chunks: int = 1
    stages: int = 2


@functools.lru_cache(maxsize=None)
def backward_plan(bh: int, t: int, d: int, dtype: torch.dtype, variant: Optional[str] = None,
                  tile: Optional[int] = None) -> BackwardPlan:
    """The backward kernels and their layout for (bh, t, d) in `dtype`: with
    d <= 128, `mma` for bf16 and `tf32x3` for fp32, else `simt`.  `mma` takes
    the narrowest chunk (16, 32 or 64 rows; at most 32 for d > 64) that
    leaves each of its 4 warps at most one chunk: a warp's chain of chunks
    sets the time at these sizes.  Two stages per warp must fit in shared
    memory when a warp walks more than one chunk: then `mma` takes the
    widest chunk and `tf32x3`, whose fp32 chunks are twice the bytes, half
    of it.  `tf32x3` takes chunks of at most that half in two stages while
    its grid fits the card (`SMS` blocks), and past it chunks of 16 rows in
    one stage, so that four blocks share an SM (the blockings timed against
    these are in PERF.md, section 6).  Past `MAX_HEAD_DIM`, `simt` runs in
    ceil(d / 256) column chunks.  `variant` and `tile` force the kernels and
    the chunk (measurements only); a forced choice that cannot take the
    shape raises."""
    _check_head_width(d)
    variant = _tensor_core_variant(variant, dtype, d, "attention_backward")
    if variant in ("mma", "tf32x3"):
        widest = 64 if d <= 64 else 32
        # the widest chunk of tf32x3 fits in shared memory in one stage only
        two_stages = widest if variant == "mma" else widest // 2
        grid = (-(-t // MMA_ROWS), bh)
        crowded = variant == "tf32x3" and grid[0] * grid[1] > SMS
        if tile is None:
            tile = 16 if crowded else next(
                (w for w in (16, 32, 64) if w <= two_stages and MMA_WARPS * w >= t), two_stages)
        elif tile not in (16, 32, 64) or tile > widest or (
                -(-t // tile) > MMA_WARPS and tile > two_stages):
            raise ValueError(f"attention_backward: {variant} chunk {tile} not in 16, 32, ..., "
                             f"{widest if MMA_WARPS * widest >= t else two_stages} at T = {t}")
        return BackwardPlan(variant, _d_pad(variant, d), tile, MMA_ROWS, MMA_WARPS, 0, grid,
                            stages=1 if crowded else 2)
    if variant == "simt":
        if tile is not None:
            raise ValueError("attention_backward: simt takes no chunk")
        chunks = -(-d // MAX_HEAD_DIM)
        d_pad = 64 if d <= 64 else 128 if d <= 128 else MAX_HEAD_DIM * chunks
        channels = 8 if d_pad == 64 else 16
        rows = BWD_THREADS // (min(d_pad, MAX_HEAD_DIM) // channels)
        return BackwardPlan("simt", d_pad, 32 if d_pad <= 128 else 16, rows, 1, channels,
                            (-(-t // rows), bh), chunks)
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


def attention_backward_tf32x3_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                              out: torch.Tensor, dout: torch.Tensor,
                                              lse2: torch.Tensor, p: BackwardPlan):
    """The `tf32x3` backward kernels' arithmetic, step by step as `p` lays it
    out (for tests): fp32 operands, the head zero-padded to `p.d_pad`, rows
    past T zero; lse2 (B·heads, T) from the forward, in its log2 domain.
    D = rowsum(dout ∘ out) in fp32.  Query pass: warp w of `p.splits` walks
    key chunks w, w + splits, ... of `p.tile` keys; per chunk S and dP as
    three TF32 products per 8-wide slice of d (`_tf32x3_matmul`),
    P = exp2(S·d^-1/2·log2(e) − lse2) (0 for keys past T), dS = P (dP − D),
    dq += dS·K as three TF32 products per 8 keys.  Key pass: the same over
    query chunks, dv += Pᵀ·dout and dk += dSᵀ·q.  The warps' partial sums
    are added in warp order, then dq and dk take the factor d^-1/2."""
    if p.variant != "tf32x3":
        raise ValueError(f"attention_backward_tf32x3_tiled_reference emulates tf32x3, "
                         f"not {p.variant}")
    bh, t, d = q.shape
    w = p.tile
    chunks = -(-t // w)
    t_pad = chunks * w

    def operand(a):
        return torch.nn.functional.pad(a.float(), (0, p.d_pad - d, 0, t_pad - t))

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
            s = _tf32x3_matmul(qf, kf[:, rows].transpose(1, 2))
            dp = _tf32x3_matmul(gf, vf[:, rows].transpose(1, 2))
            pm = torch.exp2(s * scale_log2 - lse[..., None]) * live[rows]
            dq_w = _tf32x3_matmul(pm * (dp - delta[..., None]), kf[:, rows], dq_w)
            # key pass: all key rows, this chunk's queries (Pᵀ, dSᵀ)
            st = _tf32x3_matmul(kf, qf[:, rows].transpose(1, 2))
            dpt = _tf32x3_matmul(vf, gf[:, rows].transpose(1, 2))
            pt = torch.exp2(st * scale_log2 - lse[:, None, rows]) * live[rows]
            dv_w = _tf32x3_matmul(pt, gf[:, rows], dv_w)
            dk_w = _tf32x3_matmul(pt * (dpt - delta[:, None, rows]), qf[:, rows], dk_w)
        dq, dk, dv = dq + dq_w, dk + dk_w, dv + dv_w
    return tuple(a[:, :t, :d] * mul for a, mul in ((dq, scale), (dk, scale), (dv, 1.0)))


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       dout: torch.Tensor, lse: Optional[torch.Tensor] = None,
                       use_kernel: bool = True, *, variant: Optional[str] = None,
                       tile: Optional[int] = None):
    """(dq, dk, dv) of out = attention(q, k, v) given dL/dout, all
    (B·heads, T, d) in q's dtype.  On a CUDA tensor the kernels that
    `backward_plan` picks: `mma` and `tf32x3` need `lse`, the (B·heads, T)
    fp32 lse2 of the forward kernel (`attention_with_lse`), and raise
    without it; `simt` takes none.  On a CPU tensor, or with `use_kernel=False`,
    `attention_backward_reference`.  `variant` and `tile` force the kernels
    (measurements only)."""
    global backward_launches
    bh, t, d = q.shape
    if not all(a.shape == q.shape for a in (k, v, out, dout)):
        raise ValueError(f"attention_backward: shapes {[tuple(a.shape) for a in (q, k, v, out, dout)]}")
    bp = backward_plan(bh, t, d, q.dtype, variant, tile)
    if q.device.type == "cpu" or not use_kernel:
        return attention_backward_reference(q, k, v, out, dout)
    saved = bp.variant in ("mma", "tf32x3")        # the kernels read the forward's lse2
    if saved and (lse is None or lse.shape != (bh, t) or lse.dtype != torch.float32):
        raise ValueError(f"attention_backward: {bp.variant} needs the forward's lse2, "
                         "(B·heads, T) fp32, "
                         f"not {None if lse is None else (tuple(lse.shape), lse.dtype)}")
    others = (k, v, out, dout) + ((lse,) if saved else ())
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
        if saved:
            delta = torch.empty(bh * t, dtype=torch.float32, device=q.device)
            fn = (lib.attention_mma_backward if bp.variant == "mma"
                  else lib.attention_tf32x3_backward)
            extra = () if bp.variant == "mma" else (bp.stages,)
            rc = fn(*(a.data_ptr() for a in tensors), lse.contiguous().data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), bh, t, d,
                    LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), bp.tile, *extra, stream)
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
    """(out, lse2): lse2 only when `with_lse` and the `mma` or `tf32x3`
    kernel ran (the plain version and `simt` keep none), else None."""
    global launches
    if not kernel:
        return attention_reference(q, k, v), None
    bh, t, d = q.shape
    p = plan(bh, t, d, q.dtype, variant)
    out = torch.empty_like(q)
    lse = (torch.empty((bh, t), dtype=torch.float32, device=q.device)
           if with_lse and p.variant in ("mma", "tf32x3") else None)
    if out.numel() == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if p.variant in ("mma", "tf32x3"):
            fn = lib.attention_mma_forward if p.variant == "mma" else lib.attention_tf32x3_forward
            extra = () if p.variant == "mma" else (p.stages,)
            rc = fn(*args, None if lse is None else lse.data_ptr(), bh, t, d,
                    LOG2E / math.sqrt(d), p.key_splits, *extra, stream)
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
    _check_head_width(d)
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
    rows' (B·heads, T) fp32 log-sum-exp in the log2 domain that the `mma` or
    `tf32x3` kernel writes beside it (None on the `simt` route, which keeps
    none);
    on a CPU tensor, or with `use_kernel=False`, `attention_reference` and
    `attention_lse_reference`."""
    if not _check_inputs(q, k, v, use_kernel):
        return attention_reference(q, k, v), attention_lse_reference(q, k)
    return _forward(q, k, v, True, variant, with_lse=True)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_kernel: bool = True, *, variant: Optional[str] = None) -> torch.Tensor:
    """q, k, v (B·heads, T, d) -> (B·heads, T, d), any d >= 1;
    differentiable in q, k and v.

    `variant` (measurements only) forces the kernel that `plan` would
    choose from dtype and shape, and with it the backward's."""
    kernel = _check_inputs(q, k, v, use_kernel)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, kernel, variant)
    return _forward(q, k, v, kernel, variant)[0]
