"""Self-attention with the ADM legacy scaling over (B·heads, T, d).

Port of the Pallas TPU kernel `ops/attention.py::flash_attention` of the
JAX package: q and k are each scaled by d^-1/4 and the softmax runs in
fp32.  On a CUDA tensor `attention` launches one of the hand-written
kernels, chosen by `plan` from the dtype and the shape alone:

- `mma`: bf16, the UNet's path.  A flash kernel on the tensor cores
  (`mma.sync` m16n8k16), 16 query rows per warp, the keys of a row group
  split over the block's warps and merged in order, P rounded to bf16 in
  registers for the P·V product.  d <= 128 in `csrc/attention_mma.cu`;
  wider heads in `csrc/attention_wide_mma.cu`;
- `tf32x3`: fp32, the UNet's path at the CLIs' default compute dtype.  The
  same blocking in key tiles of 32, on `mma.sync` m16n8k8 tf32: each operand
  split into TF32 hi + lo in registers and each product taken as hi·hi +
  hi·lo + lo·hi, which keeps fp32's accuracy
  (`attention_tf32x3_tiled_reference`).  d <= 128 in
  `csrc/attention_tf32x3.cu`; wider heads in `csrc/attention_wide_tf32x3.cu`;
- `simt` (`csrc/attention.cu`): fp32 dot products on the CUDA cores, any
  d (past `MAX_HEAD_DIM` = 256 in column chunks of 256).  On no default
  route: only when forced (`variant="simt"`, measurements only).

All take any T and any d.  Past `MMA_MAX_HEAD_DIM` = 128 the tensor-core
kernels run in column chunks of output columns on a third grid axis (the
forward 128 or 256 a block, `Plan.chunk_cols`; the backward `WIDE_CHUNK` =
128): each block recomputes S over the full padded head, streaming q and k
through shared memory in slices of `WIDE_SLICE` = 64 columns (in `tf32x3`
each slice's sum goes into an fp32 total), and stages only its chunk of v;
every chunk computes the same row statistics and chunk 0 writes lse2.  On a CPU tensor, or when the caller passes `use_kernel=False`,
`attention` runs `attention_reference`.

Gradients (the JAX package differentiates its einsum attention with XLA):
when q, k or v needs one, `attention` runs as a `torch.autograd.Function`
that saves q, k, v, the output and, on the `mma` and `tf32x3` routes, the
rows' log-sum-exp that the forward kernel writes beside the output (lse2,
in the kernel's log2 domain).  Its backward, `attention_backward`, launches
one of three pairs of kernels on a CUDA tensor, chosen by `backward_plan`
from the dtype and the shape; each pair is a query pass and a key pass with
no atomics, so every launch gives the same bits:

- `mma`: bf16.  All five products on the tensor cores (`mma.sync`
  m16n8k16), P from the forward's lse2, P and dS rounded to bf16 in
  registers where they feed a product, the 4 warps of a block splitting the
  walked dimension and their partial sums added in order.  d <= 128 in
  `csrc/attention_bwd_mma.cu`; wider heads in column chunks of 128 in
  `csrc/attention_wide_mma.cu` (each pass recomputes S and dP over the full
  head from slices);
- `tf32x3`: fp32.  The same layout on `mma.sync` m16n8k8 tf32, each of the
  five products taken as three TF32 products of split operands, P and dS
  split in registers.  d <= 128 in `csrc/attention_bwd_tf32x3.cu`; wider
  heads in `csrc/attention_wide_tf32x3.cu`;
- `simt` (`csrc/attention_bwd.cu`): fp32 dot products on the CUDA cores,
  the rows' statistics recomputed; past `MAX_HEAD_DIM` in column chunks of
  256.  Only when forced.

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

__all__ = ["BackwardPlan", "MAX_HEAD_DIM", "Plan", "VARIANTS", "WIDE_CHUNK", "WIDE_SLICE",
           "attention",
           "attention_backward", "attention_backward_mma_tiled_reference",
           "attention_backward_reference", "attention_backward_tf32x3_tiled_reference",
           "attention_backward_tiled_reference", "attention_lse_reference",
           "attention_reference", "attention_tf32x3_tiled_reference",
           "attention_tiled_reference", "attention_with_lse", "backward_launches",
           "backward_launches_by_variant", "backward_plan", "launches", "launches_by_variant",
           "plan", "wide_backward_launches", "wide_launches"]

VARIANTS = ("mma", "tf32x3", "simt")
launches = 0    # forward calls that launched a kernel since the caller last set this to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant
backward_launches = 0    # backward calls that launched the kernels, the same way
backward_launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant
wide_launches = 0             # forward launches of `mma` and `tf32x3` past MMA_MAX_HEAD_DIM
wide_backward_launches = 0    # the same, backward

MAX_HEAD_DIM = 256       # the widest head `simt` takes in one pass; wider ones go in chunks of it
MMA_MAX_HEAD_DIM = 128   # the widest head `mma` and `tf32x3` take in one pass
WIDE_CHUNK = 128         # output columns per block past MMA_MAX_HEAD_DIM (the forward: or twice)
WIDE_SLICE = 64          # columns of q and k (dout, v) per shared-memory slice of those kernels
MAX_SMEM = 232448        # the most shared memory a block takes on the card
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
    `chunks` > 1: the output's columns split into that many chunks over a
    third grid axis, of `MAX_HEAD_DIM` columns (`simt`).  Past
    `MMA_MAX_HEAD_DIM` `mma` and `tf32x3` run in `chunks` chunks of
    `chunk_cols` (128 or 256) output columns (one chunk at d <= 256 with
    256), q and k streamed in slices of `WIDE_SLICE` columns.  `stages`
    (`mma`, `tf32x3`): the shared-memory stages of a key split with more
    than one tile (or, past `MMA_MAX_HEAD_DIM`, the ring of a split's
    slices), 2 to stream the next one in during this one (`simt` ignores
    it)."""
    variant: str
    warps: int
    key_splits: int
    key_tile: int
    d_pad: int
    grid: Tuple[int, int]
    chunks: int = 1
    stages: int = 2
    chunk_cols: int = 0


@functools.lru_cache(maxsize=None)
def plan(bh: int, t: int, d: int, dtype: torch.dtype, variant: Optional[str] = None) -> Plan:
    """The kernel and tiling for (bh, t, d) in `dtype`: `mma` for bf16 and
    `tf32x3` for fp32, at any d.  They run `MMA_WARPS` warps per block and
    split the keys of a row group over as many of them (4, 2, then 1) as
    leave every split a key tile (64 keys for `mma`, 32 for `tf32x3`): a
    warp's chain of tiles, not the card's rate, sets the time at these
    sizes.  Up to d = 128 two rounds of split tiles must fit in shared
    memory, so 64 < d <= 128 splits at most 2 ways, and `tf32x3`'s two
    rounds fill an SM's shared memory: past one block per SM of the card
    (`SMS`) it takes one round, refilled after each tile, and several blocks
    share an SM.  Past 128 q and k stream through in slices, so any split
    fits; the output runs in column chunks of 128 or 256 and the splits
    fall as the grid grows (`_wide_forward_blocking`), in one or two ring
    stages (`_wide_stages`).  `simt` (any d; past `MAX_HEAD_DIM` in column
    chunks of 256) only when forced.  `variant` forces the kernel (measurements only); one
    that cannot take the dtype raises."""
    _check_head_width(d)
    variant = _tensor_core_variant(variant, dtype, "attention")
    if variant in ("mma", "tf32x3"):
        key_tile = MMA_KEY_TILE if variant == "mma" else TF32X3_KEY_TILE
        wide = d > MMA_MAX_HEAD_DIM
        most = min(-(-t // key_tile), 4 if d <= 64 or wide else 2)
        key_splits = 4 if most >= 4 else 2 if most >= 2 else 1
        rows = MMA_ROWS * MMA_WARPS // key_splits
        grid = (-(-t // rows), bh)
        d_pad = _d_pad(variant, d)
        if not wide:
            stages = 1 if variant == "tf32x3" and grid[0] * grid[1] > SMS else 2
            return Plan(variant, MMA_WARPS, key_splits, key_tile, d_pad, grid, stages=stages)
        chunk_cols, key_splits = _wide_forward_blocking(variant, bh, t, d_pad, key_splits)
        chunks = -(-d_pad // chunk_cols)
        grid = (-(-t // (MMA_ROWS * MMA_WARPS // key_splits)), bh)
        stages = _wide_stages(grid[0] * grid[1] * chunks, lambda n: _wide_forward_smem(
            variant, MMA_WARPS // key_splits, key_splits, n, chunk_cols))
        return Plan(variant, MMA_WARPS, key_splits, key_tile, d_pad, grid, chunks, stages,
                    chunk_cols)
    if variant == "simt":
        chunks = -(-d // MAX_HEAD_DIM)
        d_max = 64 if d <= 64 else 128 if d <= 128 else MAX_HEAD_DIM * chunks
        return Plan("simt", 8, 1, 32 if d_max <= 128 else 16, d_max, (-(-t // SIMT_ROWS), bh),
                    chunks)
    raise ValueError(f"attention: unknown variant {variant!r}")


def _wide_forward_blocking(variant: str, bh: int, t: int, d_pad: int, splits: int):
    """(output columns a block, key splits) of the forward past
    `MMA_MAX_HEAD_DIM`, from `splits` as the key tiles allow: 256 columns
    where the head has more than 3 chunks of 128 and the grid passes one
    wave of the card (`SMS`), which halves the recompute of S; then, while
    the grid passes two waves, 2 splits, 256 columns, 1 split (the grid's
    blocks share the card, and a block's warps share their K slices).  The
    blockings timed against it: PERF.md, section 6 (PR 19)."""
    def blocks(chunk, s):
        return -(-t // (MMA_ROWS * MMA_WARPS // s)) * bh * -(-d_pad // chunk)

    chunk = 2 * WIDE_CHUNK if d_pad > 3 * WIDE_CHUNK and blocks(WIDE_CHUNK, splits) > SMS \
        else WIDE_CHUNK
    while blocks(chunk, splits) > 2 * SMS:
        if splits > 2:
            splits = 2
        elif chunk == WIDE_CHUNK:
            chunk = 2 * WIDE_CHUNK
        elif splits > 1:
            splits = 1
        else:
            break
    return chunk, splits


def _wide_stages(blocks: int, smem) -> int:
    """Ring stages past `MMA_MAX_HEAD_DIM`: two while the grid's `blocks` fit
    one wave of the card or two blocks of two stages fit an SM, else one
    (several blocks then share an SM and hide each other's copies); fewer
    where `smem(stages)` passes a block's shared memory."""
    stages = 2 if blocks <= SMS or 2 * smem(2) <= MAX_SMEM else 1
    while stages > 1 and smem(stages) > MAX_SMEM:
        stages -= 1
    return stages


def _wide_backward_smem(variant: str, tile: int, stages: int) -> int:
    """Bytes of shared memory of a key-pass block past `MMA_MAX_HEAD_DIM`
    (csrc/attention_wide_*.cu `bwd_smem`): the rows' D, then 4 warps' rings
    of `stages` stages, each the larger of a slice item (16 + 16 block rows
    and 2 `tile` walked rows, `WIDE_SLICE` columns) and a column-chunk item
    (`tile` rows of `WIDE_CHUNK`); after the loop the same bytes hold the
    warps' partial sums of dk and dv."""
    elem, pad = (2, 8) if variant == "mma" else (4, 4)
    stage = max((2 * MMA_ROWS + 2 * tile) * (WIDE_SLICE + pad), tile * (WIDE_CHUNK + pad))
    parts = 2 * MMA_WARPS * MMA_ROWS * (WIDE_CHUNK + 8) * 4
    return MMA_ROWS * 4 + max(MMA_WARPS * stages * stage * elem, parts)


def _wide_forward_smem(variant: str, groups: int, splits: int, stages: int, chunk: int) -> int:
    """Bytes of shared memory of a forward block past `MMA_MAX_HEAD_DIM`
    (csrc/attention_wide_*.cu `fwd_smem`): `splits` rings of `stages`
    stages, each the larger of a slice item (q's rows of the row groups and
    a key tile, `WIDE_SLICE` columns) and a v item (a key tile,
    `WIDE_CHUNK` columns: a chunk of 256 takes its v in two), rows padded
    against bank conflicts; after the loop the same bytes hold the splits'
    partial results, `chunk` columns each."""
    elem, key_tile, pad = (2, MMA_KEY_TILE, 8) if variant == "mma" else (4, TF32X3_KEY_TILE, 4)
    stage = max((MMA_ROWS * groups + key_tile) * (WIDE_SLICE + pad),
                key_tile * (WIDE_CHUNK + pad))
    partial = (chunk // 8) * 128 + 128
    return max(splits * stages * stage * elem, groups * (splits - 1) * partial * 4)


def _check_head_width(d: int) -> None:
    if d < 1:
        raise ValueError(f"attention: head width {d}, not at least 1")


def _tensor_core_variant(variant: Optional[str], dtype: torch.dtype, what: str) -> str:
    """The variant a plan takes: the forced one, else `mma` (bf16) or
    `tf32x3` (fp32), and `simt` for another dtype (which the wrappers
    refuse); raises for a forced tensor-core variant of the other dtype."""
    own = {torch.bfloat16: "mma", torch.float32: "tf32x3"}.get(dtype)
    if variant is None:
        return own or "simt"
    if variant in ("mma", "tf32x3") and variant != own:
        raise ValueError(f"{what}: {variant} takes {'bf16' if variant == 'mma' else 'fp32'}, "
                         f"not {dtype}")
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


def _wide(p) -> bool:
    """Whether plan `p` (forward or backward) runs a tensor-core kernel past
    `MMA_MAX_HEAD_DIM`: q and k in slices, the output in column chunks."""
    return p.variant in ("mma", "tf32x3") and p.d_pad > MMA_MAX_HEAD_DIM


def _chunk_columns(p) -> list:
    """The output columns each block of plan `p` computes: all of them, or
    past `MMA_MAX_HEAD_DIM` one chunk per block (`chunk_cols` of a forward
    plan, `WIDE_CHUNK` of a backward plan)."""
    if not _wide(p):
        return [slice(None)]
    width = p.chunk_cols if isinstance(p, Plan) else WIDE_CHUNK
    return [slice(c, c + width) for c in range(0, p.d_pad, width)]


def _logits(a: torch.Tensor, b: torch.Tensor, p, tf32x3: bool) -> torch.Tensor:
    """a @ bᵀ over the padded head (batched) as the kernels of plan `p` add
    it up: in one sum up to `MMA_MAX_HEAD_DIM`, past it slice by slice of
    `WIDE_SLICE` columns into an fp32 total.  `tf32x3`: each slice's sum as
    `_tf32x3_matmul` takes it, else in fp32."""
    step = WIDE_SLICE if _wide(p) else p.d_pad
    total = 0
    for c in range(0, p.d_pad, step):
        a_s, b_s = a[..., c:c + step], b[..., c:c + step].transpose(-1, -2)
        total = total + (_tf32x3_matmul(a_s, b_s) if tf32x3 else a_s @ b_s)
    return total


def _forward_tiled(q, k, v, p, tf32x3: bool, with_lse: bool):
    """The forward kernels' arithmetic for `attention_tiled_reference` (bf16)
    and `attention_tf32x3_tiled_reference` (fp32), chunk by chunk of output
    columns: each chunk recomputes the rows' statistics, chunk 0's lse2 is
    the one written."""
    bh, t, d = q.shape
    kt = p.key_tile
    t_keys = -(-t // kt) * kt

    def operand(a, rows):
        a = a.float() if tf32x3 else a.to(torch.bfloat16).float()
        return torch.nn.functional.pad(a, (0, p.d_pad - d, 0, rows - t))

    qf, kf, vf = operand(q, t), operand(k, t_keys), operand(v, t_keys)
    scale = LOG2E / math.sqrt(d)
    outs, lses = [], []
    for cols in _chunk_columns(p):
        parts = []
        for split in range(p.key_splits):
            m = qf.new_full((bh, t, 1), -math.inf)
            l = qf.new_zeros((bh, t, 1))
            acc = qf.new_zeros((bh, t, vf[..., cols].shape[-1]))
            for j0 in range(split * kt, t_keys, p.key_splits * kt):
                s = _logits(qf, kf[:, j0:j0 + kt], p, tf32x3) * scale
                s[..., max(t - j0, 0):] = -1e30
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                pm = torch.exp2(s - m_new)
                l = l * alpha + pm.sum(-1, keepdim=True)
                vt = vf[:, j0:j0 + kt, cols]
                if tf32x3:
                    acc = _tf32x3_matmul(pm, vt, acc * alpha)
                else:
                    acc = acc * alpha + pm.to(torch.bfloat16).float() @ vt
                m = m_new
            parts.append((m, l, acc))
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        l = acc = 0
        for m, l_s, acc_s in parts:
            c = torch.exp2(m - m_all)
            l, acc = l + l_s * c, acc + acc_s * c
        outs.append(acc * (1.0 / l) if tf32x3 else acc / l)
        lses.append((m_all + torch.log2(l))[..., 0])
    out = torch.cat(outs, -1)[..., :d]
    out = out if tf32x3 else out.to(torch.bfloat16)
    return (out, lses[0]) if with_lse else out


def attention_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              p: Plan, with_lse: bool = False):
    """`mma`'s arithmetic, step by step as plan `p` lays it out (for tests):
    bf16 operands, d zero-padded to `p.d_pad`.  Per chunk of output columns
    (`p.chunks`), key split s takes tiles s, s + key_splits, ...; per tile,
    S in fp32 from the unscaled q and k (past d = 128 summed slice by slice
    of `WIDE_SLICE`), times d^-1/2·log2(e), keys past T at -1e30, then the
    online softmax with exp2, the row sums from fp32 P, P rounded to bf16
    for P·V of the chunk's columns.  The splits' (O, m, l) are merged in
    split order; one division and one rounding to bf16 at the end.  With
    `with_lse`, also the rows' lse2 = m + log2(l) that chunk 0 writes for
    the backward: (out, lse2)."""
    if p.variant != "mma":
        raise ValueError(f"attention_tiled_reference emulates mma, not {p.variant}")
    return _forward_tiled(q, k, v, p, False, with_lse)


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
    tests): fp32 operands, d zero-padded to `p.d_pad`.  Per chunk of output
    columns (`p.chunks`), key split s takes tiles s, s + key_splits, ...;
    per tile, S = Q Kᵀ from the unscaled q and k as three TF32 products per
    8-wide slice of d (`_tf32x3_matmul`; past d = 128 each `WIDE_SLICE` of
    columns in a sum of its own, added into an fp32 total), times
    d^-1/2·log2(e), keys past T at -1e30, then the online softmax with
    exp2, the row sums from fp32 P, O rescaled and P·V of the chunk's
    columns added into it as three TF32 products per 8 keys.  The splits'
    (O, m, l) are merged in split order; O times 1 / l at the end.  With
    `with_lse`, also the rows' lse2 = m + log2(l) that chunk 0 writes for
    the backward: (out, lse2)."""
    if p.variant != "tf32x3":
        raise ValueError(f"attention_tf32x3_tiled_reference emulates tf32x3, not {p.variant}")
    return _forward_tiled(q, k, v, p, True, with_lse)


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

    `mma` and `tf32x3`: `splits` = 4 warps share a block's 16 rows and
    split the walked keys (queries) in chunks of `tile` rows, warp w taking
    chunks w, w + 4, ...; `channels` is 0.  Past `MMA_MAX_HEAD_DIM`,
    `chunks` > 1 column chunks of `WIDE_CHUNK` on a third grid axis, each
    pass recomputing S and dP from slices of `WIDE_SLICE` columns.
    `simt` (csrc/attention_bwd.cu): each row is held by d_pad / `channels`
    threads, tiles of `tile` keys (queries) go through shared memory;
    `splits` is 1.  Past `MAX_HEAD_DIM`, `chunks` > 1 column chunks of 256
    on a third grid axis, each row held by 256 / `channels` threads.
    `stages` (`mma`, `tf32x3`): the shared-memory stages of a warp with more
    than one chunk (past `MMA_MAX_HEAD_DIM`: with more than one slice), 2 to
    stream the next one in during this one (`simt` ignores it)."""
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
    """The backward kernels and their layout for (bh, t, d) in `dtype`:
    `mma` for bf16 and `tf32x3` for fp32, at any d.  Up to d = 128 `mma`
    takes the narrowest chunk (16, 32 or 64 rows; at most 32 for d > 64)
    that leaves each of its 4 warps at most one chunk: a warp's chain of
    chunks sets the time at these sizes.  Two stages per warp must fit in
    shared memory when a warp walks more than one chunk: then `mma` takes
    the widest chunk and `tf32x3`, whose fp32 chunks are twice the bytes,
    half of it.  `tf32x3` takes chunks of at most that half in two stages
    while its grid fits the card (`SMS` blocks), and past it chunks of 16
    rows in one stage, so that four blocks share an SM (the blockings timed
    against these are in PERF.md, section 6).  Past 128 both take chunks of
    16 rows up to T = 64 and 32 above, in column chunks of `WIDE_CHUNK`, in
    one or two ring stages (`_wide_stages`).  `simt`
    (past `MAX_HEAD_DIM` in column chunks of 256) only when forced.
    `variant` and `tile` force the kernels and the chunk (measurements
    only); a forced choice that cannot take the shape raises."""
    _check_head_width(d)
    variant = _tensor_core_variant(variant, dtype, "attention_backward")
    if variant in ("mma", "tf32x3") and d > MMA_MAX_HEAD_DIM:
        d_pad = _d_pad(variant, d)
        chunks = -(-d_pad // WIDE_CHUNK)
        grid = (-(-t // MMA_ROWS), bh)
        if tile is None:
            tile = 16 if MMA_WARPS * 16 >= t else 32
        elif tile not in (16, 32):
            raise ValueError(f"attention_backward: {variant} past d = {MMA_MAX_HEAD_DIM} takes "
                             f"chunks of 16 or 32, not {tile}")
        stages = _wide_stages(grid[0] * grid[1] * chunks,
                              lambda n: _wide_backward_smem(variant, tile, n))
        return BackwardPlan(variant, d_pad, tile, MMA_ROWS, MMA_WARPS, 0, grid, chunks, stages)
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


def _backward_tiled(q, k, v, out, dout, lse2, p, tf32x3: bool):
    """The backward kernels' arithmetic for
    `attention_backward_mma_tiled_reference` (bf16) and
    `attention_backward_tf32x3_tiled_reference` (fp32), chunk by chunk of
    output columns, each chunk recomputing S and dP over the full head."""
    bh, t, d = q.shape
    w = p.tile
    chunks = -(-t // w)
    t_pad = chunks * w

    def operand(a):
        a = a.float() if tf32x3 else a.to(torch.bfloat16).float()
        return torch.nn.functional.pad(a, (0, p.d_pad - d, 0, t_pad - t))

    def product(a, b, acc):                    # acc + a @ b as the kernels add it
        if tf32x3:
            return _tf32x3_matmul(a, b, acc)
        return acc + a.to(torch.bfloat16).float() @ b

    qf, kf, vf, of, gf = (operand(a) for a in (q, k, v, out, dout))
    lse = torch.nn.functional.pad(lse2.float(), (0, t_pad - t))
    delta = (gf * of).sum(-1)                                   # (bh, t_pad)
    live = torch.arange(t_pad, device=q.device) < t
    scale_log2, scale = LOG2E / math.sqrt(d), 1.0 / math.sqrt(d)
    grads = []
    for cols in _chunk_columns(p):
        dq = dk = dv = 0
        for warp in range(p.splits):
            dq_w = dk_w = dv_w = qf.new_zeros(bh, t_pad, vf[..., cols].shape[-1])
            for c in range(warp, chunks, p.splits):
                rows = slice(c * w, (c + 1) * w)
                # query pass: all query rows, this chunk's keys
                s = _logits(qf, kf[:, rows], p, tf32x3)
                dp = _logits(gf, vf[:, rows], p, tf32x3)
                pm = torch.exp2(s * scale_log2 - lse[..., None]) * live[rows]
                dq_w = product(pm * (dp - delta[..., None]), kf[:, rows, cols], dq_w)
                # key pass: all key rows, this chunk's queries (Pᵀ, dSᵀ)
                st = _logits(kf, qf[:, rows], p, tf32x3)
                dpt = _logits(vf, gf[:, rows], p, tf32x3)
                pt = torch.exp2(st * scale_log2 - lse[:, None, rows]) * live[rows]
                dv_w = product(pt, gf[:, rows, cols], dv_w)
                dk_w = product(pt * (dpt - delta[:, None, rows]), qf[:, rows, cols], dk_w)
            dq, dk, dv = dq + dq_w, dk + dk_w, dv + dv_w
        grads.append((dq, dk, dv))
    result = []
    for i, mul in ((0, scale), (1, scale), (2, 1.0)):
        a = torch.cat([g[i] for g in grads], -1)[:, :t, :d] * mul
        result.append(a if tf32x3 else a.to(torch.bfloat16))
    return tuple(result)


def attention_backward_mma_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                           out: torch.Tensor, dout: torch.Tensor,
                                           lse2: torch.Tensor, p: BackwardPlan):
    """The `mma` backward kernels' arithmetic, step by step as `p` lays it
    out (for tests): bf16 operands, the head zero-padded to `p.d_pad`, rows
    past T zero; lse2 (B·heads, T) from the forward, in its log2 domain.
    D = rowsum(dout ∘ out) in fp32.  Per chunk of output columns
    (`p.chunks`): query pass: warp w of `p.splits` walks key chunks w,
    w + splits, ... of `p.tile` keys; per chunk S and dP in fp32 (past
    d = 128 summed slice by slice of `WIDE_SLICE`),
    P = exp2(S·d^-1/2·log2(e) − lse2) (0 for keys past T),
    dS = P (dP − D) rounded to bf16 for dS·K.  Key pass: the same over query
    chunks, P rounded to bf16 for Pᵀ·dout, dS for dSᵀ·q.  The warps'
    partial sums are added in warp order, then dq and dk take the factor
    d^-1/2 and every output one rounding to bf16."""
    if p.variant != "mma":
        raise ValueError(f"attention_backward_mma_tiled_reference emulates mma, not {p.variant}")
    return _backward_tiled(q, k, v, out, dout, lse2, p, False)


def attention_backward_tf32x3_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                              out: torch.Tensor, dout: torch.Tensor,
                                              lse2: torch.Tensor, p: BackwardPlan):
    """The `tf32x3` backward kernels' arithmetic, step by step as `p` lays it
    out (for tests): fp32 operands, the head zero-padded to `p.d_pad`, rows
    past T zero; lse2 (B·heads, T) from the forward, in its log2 domain.
    D = rowsum(dout ∘ out) in fp32.  Per chunk of output columns
    (`p.chunks`): query pass: warp w of `p.splits` walks key chunks w,
    w + splits, ... of `p.tile` keys; per chunk S and dP as three TF32
    products per 8-wide slice of d (`_tf32x3_matmul`; past d = 128 each
    `WIDE_SLICE` of columns in a sum of its own, added into an fp32 total),
    P = exp2(S·d^-1/2·log2(e) − lse2) (0 for keys past T), dS = P (dP − D),
    dq += dS·K as three TF32 products per 8 keys.  Key pass: the same over
    query chunks, dv += Pᵀ·dout and dk += dSᵀ·q.  The warps' partial sums
    are added in warp order, then dq and dk take the factor d^-1/2."""
    if p.variant != "tf32x3":
        raise ValueError(f"attention_backward_tf32x3_tiled_reference emulates tf32x3, "
                         f"not {p.variant}")
    return _backward_tiled(q, k, v, out, dout, lse2, p, True)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       dout: torch.Tensor, lse: Optional[torch.Tensor] = None,
                       use_kernel: bool = True, *, variant: Optional[str] = None,
                       tile: Optional[int] = None):
    """(dq, dk, dv) of out = attention(q, k, v) given dL/dout, all
    (B·heads, T, d) in q's dtype.  On a CUDA tensor the kernels that
    `backward_plan` picks: `mma` and `tf32x3` need `lse`, the (B·heads, T)
    fp32 lse2 of the forward kernel (`attention_with_lse`), and raise
    without it; the forced `simt` takes none.  On a CPU tensor, or with `use_kernel=False`,
    `attention_backward_reference`.  `variant` and `tile` force the kernels
    (measurements only)."""
    global backward_launches, wide_backward_launches
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
            wide = "_wide" if _wide(bp) else ""
            fn = getattr(lib, f"attention_{bp.variant}{wide}_backward")
            extra = () if bp.variant == "mma" and not wide else (bp.stages,)
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
    wide_backward_launches += _wide(bp)
    _flops.report(8.0 * bh * t * t * d, "attention_backward")
    return dq, dk, dv


def _forward(q, k, v, kernel, variant, with_lse=False):
    """(out, lse2): lse2 only when `with_lse` and the `mma` or `tf32x3`
    kernel ran (the plain version and the forced `simt` keep none), else
    None."""
    global launches, wide_launches
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
            wide = "_wide" if _wide(p) else ""
            fn = getattr(lib, f"attention_{p.variant}{wide}_forward")
            extra = ((p.stages, p.chunk_cols) if wide else
                     () if p.variant == "mma" else (p.stages,))
            rc = fn(*args, None if lse is None else lse.data_ptr(), bh, t, d,
                    LOG2E / math.sqrt(d), p.key_splits, *extra, stream)
        else:
            rc = lib.attention_forward(*args, bh, t, d, 1.0 / math.sqrt(math.sqrt(d)),
                                       int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, f"attention ({p.variant})")
    launches += 1
    launches_by_variant[p.variant] += 1
    wide_launches += _wide(p)
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
    `tf32x3` kernel writes beside it (None with a forced `simt`, which keeps
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
