"""3x3 stride-1 zero-padding-1 convolution, NHWC x HWIO + bias -> NHWC.

Port of the Pallas TPU kernel `ops/conv3x3.py::conv3x3_same` of the JAX
package.  On a CUDA tensor `conv3x3` launches one of three hand-written
kernels, chosen by `plan` from the dtype and the shape alone:

- `tc` (`csrc/conv3x3_tc.cu`): bf16 with Cin and Cout multiples of 64, the
  UNet's 60 hot convs.  An implicit GEMM on the tensor cores (`wgmma`) fed
  by TMA, with the K loop split over several blocks on small maps;
- `narrow` (`csrc/conv3x3.cu`): Cout < 16 (the UNet's final conv), one
  thread per output pixel over a shared-memory tile, bound by bytes;
- `simt` (`csrc/conv3x3.cu`): everything else (fp32 I/O, the Cin = 1 stem,
  other channel counts), fp32 FMA on the CUDA cores.

All three accumulate in fp32, add the fp32 bias and round once to the input
dtype.  On a CPU tensor, or when the caller passes `use_kernel=False`,
`conv3x3` runs `conv3x3_reference`, the same nine shifted-tap matmuls
written in PyTorch.

Gradients (the JAX package differentiates its XLA conv, `MatmulConv3x3`):
when an input needs one, `conv3x3` runs as a `torch.autograd.Function`.
- The input gradient of a stride-1 zero-pad-1 3x3 conv is the same conv of
  the output gradient with the kernel flipped in space and Cin, Cout swapped
  (`swapped_weight`, made once per frozen weight).  `conv3x3_input_grad`
  runs it through the same three kernels, chosen by `plan` for the swapped
  channel counts (on a CPU tensor through `conv3x3_reference`).
- The bias gradient is an fp32 sum of the output gradient over (B, H, W).
- The weight gradient, dW[di, dj] = x(shifted by the tap)^T dL/dy, is a
  GEMM of M = 9 Cin, N = Cout, K = B H W pixels: `conv3x3_weight_grad`
  launches `tc` (`csrc/conv3x3_wgrad_tc.cu`: bf16 tensor cores, `wgmma`
  fed by TMA, Cin and Cout multiples of 64; a block owns a column of three
  taps) or, from `csrc/conv3x3_wgrad.cu`, `mma` (other bf16 shapes with
  Cin and Cout multiples of 16), `narrow_out` (Cout <= 16: the final conv)
  and `narrow_in` (Cin <= 16: the stem), each reading its large operand
  once, or `simt` (fp32 FMA: the other fp32 shapes), with K split over
  blocks as `wgrad_plan` lays it out and the splits added in a fixed order
  (deterministic).  On a CPU tensor `conv3x3_weight_grad_reference`
  computes it.  x is saved for it only when the weight requires a
  gradient.
The plans take the device's SM count (`device_sms`; 132, an H100 SXM's, by
default).
Forward, input-gradient and weight-gradient launches are counted apart.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

__all__ = ["Plan", "VARIANTS", "WGRAD_VARIANTS", "WgradPlan", "backward_launches",
           "backward_launches_by_variant", "conv3x3", "conv3x3_input_grad", "conv3x3_reference",
           "conv3x3_tiled_reference", "conv3x3_weight_grad", "conv3x3_weight_grad_reference",
           "conv3x3_wgrad_tiled_reference", "device_sms", "launches", "launches_by_variant", "plan",
           "swapped_weight", "wgrad_launches", "wgrad_launches_by_variant", "wgrad_plan"]

VARIANTS = ("tc", "narrow", "simt")
launches = 0    # forward calls that launched a kernel since the caller last set this to 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)    # the same, by variant
backward_launches = 0    # input-gradient calls that launched a kernel, the same way
backward_launches_by_variant = dict.fromkeys(VARIANTS, 0)
WGRAD_VARIANTS = ("tc", "mma", "narrow_out", "narrow_in", "simt")
wgrad_launches = 0    # weight-gradient calls that launched a kernel, the same way
wgrad_launches_by_variant = dict.fromkeys(WGRAD_VARIANTS, 0)

SMS = 132          # streaming multiprocessors of an H100 SXM: the plans' default
TC_BK = 64         # input channels per K step of `tc` (128 bytes of bf16: one swizzled row)
TC_BN = 128        # output channels per `tc` tile
MIN_BLOCKS = 100   # at SMS: a grid of fewer blocks leaves a quarter of the SMs idle
NARROW_MAX_COUT = 15
NARROW_TILE = 16   # `narrow` tiles are 16 x 16 output pixels
# weight gradient.  `tc` (csrc/conv3x3_wgrad_tc.cu): a block owns one
# column of three taps x 128 input x 128 output channels, one block per SM;
# a K step is a box of at most 128 output pixels, 8 wide; splits of K come
# in clusters that add their partials on chip.  `mma`
# (csrc/conv3x3_wgrad.cu): 128 channels of one tap x 128 output channels
# over 32-pixel steps; `simt`: 64 (tap, channel) rows x 64 output channels
# over 16-pixel steps; both aim at WGRAD_BLOCKS_PER_SM blocks per SM.
# `narrow_out` / `narrow_in`: 128 channels of the large operand per block,
# a split per tile of rows x at most NARROW_WGRAD_COLS columns of one image.
WGRAD_TC_TILE = (128, 128)
WGRAD_TC_PIXELS = 128
WGRAD_TC_CLUSTER = 2          # splits per cluster (or 1)
WGRAD_MMA_TILE = (128, 128, 32)
WGRAD_SIMT_TILE = (64, 64, 16)
WGRAD_BLOCKS_PER_SM = 4
WGRAD_MIN_STEPS = 16          # K steps per split at least, so partial sums stay few
WGRAD_WIDE_SPLITS = 64        # more partials: added 8 strided runs at a time (csrc/conv3x3_wgrad.cu)
NARROW_WGRAD_CHANNELS = 128
NARROW_WGRAD_COLS = 64
NARROW_WGRAD_BLOCKS_PER_SM = 3   # the one-channel narrow kernels' residency (512 threads a block)


class Plan(NamedTuple):
    """How `conv3x3` runs one shape.  For `tc` an output tile is a box of
    `box` = (rows, cols) pixels of one image (`bm` of them) by `bn` channels;
    its K loop of `k_steps` steps (one tap x 64 input channels each) is cut
    into `splits` ranges of `steps_per_split`, each run by its own block,
    whose fp32 partials (`workspace_bytes`) a second kernel adds up."""
    variant: str
    box: Optional[Tuple[int, int]]
    bm: int
    bn: int
    tiles: int             # output tiles (pixel tiles x channel tiles)
    k_steps: int
    splits: int
    steps_per_split: int
    workspace_bytes: int


def _tc_eligible(cin: int, cout: int, dtype: torch.dtype) -> bool:
    return dtype == torch.bfloat16 and cin % TC_BK == 0 and cout % 64 == 0


def _tc_plan(b: int, h: int, w: int, cin: int, cout: int,
             splits: Optional[int], sms: int) -> Plan:
    n_tiles = -(-cout // TC_BN)
    # 128-pixel tiles (two consumer warpgroups, one block per SM) unless too
    # few of them to fill the card; 64-pixel tiles then run two blocks per SM
    bm = 128 if -(-b * h * w // 128) * n_tiles >= MIN_BLOCKS * sms // SMS else 64
    slots = sms * (1 if bm == 128 else 2)
    wt = min(1 << (w.bit_length() - 1), bm)          # widest power of two <= W
    ht = bm // wt
    tiles = b * -(-h // ht) * -(-w // wt) * n_tiles
    k_steps = 9 * cin // TC_BK

    def per_split(s):
        return -(-k_steps // s)

    if splits is None:
        # fewest waves x (steps per block + one step of fill and epilogue);
        # ties go to fewer splits, which move fewer partial sums
        cands = {-(-k_steps // per_split(s)) for s in range(1, k_steps + 1)}
        splits = min(cands, key=lambda s: (-(-tiles * s // slots) * (per_split(s) + 1), s))
    if not 1 <= splits <= k_steps or -(-k_steps // per_split(splits)) != splits:
        raise ValueError(f"conv3x3: {splits} splits of {k_steps} K steps leave one empty")
    ws = 4 * splits * b * h * w * cout if splits > 1 else 0
    return Plan("tc", (ht, wt), bm, TC_BN, tiles, k_steps, splits, per_split(splits), ws)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
         variant: Optional[str] = None, splits: Optional[int] = None, sms: int = SMS) -> Plan:
    """The kernel and tiling for x (b, h, w, cin) -> cout channels in `dtype`
    on a device of `sms` SMs: `tc` for bf16 with Cin and Cout multiples of
    64, `narrow` for Cout < 16, `simt` otherwise.  `variant` and `splits`
    force a choice (measurements only); a variant that cannot take the shape
    raises."""
    if variant is None:
        variant = ("tc" if _tc_eligible(cin, cout, dtype)
                   else "narrow" if cout <= NARROW_MAX_COUT else "simt")
    if variant == "tc":
        if not _tc_eligible(cin, cout, dtype):
            raise ValueError(f"conv3x3: tc takes bf16 with Cin, Cout multiples of 64, "
                             f"not {dtype} {cin}->{cout}")
        return _tc_plan(b, h, w, cin, cout, splits, sms)
    if splits not in (None, 1):
        raise ValueError(f"conv3x3: {variant} does not split K")
    if variant == "narrow":
        if cout > NARROW_MAX_COUT:
            raise ValueError(f"conv3x3: narrow takes Cout <= {NARROW_MAX_COUT}, not {cout}")
        t = NARROW_TILE
        tiles = b * -(-h // t) * -(-w // t)
        return Plan("narrow", (t, t), t * t, cout, tiles, 1, 1, 1, 0)
    if variant == "simt":
        tiles = -(-b * h * w // 64) * -(-cout // 64)
        return Plan("simt", None, 64, 64, tiles, 1, 1, 1, 0)
    raise ValueError(f"conv3x3: unknown variant {variant!r}")


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


def conv3x3_tiled_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                            p: Plan) -> torch.Tensor:
    """`tc`'s arithmetic, step by step as plan `p` lays it out (for tests):
    per output tile and split, fp32 sums over the split's K steps of a
    zero-filled box of x at the tap's offset times 64 rows of the weight;
    then the splits' partials added in order, the bias, one rounding."""
    if p.variant != "tc":
        raise ValueError(f"conv3x3_tiled_reference emulates tc, not {p.variant}")
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    ht, wt = p.box
    xf, wf = x.float(), weight.float().reshape(9 * cin, cout)
    chunks = cin // TC_BK

    def box(bi, r0, c0, ch):        # TMA's box: zero fill wherever it leaves the image
        out = xf.new_zeros(ht, wt, TC_BK)
        rs, cs = max(r0, 0), max(c0, 0)
        re, ce = min(r0 + ht, h), min(c0 + wt, w)
        if rs < re and cs < ce:
            out[rs - r0:re - r0, cs - c0:ce - c0] = xf[bi, rs:re, cs:ce, ch:ch + TC_BK]
        return out.reshape(ht * wt, TC_BK)

    y = xf.new_zeros(b, -(-h // ht) * ht, -(-w // wt) * wt, -(-cout // p.bn) * p.bn)
    wpad = torch.nn.functional.pad(wf, (0, y.shape[-1] - cout))
    for bi in range(b):
        for h0 in range(0, h, ht):
            for w0 in range(0, w, wt):
                for n0 in range(0, cout, p.bn):
                    parts = []
                    for s in range(p.splits):
                        acc = xf.new_zeros(ht * wt, p.bn)
                        for k in range(s * p.steps_per_split,
                                       min((s + 1) * p.steps_per_split, p.k_steps)):
                            tap, ch = divmod(k, chunks)
                            di, dj = divmod(tap, 3)
                            a = box(bi, h0 + di - 1, w0 + dj - 1, ch * TC_BK)
                            row = tap * cin + ch * TC_BK
                            acc += a @ wpad[row:row + TC_BK, n0:n0 + p.bn]
                        parts.append(acc)
                    total = parts[0]
                    for part in parts[1:]:
                        total = total + part
                    y[bi, h0:h0 + ht, w0:w0 + wt, n0:n0 + p.bn] = total.reshape(ht, wt, p.bn)
    return (y[:, :h, :w, :cout] + bias.float()).to(x.dtype)


def conv3x3_weight_grad_reference(x: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """dL/dW (3, 3, Cin, Cout) in fp32: per tap, the shifted x (zero halo)
    transposed times the output gradient (the CPU path's weight gradient)."""
    b, h, w, cin = x.shape
    g = grad_out.float().reshape(-1, grad_out.shape[-1])
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return torch.stack([torch.stack([xp[:, di:di + h, dj:dj + w, :].reshape(-1, cin).T @ g
                                     for dj in range(3)]) for di in range(3)])


class WgradPlan(NamedTuple):
    """How `conv3x3_weight_grad` runs one shape: `tiles` blocks of dW (`tc`:
    a column of three taps x `bm` input x `bn` output channels; `mma`: `bm`
    input channels of one tap x `bn`; `simt`: `bm` (tap, channel) rows x
    `bn`; narrow: `bm` channels of the large operand, `bn` the small
    operand's channels as the kernel holds them) and a K loop of `k_steps`
    steps of `bk` pixels (`tc` and narrow: boxes of `box` = (rows, cols)
    pixels of one image) cut into `splits` ranges of `steps_per_split`, one
    block each.  `tc` adds `cluster` consecutive splits on chip; the fp32
    partial sums of the rest (`workspace_bytes`) a second kernel adds in
    split order."""
    variant: str
    bm: int
    bn: int
    bk: int
    tiles: int
    k_steps: int
    splits: int
    steps_per_split: int
    workspace_bytes: int
    box: Optional[Tuple[int, int]] = None
    cluster: int = 1


def _wgrad_takes(variant: str, cin: int, cout: int, dtype: torch.dtype) -> bool:
    bf16 = dtype == torch.bfloat16
    return {"tc": bf16 and cin % 64 == 0 and cout % 64 == 0,
            "mma": bf16 and cin % 16 == 0 and cout % 16 == 0,
            "narrow_out": cout <= 16, "narrow_in": cin <= 16, "simt": True}[variant]


def _even_splits(k_steps: int, want: int) -> Tuple[int, int]:
    """(splits, steps per split): at most `want` splits of K, none empty."""
    per = -(-k_steps // max(1, min(want, k_steps)))
    return -(-k_steps // per), per


def _wgrad_tc_plan(b, h, w, cin, cout, splits, cluster, sms) -> WgradPlan:
    # boxes 8 wide (the tap offset, box_w pixel rows, stays a multiple of
    # the swizzle's 8 rows) and as tall as the map or the 128 pixels allow:
    # 16 x 8 stages x 2 + 16 rows of x per 16 of dL/dy, 8 x 16 ones 2 + 8
    wt = 8
    ht = min(WGRAD_TC_PIXELS // wt, max(2, 1 << (h - 1).bit_length()))
    bm, bn = WGRAD_TC_TILE
    tiles = 3 * -(-cin // bm) * -(-cout // bn)
    k_steps = b * -(-h // ht) * -(-w // wt)
    # split y of S runs K steps [y K / S, (y + 1) K / S): any S <= K leaves none empty
    if splits is None:              # one wave of a block per SM, whole clusters, 2 steps a split
        splits = max(1, min(sms // tiles, k_steps // 2))
        if cluster is None:         # unless whole clusters would idle an eighth of the wave
            cluster = WGRAD_TC_CLUSTER
            if splits < cluster or 8 * (splits % cluster) > splits:
                cluster = 1
        splits -= splits % cluster
    elif cluster is None:
        cluster = WGRAD_TC_CLUSTER if splits % WGRAD_TC_CLUSTER == 0 else 1
    if not 1 <= splits <= min(k_steps, 65535):
        raise ValueError(f"conv3x3 weight grad: {splits} splits of {k_steps} K steps")
    if cluster not in (1, WGRAD_TC_CLUSTER) or splits % cluster:
        raise ValueError(f"conv3x3 weight grad: clusters of {cluster} of {splits} splits")
    groups = splits // cluster
    ws = 4 * groups * 9 * cin * cout if groups > 1 else 0
    return WgradPlan("tc", bm, bn, ht * wt, tiles, k_steps, splits, -(-k_steps // splits), ws,
                     (ht, wt), cluster)


def _wgrad_narrow_plan(variant, b, h, w, cin, cout, splits, sms) -> WgradPlan:
    small, wide = (cout, cin) if variant == "narrow_out" else (cin, cout)
    held = 1 if small == 1 else 16                 # the kernel's accumulators per tap
    workers = 4 if held == 1 else 1                # row workers per block (csrc/conv3x3_wgrad.cu)
    cols = min(w, NARROW_WGRAD_COLS)
    tiles = -(-wide // NARROW_WGRAD_CHANNELS)
    rows, most = workers, (16 if held == 1 else 4)
    while rows < most and b * -(-h // rows) * -(-w // cols) * tiles > NARROW_WGRAD_BLOCKS_PER_SM * sms:
        rows *= 2
    k_steps = b * -(-h // rows) * -(-w // cols)
    if splits not in (None, k_steps):
        raise ValueError(f"conv3x3 weight grad: {variant} runs one split per tile, {k_steps}")
    ws = 4 * k_steps * 9 * cin * cout if k_steps > 1 else 0
    return WgradPlan(variant, NARROW_WGRAD_CHANNELS, held, rows * cols, tiles, k_steps, k_steps, 1,
                     ws, (rows, cols), 1)


@functools.lru_cache(maxsize=None)
def wgrad_plan(b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
               variant: Optional[str] = None, splits: Optional[int] = None, sms: int = SMS,
               cluster: Optional[int] = None) -> WgradPlan:
    """The weight-gradient kernel and its split of K = b*h*w pixels for x
    (b, h, w, cin) and dL/dy (b, h, w, cout) in `dtype` on a device of `sms`
    SMs: `tc` for bf16 with Cin and Cout multiples of 64, `mma` for other
    bf16 with multiples of 16, `narrow_out` for Cout <= 16, `narrow_in` for
    Cin <= 16, `simt` otherwise.  Without `splits`, `tc` splits K so that
    its grid is one wave of a block per SM, in clusters of up to
    `WGRAD_TC_CLUSTER` splits; `mma` and `simt` split until the grid holds
    about `WGRAD_BLOCKS_PER_SM` blocks per SM, keeping at least
    `WGRAD_MIN_STEPS` steps per split; the narrow variants take a split per
    tile, tiles as large as keep about `NARROW_WGRAD_BLOCKS_PER_SM` blocks
    per SM.  `variant`, `splits` and `cluster` force a choice (measurements
    only); one that cannot take the shape raises."""
    if variant is None:
        variant = next(v for v in WGRAD_VARIANTS if _wgrad_takes(v, cin, cout, dtype))
    if variant not in WGRAD_VARIANTS:
        raise ValueError(f"conv3x3 weight grad: unknown variant {variant!r}")
    if not _wgrad_takes(variant, cin, cout, dtype):
        raise ValueError(f"conv3x3 weight grad: {variant} does not take {dtype} {cin}->{cout}")
    if cluster is not None and variant != "tc":
        raise ValueError(f"conv3x3 weight grad: {variant} runs no clusters")
    if variant == "tc":
        return _wgrad_tc_plan(b, h, w, cin, cout, splits, cluster, sms)
    if variant.startswith("narrow"):
        return _wgrad_narrow_plan(variant, b, h, w, cin, cout, splits, sms)
    if variant == "mma":
        bm, bn, bk = WGRAD_MMA_TILE
        tiles = 9 * -(-cin // bm) * -(-cout // bn)
    else:
        bm, bn, bk = WGRAD_SIMT_TILE
        tiles = -(-9 * cin // bm) * -(-cout // bn)
    k_steps = -(-b * h * w // bk)
    if splits is None:
        splits = max(1, min(-(-WGRAD_BLOCKS_PER_SM * sms // tiles), k_steps // WGRAD_MIN_STEPS))
    if not 1 <= splits <= min(k_steps, 65535):
        raise ValueError(f"conv3x3 weight grad: {splits} splits of {k_steps} K steps")
    splits, per_split = _even_splits(k_steps, splits)
    ws = 4 * splits * 9 * cin * cout if splits > 1 else 0
    return WgradPlan(variant, bm, bn, bk, tiles, k_steps, splits, per_split, ws)


def _box_origin(k: int, h: int, w: int, box: Tuple[int, int]) -> Tuple[int, int, int]:
    """(image, row, column) of the corner of K step (box) k."""
    ht, wt = box
    tiles_w = -(-w // wt)
    bi, t = divmod(k, -(-h // ht) * tiles_w)
    return bi, (t // tiles_w) * ht, (t % tiles_w) * wt


def conv3x3_wgrad_tiled_reference(x: torch.Tensor, grad_out: torch.Tensor,
                                  p: WgradPlan) -> torch.Tensor:
    """The weight-gradient kernels' split and summation order as plan `p`
    lays it out (for tests): per split, fp32 sums over its K steps of the
    tap-shifted x (zero halo) transposed times dL/dy; `mma` and `simt` take
    `p.bk` pixels of the flattened grid a step, `tc` a box of output pixels
    (the three taps of each kernel column from one x box), the narrow
    variants a tile of pixels (`narrow_out`: of x, each feeding the nine
    taps' neighbours of dL/dy; `narrow_in`: of dL/dy), each row worker's
    rows summed apart and the workers added in order.  `tc` adds each
    cluster's splits in rank order; then the partials are added in order,
    or, past `WGRAD_WIDE_SPLITS` of them, in 8 runs of every 8th, whose sums
    are added in order."""
    b, h, w, cin = x.shape
    cout = grad_out.shape[-1]
    xf, g = x.float(), grad_out.float()
    if p.box is None:
        n = b * h * w
        xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
        taps = torch.stack([xp[:, di:di + h, dj:dj + w, :].reshape(n, cin)
                            for di in range(3) for dj in range(3)], dim=1).reshape(n, 9 * cin)
        gf = g.reshape(n, cout)

        def step(k):
            rows = slice(k * p.bk, min((k + 1) * p.bk, n))
            return (taps[rows].T @ gf[rows]).reshape(3, 3, cin, cout)
    elif p.variant == "tc":
        ht, wt = p.box
        hh, ww = -(-h // ht) * ht, -(-w // wt) * wt      # TMA's zero fill past the map
        xp = torch.nn.functional.pad(xf, (0, 0, 1, ww - w + 1, 1, hh - h + 1))
        gp = torch.nn.functional.pad(g, (0, 0, 0, ww - w, 0, hh - h))

        def step(k):
            bi, h0, w0 = _box_origin(k, h, w, p.box)
            gb = gp[bi, h0:h0 + ht, w0:w0 + wt].reshape(-1, cout)
            return torch.stack([torch.stack([
                xp[bi, h0 + di:h0 + di + ht, w0 + dj:w0 + dj + wt].reshape(-1, cin).T @ gb
                for dj in range(3)]) for di in range(3)])
    else:
        rows, cols = p.box
        workers = 4 if p.bn == 1 else 1
        xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
        gp = torch.nn.functional.pad(g, (0, 0, 1, 1, 1, 1))

        def step(k):
            bi, h0, w0 = _box_origin(k, h, w, p.box)
            n_c = min(cols, w - w0)
            total = None
            for y in range(workers):
                acc = xf.new_zeros(3, 3, cin, cout)
                for r in range(y, min(rows, h - h0), workers):
                    hr = h0 + r
                    for di in range(3):
                        for dj in range(3):
                            if p.variant == "narrow_out":    # x's pixel feeds dy at (+1-di, +1-dj)
                                a = xf[bi, hr, w0:w0 + n_c]
                                c = gp[bi, hr + 2 - di, w0 + 2 - dj:w0 + 2 - dj + n_c]
                            else:                            # dy's pixel takes x at (+di-1, +dj-1)
                                a = xp[bi, hr + di, w0 + dj:w0 + dj + n_c]
                                c = g[bi, hr, w0:w0 + n_c]
                            acc[di, dj] += a.T @ c
                total = acc if total is None else total + acc
            return total

    def bounds(s):                  # `tc` balances its splits; the others cut at steps_per_split
        if p.variant == "tc":
            return s * p.k_steps // p.splits, (s + 1) * p.k_steps // p.splits
        return s * p.steps_per_split, min((s + 1) * p.steps_per_split, p.k_steps)

    parts = []
    for s in range(p.splits):
        acc = None
        for k in range(*bounds(s)):
            acc = step(k) if acc is None else acc + step(k)
        parts.append(acc)
    groups = [functools.reduce(torch.add, parts[i:i + p.cluster])
              for i in range(0, p.splits, p.cluster)]
    if len(groups) > WGRAD_WIDE_SPLITS:     # the second kernel's order for many partials
        groups = [functools.reduce(torch.add, groups[q::8]) for q in range(8)]
    return functools.reduce(torch.add, groups)


def _input_grad_operands(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The input-gradient conv's kernel and its zero bias, made once per
    weight and kept on the weight until its version changes (a frozen base
    weight never does)."""
    cached = getattr(weight, "_conv3x3_swapped", None)
    if cached is None or cached[0] != weight._version:
        swapped = weight.detach().flip((0, 1)).transpose(2, 3).contiguous()
        cached = (weight._version, swapped,
                  torch.zeros(swapped.shape[-1], device=weight.device))
        weight._conv3x3_swapped = cached
    return cached[1], cached[2]


def swapped_weight(weight: torch.Tensor) -> torch.Tensor:
    """The input-gradient conv's kernel: `weight` flipped in space with Cin
    and Cout swapped, (3, 3, Cout, Cin), contiguous."""
    return _input_grad_operands(weight)[0]


def _check_kernel_inputs(x, weight, bias):
    if x.device.type != "cuda" or weight.device != x.device or bias.device != x.device:
        raise ValueError(f"conv3x3: tensors on {x.device}, {weight.device}, {bias.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or weight.dtype != x.dtype:
        raise TypeError(f"conv3x3: dtypes {x.dtype}, {weight.dtype}; want fp32 or bf16, equal")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("conv3x3: x and weight must be contiguous")


def _launch(x, weight, bias, variant, splits) -> Tuple[torch.Tensor, str]:
    """One kernel launch on checked CUDA tensors; (output, variant)."""
    bsz, h, w, cin = x.shape
    cout = weight.shape[-1]
    p = plan(bsz, h, w, cin, cout, x.dtype, variant, splits, device_sms(x.device))
    bias32 = bias.detach().float().contiguous()
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, None
    lib = _build.library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), weight.data_ptr(), bias32.data_ptr(), out.data_ptr())
        if p.variant == "tc":
            ws = (torch.empty(p.workspace_bytes // 4, dtype=torch.float32, device=x.device)
                  if p.splits > 1 else None)
            rc = lib.conv3x3_tc_forward(*args, ws.data_ptr() if ws is not None else None,
                                        bsz, h, w, cin, cout, p.box[0], p.box[1], p.bm,
                                        p.splits, p.steps_per_split, stream)
        elif p.variant == "narrow":
            rc = lib.conv3x3_narrow_forward(*args, bsz, h, w, cin, cout, is_bf16, stream)
        else:
            rc = lib.conv3x3_forward(*args, bsz, h, w, cin, cout, is_bf16, stream)
    _build.check(rc, f"conv3x3 ({p.variant})")
    return out, p.variant


def _forward(x, weight, bias, kernel, variant, splits):
    global launches
    if not kernel:
        return conv3x3_reference(x, weight, bias)
    out, used = _launch(x, weight, bias, variant, splits)
    if used is not None:
        launches += 1
        launches_by_variant[used] += 1
    return out


def conv3x3_input_grad(grad_out: torch.Tensor, weight: torch.Tensor,
                       use_kernel: bool = True) -> torch.Tensor:
    """dL/dx (B, H, W, Cin) of y = conv3x3(x, weight, bias), given dL/dy
    (B, H, W, Cout): the conv of dL/dy with `swapped_weight(weight)` and no
    bias, through the kernel `plan` picks for it (`conv3x3_reference` on a
    CPU tensor or with `use_kernel=False`).  The result has dL/dy's dtype."""
    global backward_launches
    ws, zero = _input_grad_operands(weight)
    if grad_out.device.type == "cpu" or not use_kernel:
        return conv3x3_reference(grad_out, ws, zero)
    grad_out = grad_out.contiguous()
    _check_kernel_inputs(grad_out, ws, zero)
    out, used = _launch(grad_out, ws, zero, None, None)
    if used is not None:
        backward_launches += 1
        backward_launches_by_variant[used] += 1
    return out


_SMS_BY_DEVICE: dict = {}


def device_sms(device: torch.device) -> int:
    """The SM count of a CUDA device (cached): what the plans size grids by."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS_BY_DEVICE:
        _SMS_BY_DEVICE[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS_BY_DEVICE[idx]


def conv3x3_weight_grad(x: torch.Tensor, grad_out: torch.Tensor,
                        use_kernel: bool = True, *, splits: Optional[int] = None) -> torch.Tensor:
    """dL/dW (3, 3, Cin, Cout) in fp32 of y = conv3x3(x, weight, bias), given
    x (B, H, W, Cin) and dL/dy (B, H, W, Cout) of one dtype: on a CUDA
    tensor the kernel `wgrad_plan` picks for the device (`splits` forces its
    split of K, for measurements), on a CPU tensor or with
    `use_kernel=False` `conv3x3_weight_grad_reference`."""
    global wgrad_launches
    if x.ndim != 4 or grad_out.shape[:3] != x.shape[:3]:
        raise ValueError(f"conv3x3 weight grad: bad shapes x {tuple(x.shape)} "
                         f"grad {tuple(grad_out.shape)}")
    if x.device.type == "cpu" or not use_kernel:
        return conv3x3_weight_grad_reference(x, grad_out)
    if x.device.type != "cuda" or grad_out.device != x.device:
        raise ValueError(f"conv3x3 weight grad: tensors on {x.device}, {grad_out.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or grad_out.dtype != x.dtype:
        raise TypeError(f"conv3x3 weight grad: dtypes {x.dtype}, {grad_out.dtype}; want fp32 "
                        "or bf16, equal")
    x, grad_out = x.contiguous(), grad_out.contiguous()
    bsz, h, w, cin = x.shape
    cout = grad_out.shape[-1]
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    if x.numel() == 0 or grad_out.numel() == 0:
        return dw.zero_()
    p = wgrad_plan(bsz, h, w, cin, cout, x.dtype, None, splits, device_sms(x.device))
    ws = (torch.empty(p.workspace_bytes // 4, dtype=torch.float32, device=x.device)
          if p.workspace_bytes else None)
    lib = _build.library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), grad_out.data_ptr(), dw.data_ptr(),
                ws.data_ptr() if ws is not None else None, bsz, h, w, cin, cout)
        if p.variant == "tc":
            rc = lib.conv3x3_wgrad_tc(*args, *p.box, p.splits, p.cluster, stream)
        elif p.variant == "mma":
            rc = lib.conv3x3_wgrad_mma(*args, p.splits, p.steps_per_split, stream)
        elif p.variant == "simt":
            rc = lib.conv3x3_wgrad_simt(*args, is_bf16, p.splits, p.steps_per_split, stream)
        else:
            rc = lib.conv3x3_wgrad_narrow(*args, is_bf16, int(p.variant == "narrow_out"), *p.box,
                                          p.splits, stream)
    _build.check(rc, f"conv3x3 weight grad ({p.variant})")
    wgrad_launches += 1
    wgrad_launches_by_variant[p.variant] += 1
    return dw


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, kernel, variant, splits):
        ctx.kernel = kernel
        ctx.x_dtype, ctx.bias_dtype = x.dtype, bias.dtype
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, weight)
        return _forward(x, weight, bias, kernel, variant, splits)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = conv3x3_input_grad(grad_out.to(weight.dtype), weight, ctx.kernel).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:     # fp32, rounded to the weight's dtype (bf16 as JAX's conv)
            gw = conv3x3_weight_grad(x.to(weight.dtype), grad_out.to(weight.dtype),
                                     ctx.kernel).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            gb = grad_out.float().sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return gx, gw, gb, None, None, None


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            use_kernel: bool = True, *, variant: Optional[str] = None,
            splits: Optional[int] = None) -> torch.Tensor:
    """x (B, H, W, Cin), weight (3, 3, Cin, Cout), bias (Cout,) -> (B, H, W, Cout).

    Differentiable in x, weight and bias.  The weight's gradient comes
    back in the weight's dtype: for a bf16 weight the kernel's fp32 sum
    rounded to bf16, as the JAX package's bf16 conv gives it, before
    autograd casts it to an fp32 master's dtype.  `variant` and `splits` (measurements only) force what `plan` would
    choose from dtype and shape."""
    if x.ndim != 4 or weight.shape[:3] != (3, 3, x.shape[-1]) or bias.shape != weight.shape[3:]:
        raise ValueError(f"conv3x3: bad shapes x {tuple(x.shape)} weight "
                         f"{tuple(weight.shape)} bias {tuple(bias.shape)}")
    kernel = use_kernel and x.device.type != "cpu"
    if kernel:
        _check_kernel_inputs(x, weight, bias)
    if not (torch.is_grad_enabled()
            and (x.requires_grad or weight.requires_grad or bias.requires_grad)):
        return _forward(x, weight, bias, kernel, variant, splits)
    return _Conv3x3.apply(x, weight, bias, kernel, variant, splits)
