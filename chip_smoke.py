#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`diffusion_models_dev_project_tpu_torch`).

Drives the port's two paths through its factory entry points on one CUDA
device: the flagship 256² disk-ellipse DDS reconstruction, and steerable
LoRA adaptation inside the DDS loop, whose gradients run through both hand
kernels' backward passes:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles `csrc/*.cu` with nvcc for sm_90a (ops/_build.py) and
   requires HGMMA (wgmma) and UTMALDG (TMA load) instructions in the SASS,
   and HMMA (mma.sync) in the functions of attention_mma.cu and in both
   kernels of attention_bwd_mma.cu;
3. kernels: runs each kernel's wrapper at every shape the UNet forward
   gives it (recorded with forward hooks), checks it against its plain
   PyTorch version, and times kernel, plain version and library yardstick;
   each redesigned kernel (conv3x3 `tc`, attention `mma`) also against the
   CUDA-core `simt` kernel it replaced at the same shapes, for bitwise equal
   output over two launches, and at added shapes (conv3x3: batch 2, H != W,
   the largest split of K, 64 and 192 channels; attention: ragged T, other
   head widths up to 256, T = 1024); attention also against each SDPA
   backend that takes the inputs; `mma`'s saved log-sum-exp against a
   plain one, its output equal with and without it, and its time with it.
   Then the backward kernels: the conv3x3 input gradient (and the bias
   gradient) at every conv shape against autograd of the plain version, and
   the attention backward, each variant that takes the shape (`mma` with
   the forward's log-sum-exp, `simt`), at the path's shapes and added ones
   (T = 1 to 1024, ragged T, d = 8 to 256, fp32 and bf16) against its plain
   twin, each bitwise equal over two launches and timed beside its plain
   twin, cuDNN's `conv2d_input` or SDPA's backward, and its bound; `mma`
   must take at most a third of `simt`'s time per UNet backward and less
   than the plain twin's;
4. UNet: one full-width forward of the shipped VESDE prior at 256², batch 1,
   with the kernels against `use_kernel=False`;
5. gradient: the same prior with LoRA rank 4 (up-projections drawn nonzero),
   the gradient of the adaptation loss (score -> Tweedie -> cg(1) ->
   mean((Ax - y)²) + 1e-6 TV) for every trainable leaf, in bf16 with the
   kernels against `use_kernel=False`, both against an fp32 plain
   gradient, and in fp32 with the kernels against it; the launch counts of
   one forward and backward;
6. DDS: reconstructs the first images of the shipped val set (60 angles,
   noise 0.01, gamma 0.01, eta 0.85, 5 CG iterations) and requires each to
   beat its FBP in PSNR, with the kernel launch counts of the run checked
   (per forward 62 conv3x3, of which 60 tc, 1 narrow, 1 simt, and 4
   attention, all mma; per backward 4 attention backwards, all mma); CUDA
   events around the score call and the CG solve
   of the loop's last steps split a step into UNet, CG and the rest;
7. adapted: LoRA-adapted DDS (50 outer x 10 inner Adam steps, rank 4,
   lr 1e-3, TV 1e-6, eta 0.85, cg(1), add_cg) of val image 0 and of an OOD
   bars phantom; each must beat its FBP (at 50 outer steps or more; a
   shortened probe is not gated); a plain DDS of as many steps on the same
   observation is printed beside it; CUDA events split each outer step into
   the adaptation and the two score forwards; the launch counts are checked;
8. DPS: the gradient DPS takes in x, of ||y - A·Tweedie(score(x, t), x, t)||
   at t = 0.5 on val image 0, in bf16 and in fp32 with the kernels against
   `use_kernel=False`, with the launch counts of one forward and backward
   (per backward also the stem's input gradient, on `narrow`) and its wall
   and device times; then DPS and naive (penalty 10, 1000 steps) through the
   port's conditional CLI on its default data (test-fold image 0, generated
   at 256²), each started from the prior and from the FBP (the last 500
   steps of the grid): every run inside the CLI's divergence guard with its
   launch counts exact; from the FBP, DPS better than naive by
   `DPS_MARGIN_DB` (on the 1000-step grid or finer); CUDA events splitting
   a DPS step into the score's forward and backward and the rest;
9. prints one `{"kernels": [...]}` line, then, last, the device line
   `{"ok": true, "device": {...}}`.

Any failed check raises, so the script exits non-zero and prints no result.
Usage: python3 chip_smoke.py [--steps N] [--images N] [--adapt-steps N] [--adapt-images N]
       [--dps-steps N]
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "flagship_vesde_256_ema.msgpack.npz")
VALSET = os.path.join(REPO, "data_assets", "disk_ellipses_val_256.npz")

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version on the same inputs: max|diff| / max|plain|.  bf16
# output is rounded once from an fp32 sum in either version; a different
# summation order may flip that rounding by one bf16 ulp (2^-8 relative).
TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# whole UNet, kernels against plain versions: one-ulp bf16 flips propagate
# through ~30 residual blocks
TOL_UNET = 5e-2
# full-width LoRA gradient (|g_a - g_b| / |g_b|, 2-norms): bf16 kernels
# against bf16 plain over all trainable leaves; per leaf, the bf16 kernels'
# distance from the fp32 plain gradient, at most twice the bf16 plain path's
# own distance or 5e-2, whichever is larger (bf16 rounding alone moves a
# single leaf by up to ~7% either way); fp32 kernels against fp32 plain per
# leaf, free of bf16 rounding
TOL_GRAD_ALL = 2e-2
TOL_GRAD_LEAF_FACTOR = 2.0
TOL_GRAD_LEAF = 5e-2
TOL_GRAD_FP32 = 1e-3
LORA_RANK = 4
ADAPT_PROTOCOL_STEPS = 50     # outer steps of the adapted protocol (10 Adam steps each)
DPS_PROTOCOL_STEPS = 1000     # steps of the conditional CLI's protocol
DPS_PENALTY = 10.0            # the best DPS penalty of the JAX package's records (BENCH.md)
DPS_T = 0.5                   # the time at which the full-width gradient in x is checked
# the FBP start skips this part of the 1000-step grid (the CLI's
# --pct_chain_elapsed), where the shipped prior's score is biased (BENCH.md;
# PERF.md §6)
DPS_FBP_PCT = 0.5
# from the FBP, DPS must beat naive on the same observation by this much on
# the 1000-step grid (dB): half the margin of a probe of both runs (12.54 dB,
# conditional_probe.py), set before the full run (PERF.md §6)
DPS_MARGIN_DB = 6.0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls captured in one CUDA graph
    and replayed, timed with CUDA events after one warm-up replay: the
    device's time without the host's Python and launch overhead, which at
    small shapes exceeds the kernels' own (inputs hot in L2)."""
    import torch

    # warm up and capture on one side stream: a backward captured by autograd
    # needs the gradient accumulators it meets to live on the capture stream
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean time of `fn` over `reps` eager back-to-back calls (CUDA events),
    after one warm-up call: what a caller waits, host overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of `fn` (launches enqueued, not waited for)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


class StepTimer:
    """CUDA events around the score call and the CG solve of each DDS step
    from `first_step` on: the UNet, CG and the rest of a step, measured in
    the loop's own steps.  Events on one stream complete in order, so a
    step (one score call to the next) is the sum of the three parts."""

    def __init__(self, score_fn, cg_fn, first_step: int):
        self.score_fn, self.cg_fn, self.first_step = score_fn, cg_fn, first_step
        self.steps, self.calls, self.end = [], 0, None

    @staticmethod
    def _event():
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def score(self, x, t):
        self.calls += 1
        if self.calls <= self.first_step:
            return self.score_fn(x, t)
        start = self._event()
        out = self.score_fn(x, t)
        self.steps.append([start, self._event()])
        return out

    def cg(self, *args, **kwargs):
        if self.calls <= self.first_step:
            return self.cg_fn(*args, **kwargs)
        self.steps[-1].append(self._event())
        out = self.cg_fn(*args, **kwargs)
        self.steps[-1].append(self._event())
        return out

    def finish(self):
        self.end = self._event()

    def split(self):
        """Per timed step, ms of the step, the UNet, CG and the rest."""
        self.end.synchronize()
        rows = []
        for i, (s0, s1, c0, c1) in enumerate(self.steps):
            nxt = self.steps[i + 1][0] if i + 1 < len(self.steps) else self.end
            step, unet, cg = s0.elapsed_time(nxt), s0.elapsed_time(s1), c0.elapsed_time(c1)
            rows.append({"step": step, "unet": unet, "cg": cg, "rest": step - unet - cg})
        return rows


SPLIT_STEPS = 200    # DDS steps at the end of each image whose parts are timed


def bound(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by, ops_ms, bytes_ms): the least time for `flops`
    operations of `dtype` and `nbytes` of device memory traffic."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def rel_err(out, ref) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def record_shapes(model):
    """Forward hooks that record each conv3x3 and attention call's shapes."""
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    seen = {"conv": [], "attn": []}

    def conv_hook(mod, args):
        x = args[0]
        seen["conv"].append((tuple(x.shape), mod.weight.shape[-1], str(mod.dtype).split(".")[-1]))

    def attn_hook(mod, args):
        b, h, w, c = args[0].shape
        heads = mod.spec.num_heads
        seen["attn"].append(((b * heads, h * w, c // heads), str(mod.qkv.dtype).split(".")[-1]))

    handles = []
    for m in model.modules():
        if isinstance(m, U.Conv3x3):
            handles.append(m.register_forward_pre_hook(conv_hook))
        elif isinstance(m, U.AttentionBlock):
            handles.append(m.register_forward_pre_hook(attn_hook))
    return seen, handles


def conv_inputs(xshape, cout, dt, gen):
    import torch

    cin = xshape[-1]
    tdt = getattr(torch, dt)
    x = torch.randn(xshape, generator=gen, device="cuda").to(tdt)
    wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") / math.sqrt(9 * cin)).to(tdt)
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    return x, wt, bias


def check_conv_once(xshape, cout, dt, gen, splits=None):
    """One kernel call against the plain version; for tc also a second call,
    which must give the same bits.  Returns (inputs, plan, max|diff|, rel)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    b, h, w, cin = xshape
    x, wt, bias = conv_inputs(xshape, cout, dt, gen)
    p = C.plan(b, h, w, cin, cout, x.dtype, splits=splits)
    out = C.conv3x3(x, wt, bias, splits=splits)
    ref = C.conv3x3(x, wt, bias, use_kernel=False)
    torch.cuda.synchronize()
    d, r = rel_err(out, ref)
    if not (torch.isfinite(out).all() and r <= TOL[dt]):
        raise AssertionError(f"conv3x3 {p.variant} {xshape}->{cout} {dt}: rel err {r:.3e} > {TOL[dt]}")
    if p.variant == "tc":
        again = C.conv3x3(x, wt, bias, splits=splits)
        if not torch.equal(out, again):
            raise AssertionError(f"conv3x3 tc {xshape}->{cout}: two launches differ")
    return (x, wt, bias), p, d, r


def check_conv(shapes, gen):
    """Kernel vs plain at every distinct conv shape in both I/O types, timed
    in the path's type beside the plain version, cuDNN and the bound; at the
    shapes `tc` takes, also the CUDA-core `simt` kernel in the same run.  Added
    shapes are checked, not timed.  Returns per-forward totals."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms", "simt_ms", "gflop")
    tot = dict.fromkeys(keys, 0.0)
    by_variant, by_map = {}, {}
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs = 0.0
    log(f"{'shape (B,H,W,Cin->Cout)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'splits':>6} "
        f"{'kernel_ms':>10} {'simt_ms':>9} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} "
        f"{'bound_by':>10} {'rel_err':>9}")
    for (xshape, cout, dtype), n in sorted(counts.items(), key=lambda kv: (-kv[0][0][1], kv[0][0][3])):
        b, h, w, cin = xshape
        for dt in ("bfloat16", "float32"):     # correctness in both I/O types
            (x, wt, bias), p, d, r = check_conv_once(xshape, cout, dt, gen)
            worst[dt] = max(worst[dt], r)
            if dt != dtype:
                continue
            max_abs = max(max_abs, d)
            xl = x.permute(0, 3, 1, 2)                          # channels-last NCHW view
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bl = bias.to(x.dtype)
            reps = 20 if h >= 128 else 50
            k_ms = time_ms(lambda: C.conv3x3(x, wt, bias), reps)
            s_ms = 0.0
            if p.variant == "tc":
                s_ms = time_ms(lambda: C.conv3x3(x, wt, bias, variant="simt"), max(reps // 4, 5))
            p_ms = time_ms(lambda: C.conv3x3(x, wt, bias, use_kernel=False), max(reps // 4, 5))
            l_ms = time_ms(lambda: F.conv2d(xl, wl, bl, padding=1), reps)
            flops = 2.0 * b * h * w * cin * cout * 9
            nbytes = x.numel() * x.element_size() * (1 + cout / cin) + wt.numel() * wt.element_size() + 4 * cout
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{str((b, h, w, cin)) + '->' + str(cout):>28} {dt:>8} {n:>3} {p.variant:>7} {p.splits:>6} "
                f"{k_ms:>10.4f} {s_ms:>9.4f} {p_ms:>9.4f} {l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, ops_ms=ops_ms,
                       bytes_ms=bytes_ms, simt_ms=s_ms, gflop=flops / 1e9)
            for agg in (tot, by_variant.setdefault(p.variant, dict.fromkeys(keys, 0.0)),
                        by_map.setdefault(h, dict.fromkeys(keys, 0.0))):
                for key in keys:
                    agg[key] += n * row[key]
                agg["calls"] = agg.get("calls", 0) + n
    # checked only: batch 2, H != W with ragged tiles, the largest split,
    # Cin = Cout = 64 (half of a 128-channel tile), Cout = 192
    extra = [((2, 32, 32, 256), 256, None), ((1, 16, 48, 128), 128, None),
             ((1, 8, 8, 1024), 512, 144), ((1, 32, 32, 64), 64, None),
             ((1, 12, 20, 128), 192, None)]
    for xshape, cout, splits in extra:
        _, p, _, r = check_conv_once(xshape, cout, "bfloat16", gen, splits=splits)
        worst["bfloat16"] = max(worst["bfloat16"], r)
        log(f"{str(xshape) + '->' + str(cout):>28} {'bfloat16':>8} {'-':>3} {p.variant:>7} {p.splits:>6} "
            f"{'':>10} {'':>9} {'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
    x, wt, bias = conv_inputs((1, 8, 8, 512), 512, "bfloat16", gen)
    xl, wl = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    host = {name: host_us(fn, 200) for name, fn in (
        ("tc", lambda: C.conv3x3(x, wt, bias)),
        ("cuDNN", lambda: F.conv2d(xl, wl, bias.to(x.dtype), padding=1)))}
    log(f"host time per call at (1, 8, 8, 512)->512, enqueue only: conv3x3 (tc) {host['tc']:.1f} us, "
        f"F.conv2d {host['cuDNN']:.1f} us")
    log(f"conv3x3 max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']}); tc bitwise equal over two launches")
    log(f"{'per UNet forward':>28} {'calls':>5} {'kernel_ms':>10} {'TFLOP/s':>8} {'of bound':>8} "
        f"{'simt_ms':>9} {'cuDNN_ms':>9} {'bound_ms':>9}")
    for name, agg in ([(f"map {h}x{h}", by_map[h]) for h in sorted(by_map, reverse=True)]
                      + [(f"variant {v}", by_variant[v]) for v in C.VARIANTS if v in by_variant]
                      + [("all", tot)]):
        log(f"{name:>28} {agg.get('calls', 0):>5} {agg['ms']:>10.4f} {agg['gflop'] / agg['ms']:>8.1f} "
            f"{agg['bound_ms'] / agg['ms']:>8.2%} {agg['simt_ms']:>9.4f} {agg['library_ms']:>9.4f} "
            f"{agg['bound_ms']:>9.5f}")
    tc = by_variant.get("tc", dict.fromkeys(keys, 0.0))
    log(f"conv3x3 per UNet forward ({len(shapes)} calls): kernel {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, cuDNN {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, "
        f"{tot['gflop']:.1f} GFLOP -> {tot['gflop'] / tot['ms']:.1f} TFLOP/s; at the {tc.get('calls', 0)} "
        f"tc shapes: tc {tc['ms']:.3f} ms against simt {tc['simt_ms']:.3f} ms")
    if not tc["ms"] * 5 <= tc["simt_ms"]:
        raise AssertionError("conv3x3: tc takes more than 1/5 of the simt design's time per forward")
    return tot, max_abs, by_variant


# functions whose SASS must hold HMMA (mma.sync): the attention forward and
# both kernels of its backward
HMMA_FUNCTIONS = ("attention_mma_kernel", "attention_bwd_mma_dq_kernel",
                  "attention_bwd_mma_dkdv_kernel")


def sass_counts(lib_path):
    """HGMMA and UTMALDG instructions in the built library's SASS, and HMMA
    in the functions named in `HMMA_FUNCTIONS`, by name."""
    import shutil

    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
             shutil.which("cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((c for c in cands if c and os.path.exists(c)), None)
    if tool is None:
        raise RuntimeError("cuobjdump not found under CUDA_HOME, on PATH or in triton's package")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    counts["HMMA"], function = dict.fromkeys(HMMA_FUNCTIONS, 0), ""
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1]
        else:
            for name in HMMA_FUNCTIONS:
                if name in function:
                    counts["HMMA"][name] += line.count("HMMA")
    return counts


def sdpa_backends():
    """(name, backend) of each SDPA backend this torch names."""
    from torch.nn.attention import SDPBackend

    names = (("flash", "FLASH_ATTENTION"), ("efficient", "EFFICIENT_ATTENTION"),
             ("cudnn", "CUDNN_ATTENTION"), ("math", "MATH"))
    return [(name, getattr(SDPBackend, attr)) for name, attr in names if hasattr(SDPBackend, attr)]


def time_sdpa(q4, k4, v4, reps):
    """Device ms of `F.scaled_dot_product_attention` on (1, B·heads, T, d)
    views, as dispatched by default and under each backend alone; a backend
    that refuses the inputs (or the graph capture) maps to its error."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    times = {"default": time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)}
    for name, backend in sdpa_backends():
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4)
        try:
            call()
            times[name] = time_ms(call, reps)
        except RuntimeError as err:
            times[name] = str(err).splitlines()[0][:100]
    return times


def check_attention_once(shape, dt, gen):
    """One kernel call against the plain version; for mma also a second
    call, which must give the same bits, and a call that saves the rows'
    log-sum-exp: the same output bit for bit, and lse2 against the plain
    `attention_lse_reference`.  Returns (inputs, plan, max|diff|, rel)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    tdt = getattr(torch, dt)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt) for _ in range(3))
    p = A.plan(*shape, tdt)
    out = A.attention(q, k, v)
    ref = A.attention(q, k, v, use_kernel=False)
    torch.cuda.synchronize()
    d, r = rel_err(out, ref)
    if not (torch.isfinite(out).all() and r <= TOL[dt]):
        raise AssertionError(f"attention {p.variant} {shape} {dt}: rel err {r:.3e} > {TOL[dt]}")
    if p.variant == "mma":
        if not torch.equal(out, A.attention(q, k, v)):
            raise AssertionError(f"attention mma {shape}: two launches differ")
        out_l, lse = A.attention_with_lse(q, k, v)
        _, r_lse = rel_err(lse, A.attention_lse_reference(q, k))
        if not (torch.equal(out_l, out) and r_lse <= TOL["float32"]):
            raise AssertionError(f"attention mma {shape}: the output differs with lse on, or "
                                 f"lse2 is {r_lse:.3e} of max|plain| away (tol {TOL['float32']})")
    return (q, k, v), p, d, r


def check_attention(shapes, gen):
    """Kernel vs plain at the path's attention shapes, timed beside the plain
    version, the CUDA-core `simt` kernel, SDPA as dispatched by default and
    each SDPA backend; and at added shapes, checked only.  Returns
    per-forward totals."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    # checked only, each with the plan's own key splits.  mma: ragged T over
    # 4 splits (T = 300), a last round with fewer tiles than splits (T = 257),
    # d = 40 and 128, T = 1024 (4 rounds of 4 splits), d = 20 (scalar loads),
    # d = 128 over several rounds of 2 splits (T = 300); simt: the fp32
    # shapes, d = 256 in both dtypes, T = 5
    extra = [((8, 300, 64), "bfloat16"), ((2, 257, 40), "bfloat16"),
             ((3, 100, 128), "bfloat16"), ((8, 1024, 64), "bfloat16"),
             ((2, 37, 20), "bfloat16"), ((3, 300, 128), "bfloat16"),
             ((2, 257, 40), "float32"), ((3, 100, 128), "float32"),
             ((8, 256, 64), "float32"), ((1, 5, 8), "float32"),
             ((2, 64, 256), "float32"), ((2, 64, 256), "bfloat16")]
    keys = ("ms", "plain_ms", "library_ms", "library_best_ms", "bound_ms", "ops_ms", "bytes_ms",
            "simt_ms", "lse_ms")
    tot = dict.fromkeys(keys, 0.0)
    best_names = set()
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs = 0.0
    log(f"{'attention (BH,T,d)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'w/s':>5} "
        f"{'kernel_ms':>10} {'simt_ms':>9} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} "
        f"{'bound_by':>10} {'rel_err':>9}")
    for shape, dt in list(counts) + extra:
        n = counts.get((shape, dt), 0)
        (q, k, v), p, d, r = check_attention_once(shape, dt, gen)
        worst[dt] = max(worst[dt], r)
        blocking = f"{p.warps}/{p.key_splits}"
        if n == 0:
            log(f"{str(shape):>28} {dt:>8} {'-':>3} {p.variant:>7} {blocking:>5} {'':>10} {'':>9} "
                f"{'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
            continue
        max_abs = max(max_abs, d)
        bh, t, dd = shape
        # lse off and on in turns: off, on, on, off
        off = [time_ms(lambda: A.attention(q, k, v), 100)]
        on = [time_ms(lambda: A.attention_with_lse(q, k, v), 100) for _ in range(2)]
        off.append(time_ms(lambda: A.attention(q, k, v), 100))
        k_ms, lse_ms = sum(off) / 2, sum(on) / 2
        s_ms = time_ms(lambda: A.attention(q, k, v, variant="simt"), 100)
        p_ms = time_ms(lambda: A.attention(q, k, v, use_kernel=False), 50)
        sdpa = time_sdpa(*(a.view(1, bh, t, dd) for a in (q, k, v)), 100)
        taken = {name: ms for name, ms in sdpa.items() if name != "default" and isinstance(ms, float)}
        best = min(taken, key=taken.get)
        best_names.add(best)
        flops = 4.0 * bh * t * t * dd
        nbytes = 4.0 * q.numel() * q.element_size()
        b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
        log(f"{str(shape):>28} {dt:>8} {n:>3} {p.variant:>7} {blocking:>5} {k_ms:>10.4f} "
            f"{s_ms:>9.4f} {p_ms:>9.4f} {sdpa['default']:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
        log(f"{'':>28} SDPA on (1, B·heads, T, d): "
            + ", ".join(f"{name} {ms:.4f} ms" if isinstance(ms, float) else f"{name} refused ({ms})"
                        for name, ms in sdpa.items()))
        log(f"{'':>28} with the saved log-sum-exp: {lse_ms:.4f} ms ({lse_ms / k_ms - 1:+.2%})")
        row = dict(ms=k_ms, plain_ms=p_ms, library_ms=sdpa["default"], library_best_ms=taken[best],
                   bound_ms=b_ms, ops_ms=ops_ms, bytes_ms=bytes_ms, simt_ms=s_ms, lse_ms=lse_ms)
        for key in keys:
            tot[key] += n * row[key]
    log(f"attention max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']}); mma bitwise equal over two launches "
        f"and with its log-sum-exp saved")
    tot["library_best"] = "/".join(sorted(best_names))
    log(f"attention per UNet forward ({len(shapes)} calls): kernel {tot['ms']:.4f} ms, simt "
        f"{tot['simt_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, SDPA default "
        f"{tot['library_ms']:.4f} ms, fastest SDPA backend ({tot['library_best']}) "
        f"{tot['library_best_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
    log(f"attention: mma per forward takes {tot['ms'] / tot['library_ms']:.3f}x the time of SDPA as "
        f"dispatched by default, {tot['ms'] / tot['library_best_ms']:.3f}x its fastest backend, "
        f"{tot['ms'] / tot['simt_ms']:.3f}x the simt kernel; with the log-sum-exp saved "
        f"{tot['lse_ms']:.4f} ms ({tot['lse_ms'] / tot['ms'] - 1:+.2%}, at most +5%)")
    if not (tot["ms"] <= tot["plain_ms"] and tot["ms"] <= tot["library_ms"]
            and tot["ms"] < tot["simt_ms"]):
        raise AssertionError("attention: mma is slower per forward than its plain version, "
                             "than SDPA as dispatched by default or than the simt kernel")
    if not tot["lse_ms"] <= 1.05 * tot["ms"]:
        raise AssertionError("attention: saving the log-sum-exp costs mma more than 5% per forward")
    return tot, max_abs

def check_conv_backward(shapes, gen):
    """The conv3x3 input gradient (`conv3x3_input_grad`, the launch function
    itself) at every distinct conv shape in both I/O types against autograd
    of the plain version, bitwise equal over two launches and equal to the
    autograd Function's; the Function's bias gradient against autograd's.
    Timed in the path's type beside the plain twin, cuDNN's `conv2d_input`
    and the bound, summed over the convs whose input takes a gradient (all
    but the stem, whose input is the diffusion state).  Returns
    (per-backward totals, max|diff|, launches by variant per backward)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    tot = dict.fromkeys(keys, 0.0)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs, by_variant = 0.0, {}
    log(f"{'input grad (B,H,W,Cin<-Cout)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'splits':>6} "
        f"{'kernel_ms':>10} {'plain_ms':>9} {'library_ms':>10} {'bound_ms':>9} {'bound_by':>10} "
        f"{'rel_err':>9} {'bias_err':>9}")
    for (xshape, cout, dtype), n in sorted(counts.items(), key=lambda kv: (-kv[0][0][1], kv[0][0][3])):
        b, h, w, cin = xshape
        needs = cin != 1                 # the stem's input takes no gradient
        for dt in ("bfloat16", "float32"):
            x, wt, bias = conv_inputs(xshape, cout, dt, gen)
            g = torch.randn((b, h, w, cout), generator=gen, device="cuda").to(x.dtype)
            gx = C.conv3x3_input_grad(g, wt)
            again = C.conv3x3_input_grad(g, wt)
            xr, br = x.clone().requires_grad_(), bias.clone().requires_grad_()
            rx, rb = torch.autograd.grad(C.conv3x3_reference(xr, wt, br), (xr, br), g)
            xk, bk = x.clone().requires_grad_(), bias.clone().requires_grad_()
            kx, kb = torch.autograd.grad(C.conv3x3(xk, wt, bk), (xk, bk), g)
            torch.cuda.synchronize()
            d, r = rel_err(gx, rx)
            _, rb_err = rel_err(kb, rb)
            p = C.plan(b, h, w, cout, cin, x.dtype)
            label = f"{str((b, h, w, cin)) + '<-' + str(cout):>28} {dt:>8}"
            if not (torch.isfinite(gx).all() and r <= TOL[dt] and rb_err <= TOL["float32"]):
                raise AssertionError(f"conv3x3 input grad {label}: rel err {r:.3e}, bias {rb_err:.3e}")
            if not (torch.equal(gx, again) and torch.equal(kx, gx)):
                raise AssertionError(f"conv3x3 input grad {label}: launches or the Function differ")
            worst[dt] = max(worst[dt], r)
            if dt != dtype or not needs:
                log(f"{label} {'-':>3} {p.variant:>7} {p.splits:>6} {'':>10} {'':>9} {'':>10} {'':>9} "
                    f"{'':>10} {r:>9.2e} {rb_err:>9.2e}")
                continue
            max_abs = max(max_abs, d)
            by_variant[p.variant] = by_variant.get(p.variant, 0) + n
            gl = g.permute(0, 3, 1, 2)                             # channels-last NCHW views
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            size = (b, cin, h, w)
            reps = 20 if h >= 128 else 50
            k_ms = time_ms(lambda: C.conv3x3_input_grad(g, wt), reps)
            p_ms = time_ms(lambda: C.conv3x3_input_grad(g, wt, use_kernel=False), max(reps // 4, 5))
            l_ms = time_ms(lambda: torch.nn.grad.conv2d_input(size, wl, gl, padding=1), reps)
            flops = 2.0 * b * h * w * cin * cout * 9
            nbytes = g.numel() * g.element_size() * (1 + cin / cout) + wt.numel() * wt.element_size()
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{label} {n:>3} {p.variant:>7} {p.splits:>6} {k_ms:>10.4f} {p_ms:>9.4f} "
                f"{l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e} {rb_err:>9.2e}")
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, ops_ms=ops_ms,
                       bytes_ms=bytes_ms)
            for key in keys:
                tot[key] += n * row[key]
    log(f"conv3x3 input grad max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']}); bitwise equal over two launches")
    log(f"conv3x3 input grad per UNet backward ({sum(by_variant.values())} calls: "
        + ", ".join(f"{v} {k}" for v, k in by_variant.items())
        + f"): kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, cuDNN conv2d_input "
        f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms")
    return tot, max_abs, by_variant


def check_attention_backward(shapes, gen):
    """`attention_backward` (the launch function) with each variant that
    takes the shape, `mma` given the lse2 of the forward kernel
    (`attention_with_lse`), at the path's attention shapes and at added ones,
    against `attention_backward_reference`: dq, dk and dv each within the
    tolerance of max|plain|, bitwise equal over two launches.  At the path's
    shapes timed: the planned kernel, `mma` at each chunk it takes, `simt`
    (the earlier design), the plain twin, SDPA's backward (forward and backward
    captured together, less the forward) and the bound.  Returns
    (per-backward totals, max|diff|, calls by variant per backward)."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    # checked only: ragged T over several chunks a warp (T = 300, 1024, and
    # d = 128 in two stages), T = 37 with d = 20 (scalar loads), d = 40, a
    # single row or a few (T = 1, 5 at d = 8), d = 256 (simt only), fp32
    extra = [((8, 300, 64), "bfloat16"), ((2, 37, 20), "bfloat16"), ((3, 100, 128), "bfloat16"),
             ((3, 300, 128), "bfloat16"), ((2, 257, 40), "bfloat16"), ((8, 1024, 64), "bfloat16"),
             ((1, 1, 8), "bfloat16"), ((1, 5, 8), "bfloat16"), ((2, 64, 256), "bfloat16"),
             ((8, 256, 64), "float32"), ((2, 257, 40), "float32"), ((2, 64, 256), "float32"),
             ((1, 5, 8), "float32"), ((1, 1, 16), "float32")]
    keys = ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    tot = dict.fromkeys(keys, 0.0)
    by_variant, by_tile = {}, {}
    worst = {(v, dt): 0.0 for v in A.VARIANTS for dt in ("bfloat16", "float32")}
    max_abs = 0.0
    log(f"{'attention bwd (BH,T,d)':>28} {'dtype':>8} {'n':>3} {'variant':>7} {'tile':>4} "
        f"{'grid':>9} {'kernel_ms':>10} {'simt_ms':>9} {'plain_ms':>9} {'library_ms':>10} "
        f"{'bound_ms':>9} {'bound_by':>10} {'rel_err':>9}")
    for shape, dt in list(counts) + extra:
        n = counts.get((shape, dt), 0)
        bh, t, dd = shape
        tdt = getattr(torch, dt)
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(tdt) for _ in range(4))
        o, lse = A.attention_with_lse(q, k, v)
        ref = A.attention_backward_reference(q, k, v, o, g)
        planned = A.backward_plan(bh, t, dd, tdt)
        variants = ["mma", "simt"] if planned.variant == "mma" else ["simt"]
        for variant in variants:
            bp = A.backward_plan(bh, t, dd, tdt, variant)
            grads = A.attention_backward(q, k, v, o, g, lse, variant=variant)
            again = A.attention_backward(q, k, v, o, g, lse, variant=variant)
            torch.cuda.synchronize()
            r, d = 0.0, 0.0
            for name, got, want, twice in zip("qkv", grads, ref, again):
                d_n, r_n = rel_err(got, want)
                if t == 1 and name in "qk":            # T = 1: dq and dk are 0 in exact
                    r_n = d_n                          # arithmetic, rounding noise here
                if not (torch.isfinite(got).all() and r_n <= TOL[dt] and torch.equal(got, twice)):
                    raise AssertionError(f"attention backward {variant} d{name} {shape} {dt}: rel "
                                         f"err {r_n:.3e} (tol {TOL[dt]}), or two launches differ")
                r, d = max(r, r_n), max(d, d_n)
            worst[variant, dt] = max(worst[variant, dt], r)
            tile = bp.tile if variant == "mma" else "-"
            grid = "x".join(map(str, bp.grid))
            if n == 0 or variant != planned.variant:
                log(f"{str(shape):>28} {dt:>8} {'-':>3} {variant:>7} {tile:>4} {grid:>9} "
                    f"{'':>10} {'':>9} {'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
                continue
            max_abs = max(max_abs, d)
            by_variant[variant] = by_variant.get(variant, 0) + n
            k_ms = time_ms(lambda: A.attention_backward(q, k, v, o, g, lse), 50)
            tiles = {}
            if variant == "mma":
                for w in (16, 32, 64):
                    if w != bp.tile and (w <= 32 or dd <= 64):
                        tiles[w] = time_ms(lambda: A.attention_backward(q, k, v, o, g, lse, tile=w), 50)
                tiles[bp.tile] = k_ms
            s_ms = time_ms(lambda: A.attention_backward(q, k, v, o, g, variant="simt"), 50)
            p_ms = time_ms(lambda: A.attention_backward_reference(q, k, v, o, g), 20)
            q4, k4, v4 = (a.view(1, bh, t, dd).detach().requires_grad_() for a in (q, k, v))
            g4 = g.view(1, bh, t, dd)
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 50)
            sdpa_both = time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), g4), 50)
            l_ms = sdpa_both - sdpa_fwd
            # S recomputed, dP, dq, dk and dv: 2·T²·d operations each per batch·head;
            # q, k, v, out and dout read once, dq, dk and dv written once
            flops, nbytes = 10.0 * bh * t * t * dd, 8.0 * q.numel() * q.element_size()
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{str(shape):>28} {dt:>8} {n:>3} {variant:>7} {tile:>4} {grid:>9} {k_ms:>10.4f} "
                f"{s_ms:>9.4f} {p_ms:>9.4f} {l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
            if tiles:
                log(f"{'':>28} mma by chunk: " + ", ".join(
                    f"{w} rows {ms:.4f} ms" for w, ms in sorted(tiles.items())))
                for w, ms in tiles.items():
                    by_tile[w] = by_tile.get(w, 0.0) + n * ms
            row = dict(ms=k_ms, simt_ms=s_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                       ops_ms=ops_ms, bytes_ms=bytes_ms)
            for key in keys:
                tot[key] += n * row[key]
    log("attention backward max rel err: "
        + ", ".join(f"{v} {dt} {r:.3e} (tol {TOL[dt]})" for (v, dt), r in worst.items() if r)
        + "; bitwise equal over two launches")
    log(f"attention backward per UNet backward ({len(shapes)} calls: "
        + ", ".join(f"{v} {n}" for v, n in by_variant.items())
        + f"): kernel {tot['ms']:.4f} ms, simt (earlier design) {tot['simt_ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, SDPA backward by default {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.5f} ms")
    if len(by_tile) > 1:
        log("  mma per UNet backward with one chunk for every call (where it fits): "
            + ", ".join(f"{w} rows {ms:.4f} ms" for w, ms in sorted(by_tile.items())))
    log(f"attention backward: mma takes {tot['ms'] / tot['library_ms']:.3f}x the time of SDPA's "
        f"backward by default (target 1.0 or less), {tot['ms'] / tot['simt_ms']:.3f}x the simt "
        f"design's (at most 1/3), {tot['ms'] / tot['plain_ms']:.3f}x the plain twin's (below 1)")
    if not (by_variant == {"mma": len(shapes)} and 3 * tot["ms"] <= tot["simt_ms"]
            and tot["ms"] < tot["plain_ms"]):
        raise AssertionError("attention backward: the path is not all mma, or mma takes more than "
                             "a third of the simt design's time or no less than its plain twin's")
    return tot, max_abs, by_variant


def ood_bars(im: int) -> np.ndarray:
    """Rectangular bars and a frame: the out-of-distribution phantom of the
    JAX package's adapted evaluation (scripts/eval_adapted_256.py), copied."""
    x = np.zeros((im, im), np.float32)
    q = im // 8
    for i in range(1, 4):
        x[2 * i * q - q // 2:2 * i * q + q // 2, q:im - q] = 0.4 + 0.2 * i
    x[q:im - q, q:q + im // 32] = 1.0
    x[q:im - q, im - q - im // 32:im - q] = 1.0
    return x


def adapted_phantoms(images):
    """(name, image) of the adapted phase: val image 0 and the OOD bars phantom."""
    return [("val image 0", images[0]), ("OOD bars", ood_bars(256)[..., None])]


def adapted_sampler(F, model, sde, trafo, obs, gt, n_steps: int, lora_seed: int):
    """The adapted protocol's sampler: LoRA rank 4 drawn from `lora_seed`, 10
    Adam steps at lr 1e-3 per outer step, TV 1e-6, eta 0.85, gamma 0.01,
    cg(1), add_cg; `F` is the port's factory module."""
    return F.get_standard_adapted_sampler(
        "dds", model, sde, trafo, obs, num_steps=n_steps, eta=0.85, gamma=0.01,
        tv_penalty=1e-6, lr=1e-3, num_optim_step=10, adapt_freq=1, lora_rank=LORA_RANK,
        add_cg=True, dc_type="cg", cg_iter=1, ground_truth=gt, lora_seed=lora_seed)


class AdaptTimer:
    """CUDA events around each outer step's adaptation and its two score
    forwards (adapted, then prior), from the sampler's own calls: a step
    runs from one adaptation's start to the next's."""

    def __init__(self, sampler):
        self.steps, self.inner = [], False
        adapt, score = sampler.adapt_step, sampler.score

        def timed_adapt(x, t):
            start = StepTimer._event()
            self.inner = True
            adapt(x, t)
            self.inner = False
            self.steps.append({"start": start, "adapted": StepTimer._event(), "fwd": []})

        def timed_score(x, t, lora_scale, use_kernel=True):
            if self.inner or not self.steps:
                return score(x, t, lora_scale, use_kernel)
            e0 = StepTimer._event()
            out = score(x, t, lora_scale, use_kernel)
            self.steps[-1]["fwd"].append((e0, StepTimer._event()))
            return out

        sampler.adapt_step, sampler.score = timed_adapt, timed_score

    def split(self):
        """Per outer step but the last, ms of the step, the adaptation, the
        adapted and the prior forward, and the rest."""
        import torch

        torch.cuda.synchronize()
        rows = []
        for cur, nxt in zip(self.steps, self.steps[1:]):
            step = cur["start"].elapsed_time(nxt["start"])
            adapt = cur["start"].elapsed_time(cur["adapted"])
            f1, f0 = (a.elapsed_time(b) for a, b in cur["fwd"][:2])
            rows.append({"step": step, "adapt": adapt, "fwd_adapted": f1, "fwd_prior": f0,
                         "rest": step - adapt - f1 - f0})
        return rows


def reset_counts():
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    C.launches = C.backward_launches = A.launches = A.backward_launches = 0
    C.launches_by_variant = dict.fromkeys(C.VARIANTS, 0)
    C.backward_launches_by_variant = dict.fromkeys(C.VARIANTS, 0)
    A.launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    A.backward_launches_by_variant = dict.fromkeys(A.VARIANTS, 0)


def read_counts():
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    return {"conv_fwd": C.launches, "conv_fwd_by": dict(C.launches_by_variant),
            "conv_bwd": C.backward_launches, "conv_bwd_by": dict(C.backward_launches_by_variant),
            "attn_fwd": A.launches, "attn_fwd_by": dict(A.launches_by_variant),
            "attn_bwd": A.backward_launches, "attn_bwd_by": dict(A.backward_launches_by_variant)}


def check_counts(counts, n_fwd, n_bwd, what, stem_grad=False):
    """Per forward 62 conv3x3 (60 tc, 1 narrow, 1 simt) and 4 attention
    (mma); per backward 61 conv3x3 input gradients (60 tc, 1 simt: the
    final conv's, whose gradient has Cin = 1) and 4 attention backwards
    (mma).  With `stem_grad` (a gradient in the diffusion state x, as DPS
    takes it) the backward also takes the stem's input gradient, whose
    swapped shape (Cin 128 -> Cout 1) runs on `narrow`: 62 per backward."""
    n_stem = n_bwd if stem_grad else 0
    want = {"conv_fwd": 62 * n_fwd, "conv_fwd_by": {"tc": 60 * n_fwd, "narrow": n_fwd, "simt": n_fwd},
            "conv_bwd": 61 * n_bwd + n_stem,
            "conv_bwd_by": {"tc": 60 * n_bwd, "narrow": n_stem, "simt": n_bwd},
            "attn_fwd": 4 * n_fwd, "attn_fwd_by": {"mma": 4 * n_fwd, "simt": 0},
            "attn_bwd": 4 * n_bwd, "attn_bwd_by": {"mma": 4 * n_bwd, "simt": 0}}
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want} for {n_fwd} forwards "
                             f"and {n_bwd} backwards")


class PredictorTimer:
    """CUDA events at the start of each Euler-Maruyama predictor step and
    around the gradient of its data fit (`predictors._value_and_grad`: for
    DPS the score's forward and backward, for naive the data fit alone),
    from the sampler's own calls; `remove()` puts the functions back."""

    def __init__(self, P):
        self.P, self.starts, self.grads = P, [], []
        self._step, self._value_and_grad = P.euler_maruyama_step, P._value_and_grad

        def step(*a, **k):
            self.starts.append(StepTimer._event())
            return self._step(*a, **k)

        def value_and_grad(*a, **k):
            e0 = StepTimer._event()
            out = self._value_and_grad(*a, **k)
            self.grads.append((e0, StepTimer._event()))
            return out

        P.euler_maruyama_step, P._value_and_grad = step, value_and_grad

    def remove(self):
        self.P.euler_maruyama_step, self.P._value_and_grad = self._step, self._value_and_grad

    def split(self, last: int):
        """(ms per step over the run, medians over the `last` steps before
        the final one of the step and its gradient part)."""
        import torch

        torch.cuda.synchronize()
        if len(self.grads) != len(self.starts) or len(self.starts) < 2:
            raise AssertionError(f"{len(self.starts)} predictor steps, {len(self.grads)} gradients")
        n = len(self.starts)
        rows = [(a.elapsed_time(b), g0.elapsed_time(g1))
                for a, b, (g0, g1) in zip(self.starts, self.starts[1:], self.grads)][-last:]
        return (self.starts[0].elapsed_time(self.starts[-1]) / (n - 1),
                float(np.median([r[0] for r in rows])), float(np.median([r[1] for r in rows])))


def read_report(path) -> dict:
    """PSNR, SSIM and diverged_images of a CLI's report.yaml."""
    import re

    text = open(path, encoding="utf-8").read()
    out = {k: float(re.search(rf"^{k}: (\S+)$", text, re.M).group(1)) for k in ("PSNR", "SSIM")}
    out["diverged_images"] = re.search(r"^diverged_images: (.*)$", text, re.M).group(1)
    return out


def adaptation_gradients(sampler, x, t, use_kernel):
    """(loss, {leaf: gradient}) of the sampler's adaptation loss at (x, t),
    from its start state."""
    import torch

    with sampler.adapting():
        names = list(sampler.trainable)
        loss = sampler.adaptation_loss(x, t, use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, [sampler.trainable[n] for n in names])
    return float(loss.detach()), dict(zip(names, grads))


def lora_leaf_errors(gk, gp):
    """Per leaf |g_k - g_p| / |g_p| (2-norms), and the same over all leaves."""
    import torch

    per = {}
    num = den = 0.0
    for name in gp:
        diff = float(torch.linalg.vector_norm((gk[name] - gp[name]).double()))
        ref = float(torch.linalg.vector_norm(gp[name].double()))
        per[name] = diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
        num, den = num + diff ** 2, den + ref ** 2
    return per, math.sqrt(num / den)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000, help="DDS steps per image (protocol: 1000)")
    ap.add_argument("--images", type=int, default=1, help="val images to reconstruct with DDS")
    ap.add_argument("--adapt-steps", type=int, default=50,
                    help="outer steps of the adapted phase (protocol: 50)")
    ap.add_argument("--adapt-images", type=int, default=2,
                    help="adapted images: val image 0, then the OOD bars phantom")
    ap.add_argument("--dps-steps", type=int, default=DPS_PROTOCOL_STEPS,
                    help="steps of the DPS and naive CLI runs (protocol: 1000)")
    args = ap.parse_args()
    if args.images < 1 or args.adapt_images < 1 or args.adapt_steps < 2 or args.dps_steps < 6:
        raise SystemExit("chip_smoke: --images and --adapt-images must be at least 1, "
                         "--adapt-steps at least 2, --dps-steps at least 6")
    t_all = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs the card")
    sys.path.insert(0, REPO)
    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C
    from diffusion_models_dev_project_tpu_torch import run_conditional_sampling as CLI
    from diffusion_models_dev_project_tpu_torch.ops.cg import cg
    from diffusion_models_dev_project_tpu_torch.ops.diffusion import tweedy
    from diffusion_models_dev_project_tpu_torch.sampling import predictors as P
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM

    # ---- 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[phase 1 device] {time.perf_counter() - t0:.1f} s")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    nvcc_s = _build.build_seconds
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    sass = sass_counts(_build.build())
    log(f"  SASS of the library: {sass['HGMMA']} HGMMA, {sass['UTMALDG']} UTMALDG; HMMA: "
        + ", ".join(f"{n} in {name}" for name, n in sass["HMMA"].items()))
    if not (sass["HGMMA"] and sass["UTMALDG"] and all(sass["HMMA"].values())):
        raise AssertionError("the built library holds no HGMMA, no UTMALDG, or no HMMA in one of "
                             f"{HMMA_FUNCTIONS}")
    log(f"[phase 2 build] nvcc {nvcc_s:.1f} s, total {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels at the UNet's shapes
    t0 = time.perf_counter()
    config = get_config("vesde")
    config.model.num_channels = 128            # the shipped flagship prior
    config.model.dtype = "bfloat16"            # bf16 weights and compute, fp32 accumulation
    config.data.part = "val"
    sde = F.get_standard_sde(config)
    model, _, score_fn = F.get_standard_score(config, sde, ckpt_path=CKPT)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  UNet: {n_params / 1e6:.1f}M parameters from {os.path.relpath(CKPT, REPO)}, "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 256, 256, 1), generator=gen, device="cuda") * 10.0
    t = torch.full((1,), 0.5, device="cuda")
    seen, handles = record_shapes(model)
    with torch.no_grad():
        model(x, t)
    for hnd in handles:
        hnd.remove()
    conv_tot, conv_err, conv_variants = check_conv(seen["conv"], gen)
    attn_tot, attn_err = check_attention(seen["attn"], gen)
    conv_bwd_tot, conv_bwd_err, conv_bwd_variants = check_conv_backward(seen["conv"], gen)
    attn_bwd_tot, attn_bwd_err, attn_bwd_variants = check_attention_backward(seen["attn"], gen)
    log(f"[phase 3 kernels] {time.perf_counter() - t0:.1f} s")

    # ---- 4. one full-width UNet forward, kernels against plain versions
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(x, t)
        ref = model(x, t, use_kernel=False)
        fwd_ms = wall_ms(lambda: model(x, t), 10)
        fwd_dev_ms = time_ms(lambda: model(x, t), 10)
        fwd_plain_ms = wall_ms(lambda: model(x, t, use_kernel=False), 5)
    torch.cuda.synchronize()
    d, r = rel_err(out, ref)
    log(f"  UNet 256² forward: out {tuple(out.shape)}, max|kernel - plain| {d:.3e}, rel {r:.3e} "
        f"(tol {TOL_UNET}); {fwd_ms:.2f} ms with kernels ({fwd_dev_ms:.2f} ms of device time, "
        f"replayed as a CUDA graph), {fwd_plain_ms:.2f} ms plain")
    if not (torch.isfinite(out).all() and out.shape == (1, 256, 256, 1) and r <= TOL_UNET):
        raise AssertionError("UNet forward with kernels disagrees with the plain path")
    log(f"[phase 4 unet] {time.perf_counter() - t0:.1f} s")

    # ---- 5. full-width gradient of the adaptation loss, kernels against plain
    t0 = time.perf_counter()
    model_l, _, _ = F.get_standard_score(config, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    config32 = copy.deepcopy(config)
    config32.model.dtype = "float32"
    model_32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT, lora_rank=LORA_RANK)
    trafo = F.get_standard_ray_trafo(config)
    images = np.load(VALSET)["images"]                          # (N, 256, 256, 1)
    g = torch.Generator(device="cuda").manual_seed(config.seed)
    gt, obs, _ = F.get_data_from_ground_truth(images[0], trafo, config.data.stddev, generator=g)
    samplers = {name: F.get_standard_adapted_sampler(
        "dds", m, sde, trafo, obs, num_steps=50, lora_rank=LORA_RANK, add_cg=True, cg_iter=1,
        dc_type="cg", tv_penalty=1e-6, lr=1e-3) for name, m in (("bf16", model_l), ("fp32", model_32))}
    # every up-projection drawn nonzero, so that every branch carries gradient
    lora = {n: (v if n.endswith(".down") else 0.01 * torch.randn(v.shape, generator=gen, device="cuda"))
            for n, v in samplers["bf16"].lora.items()}
    for smp in samplers.values():
        smp.lora = lora
    tg = torch.full((1,), 0.5, device="cuda")
    xg = gt + sde.marginal_prob_std(tg).reshape(1, 1, 1, 1) * torch.randn(
        gt.shape, generator=gen, device="cuda")
    reset_counts()
    loss_k, gk = adaptation_gradients(samplers["bf16"], xg, tg, True)
    counts = read_counts()
    check_counts(counts, 1, 1, "one forward and backward of the adaptation loss")
    loss_p, gp = adaptation_gradients(samplers["bf16"], xg, tg, False)
    loss_32, g32 = adaptation_gradients(samplers["fp32"], xg, tg, False)
    loss_32k, g32k = adaptation_gradients(samplers["fp32"], xg, tg, True)
    del samplers["fp32"], model_32
    per_kp, total_kp = lora_leaf_errors(gk, gp)
    per_k32, total_k32 = lora_leaf_errors(gk, g32)
    per_p32, total_p32 = lora_leaf_errors(gp, g32)
    per_f32, total_f32 = lora_leaf_errors(g32k, g32)
    n_lora = sum(n.endswith((".down", ".up")) for n in gk)
    slack = {n: per_k32[n] - max(TOL_GRAD_LEAF_FACTOR * per_p32[n], TOL_GRAD_LEAF) for n in gk}
    worst = sorted(gk, key=lambda n: -slack[n])[:5]
    log(f"  adaptation loss gradient at 256², LoRA r={LORA_RANK}: {len(gk)} trainable leaves "
        f"({n_lora} LoRA, {len(gk) - n_lora} biases); loss bf16 kernels {loss_k:.6e}, bf16 plain "
        f"{loss_p:.6e}, fp32 plain {loss_32:.6e}, fp32 kernels {loss_32k:.6e}")
    log(f"  |g_a - g_b| / |g_b| over all leaves: bf16 kernels vs bf16 plain {total_kp:.3e} (tol "
        f"{TOL_GRAD_ALL}); vs the fp32 plain gradient: bf16 kernels {total_k32:.3e}, bf16 plain "
        f"{total_p32:.3e}; fp32 kernels vs fp32 plain {total_f32:.3e}, worst leaf "
        f"{max(per_f32.values()):.3e} (tol {TOL_GRAD_FP32})")
    log(f"  per leaf, distance from the fp32 gradient, bf16 kernels against bf16 plain (tol "
        f"max({TOL_GRAD_LEAF_FACTOR} x plain, {TOL_GRAD_LEAF})), closest to the bound: "
        + ", ".join(f"{n} {per_k32[n]:.3e} vs {per_p32[n]:.3e}" for n in worst)
        + f"; largest per leaf: bf16 kernels vs bf16 plain {max(per_kp.values()):.3e}, distance "
        f"from the fp32 gradient {max(per_k32.values()):.3e} (bf16 kernels), "
        f"{max(per_p32.values()):.3e} (bf16 plain)")
    log("  launches of one forward and backward: " + json.dumps(counts))
    if not (math.isfinite(total_kp) and total_kp <= TOL_GRAD_ALL and max(slack.values()) <= 0
            and max(per_f32.values()) <= TOL_GRAD_FP32
            and all(torch.isfinite(v).all() for v in gk.values())):
        raise AssertionError("the full-width LoRA gradient with kernels disagrees with the plain path")
    sampler = samplers["bf16"]
    with sampler.adapting():
        params = list(sampler.trainable.values())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = sampler.adaptation_loss(xg, tg)
        ev[1].record()
        torch.autograd.grad(loss, params)
        ev[2].record()
        torch.cuda.synchronize()
        del loss                    # its graph would hold the gradient accumulators
        fwd_wall, bwd_wall = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        fwd_dev = time_ms(lambda: sampler.adaptation_loss(xg, tg).detach(), 3)
        both_dev = time_ms(lambda: torch.autograd.grad(sampler.adaptation_loss(xg, tg), params), 3)
    log(f"  one forward + backward of the loss: wall {fwd_wall:.2f} + {bwd_wall:.2f} ms (CUDA events, "
        f"eager); device time (graph replay) forward {fwd_dev:.2f} ms, forward + backward "
        f"{both_dev:.2f} ms, so the backward {both_dev - fwd_dev:.2f} ms")
    log(f"[phase 5 gradient] {time.perf_counter() - t0:.1f} s")

    # ---- 6. DDS reconstruction through the factory entry points
    t0 = time.perf_counter()
    reset_counts()
    step_s, results, splits = [], [], []
    for i, img in enumerate(images[:args.images]):
        g = torch.Generator(device="cuda").manual_seed(config.seed + i)
        gt, obs, fbp = F.get_data_from_ground_truth(img, trafo, config.data.stddev, generator=g)
        timer = StepTimer(score_fn, P.cg, first_step=max(args.steps - SPLIT_STEPS, 0))
        sampler = F.get_standard_sampler("dds", timer.score, sde, trafo, obs, num_steps=args.steps,
                                         im_shape=(256, 256, 1), gamma=0.01, eta=0.85, cg_iter=5)
        torch.cuda.synchronize()
        P.cg = timer.cg                # the sampler's CG solve, between CUDA events
        try:
            ts = time.perf_counter()
            xr, _ = sampler.sample(generator=g)
            timer.finish()
            torch.cuda.synchronize()
            step_s.append((time.perf_counter() - ts) / args.steps)
        finally:
            P.cg = cg
        splits.extend(timer.split())
        rec = xr[0, ..., 0].float().cpu().numpy()
        g_np, f_np = gt[0, ..., 0].cpu().numpy(), fbp[0, ..., 0].cpu().numpy()
        if not (xr.shape == (1, 256, 256, 1) and np.isfinite(rec).all()):
            raise AssertionError(f"image {i}: reconstruction not finite or of the wrong shape")
        rec = np.clip(rec, 0, 1)
        p, s, fp, fs = PSNR(rec, g_np), SSIM(rec, g_np), PSNR(f_np, g_np), SSIM(f_np, g_np)
        results.append((p, fp))
        log(f"  image {i}: DDS {p:.2f} dB / {s:.4f} SSIM | FBP {fp:.2f} dB / {fs:.4f} SSIM | "
            f"{step_s[-1] * 1e3:.2f} ms/step")
    n_fwd = args.steps * len(results)
    conv_launches, attn_launches = C.launches, A.launches
    by_variant, attn_by_variant = dict(C.launches_by_variant), dict(A.launches_by_variant)
    log(f"  launches in the DDS run: conv3x3 {conv_launches} ({conv_launches / n_fwd:g} per forward: "
        + ", ".join(f"{v} {k / n_fwd:g}" for v, k in by_variant.items())
        + f"), attention {attn_launches} ({attn_launches / n_fwd:g} per forward: "
        + ", ".join(f"{v} {k / n_fwd:g}" for v, k in attn_by_variant.items()) + ")")
    ms_step = 1e3 * float(np.mean(step_s))
    log(f"  DDS {args.steps} steps x {len(results)} images: {ms_step:.2f} ms/step, "
        f"{1e3 / ms_step:.2f} steps/s, mean PSNR {np.mean([p for p, _ in results]):.2f} dB "
        f"vs FBP {np.mean([f for _, f in results]):.2f} dB")
    # inside the loop: medians over the last steps of each image
    med = {key: float(np.median([row[key] for row in splits])) for key in ("step", "unet", "cg", "rest")}
    log(f"  per step inside the DDS loop (CUDA events, median of the last {len(splits)} steps over "
        f"{len(results)} images): step {med['step']:.2f} ms = UNet forward {med['unet']:.2f} ms + "
        f"CG(5) {med['cg']:.2f} ms + rest {med['rest']:.2f} ms (the rest: Tweedie, DDIM, noise, "
        f"and the loop's own host time)")
    if min(min(row.values()) for row in splits) < 0:
        raise AssertionError("a part of a DDS step timed negative")
    # device time of the CG solve and the fused Gram, each alone (graph replay)
    xhat0 = torch.randn((1, 256, 256, 1), generator=gen, device="cuda")
    dc_op = P.make_dc_op(sampler.ray_trafo, 0.01)
    cg_dev_ms = time_ms(lambda: cg(dc_op, xhat0, xhat0 + 0.01 * sampler.rhs, n_iter=5), 10)
    gram_ms = time_ms(lambda: sampler.ray_trafo.gram(xhat0), 20)
    log(f"  device time alone (graph replay): UNet forward {fwd_dev_ms:.2f} ms (phase 4), CG(5) "
        f"{cg_dev_ms:.2f} ms (fused Gram {gram_ms:.3f} ms each); together at most "
        f"{(fwd_dev_ms + cg_dev_ms) / ms_step:.0%} of the step")
    if conv_launches != 62 * n_fwd or attn_launches != 4 * n_fwd:
        raise AssertionError("the DDS run did not launch 62 conv3x3 and 4 attention kernels per forward")
    if by_variant != {"tc": 60 * n_fwd, "narrow": n_fwd, "simt": n_fwd}:
        raise AssertionError(f"conv3x3 launches by variant {by_variant}: want 60 tc, 1 narrow "
                             "and 1 simt per forward")
    if attn_by_variant != {"mma": 4 * n_fwd, "simt": 0}:
        raise AssertionError(f"attention launches by variant {attn_by_variant}: want 4 mma and "
                             "0 simt per forward")
    for i, (p, fp) in enumerate(results):
        if not p > fp:
            raise AssertionError(f"image {i}: DDS {p:.2f} dB does not beat FBP {fp:.2f} dB")
    if C.backward_launches or A.backward_launches:
        raise AssertionError("the DDS run launched a backward kernel")
    log(f"[phase 6 dds] {time.perf_counter() - t0:.1f} s")

    # ---- 7. LoRA-adapted DDS of val image 0 and the OOD bars phantom
    t0 = time.perf_counter()
    phantoms = adapted_phantoms(images)
    adapt_counts, adapt_rows = None, []
    n_steps = args.adapt_steps
    for i, (what, img) in enumerate(phantoms[:args.adapt_images]):
        g = torch.Generator(device="cuda").manual_seed(config.seed + 100 + i)
        gt, obs, fbp = F.get_data_from_ground_truth(img, trafo, config.data.stddev, generator=g)
        sampler = adapted_sampler(F, model_l, sde, trafo, obs, gt, n_steps, lora_seed=i)
        timer = AdaptTimer(sampler)
        torch.cuda.synchronize()
        reset_counts()
        ts = time.perf_counter()
        xa, trace = sampler.sample(generator=g, return_trace=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - ts
        counts = read_counts()
        check_counts(counts, n_steps * 12 + 1, n_steps * 10, f"adapted {what}")
        adapt_counts = counts if adapt_counts is None else {
            k: (v + counts[k] if isinstance(v, int) else {kk: vv + counts[k][kk] for kk, vv in v.items()})
            for k, v in adapt_counts.items()}
        adapt_rows.extend(timer.split())
        dds = F.get_standard_sampler("dds", score_fn, sde, trafo, obs, num_steps=n_steps,
                                     im_shape=(256, 256, 1), gamma=0.01, eta=0.85, cg_iter=5)
        xd, _ = dds.sample(generator=g)
        g_np, f_np = gt[0, ..., 0].cpu().numpy(), fbp[0, ..., 0].cpu().numpy()
        rec = {}
        for name, xr in (("adapted", xa), ("dds", xd)):
            r = xr[0, ..., 0].float().cpu().numpy()
            if not (xr.shape == (1, 256, 256, 1) and np.isfinite(r).all()):
                raise AssertionError(f"{what}: {name} reconstruction not finite or of the wrong shape")
            r = np.clip(r, 0, 1)
            rec[name] = (PSNR(r, g_np), SSIM(r, g_np))
        fb = (PSNR(f_np, g_np), SSIM(f_np, g_np))
        tr = trace.float().cpu().numpy()
        log(f"  {what}: adapted {rec['adapted'][0]:.2f} dB / {rec['adapted'][1]:.4f} SSIM | "
            f"DDS {n_steps} steps {rec['dds'][0]:.2f} dB / {rec['dds'][1]:.4f} | FBP {fb[0]:.2f} dB / "
            f"{fb[1]:.4f} | {wall_s:.1f} s, {wall_s / n_steps * 1e3:.0f} ms per outer step; Tweedie "
            f"PSNR trace {tr[0]:.2f} -> {tr[len(tr) // 2]:.2f} -> {tr[-1]:.2f} dB")
        # the quality gate holds the protocol's 50 outer steps (or more); a
        # shortened probe (--adapt-steps) prints its numbers ungated
        if n_steps >= ADAPT_PROTOCOL_STEPS and not rec["adapted"][0] > fb[0]:
            raise AssertionError(f"{what}: adapted {rec['adapted'][0]:.2f} dB does not beat FBP "
                                 f"{fb[0]:.2f} dB")
    if adapt_rows:
        med = {k: float(np.median([row[k] for row in adapt_rows]))
               for k in ("step", "adapt", "fwd_adapted", "fwd_prior", "rest")}
        log(f"  per outer step (CUDA events, median of {len(adapt_rows)} steps): step "
            f"{med['step']:.1f} ms = adaptation {med['adapt']:.1f} ms (10 Adam steps, "
            f"{med['adapt'] / 10:.1f} ms each) + adapted forward {med['fwd_adapted']:.2f} ms + prior "
            f"forward {med['fwd_prior']:.2f} ms + rest {med['rest']:.2f} ms (Tweedie, cg(1), DDIM)")
    log("  launches in the adapted runs: " + json.dumps(adapt_counts))
    log(f"[phase 7 adapted] {time.perf_counter() - t0:.1f} s")

    # ---- 8. DPS: the full-width gradient in x, then DPS and naive through the CLI
    t0 = time.perf_counter()
    del model_l, samplers, sampler
    model_f32, _, _ = F.get_standard_score(config32, sde, ckpt_path=CKPT)
    g = torch.Generator(device="cuda").manual_seed(config.seed)
    gt, obs, _ = F.get_data_from_ground_truth(images[0], trafo, config.data.stddev, generator=g)
    nll = P.make_nloglik(trafo, obs)
    td = torch.full((1,), DPS_T, device="cuda")
    xd = gt + sde.marginal_prob_std(td).reshape(1, 1, 1, 1) * torch.randn(
        gt.shape, generator=gen, device="cuda")

    def dps_loss(m, xx, use_kernel=True):
        return nll(tweedy(m(xx, td, use_kernel=use_kernel), xx, sde, td))

    def dps_gradient(m, use_kernel):
        xx = xd.detach().requires_grad_(True)
        loss = dps_loss(m, xx, use_kernel)
        return float(loss.detach()), torch.autograd.grad(loss, xx)[0]

    def rel2(a, b):
        return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))

    reset_counts()
    loss_k, gk = dps_gradient(model, True)
    dps_grad_counts = read_counts()
    check_counts(dps_grad_counts, 1, 1, "one forward and backward of the DPS loss", stem_grad=True)
    loss_p, gp = dps_gradient(model, False)
    loss_32, g32 = dps_gradient(model_f32, False)
    loss_32k, g32k = dps_gradient(model_f32, True)
    del model_f32
    e_kp, e_f32 = rel2(gk, gp), rel2(g32k, g32)
    log(f"  DPS gradient in x at 256², t = {DPS_T}: loss bf16 kernels {loss_k:.6e}, bf16 plain "
        f"{loss_p:.6e}, fp32 plain {loss_32:.6e}, fp32 kernels {loss_32k:.6e}; |g_a - g_b| / |g_b|: "
        f"bf16 kernels vs bf16 plain {e_kp:.3e} (tol {TOL_GRAD_ALL}), fp32 kernels vs fp32 plain "
        f"{e_f32:.3e} (tol {TOL_GRAD_FP32}); vs the fp32 plain gradient: bf16 kernels "
        f"{rel2(gk, g32):.3e}, bf16 plain {rel2(gp, g32):.3e}")
    log("  launches of one forward and backward: " + json.dumps(dps_grad_counts))
    if not (all(torch.isfinite(v).all() for v in (gk, gp, g32, g32k))
            and e_kp <= TOL_GRAD_ALL and e_f32 <= TOL_GRAD_FP32):
        raise AssertionError("the full-width DPS gradient with kernels disagrees with the plain path")
    xleaf = xd.detach().clone().requires_grad_(True)
    with torch.no_grad():
        dps_fwd_wall = wall_ms(lambda: dps_loss(model, xleaf), 5)
        dps_fwd_dev = time_ms(lambda: dps_loss(model, xleaf), 3)
    dps_both_wall = wall_ms(lambda: torch.autograd.grad(dps_loss(model, xleaf), xleaf), 5)
    dps_both_dev = time_ms(lambda: torch.autograd.grad(dps_loss(model, xleaf), xleaf), 3)
    log(f"  one DPS loss (score, Tweedie, ||y - Ax||): forward wall {dps_fwd_wall:.2f} ms, device "
        f"{dps_fwd_dev:.2f} ms; forward + backward wall {dps_both_wall:.2f} ms, device "
        f"{dps_both_dev:.2f} ms (wall: CUDA events around eager calls; device: graph replay)")

    # DPS and naive through the CLI, on its default data, each run from the
    # prior and from the FBP (the last steps of the same grid); outputs under build/
    workdir = os.path.join(REPO, "build", "chip_smoke_cli")
    os.makedirs(workdir, exist_ok=True)
    n_dps = args.dps_steps
    steps_run = {"prior": n_dps, "fbp": n_dps - math.ceil(DPS_FBP_PCT * n_dps)}
    cli_runs = {}
    for start in ("prior", "fbp"):
        for method in ("dps", "naive"):
            argv = ["--load_path", CKPT, "--num_channels", "128", "--method", method, "--penalty",
                    str(DPS_PENALTY), "--num_steps", str(n_dps), "--num_images", "1"]
            if start == "fbp":
                argv += ["--pct_chain_elapsed", str(DPS_FBP_PCT)]
            timer = PredictorTimer(P)
            cwd = os.getcwd()
            os.chdir(workdir)
            try:
                torch.cuda.synchronize()
                reset_counts()
                ts = time.perf_counter()
                root = CLI.coordinator(CLI.parser.parse_args(argv))
                wall_s = time.perf_counter() - ts
                counts = read_counts()
            finally:
                os.chdir(cwd)
                timer.remove()
            what = f"{method} from the {start} through the CLI"
            n = steps_run[start]
            check_counts(counts, n, n if method == "dps" else 0, what, stem_grad=True)
            ms_step, med_step, med_grad = timer.split(SPLIT_STEPS)
            report = read_report(os.path.join(workdir, root, "report.yaml"))
            with np.load(os.path.join(workdir, root, "recon_0_info.npz")) as info:
                recon, g_np = info["recon"], info["ground_truth"]
            cli_runs[method, start] = dict(report=report, counts=counts, ms_step=ms_step,
                                           med_step=med_step, med_grad=med_grad, wall_s=wall_s,
                                           gt=g_np)
            # the CLI's divergence guard holds the protocol's 1000 steps (or more);
            # a shortened probe's coarser steps may leave it, and are not gated
            if not (recon.shape == (256, 256) and np.isfinite(recon).all()
                    and (n_dps < DPS_PROTOCOL_STEPS or report["diverged_images"] == "[]")):
                raise AssertionError(f"{what}: reconstruction of the wrong shape, not finite or "
                                     f"diverged ({report['diverged_images']})")
    # FBP of the same observation: the CLI's per-image seed (config seed x 1000 + image)
    g_np = cli_runs["dps", "prior"]["gt"]
    if not all(np.array_equal(g_np, run["gt"]) for run in cli_runs.values()):
        raise AssertionError("the CLI runs reconstructed different images")
    g = torch.Generator(device="cuda").manual_seed(config.seed * 1000)
    _, _, fbp = F.get_data_from_ground_truth(g_np[..., None], trafo, config.data.stddev, generator=g)
    f_np = fbp[0, ..., 0].cpu().numpy()
    fb = (PSNR(f_np, g_np), SSIM(f_np, g_np))
    for (method, start), run in cli_runs.items():
        rep = run["report"]
        log(f"  {method} from the {start} (penalty {DPS_PENALTY:g}, {steps_run[start]} steps of "
            f"{n_dps}) through the CLI, "
            f"test-fold image 0: {rep['PSNR']:.2f} dB / {rep['SSIM']:.4f} SSIM | FBP {fb[0]:.2f} dB / "
            f"{fb[1]:.4f} | diverged images {rep['diverged_images']} | {run['wall_s']:.1f} s in the "
            f"CLI, {run['ms_step']:.2f} ms per step")
    for start in ("prior", "fbp"):
        dps, naive = cli_runs["dps", start], cli_runs["naive", start]
        log(f"  per step from the {start} (CUDA events, median of the last "
            f"{min(SPLIT_STEPS, steps_run[start] - 1)} steps): DPS {dps['med_step']:.2f} ms = score forward + "
            f"backward through Tweedie and the data fit {dps['med_grad']:.2f} ms + rest "
            f"{dps['med_step'] - dps['med_grad']:.2f} ms; naive {naive['med_step']:.2f} ms, of it the "
            f"data fit's gradient {naive['med_grad']:.2f} ms")
    dps, naive = cli_runs["dps", "prior"], cli_runs["naive", "prior"]
    log(f"  device time alone (graph replay): DPS forward + backward {dps_both_dev:.2f} ms, so at most "
        f"{dps_both_dev / dps['med_step']:.0%} of a DPS step; UNet forward {fwd_dev_ms:.2f} ms "
        f"(phase 4), at most {fwd_dev_ms / naive['med_step']:.0%} of a naive step with the data "
        f"fit's gradient")
    for (method, start), run in cli_runs.items():
        log(f"  launches in the {method} run from the {start}: " + json.dumps(run["counts"]))
    # from the prior the shipped prior's biased score at large sigma sets the
    # result (PERF.md §6): printed, not gated; from the FBP DPS must win
    margins = {start: cli_runs["dps", start]["report"]["PSNR"] - cli_runs["naive", start]["report"]["PSNR"]
               for start in ("prior", "fbp")}
    log(f"  DPS - naive: from the prior {margins['prior']:+.2f} dB (not gated), from the FBP "
        f"{margins['fbp']:+.2f} dB (gate on a grid of {DPS_PROTOCOL_STEPS} steps or more: > "
        f"{DPS_MARGIN_DB} dB)")
    if n_dps >= DPS_PROTOCOL_STEPS and not margins["fbp"] > DPS_MARGIN_DB:
        raise AssertionError(f"from the FBP, DPS {cli_runs['dps', 'fbp']['report']['PSNR']:.2f} dB does "
                             f"not beat naive {cli_runs['naive', 'fbp']['report']['PSNR']:.2f} dB by "
                             f"{DPS_MARGIN_DB} dB")
    log(f"[phase 8 dps] {time.perf_counter() - t0:.1f} s")

    # ---- 9. kernel summary, device line
    src = "diffusion_models_dev_project_tpu_torch/csrc/"
    conv_src = {"tc": src + "conv3x3_tc.cu", "narrow": src + "conv3x3.cu", "simt": src + "conv3x3.cu"}
    kernels = []
    for name, source, tot, err, launches, replaces, bwd in (
            ("conv3x3", conv_src["tc"], conv_tot, conv_err, conv_launches,
             "diffusion_models_dev_project_tpu/ops/conv3x3.py:35",
             (conv_src["tc"], conv_bwd_tot, conv_bwd_err, adapt_counts["conv_bwd"])),
            ("attention", src + "attention_mma.cu", attn_tot, attn_err, attn_launches,
             "diffusion_models_dev_project_tpu/ops/attention.py:43",
             (src + "attention_bwd_mma.cu", attn_bwd_tot, attn_bwd_err, adapt_counts["attn_bwd"]))):
        b_src, b_tot, b_err, b_launches = bwd
        fwd_key = "conv_fwd" if name == "conv3x3" else "attn_fwd"
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"],
            "launches_adapted": adapt_counts[fwd_key],    # forward launches of the adapted runs
            # per UNet backward; launches from the adapted runs
            "backward": {"source": b_src, "launches": b_launches, "ms": b_tot["ms"],
                         "plain_ms": b_tot["plain_ms"], "bound_ms": b_tot["bound_ms"],
                         "bound_by": "operations" if b_tot["ops_ms"] >= b_tot["bytes_ms"] else "bytes",
                         "library_ms": b_tot["library_ms"], "max_abs_err": b_err}})
    # launches of the DPS run through the CLI, forward and backward
    dps_counts = cli_runs["dps", "prior"]["counts"]
    for kern, (f_key, b_key) in zip(kernels, (("conv_fwd", "conv_bwd"), ("attn_fwd", "attn_bwd"))):
        kern["launches_dps"] = dps_counts[f_key]
        kern["backward"]["launches_dps"] = dps_counts[b_key]
    kernels[0]["backward"]["variants"] = {
        v: {"source": conv_src[v], "launches": adapt_counts["conv_bwd_by"][v],
            "launches_dps": dps_counts["conv_bwd_by"][v],
            "calls_per_backward": conv_bwd_variants.get(v, 0)} for v in C.VARIANTS}
    # attention backward: each variant's launches in the adapted runs and its
    # time per UNet backward at the path's shapes (simt: the earlier design)
    attn_bwd_src = {"mma": src + "attention_bwd_mma.cu", "simt": src + "attention_bwd.cu"}
    attn_bwd_ms = {"mma": attn_bwd_tot["ms"], "simt": attn_bwd_tot["simt_ms"]}
    kernels[1]["backward"]["variants"] = {
        v: {"source": attn_bwd_src[v], "launches": adapt_counts["attn_bwd_by"][v],
            "calls_per_backward": attn_bwd_variants.get(v, 0), "ms": attn_bwd_ms[v],
            "bound_ms": attn_bwd_tot["bound_ms"], "library_ms": attn_bwd_tot["library_ms"]}
        for v in A.VARIANTS}
    # the simt kernel at the shapes tc takes, per forward; each variant's share
    kernels[0]["simt_ms"] = conv_tot["simt_ms"]
    kernels[0]["variants"] = {
        v: {"source": conv_src[v], "launches": by_variant[v], "ms": agg["ms"],
            "bound_ms": agg["bound_ms"], "library_ms": agg["library_ms"]}
        for v, agg in conv_variants.items()}
    # attention: the simt kernel and the fastest SDPA backend at the
    # same inputs, per forward; each variant's share
    kernels[1]["simt_ms"] = attn_tot["simt_ms"]
    kernels[1]["library_best_ms"] = attn_tot["library_best_ms"]
    kernels[1]["library_best"] = attn_tot["library_best"]
    attn_ms = {"mma": attn_tot["ms"], "simt": attn_tot["simt_ms"]}
    kernels[1]["variants"] = {
        v: {"source": src + ("attention_mma.cu" if v == "mma" else "attention.cu"),
            "launches": attn_by_variant[v], "ms": attn_ms[v], "bound_ms": attn_tot["bound_ms"],
            "library_ms": attn_tot["library_ms"]}
        for v in A.VARIANTS}
    log(f"(kernel times are per UNet forward: the sum over its calls at their shapes; "
        f"whole run {time.perf_counter() - t_all:.1f} s)")
    log(smi.splitlines()[0])                # the card again, for readers of the output's tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
