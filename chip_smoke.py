#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`diffusion_models_dev_project_tpu_torch`).

Drives the port's main path, the flagship 256² disk-ellipse DDS
reconstruction, through its factory entry points on one CUDA device:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles `csrc/*.cu` with nvcc for sm_90a (ops/_build.py);
3. kernels: runs each kernel's wrapper at every shape the UNet forward
   gives it (recorded with forward hooks), checks it against its plain
   PyTorch version, and times kernel, plain version and library yardstick;
4. UNet: one full-width forward of the shipped VESDE prior at 256², batch 1,
   with the kernels against `use_kernel=False`;
5. DDS: reconstructs the first images of the shipped val set (60 angles,
   noise 0.01, gamma 0.01, eta 0.85, 5 CG iterations) and requires each to
   beat its FBP in PSNR, with the kernel launch counts of the run checked;
6. prints one `{"kernels": [...]}` line, then, last, the device line
   `{"ok": true, "device": {...}}`.

Any failed check raises, so the script exits non-zero and prints no result.
Usage: python3 chip_smoke.py [--steps N] [--images N]
"""
from __future__ import annotations

import argparse
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


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events),
    after one warm-up call."""
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


def check_conv(shapes, gen):
    """Kernel vs plain at every distinct conv shape; per-forward totals."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs, gflop = 0.0, 0.0
    log(f"{'shape (B,H,W,Cin->Cout)':>28} {'dtype':>8} {'n':>3} {'kernel_ms':>10} {'plain_ms':>9} "
        f"{'library_ms':>10} {'bound_ms':>9} {'bound_by':>10} {'rel_err':>9}")
    for (xshape, cout, dtype), n in sorted(counts.items(), key=lambda kv: (-kv[0][0][1], kv[0][0][3])):
        b, h, w, cin = xshape
        for dt in ("bfloat16", "float32"):     # correctness in both I/O types
            tdt = getattr(torch, dt)
            x = torch.randn(xshape, generator=gen, device="cuda").to(tdt)
            wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
                  / math.sqrt(9 * cin)).to(tdt)
            bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
            out = C.conv3x3(x, wt, bias)
            ref = C.conv3x3(x, wt, bias, use_kernel=False)
            torch.cuda.synchronize()
            d, r = rel_err(out, ref)
            worst[dt] = max(worst[dt], r)
            if dt == dtype:
                max_abs = max(max_abs, d)
            if not (torch.isfinite(out).all() and r <= TOL[dt]):
                raise AssertionError(f"conv3x3 {xshape}->{cout} {dt}: rel err {r:.3e} > {TOL[dt]}")
            if dt != dtype:
                continue
            xl = x.permute(0, 3, 1, 2)                          # channels-last NCHW view
            wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bl = bias.to(tdt)
            reps = 20 if h >= 128 else 50
            k_ms = time_ms(lambda: C.conv3x3(x, wt, bias), reps)
            p_ms = time_ms(lambda: C.conv3x3(x, wt, bias, use_kernel=False), max(reps // 4, 5))
            l_ms = time_ms(lambda: F.conv2d(xl, wl, bl, padding=1), reps)
            flops = 2.0 * b * h * w * cin * cout * 9
            nbytes = x.numel() * x.element_size() * (1 + cout / cin) + wt.numel() * wt.element_size() + 4 * cout
            b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
            log(f"{str((b, h, w, cin)) + '->' + str(cout):>28} {dt:>8} {n:>3} {k_ms:>10.4f} {p_ms:>9.4f} "
                f"{l_ms:>10.4f} {b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms), ("bound_ms", b_ms),
                           ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                tot[key] += n * v
            gflop += n * flops / 1e9
    log(f"conv3x3 max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']})")
    log(f"conv3x3 per UNet forward ({len(shapes)} calls): kernel {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, cuDNN {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, "
        f"{gflop:.1f} GFLOP -> {gflop / tot['ms']:.1f} TFLOP/s")
    return tot, max_abs


def check_attention(shapes, gen):
    """Kernel vs plain at the path's attention shapes (timed) and at ragged
    T and other head widths (checked only)."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    extra = [((8, 300, 64), "bfloat16"), ((2, 257, 40), "float32"), ((3, 100, 128), "float32"),
             ((8, 256, 64), "float32"), ((1, 5, 8), "float32")]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    max_abs = 0.0
    log(f"{'attention (BH,T,d)':>28} {'dtype':>8} {'n':>3} {'kernel_ms':>10} {'plain_ms':>9} "
        f"{'library_ms':>10} {'bound_ms':>9} {'bound_by':>10} {'rel_err':>9}")
    for (shape, dt) in list(counts) + extra:
        n = counts.get((shape, dt), 0)
        tdt = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(tdt) for _ in range(3))
        out = A.attention(q, k, v)
        ref = A.attention(q, k, v, use_kernel=False)
        torch.cuda.synchronize()
        d, r = rel_err(out, ref)
        worst[dt] = max(worst[dt], r)
        if not (torch.isfinite(out).all() and r <= TOL[dt]):
            raise AssertionError(f"attention {shape} {dt}: rel err {r:.3e} > {TOL[dt]}")
        if n == 0:
            log(f"{str(shape):>28} {dt:>8} {'-':>3} {'':>10} {'':>9} {'':>10} {'':>9} {'':>10} {r:>9.2e}")
            continue
        max_abs = max(max_abs, d)
        bh, t, dd = shape
        k_ms = time_ms(lambda: A.attention(q, k, v), 100)
        p_ms = time_ms(lambda: A.attention(q, k, v, use_kernel=False), 50)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 100)
        flops = 4.0 * bh * t * t * dd
        nbytes = 4.0 * q.numel() * q.element_size()
        b_ms, b_by, ops_ms, bytes_ms = bound(flops, nbytes, dt)
        log(f"{str(shape):>28} {dt:>8} {n:>3} {k_ms:>10.4f} {p_ms:>9.4f} {l_ms:>10.4f} "
            f"{b_ms:>9.5f} {b_by:>10} {r:>9.2e}")
        for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms), ("bound_ms", b_ms),
                         ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            tot[key] += n * val
    log(f"attention max rel err: bf16 {worst['bfloat16']:.3e} (tol {TOL['bfloat16']}), "
        f"fp32 {worst['float32']:.3e} (tol {TOL['float32']})")
    log(f"attention per UNet forward ({len(shapes)} calls): kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, SDPA {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
    return tot, max_abs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000, help="DDS steps per image (protocol: 1000)")
    ap.add_argument("--images", type=int, default=2, help="val images to reconstruct")
    args = ap.parse_args()
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
    from diffusion_models_dev_project_tpu_torch.ops.cg import cg
    from diffusion_models_dev_project_tpu_torch.sampling.predictors import make_dc_op
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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    log(f"[phase 2 build] nvcc {_build.build_seconds:.1f} s, total {time.perf_counter() - t0:.1f} s")

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
    conv_tot, conv_err = check_conv(seen["conv"], gen)
    attn_tot, attn_err = check_attention(seen["attn"], gen)
    log(f"[phase 3 kernels] {time.perf_counter() - t0:.1f} s")

    # ---- 4. one full-width UNet forward, kernels against plain versions
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(x, t)
        ref = model(x, t, use_kernel=False)
        fwd_ms = time_ms(lambda: model(x, t), 10)
        fwd_plain_ms = time_ms(lambda: model(x, t, use_kernel=False), 5)
    torch.cuda.synchronize()
    d, r = rel_err(out, ref)
    log(f"  UNet 256² forward: out {tuple(out.shape)}, max|kernel - plain| {d:.3e}, rel {r:.3e} "
        f"(tol {TOL_UNET}); {fwd_ms:.2f} ms with kernels, {fwd_plain_ms:.2f} ms plain")
    if not (torch.isfinite(out).all() and out.shape == (1, 256, 256, 1) and r <= TOL_UNET):
        raise AssertionError("UNet forward with kernels disagrees with the plain path")
    log(f"[phase 4 unet] {time.perf_counter() - t0:.1f} s")

    # ---- 5. DDS reconstruction through the factory entry points
    t0 = time.perf_counter()
    trafo = F.get_standard_ray_trafo(config)
    images = np.load(VALSET)["images"][:args.images]            # (N, 256, 256, 1)
    C.launches = A.launches = 0
    step_s, results = [], []
    for i, img in enumerate(images):
        g = torch.Generator(device="cuda").manual_seed(config.seed + i)
        gt, obs, fbp = F.get_data_from_ground_truth(img, trafo, config.data.stddev, generator=g)
        sampler = F.get_standard_sampler("dds", score_fn, sde, trafo, obs, num_steps=args.steps,
                                         im_shape=(256, 256, 1), gamma=0.01, eta=0.85, cg_iter=5)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        xr, _ = sampler.sample(generator=g)
        torch.cuda.synchronize()
        step_s.append((time.perf_counter() - ts) / args.steps)
        rec = xr[0, ..., 0].float().cpu().numpy()
        g_np, f_np = gt[0, ..., 0].cpu().numpy(), fbp[0, ..., 0].cpu().numpy()
        if not (xr.shape == (1, 256, 256, 1) and np.isfinite(rec).all()):
            raise AssertionError(f"image {i}: reconstruction not finite or of the wrong shape")
        rec = np.clip(rec, 0, 1)
        p, s, fp, fs = PSNR(rec, g_np), SSIM(rec, g_np), PSNR(f_np, g_np), SSIM(f_np, g_np)
        results.append((p, fp))
        log(f"  image {i}: DDS {p:.2f} dB / {s:.4f} SSIM | FBP {fp:.2f} dB / {fs:.4f} SSIM | "
            f"{step_s[-1] * 1e3:.2f} ms/step")
    n_fwd = args.steps * len(images)
    conv_launches, attn_launches = C.launches, A.launches
    log(f"  launches in the DDS run: conv3x3 {conv_launches} ({conv_launches / n_fwd:g} per forward), "
        f"attention {attn_launches} ({attn_launches / n_fwd:g} per forward)")
    ms_step = 1e3 * float(np.mean(step_s))
    log(f"  DDS {args.steps} steps x {len(images)} images: {ms_step:.2f} ms/step, "
        f"{1e3 / ms_step:.2f} steps/s, mean PSNR {np.mean([p for p, _ in results]):.2f} dB "
        f"vs FBP {np.mean([f for _, f in results]):.2f} dB")
    # where a step's time goes outside the UNet: the CG solve (6 fused Gram applies)
    xhat0 = torch.randn((1, 256, 256, 1), generator=gen, device="cuda")
    dc_op = make_dc_op(sampler.ray_trafo, 0.01)
    cg_ms = time_ms(lambda: cg(dc_op, xhat0, xhat0 + 0.01 * sampler.rhs, n_iter=5), 10)
    gram_ms = time_ms(lambda: sampler.ray_trafo.gram(xhat0), 20)
    log(f"  per step: UNet forward {fwd_ms:.2f} ms (phase 4), CG(5) {cg_ms:.2f} ms "
        f"(fused Gram {gram_ms:.3f} ms each), rest {ms_step - fwd_ms - cg_ms:.2f} ms")
    if conv_launches != 62 * n_fwd or attn_launches != 4 * n_fwd:
        raise AssertionError("the DDS run did not launch 62 conv3x3 and 4 attention kernels per forward")
    for i, (p, fp) in enumerate(results):
        if not p > fp:
            raise AssertionError(f"image {i}: DDS {p:.2f} dB does not beat FBP {fp:.2f} dB")
    log(f"[phase 5 dds] {time.perf_counter() - t0:.1f} s")

    # ---- 6. kernel summary, 7. device line
    src = "diffusion_models_dev_project_tpu_torch/csrc/"
    kernels = []
    for name, tot, err, launches, replaces in (
            ("conv3x3", conv_tot, conv_err, conv_launches,
             "diffusion_models_dev_project_tpu/ops/conv3x3.py:35"),
            ("attention", attn_tot, attn_err, attn_launches,
             "diffusion_models_dev_project_tpu/ops/attention.py:43")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + name + ".cu", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
            "library_ms": tot["library_ms"]})
    log(f"(kernel times are per UNet forward: the sum over its calls at their shapes; "
        f"whole run {time.perf_counter() - t_all:.1f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
