#!/usr/bin/env python3
"""Design choices of the conv3x3 weight gradient, timed on the card.

Three parts, each printed as a table and summed per UNet backward over the
flagship's convs (the shipped VESDE prior, 128 channels, bf16, 256²; the
shapes traced from one forward, at batch 3, the training batch, and 1):

- `pairs`: `tc` (csrc/conv3x3_wgrad_tc.cu) as `wgrad_plan` lays it out,
  splits of K reduced in pairs through distributed shared memory, against
  the plan without pairs (`wgrad_plan(..., cluster=1)`, launched through
  the library directly), each checked against the plain twin and timed
  paired, unpaired, unpaired, paired;
- `narrow`: the stem's and final conv's kernels (`narrow_in`,
  `narrow_out`) as planned, against the same kernels with their tiles
  grown until at most 64 splits remain;
- `host`: host microseconds per conv3x3 call at (1, 8, 8, 512) -> 512
  (enqueue only, as `chip_smoke.py` phase 3 takes it) beside `F.conv2d`
  and beside the plan lookup alone, and the UNet forward's wall and device
  ms (as phase 4).  With `--root` it times the port of another checkout,
  for example the parent commit unpacked with `git archive`, so that two
  versions compare on one host.

Kernel times are device time (CUDA-graph replay, `chip_smoke.time_ms`).
Prints the card's name and power limit first and a JSON line of the sums
last.  Needs one CUDA card.

Usage: python3 wgrad_probe.py [--parts pairs,narrow,host] [--root DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import chip_smoke as CS

NARROW_CAP = 64      # splits at most, in the `narrow` comparison


def traced_convs(model):
    """(x shape at batch 1, Cout, dtype) of each conv3x3 call of one forward."""
    import torch

    seen, handles = CS.record_shapes(model)
    with torch.no_grad():
        model(torch.zeros((1, 256, 256, 1), device="cuda"), torch.full((1,), 0.5, device="cuda"))
    for hnd in handles:
        hnd.remove()
    counts = {}
    for xs, cout, dt in seen["conv"]:
        counts[xs[1:], cout, dt] = counts.get((xs[1:], cout, dt), 0) + 1
    return counts


def inputs(b, hwc, cout, dt, gen):
    import torch

    tdt = getattr(torch, dt)
    x = torch.randn((b,) + hwc, generator=gen, device="cuda").to(tdt)
    g = (0.1 * torch.randn((b,) + hwc[:2] + (cout,), generator=gen, device="cuda")).to(tdt)
    return x, g


def checked(dw, x, g, what):
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    _, r = CS.rel_err(dw, C.conv3x3_weight_grad_reference(x, g))
    if not r <= CS.TOL_WGRAD:
        raise AssertionError(f"{what}: rel err {r:.3e} > {CS.TOL_WGRAD}")


def pairs(convs, gen, sums):
    """tc as planned (pairs) against the same plan without pairs."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    lib, sms = _build.library(), C.device_sms(torch.device("cuda"))
    for b in (CS.TRAIN_BATCH, 1):
        tot = dict.fromkeys(("paired", "unpaired"), 0.0)
        for (hwc, cout, dt), n in sorted(convs.items(), key=lambda kv: (-kv[0][0][0], kv[0][0][2])):
            h, w, cin = hwc
            p = C.wgrad_plan(b, h, w, cin, cout, getattr(torch, dt), sms=sms)
            if p.variant != "tc":
                continue
            x, g = inputs(b, hwc, cout, dt, gen)
            u = C.wgrad_plan(b, h, w, cin, cout, x.dtype, None, None, sms, 1)
            dw = torch.empty((3, 3, cin, cout), device="cuda")
            ws = torch.empty(max(u.workspace_bytes // 4, 1), device="cuda")

            def unpaired():
                rc = lib.conv3x3_wgrad_tc(x.data_ptr(), g.data_ptr(), dw.data_ptr(), ws.data_ptr(),
                                          b, h, w, cin, cout, *u.box, u.splits, 1,
                                          torch.cuda.current_stream().cuda_stream)
                _build.check(rc, "conv3x3 weight grad (tc, unpaired)")

            unpaired()
            checked(dw, x, g, f"tc unpaired {(b,) + hwc}->{cout}")
            checked(C.conv3x3_weight_grad(x, g), x, g, f"tc {(b,) + hwc}->{cout}")
            reps = 5 if b * h * w >= 65536 else 20
            paired = lambda: C.conv3x3_weight_grad(x, g)      # noqa: E731
            t = [CS.time_ms(fn, reps) for fn in (paired, unpaired, unpaired, paired)]
            tp, tu = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            tot["paired"] += n * tp
            tot["unpaired"] += n * tu
            CS.log(f"  pairs b{b} {str(hwc) + '->' + str(cout):>22} x{n:<2} planned {p.splits}/"
                   f"{p.cluster} {t[0]:.4f} {t[3]:.4f} ms | unpaired {u.splits}/1 {t[1]:.4f} "
                   f"{t[2]:.4f} ms")
        CS.log(f"tc per batch-{b} backward: planned {tot['paired']:.4f} ms, unpaired "
               f"{tot['unpaired']:.4f} ms ({tot['unpaired'] / tot['paired']:.3f}x)")
        sums[f"tc_b{b}"] = tot


def narrow(convs, gen, sums):
    """The narrow kernels as planned against tiles grown to at most NARROW_CAP splits."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    lib, sms = _build.library(), C.device_sms(torch.device("cuda"))
    for b in (CS.TRAIN_BATCH, 1):
        tot = dict.fromkeys(("planned", "capped"), 0.0)
        for (hwc, cout, dt), n in convs.items():
            h, w, cin = hwc
            p = C.wgrad_plan(b, h, w, cin, cout, getattr(torch, dt), sms=sms)
            if not p.variant.startswith("narrow"):
                continue
            x, g = inputs(b, hwc, cout, dt, gen)
            rows, cols = p.box
            while b * -(-h // rows) * -(-w // cols) > NARROW_CAP:
                rows += 4
            splits = b * -(-h // rows) * -(-w // cols)
            dw = torch.empty((3, 3, cin, cout), device="cuda")
            ws = torch.empty(splits * 9 * cin * cout, device="cuda")

            def capped():
                rc = lib.conv3x3_wgrad_narrow(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                                              ws.data_ptr(), b, h, w, cin, cout,
                                              int(x.dtype == torch.bfloat16),
                                              int(p.variant == "narrow_out"), rows, cols, splits,
                                              torch.cuda.current_stream().cuda_stream)
                _build.check(rc, f"conv3x3 weight grad ({p.variant}, capped)")

            capped()
            checked(dw, x, g, f"{p.variant} capped {(b,) + hwc}->{cout}")
            planned = lambda: C.conv3x3_weight_grad(x, g)      # noqa: E731
            t = [CS.time_ms(fn, 5) for fn in (planned, capped, capped, planned)]
            tot["planned"] += n * (t[0] + t[3]) / 2
            tot["capped"] += n * (t[1] + t[2]) / 2
            CS.log(f"  narrow b{b} {p.variant:>10} {dt:>8}: planned {p.box} {p.splits} splits "
                   f"{t[0]:.4f} {t[3]:.4f} ms | ({rows}, {cols}) {splits} splits {t[1]:.4f} "
                   f"{t[2]:.4f} ms")
        CS.log(f"stem + final conv per batch-{b} backward: planned {tot['planned']:.4f} ms, at most "
               f"{NARROW_CAP} splits {tot['capped']:.4f} ms")
        sums[f"narrow_b{b}"] = tot


def host(model, gen, sums):
    """Host us per conv3x3 call beside F.conv2d, and the UNet forward's wall and device ms."""
    import torch
    import torch.nn.functional as F

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    x, wt, bias = CS.conv_inputs((1, 8, 8, 512), 512, "bfloat16", gen)
    xl = x.permute(0, 3, 1, 2)
    wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if hasattr(C, "device_sms"):     # the plan lookup as `_launch` makes it
        lookup = lambda: C.plan(1, 8, 8, 512, 512, x.dtype, None, None, C.device_sms(x.device))  # noqa: E731
    else:
        lookup = lambda: C.plan(1, 8, 8, 512, 512, x.dtype, None, None)  # noqa: E731
    us = {name: CS.host_us(fn, 200) for name, fn in (
        ("conv3x3", lambda: C.conv3x3(x, wt, bias)),
        ("F.conv2d", lambda: F.conv2d(xl, wl, bias.to(x.dtype), padding=1)),
        ("plan", lookup))}
    xu = torch.randn((1, 256, 256, 1), generator=gen, device="cuda") * 10.0
    t = torch.full((1,), 0.5, device="cuda")
    with torch.no_grad():
        fwd = CS.wall_ms(lambda: model(xu, t), 10)
        dev = CS.time_ms(lambda: model(xu, t), 10)
    CS.log(f"host us per call at (1, 8, 8, 512)->512: conv3x3 {us['conv3x3']:.1f}, F.conv2d "
           f"{us['F.conv2d']:.1f}, of conv3x3 the plan lookup {us['plan']:.2f}; UNet 256² forward "
           f"{fwd:.2f} ms wall, {dev:.2f} ms device")
    sums["host"] = dict(us, unet_wall_ms=fwd, unet_device_ms=dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="pairs,narrow,host",
                    help="comma-separated parts to run: pairs, narrow, host")
    ap.add_argument("--root", default=CS.REPO,
                    help="the checkout whose port to time (default: this one)")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= {"pairs", "narrow", "host"}:
        raise SystemExit(f"wgrad_probe: unknown parts in {args.parts!r}")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wgrad_probe: torch.cuda.is_available() is false; this script needs the card")
    CS.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    sys.path.insert(0, os.path.abspath(args.root))
    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config

    CS.log(f"port from {F.__file__}")
    config = get_config("vesde")
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    model, _, _ = F.get_standard_score(config, F.get_standard_sde(config), ckpt_path=CS.CKPT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {}
    convs = traced_convs(model) if {"pairs", "narrow"} & set(parts) else {}
    for part in parts:
        {"pairs": lambda: pairs(convs, gen, sums), "narrow": lambda: narrow(convs, gen, sums),
         "host": lambda: host(model, gen, sums)}[part]()
    print(json.dumps(sums))


if __name__ == "__main__":
    main()
