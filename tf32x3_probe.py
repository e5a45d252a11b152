#!/usr/bin/env python3
"""Times the port's fp32 conv3x3 route (`tf32x3`) on one CUDA card and builds
variants of its weight-gradient kernel side by side.

    python3 tf32x3_probe.py [--parts route,wgrad_variants]

- `route`: at every fp32 conv shape of the flagship UNet whose Cin and Cout
  are multiples of 64 (60 per pass), the forward, the input gradient and the
  weight gradient at batch 3: `tf32x3`, the forced `simt` kernel and cuDNN
  fp32 (TF32 off), by CUDA-graph replay, summed per UNet pass beside the
  bound of three TF32 products (495 TFLOP/s) and of the fp32 CUDA cores (67).
- `wgrad_variants`: `csrc/conv3x3_wgrad_tf32x3.cu` as it is (each operand
  split by clearing low bits, two blocks per SM), with the split rounded to
  nearest (`cvt.rna.tf32.f32`), and with one block per SM; each built with
  nvcc into `build/tf32x3_variants/`, checked against the plain fp32 weight
  gradient (max|diff| / max|plain| at most 1e-4, bitwise equal over two
  launches) and timed per batch-3 UNet backward, with the opcode mix of the
  kernel's SASS.

About a minute of command on an H100, the kernels' build included.  Prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "diffusion_models_dev_project_tpu_torch", "csrc")
# (map side, Cin, Cout, calls per pass) of the flagship's 60 tf32x3 convs
SHAPES = [(256, 128, 128, 6), (256, 256, 128, 2), (128, 128, 128, 6), (128, 256, 256, 2),
          (128, 384, 128, 1), (128, 256, 128, 1), (64, 128, 128, 2), (64, 128, 256, 1),
          (64, 256, 256, 5), (64, 512, 256, 1), (64, 384, 256, 1), (32, 256, 256, 6),
          (32, 512, 512, 2), (32, 768, 256, 1), (32, 512, 256, 1), (16, 256, 256, 2),
          (16, 256, 512, 1), (16, 512, 512, 5), (16, 1024, 512, 1), (16, 768, 512, 1),
          (8, 512, 512, 10), (8, 1024, 512, 2)]
TRUNC = ("  hi = __float_as_uint(v) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;\n")
RNA = ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));\n'
       '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));\n')


def route(C, CS, torch, gen):
    tot = collections.defaultdict(float)
    for hw, cin, cout, n in SHAPES:
        x = torch.randn((1, hw, hw, cin), generator=gen, device="cuda")
        wt = torch.randn((3, 3, cin, cout), generator=gen, device="cuda") / (9 * cin) ** 0.5
        bias = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        g = torch.randn((1, hw, hw, cout), generator=gen, device="cuda")
        x3 = torch.randn((3, hw, hw, cin), generator=gen, device="cuda")
        g3 = 0.1 * torch.randn((3, hw, hw, cout), generator=gen, device="cuda")
        wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        sw, zero = C.swapped_weight(wt), torch.zeros(cin, device="cuda")
        reps = 10 if hw >= 128 else 30
        row = {
            "fwd": CS.time_ms(lambda: C.conv3x3(x, wt, bias), reps),
            "fwd simt": CS.time_ms(lambda: C.conv3x3(x, wt, bias, variant="simt"), 2),
            "fwd cuDNN": CS.time_ms(lambda: torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2), wl, bias, padding=1), reps),
            "igrad": CS.time_ms(lambda: C.conv3x3_input_grad(g, wt), reps),
            "igrad simt": CS.time_ms(lambda: C.conv3x3(g, sw, zero, variant="simt"), 2),
            "igrad cuDNN": CS.time_ms(lambda: torch.nn.grad.conv2d_input(
                (1, cin, hw, hw), wl, g.permute(0, 3, 1, 2), padding=1), reps),
            "wgrad3": CS.time_ms(lambda: C.conv3x3_weight_grad(x3, g3), reps // 2),
            "wgrad3 simt": CS.time_ms(lambda: C.conv3x3_weight_grad(x3, g3, variant="simt"), 2),
            "wgrad3 cuDNN": CS.time_ms(lambda: torch.nn.grad.conv2d_weight(
                x3.permute(0, 3, 1, 2), (cout, cin, 3, 3), g3.permute(0, 3, 1, 2), padding=1),
                reps // 2)}
        flops = 2.0 * hw * hw * 9 * cin * cout
        print(f"({hw}, {hw}, {cin})->{cout} x{n}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
        for k, v in row.items():
            tot[k] += n * v
        tot["flops"] += n * flops
    for part, scale in (("fwd", 1), ("igrad", 1), ("wgrad3", 3)):
        fl = scale * tot["flops"]
        print(f"per pass, {part}: tf32x3 {tot[part]:.3f} ms, simt {tot[part + ' simt']:.3f}, cuDNN fp32 "
              f"{tot[part + ' cuDNN']:.3f}; bounds {3 * fl / 495e9:.3f} (3 TF32 products), "
              f"{fl / 67e9:.3f} (fp32 cores)")


def wgrad_variants(C, CS, torch, gen, build):
    src = open(os.path.join(CSRC, "conv3x3_wgrad_tf32x3.cu")).read()
    lb2, lb1 = "__launch_bounds__(TNT, 2)", "__launch_bounds__(TNT, 1)"
    if TRUNC not in src or lb2 not in src:
        raise SystemExit("tf32x3_probe: the weight-gradient source no longer has the split or the "
                         "launch bounds this probe varies")
    variants = {"as is": src, "rna split": src.replace(TRUNC, RNA),
                "1 block per SM": src.replace(lb2, lb1)}
    out = os.path.join(REPO, "build", "tf32x3_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, text in enumerate(variants.values()):
        path = os.path.join(out, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[i] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-Xptxas", "-v", "-shared", path,
             os.path.join(CSRC, "conv3x3_wgrad.cu"), "-o", os.path.join(out, f"v{i}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for i, name in enumerate(variants):
        log, _ = procs[i].communicate()
        if procs[i].returncode:
            raise SystemExit(f"tf32x3_probe: nvcc failed on {name}:\n{log}")
        regs = re.findall(r"wgrad_tf32x3_kernel.*\n\s*(\d+ bytes stack frame.*)\n.*Used (\d+) registers", log)
        print(f"{name}: {regs}")
        fn = ctypes.CDLL(os.path.join(out, f"v{i}.so")).conv3x3_wgrad_tf32x3
        fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
        fn.restype = ctypes.c_int
        fns[name] = fn
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for i, name in list(enumerate(variants))[:2]:
        sass = subprocess.run([tool, "-sass", os.path.join(out, f"v{i}.so")], check=True,
                              capture_output=True, text=True).stdout
        body = next(p for p in sass.split("Function :") if "wgrad_tf32x3_kernel" in p.split("\n", 1)[0])
        ops = collections.Counter(re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body))
        print(f"{name}: {sum(ops.values())} SASS instructions, of them "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(12)))

    def call(fn, x, g):
        b, h, w, cin = x.shape
        cout = g.shape[-1]
        p = C.wgrad_plan(b, h, w, cin, cout, torch.float32, "tf32x3")
        dw = torch.empty((3, 3, cin, cout), device="cuda")
        ws = torch.empty(max(p.workspace_bytes // 4, 1), device="cuda")
        rc = fn(x.data_ptr(), g.data_ptr(), dw.data_ptr(), ws.data_ptr(), b, h, w, cin, cout,
                p.splits, p.steps_per_split, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"conv3x3_wgrad_tf32x3 returned {rc}")
        return dw

    tot = collections.defaultdict(float)
    for hw, cin, cout, n in SHAPES:
        x = torch.randn((3, hw, hw, cin), generator=gen, device="cuda")
        g = 0.1 * torch.randn((3, hw, hw, cout), generator=gen, device="cuda")
        ref = C.conv3x3_weight_grad_reference(x, g)
        for name, fn in fns.items():
            a, b = call(fn, x, g), call(fn, x, g)
            torch.cuda.synchronize()
            r = CS.rel_err(a, ref)[1]
            if not (r <= 1e-4 and torch.equal(a, b)):
                raise SystemExit(f"tf32x3_probe: {name} at {(3, hw, hw, cin)}->{cout}: rel err {r:.2e}")
            tot[name] += n * CS.time_ms(lambda: call(fn, x, g), 5 if hw >= 128 else 20)
    print("weight grad per batch-3 backward, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="route,wgrad_variants")
    parts = set(ap.parse_args().parts.split(","))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tf32x3_probe: torch.cuda.is_available() is false; this script needs the card")
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "route" in parts:
        route(C, CS, torch, gen)
    if "wgrad_variants" in parts:
        wgrad_variants(C, CS, torch, gen, _build)


if __name__ == "__main__":
    main()
