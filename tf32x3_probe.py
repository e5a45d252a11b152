#!/usr/bin/env python3
"""Times the port's fp32 conv3x3 route (`tf32x3`) on one CUDA card, builds
variants of its weight-gradient kernel side by side, and checks and times
the fp32 attention route (`tf32x3`).

    python3 tf32x3_probe.py [--parts route,wgrad_variants,attention,attention_blockings]

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
- `attention`: the registers and spills of `csrc/attention_tf32x3.cu` and
  `csrc/attention_bwd_tf32x3.cu`; at the flagship's fp32 attention shapes
  and at shapes off the path (T = 1 to 1024, ragged T, d = 8 to 128, and
  d = 18 and 13 for the scalar loads) the
  forward, its lse2 and dq, dk, dv against the plain versions (max|diff| /
  max|plain| at most 1e-4, bitwise equal over two launches) and against
  their CPU emulations run on the card; then per UNet pass at batch 1 and 3
  (B·heads 8 and 24) forward and backward beside the forced `simt` kernels,
  the plain versions and SDPA in fp32, by CUDA-graph replay.
- `attention_blockings`: the fp32 attention kernels launched directly at
  every blocking they take at the flagship's shapes at batch 1 and 3: the
  forward at 1, 2 or 4 key splits in one or two shared-memory stages, the
  backward at chunks of 16, 32 or 64 rows in one or two stages; each
  checked against the plain version (1e-4) and timed by graph replay.

About a minute of command on an H100, the kernels' build included.  Prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import math
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


# (B·heads, T, d) of the flagship's attention calls per image (3 at the 16²
# map, 1 at 8²) and their count; shapes off the path, checked only
ATTN_PASS = [((8, 256, 64), 3), ((8, 64, 64), 1)]
ATTN_CHECKED = [(8, 1024, 64), (2, 1024, 128), (2, 257, 40), (3, 100, 128), (3, 300, 128),
                (2, 37, 20), (2, 100, 64), (1, 5, 8), (1, 1, 16), (2, 37, 18), (3, 100, 13)]


def attention(A, CS, torch, gen, build):
    import torch.nn.functional as F

    section = ""
    for line in build.build_log.splitlines():
        if line.startswith("=="):
            section = line
        elif "attention_tf32x3" in section or "attention_bwd_tf32x3" in section:
            if "registers" in line or "spill" in line or "entry function" in line:
                print("  " + line.strip())
    worst = collections.defaultdict(float)
    for bh, t, d in [shape for shape, _ in ATTN_PASS] + ATTN_CHECKED:
        q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda") for _ in range(4))
        p, bp = A.plan(bh, t, d, torch.float32), A.backward_plan(bh, t, d, torch.float32)
        out, lse = A.attention_with_lse(q, k, v)
        out2, lse2 = A.attention_with_lse(q, k, v)
        grads = A.attention_backward(q, k, v, out, g, lse)
        grads2 = A.attention_backward(q, k, v, out, g, lse)
        ref, lref = A.attention_reference(q, k, v), A.attention_lse_reference(q, k)
        gref = A.attention_backward_reference(q, k, v, out, g)
        emu, lemu = A.attention_tf32x3_tiled_reference(q, k, v, p, with_lse=True)
        gemu = A.attention_backward_tf32x3_tiled_reference(q, k, v, out, g, lse, bp)
        torch.cuda.synchronize()
        errs = {"out": CS.rel_err(out, ref)[1], "lse2": CS.rel_err(lse, lref)[1]}
        emus = {"out": CS.rel_err(out, emu)[1], "lse2": CS.rel_err(lse, lemu)[1]}
        for name, a, b, c in zip(("dq", "dk", "dv"), grads, gref, gemu):
            # T = 1: dq and dk are 0 in exact arithmetic, rounding noise here
            errs[name] = CS.rel_err(a, b)[0 if t == 1 and name != "dv" else 1]
            emus[name] = CS.rel_err(a, c)[0 if t == 1 and name != "dv" else 1]
        same = (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        ok = same and max(errs.values()) <= CS.TOL["float32"] and all(
            torch.isfinite(a).all() for a in (out, lse, *grads))
        for name, e in errs.items():
            worst[name] = max(worst[name], e)
        print(f"attention tf32x3 {(bh, t, d)} splits {p.key_splits} chunk {bp.tile}: against plain "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) + "; against the emulation "
              + ", ".join(f"{n} {e:.2e}" for n, e in emus.items())
              + f"; {'bitwise equal over two launches' if same else 'TWO LAUNCHES DIFFER'}"
              + ("" if ok else " FAIL"), flush=True)
        if not ok:
            raise SystemExit(f"tf32x3_probe: attention {(bh, t, d)} failed")
    print("attention tf32x3 worst against plain: " + ", ".join(f"{n} {e:.2e}" for n, e in worst.items())
          + f" (tol {CS.TOL['float32']})")
    for batch in (1, 3):
        tot = collections.defaultdict(float)
        for (bh, t, d), n in ATTN_PASS:
            shape = (bh * batch, t, d)
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
            out, lse = A.attention_with_lse(q, k, v)
            q4, k4, v4 = (a.view(1, *shape).detach().requires_grad_() for a in (q, k, v))
            g4 = g.view(1, *shape)
            sdpa_fwd = CS.time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 50)
            sdpa_both = CS.time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), g4), 50)
            row = {"fwd": CS.time_ms(lambda: A.attention(q, k, v), 100),
                   "fwd simt": CS.time_ms(lambda: A.attention(q, k, v, variant="simt"), 50),
                   "fwd plain": CS.time_ms(lambda: A.attention(q, k, v, use_kernel=False), 20),
                   "fwd SDPA": sdpa_fwd,
                   "bwd": CS.time_ms(lambda: A.attention_backward(q, k, v, out, g, lse), 50),
                   "bwd simt": CS.time_ms(lambda: A.attention_backward(q, k, v, out, g,
                                                                       variant="simt"), 20),
                   "bwd plain": CS.time_ms(lambda: A.attention_backward_reference(q, k, v, out, g),
                                           20),
                   "bwd SDPA": sdpa_both - sdpa_fwd}
            print(f"  {shape} x{n}: " + ", ".join(f"{key} {ms:.4f}" for key, ms in row.items()),
                  flush=True)
            for key, ms in row.items():
                tot[key] += n * ms
            tot["flops"] += n * 4.0 * shape[0] * t * t * d
        for part, mul in (("fwd", 1.0), ("bwd", 2.5)):
            fl = mul * tot["flops"]
            print(f"attention per pass at batch {batch}, {part}: tf32x3 {tot[part]:.4f} ms, simt "
                  f"{tot[part + ' simt']:.4f} ({tot[part] / tot[part + ' simt']:.3f}x), plain "
                  f"{tot[part + ' plain']:.4f}, SDPA fp32 {tot[part + ' SDPA']:.4f} "
                  f"({tot[part] / tot[part + ' SDPA']:.3f}x); bounds {3 * fl / 495e9:.5f} (3 TF32 "
                  f"products), {fl / 67e9:.5f} (fp32 cores)", flush=True)


def attention_blockings(A, CS, torch, gen, lib):
    def ok(got, want):
        return all(CS.rel_err(a, b)[1] <= CS.TOL["float32"] for a, b in zip(got, want))

    def stream():          # the current one: `time_ms` captures on a side stream
        return torch.cuda.current_stream().cuda_stream

    for batch in (1, 3):
        for (bh, t, d), n in ATTN_PASS:
            bh *= batch
            q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda") for _ in range(4))
            ref = A.attention_reference(q, k, v)
            out, lse = torch.empty_like(q), torch.empty((bh, t), device="cuda")
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            rows = []
            for splits in (1, 2, 4):
                if splits > -(-t // A.TF32X3_KEY_TILE):
                    continue
                for stages in (1, 2):
                    def fwd(splits=splits, stages=stages):
                        rc = lib.attention_tf32x3_forward(*ptrs, out.data_ptr(), lse.data_ptr(), bh,
                                                          t, d, A.LOG2E / math.sqrt(d), splits,
                                                          stages, stream())
                        if rc:
                            raise RuntimeError(f"attention_tf32x3_forward returned {rc}")
                    fwd()
                    torch.cuda.synchronize()
                    rows.append(f"splits {splits} stages {stages} {CS.time_ms(fwd, 100):.4f}"
                                + ("" if ok([out], [ref]) else " WRONG"))
            print(f"forward {(bh, t, d)} x{n}: " + ", ".join(rows), flush=True)
            gref = A.attention_backward_reference(q, k, v, ref, g)
            o, lse = A.attention_with_lse(q, k, v)
            grads = [torch.empty_like(q) for _ in range(3)]
            delta = torch.empty(bh * t, device="cuda")
            rows = []
            for tile in (16, 32, 64):
                for stages in (1, 2):
                    def bwd(tile=tile, stages=stages):
                        return lib.attention_tf32x3_backward(
                            *ptrs, o.data_ptr(), g.data_ptr(), lse.data_ptr(),
                            *(x.data_ptr() for x in grads), delta.data_ptr(), bh, t, d,
                            A.LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), tile, stages, stream())
                    if bwd():
                        continue                  # a blocking the kernels refuse
                    torch.cuda.synchronize()
                    rows.append(f"chunk {tile} stages {stages} {CS.time_ms(bwd, 50):.4f}"
                                + ("" if ok(grads, gref) else " WRONG"))
            print(f"backward {(bh, t, d)} x{n}: " + ", ".join(rows), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="route,wgrad_variants,attention,attention_blockings")
    parts = set(ap.parse_args().parts.split(","))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tf32x3_probe: torch.cuda.is_available() is false; this script needs the card")
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
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
    if "attention" in parts:
        attention(A, CS, torch, gen, _build)
    if "attention_blockings" in parts:
        attention_blockings(A, CS, torch, gen, _build.library())


if __name__ == "__main__":
    main()
