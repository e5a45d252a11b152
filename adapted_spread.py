#!/usr/bin/env python3
"""Spread of the adapted protocol's PSNR under the attention backward's rounding.

Runs the LoRA-adapted DDS of `chip_smoke.py` phase 7 (50 outer x 10 inner
Adam steps, rank 4, lr 1e-3, TV 1e-6, eta 0.85, cg(1), add_cg; val image 0
and the OOD bars phantom, with the same data, noise and LoRA seeds) once per
attention backward, all else equal:

- `mma`: csrc/attention_bwd_mma.cu, the path's kernel (P and dS rounded to
  bf16 where they feed a product);
- `simt`: csrc/attention_bwd.cu, the earlier kernel (fp32 throughout);
- `plain`: `attention_backward_reference` in PyTorch (fp32, one rounding);
- `mma32`: the `mma` kernel with 32-row chunks wherever the plan takes 64
  or 16: the same roundings, its partial sums in another order;
- `emulated`: `attention_backward_mma_tiled_reference` on the card, the
  `mma` kernel's roundings in PyTorch's fp32 matrix products.

The gradients differ in their last bits only; the forward, the conv
kernels and everything else are the same launches.  What each run's PSNR
moves by is the protocol's sensitivity to that rounding.  Prints one line
per run and, last, a JSON summary.  Needs one CUDA card.

Usage: python3 adapted_spread.py [--adapt-steps N] [--backwards mma,simt,plain,mma32,emulated]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import chip_smoke as CS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--adapt-steps", type=int, default=CS.ADAPT_PROTOCOL_STEPS)
    ap.add_argument("--backwards", default="mma,simt,plain")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("adapted_spread: torch.cuda.is_available() is false; this script needs the card")
    sys.path.insert(0, CS.REPO)
    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM

    config = get_config("vesde")
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    config.data.part = "val"
    sde = F.get_standard_sde(config)
    model, _, _ = F.get_standard_score(config, sde, ckpt_path=CS.CKPT, lora_rank=CS.LORA_RANK)
    trafo = F.get_standard_ray_trafo(config)
    images = np.load(CS.VALSET)["images"]
    phantoms = CS.adapted_phantoms(images)
    launch = A.attention_backward
    runs = []
    for which in args.backwards.split(","):
        def forced(q, k, v, out, dout, lse=None, use_kernel=True, *, variant=None, tile=None,
                   which=which):
            if which == "plain":
                return launch(q, k, v, out, dout, lse, use_kernel=False)
            if which == "mma32":
                return launch(q, k, v, out, dout, lse, use_kernel, tile=32)
            if which == "emulated":
                p = A.backward_plan(*q.shape, q.dtype)
                return A.attention_backward_mma_tiled_reference(q, k, v, out, dout, lse, p)
            return launch(q, k, v, out, dout, lse, use_kernel, variant=which)

        A.attention_backward = forced      # the autograd Function's backward calls this name
        for i, (what, img) in enumerate(phantoms):
            g = torch.Generator(device="cuda").manual_seed(config.seed + 100 + i)
            gt, obs, fbp = F.get_data_from_ground_truth(img, trafo, config.data.stddev, generator=g)
            sampler = CS.adapted_sampler(F, model, sde, trafo, obs, gt, args.adapt_steps, i)
            CS.reset_counts()
            ts = time.perf_counter()
            xa, _ = sampler.sample(generator=g, return_trace=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - ts
            counts = CS.read_counts()
            r = np.clip(xa[0, ..., 0].float().cpu().numpy(), 0, 1)
            g_np, f_np = gt[0, ..., 0].cpu().numpy(), fbp[0, ..., 0].cpu().numpy()
            if not np.isfinite(r).all():
                raise AssertionError(f"{which} {what}: reconstruction not finite")
            row = {"backward": which, "image": what, "psnr": PSNR(r, g_np), "ssim": SSIM(r, g_np),
                   "fbp_psnr": PSNR(f_np, g_np), "seconds": wall,
                   "attn_bwd_by": counts["attn_bwd_by"]}
            runs.append(row)
            CS.log(json.dumps(row))
    A.attention_backward = launch
    smi = CS.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    summary = {}
    for what, _ in phantoms:
        psnr = {row["backward"]: row["psnr"] for row in runs if row["image"] == what}
        summary[what] = {"psnr": psnr, "spread_db": max(psnr.values()) - min(psnr.values())}
    CS.log(smi.splitlines()[0])
    print(json.dumps({"adapt_steps": args.adapt_steps, "spread": summary,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    os.chdir(CS.REPO)
    main()
