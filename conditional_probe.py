#!/usr/bin/env python3
"""Conditional chains of the port on the card, under other settings than the CLI's.

Runs the sampling engine (`factory.get_standard_sampler`) with the shipped
VESDE prior (128 channels) on the conditional CLI's data: test-fold
disk-ellipse image 0 generated at 256², 60 angles, noise 0.01, the CLI's
per-image seed for the observation and the chain.  Each run is one
`dtype:method:penalty:pct:num_steps` setting:

- `dtype`: the UNet's, `bfloat16` (the hand kernels' path) or `float32`;
- `method`: `uncond`, `naive` or `dps`;
- `pct`: the part of the chain skipped by starting from the FBP
  (`pct_chain_elapsed`), 0 for a start from the prior.

For each run it prints the PSNR of the clamped reconstruction, its largest
|x|, the FBP's PSNR and the per-step PSNR of x_mean at 0, 10, ..., 100% of
the chain, and a JSON line of all runs last.  What it shows is where the
prior and the precision let the Euler-Maruyama chains reconstruct.  Needs
one CUDA card.

Usage: python3 conditional_probe.py [--runs bfloat16:dps:10:0:1000,float32:uncond:0:0:1000]
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import numpy as np

import chip_smoke as CS

DEFAULT_RUNS = ("bfloat16:uncond:0:0:1000,bfloat16:naive:10:0:1000,bfloat16:dps:10:0:1000,"
                "float32:uncond:0:0:1000,float32:naive:10:0:1000,float32:dps:10:0:1000,"
                "bfloat16:naive:10:0.5:1000,bfloat16:dps:10:0.5:1000")
TRACE_AT = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=DEFAULT_RUNS,
                    help="comma-separated dtype:method:penalty:pct:num_steps settings")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conditional_probe: torch.cuda.is_available() is false; this script needs the card")
    CS.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    sys.path.insert(0, CS.REPO)
    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR

    config = get_config("vesde")
    config.model.num_channels = 128
    sde = F.get_standard_sde(config)
    trafo = F.get_standard_ray_trafo(config)
    image = F.get_standard_dataset(config, trafo)[0]
    seed = config.seed * 1000            # the conditional CLI's seed for image 0
    models, results = {}, []
    for run in args.runs.split(","):
        dtype, method, penalty, pct, steps = run.split(":")
        if dtype not in models:
            c = copy.deepcopy(config)
            c.model.dtype = dtype
            models[dtype] = F.get_standard_score(c, sde, ckpt_path=CS.CKPT)[2]
        g = torch.Generator(device="cuda").manual_seed(seed)
        gt, obs, fbp = F.get_data_from_ground_truth(image, trafo, config.data.stddev, generator=g)
        sampler = F.get_standard_sampler(method, models[dtype], sde, trafo, obs,
                                         num_steps=int(steps), penalty=float(penalty),
                                         pct_chain_elapsed=float(pct), ground_truth=gt,
                                         filtbackproj=fbp)
        t0 = time.perf_counter()
        x, trace = sampler.sample(generator=g, return_trace=True)
        raw = x[0, ..., 0].float().cpu().numpy()
        seconds = time.perf_counter() - t0
        g_np, tr = gt[0, ..., 0].cpu().numpy(), trace.cpu().numpy()
        row = {"run": run, "psnr": PSNR(np.clip(raw, 0, None), g_np),
               "abs_max": float(np.abs(raw).max()), "fbp_psnr": PSNR(fbp[0, ..., 0].cpu().numpy(), g_np),
               "trace": [float(tr[int(f * (len(tr) - 1))]) for f in TRACE_AT], "seconds": seconds}
        results.append(row)
        CS.log(f"{run}: PSNR {row['psnr']:.2f} dB, |x|max {row['abs_max']:.3g}, FBP {row['fbp_psnr']:.2f} "
               f"dB, {seconds:.1f} s; trace at 0..100%: " + " ".join(f"{v:.1f}" for v in row["trace"]))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "runs": results}), flush=True)


if __name__ == "__main__":
    main()
