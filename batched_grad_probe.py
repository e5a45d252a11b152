#!/usr/bin/env python3
"""How steady the bf16 gradient gates of `chip_smoke.py` are, on one CUDA
card: over draws of their inputs, and over repeats on the same inputs.

- `seeds`: `chip_smoke.batched_gradient_check` (phase 11c) takes the
  full-width gradient of the batched LoRA adaptation loss for val images 0
  and 1 (bf16 with the kernels, bf16 plain, fp32 with the kernels) and
  holds each image's rows to phase 5's gates against the image's serial
  fp32 gradient.  Its noised states and its LoRA up-projections come from
  the generator it is given, which in `chip_smoke.py` is the one every
  earlier phase draws from.  This part runs the check with that generator
  seeded 0, 1, ..., N - 1 and prints, per seed, the check's own lines (each
  gate's reading) and whether every gate held, without stopping at a
  failed one (about 20 s of command a seed).
- `repeats`: phase 5's adaptation-loss gradient (val image 0, t = 0.5,
  every LoRA up-projection drawn nonzero) taken `--repeats` times on the
  same inputs in each of the four forms that phase 5's gates compare (bf16
  with the kernels, bf16 plain, fp32 plain, fp32 with the kernels): per
  form, whether every repeat gives the same bits and the largest
  |g_i - g_1| / |g_1| (2-norms) over leaves and repeats; then each form
  once more under `torch.use_deterministic_algorithms(True,
  warn_only=True)`, naming the operations torch reports as
  nondeterministic.

Last a JSON line of the results.  With `--root DIR` it runs the port and
`chip_smoke.py` of another checkout, for example the parent commit
unpacked with `git archive` (its VESDE checkpoint linked in), so that two
versions compare on one card.

Usage: python3 batched_grad_probe.py [--parts seeds,repeats] [--seeds N] [--repeats N]
       [--root DIR]
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))


def repeats(CS, F, config, config32, sde, trafo, images, n):
    """Phase 5's four gradients, each `n` times on the same inputs, then once
    under torch's deterministic-algorithms check; returns the readings."""
    import torch

    gt, obs, _ = F.get_data_from_ground_truth(
        images[0], trafo, config.data.stddev,
        generator=torch.Generator(device="cuda").manual_seed(config.seed))
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = {"bf16": F.get_standard_score(config, sde, ckpt_path=CS.CKPT,
                                           lora_rank=CS.LORA_RANK)[0],
              "fp32": F.get_standard_score(config32, sde, ckpt_path=CS.CKPT,
                                           lora_rank=CS.LORA_RANK)[0]}
    samplers = {name: F.get_standard_adapted_sampler(
        "dds", m, sde, trafo, obs, num_steps=50, lora_rank=CS.LORA_RANK, add_cg=True, cg_iter=1,
        dc_type="cg", tv_penalty=1e-6, lr=1e-3) for name, m in models.items()}
    lora = {k: (v if k.endswith(".down") else 0.01 * torch.randn(v.shape, generator=gen,
                                                                   device="cuda"))
            for k, v in samplers["bf16"].lora.items()}
    for smp in samplers.values():
        smp.lora = lora
    t = torch.full((1,), 0.5, device="cuda")
    x = gt + sde.marginal_prob_std(t).reshape(1, 1, 1, 1) * torch.randn(
        gt.shape, generator=gen, device="cuda")
    out = {}
    for form, (dt, kernel) in {"bf16 kernels": ("bf16", True), "bf16 plain": ("bf16", False),
                               "fp32 plain": ("fp32", False),
                               "fp32 kernels": ("fp32", True)}.items():
        runs = [CS.adaptation_gradients(samplers[dt], x, t, kernel)[1] for _ in range(n)]
        same = all(torch.equal(r[k], runs[0][k]) for r in runs[1:] for k in runs[0])
        spread = max([CS.lora_leaf_errors(r, runs[0])[1] for r in runs[1:]] or [0.0])
        worst = max([max(CS.lora_leaf_errors(r, runs[0])[0].values()) for r in runs[1:]] or [0.0])
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                CS.adaptation_gradients(samplers[dt], x, t, kernel)
        finally:
            torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message).split(" does not have a deterministic")[0]
                          for w in caught if "deterministic" in str(w.message)})
        out[form] = {"same_bits": same, "spread_all_leaves": spread, "spread_worst_leaf": worst,
                     "nondeterministic_ops": flagged}
        print(f"{form}: {n} repeats, the same bits {same}; |g_i - g_1| / |g_1| over all leaves "
              f"{spread:.3e}, worst leaf {worst:.3e}; torch flags as nondeterministic: "
              f"{flagged or 'none'}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="seeds,repeats")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--root", default=REPO, help="the checkout whose port and chip_smoke.py run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("batched_grad_probe: torch.cuda.is_available() is false; this script "
                         "needs the card")
    import chip_smoke as CS
    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"port and chip_smoke.py of {os.path.abspath(CS.REPO)}", flush=True)
    config = get_config("vesde")                   # as chip_smoke.py's main sets it up
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    config.data.part = "val"
    config32 = copy.deepcopy(config)
    config32.model.dtype = "float32"
    sde = F.get_standard_sde(config)
    trafo = F.get_standard_ray_trafo(config)
    images = np.load(CS.VALSET)["images"]
    parts = set(args.parts.split(","))
    result = {"root": os.path.abspath(CS.REPO)}
    if "repeats" in parts:
        result["repeats"] = repeats(CS, F, config, config32, sde, trafo, images, args.repeats)
    held = []
    for seed in range(args.seeds if "seeds" in parts else 0):
        print(f"seed {seed}:", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        try:
            CS.batched_gradient_check(F, config, config32, sde, trafo, images, gen)
            held.append(True)
        except AssertionError as err:          # the check's gate failed: record it, go on
            print(f"  seed {seed}: a gate failed: {err}", flush=True)
            held.append(False)
    if "seeds" in parts:
        result.update(seeds=args.seeds, held=held)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
