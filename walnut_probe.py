#!/usr/bin/env python3
"""Probe of chip_smoke.py's walnut and AAPM phases (12, 12b, 13) alone, on the card.

Builds the kernels, loads the shipped VESDE prior and runs `walnut_phase`
(without its quality gates) and `aapm_phase` of chip_smoke.py at the given
depths, then prints each walnut DDS's margin over FDK and each AAPM run's
over FBP: `chip_smoke.py`'s `WALNUT_MARGIN_DB` and `WALNUT_AGREE_DB` are
set from such a probe before a full run.

    python3 walnut_probe.py [--walnut-steps N] [--aapm-steps N] [--skip-aapm]

About 5 minutes of command at the defaults (1000 steps each).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walnut-steps", type=int, default=1000)
    ap.add_argument("--aapm-steps", type=int, default=1000)
    ap.add_argument("--skip-aapm", action="store_true", help="run the walnut phases only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("walnut_probe: torch.cuda.is_available() is false; this script needs the card")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import chip_smoke as CS
    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.ops import _build
    from diffusion_models_dev_project_tpu_torch.sampling import predictors as P

    t_all = time.perf_counter()
    smi = CS.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    CS.log(smi.splitlines()[0])
    _build.library()
    CS.log(f"kernels built in {_build.build_seconds:.1f} s")
    config = get_config("vesde")
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    config.data.part = "val"
    config32 = copy.deepcopy(config)
    config32.model.dtype = "float32"
    sde = F.get_standard_sde(config)
    _, _, score_fn = F.get_standard_score(config, sde, ckpt_path=CS.CKPT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model_args = (config, config32, sde, score_fn)
    walnut = CS.walnut_phase(F, P, model_args, args.walnut_steps, gen, gate=False)
    margins = {m: r["psnr"] - walnut["fdk"][0] for m, r in walnut["dds"].items()}
    summary = {"walnut_steps": args.walnut_steps, "fdk_db": walnut["fdk"][0],
               "walnut_dds_db": {m: r["psnr"] for m, r in walnut["dds"].items()},
               "walnut_margin_db": margins, "adapted_db": walnut["adapted"]["psnr"],
               "plain_matched_db": walnut["plain_matched"][0]}
    if not args.skip_aapm:
        workdir = os.path.join(repo, "build", "walnut_probe_cli")
        aapm = CS.aapm_phase(F, P, model_args, args.aapm_steps, gen, workdir)
        CS.shutil.rmtree(workdir, ignore_errors=True)
        summary.update(aapm_steps=args.aapm_steps,
                       aapm_cli_margin_db=aapm["cli"]["psnr"] - aapm["cli"]["fbp"][0],
                       matrix_margin_db=aapm["matrix"]["psnr"] - aapm["matrix"]["fbp"][0])
    CS.log(f"whole probe {time.perf_counter() - t_all:.1f} s; {smi.splitlines()[0]}")
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
