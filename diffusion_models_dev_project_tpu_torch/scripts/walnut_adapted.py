"""Adapted (steerable-LoRA) sampling on the walnut cone-beam protocol
(counterpart of the repository's `scripts/walnut_adapted.py`, with its
flags, defaults and printed lines).

A synthetic stand-in for the measured CWI data: the observation is
`walnut_phantom(501)` on the 256² model grid pushed through the
protocol-scale dense cone-beam operator (the synthetic centred orbit of
`_walnut_common.py`, 60 angles x 128 columns) plus 5% noise.  The
ellipse-trained 256² prior is steered on it with a LoRA per image: 50 outer
DDS steps, each after 10 Adam steps on the LoRA leaves (rank 4, lr 1e-3,
TV 1e-6) of the loss through CG(5) data consistency (`--dc_type cg
--cg_iter 5`).  As in the JAX script, the outer step itself runs no CG
(`add_cg` stays at the factory's default, off).  The operator and its
`.mat` are shared with `walnut_full_scale` through `--workdir`.

    python -m diffusion_models_dev_project_tpu_torch.scripts.walnut_adapted \\
        --ckpt checkpoints/flagship_ddpm_256_ema.msgpack.npz [--lr 2e-4]

runs on the card; `--device cpu` runs the plain PyTorch path on the CPU.
The prior loads as `walnut_full_scale.load_prior` loads it (bf16 compute,
fp32 LoRA leaves).  The LoRA is drawn from `lora_seed` 0, JAX's values for
that seed (`sampling/adaptation.py::init_lora`).  Seeds: the observation
noise from a generator seeded 3, the chain's draws from one seeded
`--seed` (7), where the JAX script uses `PRNGKey(3)` and `PRNGKey(7)`;
JAX's draws cannot be reproduced in torch, so readings on the card are
compared with the JAX records, not bit for bit.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ._walnut_common import CWI, WalnutProtocol

parser = argparse.ArgumentParser(description="adapted (LoRA) sampling on the walnut protocol")
parser.add_argument("--ckpt", required=True, help="the ellipse-trained 256² prior (*.msgpack.npz)")
parser.add_argument("--sde", default="ddpm", choices=["vesde", "ddpm"])
parser.add_argument("--num_channels", default=128, type=int)
parser.add_argument("--num_steps", default=50, type=int,
                    help="adapted protocol default (reference run_adapted_sampling.py:21)")
parser.add_argument("--num_optim_step", default=10, type=int)
parser.add_argument("--lora_rank", default=4, type=int)
parser.add_argument("--lr", default=1e-3, type=float)
parser.add_argument("--gamma", default=0.01, type=float)
parser.add_argument("--eta", default=0.85, type=float)
parser.add_argument("--dc_type", default="cg")
parser.add_argument("--cg_iter", default=5, type=int)
parser.add_argument("--tv_penalty", default=1e-6, type=float)
parser.add_argument("--workdir", default="outputs/walnut_full",
                    help="shares the assembled .mat with walnut_full_scale")
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")
parser.add_argument("--seed", default=7, type=int,
                    help="the chain's generator seed (the JAX script's PRNGKey(7))")


def adapted_sampler(args, model, sde, rt, obs, x_model):
    """The JAX script's sampler: `add_cg` at the factory's default (off),
    the ground truth passed, the LoRA drawn from `lora_seed` 0."""
    from .. import factory as F

    return F.get_standard_adapted_sampler(
        "dds", model, sde, rt, obs,
        num_steps=args.num_steps, eta=args.eta, gamma=args.gamma,
        tv_penalty=args.tv_penalty, lr=args.lr,
        num_optim_step=args.num_optim_step, lora_rank=args.lora_rank,
        dc_type=args.dc_type, cg_iter=args.cg_iter,
        ground_truth=x_model, lora_seed=0)


def main(argv=None, protocol: WalnutProtocol = CWI, size: int = 256) -> dict:
    """Run the adapted reconstruction of `argv` (default: the command line)
    for `protocol` on a `size`² model grid.  Returns `fdk_psnr`, the clamped
    reconstruction `recon`, its `psnr` and `ssim`, and the chain's
    `seconds`."""
    from ..utils.device import resolve_device, synchronize
    from ..utils.metrics import PSNR, SSIM
    from ._walnut_common import build_walnut_trafo
    from .walnut_full_scale import load_prior, model_ground_truth, observe

    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)

    t0 = time.time()
    rt = build_walnut_trafo(args.workdir, impl="dense", new_shape=(size, size), device=device,
                            protocol=protocol)
    print(f"[dense] walnut operator ready in {time.time() - t0:.1f}s "
          f"({tuple(rt.matrix.shape)})", flush=True)

    x_model = model_ground_truth(protocol, size, device)
    gt_model = x_model[0, :, :, 0].cpu().numpy()
    with torch.no_grad():
        obs = observe(x_model, rt, device)         # walnut stddev
        fdk = rt.fbp(obs)
    p_fdk = PSNR(fdk[0, :, :, 0].cpu().numpy(), gt_model)
    print(f"FDK baseline: {p_fdk:.2f} dB", flush=True)

    _, sde, model = load_prior(args, size, device, lora_rank=args.lora_rank)
    sampler = adapted_sampler(args, model, sde, rt, obs, x_model)
    g = torch.Generator(device=device).manual_seed(args.seed)
    synchronize(device)
    t0 = time.time()
    x, _ = sampler.sample(generator=g)
    synchronize(device)
    x = np.clip(x[0, :, :, 0].float().cpu().numpy(), 0, 1)
    dt = time.time() - t0
    p, s = PSNR(x, gt_model), SSIM(x, gt_model)
    print(f"[adapted dds eta={args.eta}] walnut steered reconstruction: "
          f"{p:.2f} dB / {s:.4f} SSIM in {dt:.1f}s "
          f"({args.num_steps} steps x {args.num_optim_step} optim, "
          f"LoRA r={args.lora_rank})  vs FDK {p_fdk:.2f} dB", flush=True)
    np.savez(os.path.join(args.workdir, f"adapted_recon_eta{args.eta}.npz"),
             recon=x, gt=gt_model, psnr=p, ssim=s, eta=args.eta,
             lora_rank=args.lora_rank, num_steps=args.num_steps,
             num_optim_step=args.num_optim_step)
    return dict(fdk_psnr=p_fdk, recon=x, psnr=p, ssim=s, seconds=dt)


if __name__ == "__main__":
    main()
