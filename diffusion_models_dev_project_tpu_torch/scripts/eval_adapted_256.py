"""Adapted (steerable) sampling of the port at the flagship 256² protocol:
in distribution (the shipped val set) and out of it (bar and block
phantoms, far off the ellipse manifold), with the 256² prior.

Counterpart of the repository's `scripts/eval_adapted_256.py`, with its
flags, defaults and printed lines: per case

    [name] FBP xx.xx | DDS(1000, eta=0.85) xx.xx/0.xxx | adapted(lora) xx.xx/0.xxx  (t s)

then the in-distribution and OOD means.  The adapted defaults are the
reference's (50 outer x 10 inner Adam steps, LoRA rank 4, lr 1e-3, TV
1e-6, η 0.85, cg(1) data consistency, add_cg); plain DDS runs the
1000-step conditional protocol (γ 0.01, cg_iter 5) on the model without
LoRA for comparison, and FBP is the classical baseline.

    python -m diffusion_models_dev_project_tpu_torch.scripts.eval_adapted_256 \\
        --ckpt checkpoints/flagship_vesde_256_ema.msgpack.npz [--num_in_dist 3] [--num_ood 3]

runs on the card; `--device cpu` runs the plain PyTorch path on the CPU
(the JAX script's `--platform cpu`).  The cases: val images 0 .. n-1
(index i), the bars phantom (`ood_bars`, index 100), then block phantoms
(`ood_grid` of seed 17 + k, index 101 + k).  Case `idx` draws its
observation noise from a generator seeded from (seed, idx, 0) and both
chains, DDS's and the adapted one's, from (seed, idx, 1)
(`physics/simulation.py::seed_of`; JAX folds idx into the config seed's
key, then 1 into that key).  A fresh LoRA is drawn per case from
`lora_seed = idx`; `full` and `decoder` build a fresh sampler per case.
The weights are held as the JAX script holds its fp32 tree
(`eval_flagship_256.load_model`, `float32`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description="adapted sampling at the flagship 256² protocol")
parser.add_argument("--ckpt", required=True)
parser.add_argument("--num_channels", default=128, type=int)
parser.add_argument("--num_in_dist", default=3, type=int)
parser.add_argument("--num_ood", default=3, type=int)
parser.add_argument("--adaptation", default="lora", choices=["lora", "full", "decoder"])
parser.add_argument("--num_steps", default=50, type=int)
parser.add_argument("--num_optim_step", default=10, type=int)
parser.add_argument("--lora_rank", default=4, type=int)
parser.add_argument("--lr", default=1e-3, type=float)
parser.add_argument("--tv_penalty", default=1e-6, type=float)
parser.add_argument("--eta", default=0.85, type=float)
parser.add_argument("--dds_steps", default=1000, type=int)
parser.add_argument("--dds_eta", default=0.85, type=float)
parser.add_argument("--save_npz", default=None)
parser.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")


def ood_bars(im: int) -> np.ndarray:
    """Rectangular bars + frame (the JAX package's `demo_adapted_ood.ood_phantom`)."""
    x = np.zeros((im, im), np.float32)
    q = im // 8
    for i in range(1, 4):
        x[2 * i * q - q // 2:2 * i * q + q // 2, q:im - q] = 0.4 + 0.2 * i
    x[q:im - q, q:q + im // 32] = 1.0
    x[q:im - q, im - q - im // 32:im - q] = 1.0
    return x


def ood_grid(im: int, seed: int) -> np.ndarray:
    """Checkerboard-ish block phantom, value pattern seeded per image."""
    rng = np.random.default_rng(seed)
    x = np.zeros((im, im), np.float32)
    n = 6
    cell = im // (n + 2)
    for i in range(n):
        for j in range(n):
            if rng.random() < 0.55:
                r0 = cell + i * cell
                c0 = cell + j * cell
                x[r0 + 2:r0 + cell - 2, c0 + 2:c0 + cell - 2] = rng.uniform(0.3, 1.0)
    return x


def cases(dataset, num_in_dist: int, num_ood: int, im: int = 256):
    """(name, NHWC ground truth (im, im, 1), idx) of each case, in order."""
    out = []
    for i, gt in enumerate(dataset):
        if i >= num_in_dist:
            break
        out.append((f"in-dist val[{i}]", np.asarray(gt), i))
    if num_ood >= 1:
        out.append(("OOD bars", ood_bars(im)[..., None], 100))
    for k in range(num_ood - 1):
        out.append((f"OOD blocks[{k}]", ood_grid(im, 17 + k)[..., None], 101 + k))
    return out


def evaluate(args, sde, model, trafo, case_list, seed: int, stddev: float, device,
             draws=None) -> list:
    """Plain DDS and adapted sampling of each case, with the JAX script's
    printed lines.  `draws(idx)`, when given, returns case idx's
    standard-normal draws (the observation's, the DDS chain's list, the
    adapted chain's list) in place of the generators: parity tests inject
    JAX's this way.  Returns a dict per case: `name`, the PSNRs `fbp`,
    `dds`, `adapted`, the SSIMs `dds_ssim`, `adapted_ssim`, the clipped
    reconstructions `x_dds`, `x_adapted`, the ground truth `gt` and the
    adapted run's `seconds`."""
    from .. import factory as F
    from ..physics.simulation import seed_of
    from ..sampling.adaptation import init_lora
    from ..utils.metrics import PSNR, SSIM
    from ..utils.device import synchronize

    def generator(*path):
        return torch.Generator(device=device).manual_seed(seed_of(*path))

    def as_list(noises):
        return None if noises is None else [torch.as_tensor(a, device=device) for a in noises]

    lora = args.adaptation == "lora"
    im_shape = tuple(case_list[0][1].shape)
    dds_sampler = ad_sampler = None
    rows = []
    for name, gt, idx in case_list:
        obs_noise, dds_noises, ad_noises = (None,) * 3 if draws is None else draws(idx)
        gt, obs, fbp = F.get_data_from_ground_truth(
            gt, trafo, stddev, generator=None if draws else generator(seed, idx, 0),
            noise=None if obs_noise is None else torch.as_tensor(obs_noise, device=device))
        g = gt[0, ..., 0].cpu().numpy()

        if dds_sampler is None:
            # the prior: a LoRA model at lora_scale 0 skips its branches
            dds_sampler = F.get_standard_sampler(
                "dds", lambda x, t: model(x, t, lora_scale=0.0), sde, trafo, obs,
                num_steps=args.dds_steps, im_shape=im_shape, gamma=0.01, eta=args.dds_eta,
                cg_iter=5)
        else:
            dds_sampler.observation = obs
            dds_sampler.rhs = trafo.adjoint(obs)
        x_dds, _ = dds_sampler.sample(generator=None if draws else generator(seed, idx, 1),
                                      noises=as_list(dds_noises))
        x_dds = np.clip(x_dds[0, ..., 0].float().cpu().numpy(), 0, 1)

        synchronize(device)
        t0 = time.time()
        if ad_sampler is None or not lora:
            # full and decoder adapt the base weights: a fresh sampler per case
            ad_sampler = F.get_standard_adapted_sampler(
                "dds", model, sde, trafo, obs, num_steps=args.num_steps, im_shape=im_shape,
                num_optim_step=args.num_optim_step, adapt_freq=1, lr=args.lr,
                tv_penalty=args.tv_penalty, eta=args.eta, gamma=0.01, dc_type="cg", cg_iter=1,
                add_cg=True, lora_rank=args.lora_rank, adaptation=args.adaptation, lora_seed=idx)
        else:
            # a fresh adaptation state per case
            ad_sampler.observation = obs
            ad_sampler.rhs = trafo.adjoint(obs)
            ad_sampler.lora = init_lora(model, seed=idx)
        x_ad, _ = ad_sampler.sample(generator=None if draws else generator(seed, idx, 1),
                                    noises=as_list(ad_noises))
        synchronize(device)
        x_ad = np.clip(x_ad[0, ..., 0].float().cpu().numpy(), 0, 1)
        dt_ad = time.time() - t0

        row = dict(name=name, fbp=PSNR(fbp[0, ..., 0].cpu().numpy(), g),
                   dds=PSNR(x_dds, g), dds_ssim=SSIM(x_dds, g),
                   adapted=PSNR(x_ad, g), adapted_ssim=SSIM(x_ad, g),
                   x_dds=x_dds, x_adapted=x_ad, gt=g, seconds=dt_ad)
        rows.append(row)
        print(f"[{name}] FBP {row['fbp']:6.2f} | DDS({args.dds_steps}, "
              f"eta={args.dds_eta}) {row['dds']:6.2f}/{row['dds_ssim']:.3f} | "
              f"adapted({args.adaptation}) {row['adapted']:6.2f}/"
              f"{row['adapted_ssim']:.3f}  ({dt_ad:.0f}s)", flush=True)
    return rows


def main(argv=None) -> list:
    """Run the evaluation of `argv` (default: the command line); returns
    `evaluate`'s rows."""
    from .. import factory as F
    from ..configs.disk_ellipses_configs import get_config
    from ..utils.device import resolve_device
    from .eval_flagship_256 import load_model

    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = get_config("vesde")
    config.model.num_channels = args.num_channels
    config.model.dtype = args.dtype
    config.data.part = "val"
    config.ckpt_path = args.ckpt
    sde = F.get_standard_sde(config)
    # full and decoder adapt the base weights: the model carries no LoRA
    lora_rank = args.lora_rank if args.adaptation == "lora" else 0
    model = load_model(config, sde, args.ckpt, "float32", device, lora_rank=lora_rank,
                       adaptation=args.adaptation)
    trafo = F.get_standard_ray_trafo(config, device=device)
    dataset = F.get_standard_dataset(config, trafo)
    rows = evaluate(args, sde, model, trafo, cases(dataset, args.num_in_dist, args.num_ood),
                    config.seed, config.data.stddev, device)
    for sub in ("in-dist", "OOD"):
        sel = [r for r in rows if r["name"].startswith(sub)]
        if sel:
            print(f"MEAN {sub}: FBP {np.mean([r['fbp'] for r in sel]):.2f} | "
                  f"DDS {np.mean([r['dds'] for r in sel]):.2f} | "
                  f"adapted {np.mean([r['adapted'] for r in sel]):.2f}", flush=True)
    if args.save_npz:
        np.savez(args.save_npz, **{f"{r['name']}_{k}": r[key] for r in rows
                                   for k, key in (("ad", "x_adapted"), ("dds", "x_dds"),
                                                  ("gt", "gt"))})
    return rows


if __name__ == "__main__":
    main()
