"""512² end-to-end DDS reconstruction of the port: the 512² configuration.

Counterpart of the repository's `scripts/smoke_512.py`.  No 512² prior has
been trained (the reference's own 512 config arrives without weights too),
so the UNet's weights are random, drawn from the config's seed, and the
run sits in the strong data-consistency regime (γ 10, cg_iter 10: CG
dominates and recovers the image; the score term only regularizes):
test-fold phantom 0 at 512², η 0.85.  The config is `image_size` 512 with
the channel_mult table's (0.5, 1, 1, 2, 2, 4, 4) at 128 channels: a
64-channel 512² level, and attention at the 16² maps
(`attention_resolutions` "16" names the map size: 256 tokens, 8 heads of
64) and the 8² middle, the flagship's shapes.  (The JAX script's
docstring expects 1024 tokens and its flash kernel; its UNet derives the
same 16² level, where its `auto` rule runs the einsum.)  It prints the
FBP's and the DDS's PSNR and SSIM and writes `recon_512.npz` (`recon`,
`gt`, `psnr`, `ssim`, `fbp_psnr`, `num_steps`) under `--workdir`.

    python -m diffusion_models_dev_project_tpu_torch.scripts.smoke_512 [--num_steps 100]

runs on the card; `--device cpu --num_channels 64 --num_steps 2` runs the
plain PyTorch path on the CPU at a small width.  The JAX script's
`--attention_impl` is not ported: on the card the port's attention always
runs its kernel (`ops/attention.py`), and an `einsum` choice would only run
the plain version there.  The UNet computes in bf16 (`DTYPE`), the compute
dtype of the flagship evaluation and of its kernels (conv3x3's `tc`,
attention's `mma`); the JAX script runs its config's fp32 UNet, so its
PSNR is of another precision.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description="512² DDS reconstruction with a random prior")
parser.add_argument("--num_steps", default=100, type=int)
parser.add_argument("--gamma", default=10.0, type=float)
parser.add_argument("--cg_iter", default=10, type=int)
parser.add_argument("--workdir", default="outputs/smoke_512")
# the port's own
parser.add_argument("--num_channels", default=128, type=int)
parser.add_argument("--device", default=None, help="cuda (default) or cpu")

IM = 512
DTYPE = "bfloat16"


def config_512(num_channels: int = 128):
    """The VESDE disk-ellipse config at 512² (channel_mult from the
    port's table for 512), computing in `DTYPE`."""
    from ..configs.disk_ellipses_configs import get_config

    config = get_config("vesde")
    config.data.im_size = config.model.image_size = IM
    config.model.num_channels = num_channels
    config.model.dtype = DTYPE
    return config


def main(argv=None, score_wrap=None) -> dict:
    """Run the smoke reconstruction of `argv` (default: the command line);
    returns what `recon_512.npz` holds.  `score_wrap(score_fn)`, when given,
    wraps the score the sampler calls (a caller's timer)."""
    from .. import factory as F
    from ..data.ellipses import get_disk_dist_ellipses_dataset
    from ..utils.device import resolve_device, synchronize
    from ..utils.metrics import PSNR, SSIM

    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    config = config_512(args.num_channels)
    sde = F.get_standard_sde(config)
    model, _, score_fn = F.get_standard_score(config, sde, load_model=False, device=device)
    cm = ", ".join(f"{m:g}" for m in model.cfg.channel_mult)
    ds = model.cfg.attention_resolutions
    print(f"model channel_mult ({cm}) x {args.num_channels}, {DTYPE}; attention "
          f"(ops/attention.py) at the {', '.join(f'{IM // d}²' for d in ds)} maps and the "
          f"middle block", flush=True)
    trafo = F.get_standard_ray_trafo(config, device=device)
    gt = next(iter(get_disk_dist_ellipses_dataset(fold="test", im_size=IM, length=1,
                                                  diameter=0.4745, max_n_ellipse=140,
                                                  device=device)))
    gen = torch.Generator(device=device).manual_seed(0)
    gt, obs, fbp = F.get_data_from_ground_truth(gt, trafo, 0.01, generator=gen)
    gt_np = gt[0, ..., 0].cpu().numpy()
    p_fbp = PSNR(fbp[0, ..., 0].cpu().numpy(), gt_np)
    print(f"FBP 512²: {p_fbp:.2f} dB", flush=True)

    sampler = F.get_standard_sampler(
        "dds", score_fn if score_wrap is None else score_wrap(score_fn), sde, trafo, obs,
        num_steps=args.num_steps, im_shape=(IM, IM, 1), gamma=args.gamma, eta=0.85,
        cg_iter=args.cg_iter)
    synchronize(device)
    t0 = time.time()
    x, _ = sampler.sample(generator=torch.Generator(device=device).manual_seed(1))
    synchronize(device)
    x = x[0, ..., 0].float().cpu().numpy()
    dt = time.time() - t0
    if not np.isfinite(x).all():
        raise FloatingPointError("the 512² reconstruction is not finite")
    x = np.clip(x, 0, 1)
    p, s = PSNR(x, gt_np), SSIM(x, gt_np)
    print(f"[512² dds untrained-prior gamma={args.gamma}] {p:.2f} dB / {s:.4f} SSIM in "
          f"{dt:.1f}s ({args.num_steps} steps)", flush=True)
    out = dict(recon=x, gt=gt_np, psnr=p, ssim=s, fbp_psnr=p_fbp, num_steps=args.num_steps)
    np.savez(os.path.join(args.workdir, "recon_512.npz"), **out)
    return out


if __name__ == "__main__":
    main()
