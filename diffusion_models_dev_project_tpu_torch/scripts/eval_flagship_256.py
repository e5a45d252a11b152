"""Flagship-resolution evaluation of the port: DDS, DPS or naive on the
shipped 256² val set (`data_assets/disk_ellipses_val_256.npz`, 10 images)
with a 256²-trained prior, the disk-ellipse protocol of the conditional CLI
(60 angles, relative noise 0.01).

Counterpart of the repository's `scripts/eval_flagship_256.py`, with its
flags, defaults and printed lines: per image

    image i: <method> xx.xx dB / 0.xxxx SSIM | FBP xx.xx dB | t s

then `MEAN over N: ...`.  Defaults are the reference's (1000 steps, η 0.15,
γ 0.01, cg_iter 5 for DDS; penalty 1 for DPS and naive).  `--sde ddpm`
with `--travel_length`/`--travel_repeat` runs DDS with time travel, and
`--method dps` ancestral DPS.  `--trace` samples the first image once more
with its per-step PSNR trace, prints the trace's quartiles and writes it
to `outputs/trace_psnr.npy`; `--save_npz` writes the stacks `recon`, `gt`,
`psnr` and `ssim`.

    python -m diffusion_models_dev_project_tpu_torch.scripts.eval_flagship_256 \\
        --ckpt checkpoints/flagship_vesde_256_ema.msgpack.npz [--eta 0.85] [--num_images 10]

runs on the card; `--device cpu` runs the plain PyTorch path on the CPU.
`--cg_precision` and `--small_conv_matmul` are accepted with no effect: they
choose TPU code paths.  Here every stride-1 3x3 conv runs the conv3x3
kernel (`ops/conv3x3.py::plan` picks its variant) and CG runs in fp32 with
TF32 off.  `--params_dtype` stores the weights as the JAX script holds them
(`load_model`).

Per image i, one generator seeded from (seed, i, 0) draws the observation
noise and a second, from (seed, i, 1), the sampler's noise
(`physics/simulation.py::seed_of`; JAX folds i into the config seed's key,
then 1 into that key for the chain).  One sampler serves the run: between
images it is re-pointed at the new observation, Aᵀy and FBP.  Each image's
seconds are taken between two `torch.cuda.synchronize()` on the card.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

parser = argparse.ArgumentParser(description="flagship 256² evaluation on the shipped val set")
parser.add_argument("--ckpt", required=True)
parser.add_argument("--sde", default="vesde", choices=["vesde", "vpsde", "ddpm"])
parser.add_argument("--method", default="dds", choices=["dds", "dps", "naive"])
parser.add_argument("--travel_length", default=1, type=int)
parser.add_argument("--travel_repeat", default=1, type=int)
parser.add_argument("--early_stopping_pct", default=None, type=float)
parser.add_argument("--num_steps", default=1000, type=int)
parser.add_argument("--num_images", default=10, type=int)
parser.add_argument("--num_channels", default=128, type=int)
parser.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="UNet compute dtype")
parser.add_argument("--eta", default=0.15, type=float)
parser.add_argument("--gamma", default=0.01, type=float)
parser.add_argument("--penalty", default=1.0, type=float)
parser.add_argument("--cg_iter", default=5, type=int)
parser.add_argument("--cg_precision", default="high", choices=["default", "high", "highest"],
                    help="accepted with no effect: CG runs in fp32 with TF32 off")
parser.add_argument("--small_conv_matmul", default=1024, type=int,
                    help="accepted with no effect: every 3x3 conv runs the conv3x3 kernel, "
                         "whose variant ops/conv3x3.py::plan picks")
parser.add_argument("--params_dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="UNet weight storage dtype (as the JAX script's)")
parser.add_argument("--save_npz", default=None, help="save per-image recon/gt stacks to this .npz")
parser.add_argument("--trace", action="store_true",
                    help="record the per-step PSNR trace (first image only) and print its "
                         "quartiles")
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")

TRACE_QUANTILES = (0.0, 0.25, 0.5, 0.75, 0.9, 0.95, 1.0)


def load_model(config, sde, ckpt: str, params_dtype: str, device, **score_kw):
    """The UNet of `config` with the EMA weights of `ckpt`
    (`factory.get_standard_score(..., **score_kw)`), its leaves stored as
    the JAX scripts hold theirs:
    - `bfloat16`: every floating leaf rounded to bf16, the GroupNorm and
      final-conv leaves included, as the JAX script casts its whole tree;
    - `float32`: the checkpoint's fp32 values wherever the layer computes
      in fp32 (GroupNorm, the final conv, LoRA branches).  Every other layer
      casts its leaves to the compute dtype at each call, in the port as in
      flax, so holding them in that dtype gives the same arithmetic."""
    from .. import factory as F
    from ..models.unet import GroupNorm32

    model, _, _ = F.get_standard_score(config, sde, use_ema=True, ckpt_path=ckpt, device=device,
                                       **score_kw)
    with torch.no_grad():
        if params_dtype == "bfloat16":
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
        elif model.cfg.torch_dtype != torch.float32:
            state = F.load_params(ckpt, use_ema=True, cfg=model.cfg)
            for name, mod in model.named_modules():
                if isinstance(mod, GroupNorm32) or getattr(mod, "dtype", None) == torch.float32:
                    for leaf, p in mod.named_parameters(recurse=False):
                        p.data = state[f"{name}.{leaf}"].to(device=p.device, dtype=torch.float32)
    return model


def evaluate(args, sde, score_fn, trafo, images, seed: int, stddev: float, device,
             draws=None) -> dict:
    """Reconstruct the first `args.num_images` of `images` (NHWC (H, W, 1)
    arrays) with `args.method`, one sampler re-pointed per image, and print
    the JAX script's lines.  `draws(i)`, when given, returns image i's
    standard-normal draws (the observation's, then the chain's list) in
    place of the generators: parity tests inject JAX's this way.  Returns
    the per-image lists `psnr`, `ssim`, `fbp`, `recon`, `gt`, `seconds`, and
    `trace` (the first image's, with `args.trace`)."""
    from .. import factory as F
    from ..physics.simulation import seed_of
    from ..utils.device import synchronize
    from ..utils.metrics import PSNR, SSIM

    def generator(*path):
        return torch.Generator(device=device).manual_seed(seed_of(*path))

    out = {k: [] for k in ("psnr", "ssim", "fbp", "recon", "gt", "seconds")}
    sampler = None
    for i, image in enumerate(images):
        if i >= args.num_images:
            break
        obs_noise, chain = (None, None) if draws is None else draws(i)
        gt, obs, fbp = F.get_data_from_ground_truth(
            image, trafo, stddev, generator=None if draws else generator(seed, i, 0),
            noise=None if obs_noise is None else torch.as_tensor(obs_noise, device=device))

        def sample(return_trace=False):
            noises = None if chain is None else [torch.as_tensor(a, device=device) for a in chain]
            return sampler.sample(generator=None if draws else generator(seed, i, 1),
                                  noises=noises, return_trace=return_trace)

        if sampler is None:
            sampler = F.get_standard_sampler(
                args.method, score_fn, sde, trafo, obs, num_steps=args.num_steps,
                im_shape=tuple(gt.shape[1:]), gamma=args.gamma, eta=args.eta,
                cg_iter=args.cg_iter, penalty=args.penalty, filtbackproj=fbp,
                travel_length=args.travel_length, travel_repeat=args.travel_repeat,
                early_stopping_pct=args.early_stopping_pct,
                ground_truth=gt if args.trace else None, cg_precision=args.cg_precision)
            if args.trace:
                _, tr = sample(return_trace=True)
                tr = tr.cpu().numpy()
                q = [tr[int(f * (len(tr) - 1))] for f in TRACE_QUANTILES]
                print("trace PSNR @ {0,25,50,75,90,95,100}% of steps: "
                    + " ".join(f"{v:.1f}" for v in q), flush=True)
                os.makedirs("outputs", exist_ok=True)
                np.save("outputs/trace_psnr.npy", tr)
                out["trace"] = tr
                sampler.ground_truth = None       # the trace is the first image's alone
        else:
            sampler.observation = obs
            sampler.rhs = trafo.adjoint(obs)
            sampler.filtbackproj = fbp
        synchronize(device)
        t0 = time.time()
        x, _ = sample()
        synchronize(device)
        x = np.clip(x[0, ..., 0].float().cpu().numpy(), 0, 1)
        g = gt[0, ..., 0].cpu().numpy()
        dt = time.time() - t0
        p, s = PSNR(x, g), SSIM(x, g)
        fp = PSNR(fbp[0, ..., 0].cpu().numpy(), g)
        print(f"image {i}: {args.method} {p:6.2f} dB / {s:.4f} SSIM | FBP {fp:6.2f} dB | "
            f"{dt:.1f}s", flush=True)
        for k, v in zip(("psnr", "ssim", "fbp", "recon", "gt", "seconds"), (p, s, fp, x, g, dt)):
            out[k].append(v)
    return out


def main(argv=None) -> dict:
    """Run the evaluation of `argv` (default: the command line); returns
    `evaluate`'s lists."""
    from .. import factory as F
    from ..configs.disk_ellipses_configs import get_config
    from ..utils.device import resolve_device

    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = get_config(args.sde)
    config.model.num_channels = args.num_channels
    config.model.dtype = args.dtype
    config.data.part = "val"                    # the shipped set
    config.ckpt_path = args.ckpt
    sde = F.get_standard_sde(config)
    model = load_model(config, sde, args.ckpt, args.params_dtype, device)
    trafo = F.get_standard_ray_trafo(config, device=device)
    dataset = F.get_standard_dataset(config, trafo)
    res = evaluate(args, sde, model, trafo, dataset, config.seed, config.data.stddev, device)
    print(f"MEAN over {len(res['psnr'])}: {args.method} {np.mean(res['psnr']):.2f} dB / "
          f"{np.mean(res['ssim']):.4f} SSIM | FBP {np.mean(res['fbp']):.2f} dB", flush=True)
    if args.save_npz:
        np.savez(args.save_npz, recon=np.stack(res["recon"]), gt=np.stack(res["gt"]),
                 psnr=np.array(res["psnr"]), ssim=np.array(res["ssim"]))
    return res


if __name__ == "__main__":
    main()
