"""Conditional posterior sampling CLI of the port: naive, DPS and DDS.

Counterpart of the JAX package's `run_conditional_sampling.py`, with its
flags, so that a JAX command line parses, and its per-image protocol: per
image a seed, the observation simulated from the ground truth, one
reverse diffusion, the clamped reconstruction written as
`recon_<i>_info.npz` and `recon_<i>.png` under `./outputs/...`, the mean
PSNR and SSIM in `report.yaml` and, last, as a JSON line.  One sampler
serves the run; each image's data is swapped into it.

    python -m diffusion_models_dev_project_tpu_torch.run_conditional_sampling \\
        --load_path checkpoints/flagship_vesde_256_ema.msgpack.npz --num_channels 128 \\
        --method dps --penalty 10 --num_images 1

runs on the card, with the UNet in bf16 (`--params_dtype`, as in the JAX
CLI); `--device cpu --im_size 32 --num_channels 32 --num_steps 3` runs the
plain PyTorch path on the CPU at a small size, with random weights.  The
data are the JAX CLI's: the generated test-fold disk-ellipse phantoms, the
AAPM slices under `AAPM_DATA_PATH` (`--dataset aapm`), or the walnut's
measured observation under `WALNUT_DATA_PATH` (`--dataset walnut`, whose
dataset gives observation, ground truth and FDK itself).  `--model_learned_on
aapm` builds the AAPM config's UNet (random weights without `--load_path`).
`--shard_images N` reconstructs N images per call on the batch axis, as the
JAX CLI does; `sampling_mode` in `report.yaml` says `sharded(N)`.
"""
import argparse
import dataclasses
import json
from itertools import islice

import numpy as np

parser = argparse.ArgumentParser(description="conditional sampling")
parser.add_argument("--dataset", default="ellipses", choices=["walnut", "ellipses", "aapm"])
parser.add_argument("--model_learned_on", default="ellipses", choices=["ellipses", "aapm"])
parser.add_argument("--method", default="dds", choices=["naive", "dps", "dds"])
parser.add_argument("--ema", action="store_true")
parser.add_argument("--add_corrector_step", action="store_true",
                    help="Langevin corrector after each predictor step")
parser.add_argument("--num_steps", default=1000)
parser.add_argument("--penalty", default=1, help="reg. penalty for naive/dps")
parser.add_argument("--gamma", default=0.01, help="reg. used for dds")
parser.add_argument("--eta", default=0.15, help="dds stochastic/deterministic noise weighting")
parser.add_argument("--pct_chain_elapsed", default=0, help="start the chain from noised FBP")
parser.add_argument("--sde", default="vesde", choices=["vpsde", "vesde", "ddpm"])
parser.add_argument("--cg_iter", default=5)
parser.add_argument("--cg_precision", default="high", choices=["default", "high", "highest"],
                    help="accepted and ignored: CG runs in fp32 with TF32 off")
parser.add_argument("--load_path", help="path to a model checkpoint (flax msgpack *.npz)")
parser.add_argument("--stddev", default=None, help="noise level override")
parser.add_argument("--early_stopping_pct", default=1.0,
                    help="early stop sampling (DDPM/DPS only)")
parser.add_argument("--num_images", default=None,
                    help="override dataconfig.data.validation.num_images")
parser.add_argument("--version", default=1)
parser.add_argument("--im_size", default=None,
                    help="override image size (extension; reference configs are fixed at 256)")
parser.add_argument("--num_channels", default=None, help="override model channels (extension)")
parser.add_argument("--sigma_max", default=None,
                    help="override sde.sigma_max: must match the checkpoint's (extension)")
parser.add_argument("--small_conv_matmul", default=1024, type=int,
                    help="accepted and ignored: chooses a TPU code path; the port's "
                         "ops/conv3x3.py::plan picks each conv's kernel")
parser.add_argument("--pallas_conv_min", default=0, type=int,
                    help="accepted and ignored: chooses a TPU code path; the port's "
                         "ops/conv3x3.py::plan picks each conv's kernel")
parser.add_argument("--params_dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="UNet dtype, of its weights and its compute")
parser.add_argument("--shard_images", default=0,
                    help="N > 0: N images per call, stacked on the sampler's batch axis")
parser.add_argument("--debug_nans", action="store_true",
                    help="accepted and ignored: a JAX debugging switch")
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")
parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="UNet dtype; overrides --params_dtype")

DIVERGED_ABS = 1e3      # a reconstruction with |x| above this has diverged


def coordinator(args):
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.utils.device import resolve_device
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM
    from diffusion_models_dev_project_tpu_torch.utils.reporting import (save_image_png,
                                                                        save_recon_info,
                                                                        write_report)

    device = resolve_device(args.device)
    config, dataconfig = F.get_standard_configs(args)
    if args.im_size is not None:
        for c in (config, dataconfig):
            c.model.image_size = c.data.im_size = int(args.im_size)
    if args.num_channels is not None:
        config.model.num_channels = int(args.num_channels)
    if args.sigma_max is not None:
        config.sde.sigma_max = float(args.sigma_max)
    config.model.dtype = args.dtype or args.params_dtype
    save_root = F.get_standard_path(args, run_type=args.method, data_part=dataconfig.data.part)
    print("save to:", save_root)
    save_root.mkdir(parents=True, exist_ok=True)
    if args.stddev is not None:
        dataconfig.data.stddev = float(args.stddev)

    sde = F.get_standard_sde(config)
    model, _, score_fn = F.get_standard_score(config, sde, use_ema=args.ema,
                                              load_model=args.load_path is not None,
                                              ckpt_path=args.load_path, device=device)
    ray_trafo = F.get_standard_ray_trafo(dataconfig, device=device)
    dataset = F.get_standard_dataset(dataconfig, ray_trafo)
    print("Number of parameters:", sum(p.numel() for p in model.parameters()))
    num_images = (int(args.num_images) if args.num_images is not None
                  else dataconfig.data.validation.num_images)
    seed = config.seed or 0

    def prepare(i, sample):
        """Image i's data, from its own generator (seed·1000 + i), which
        the serial chain then goes on drawing from."""
        gen = torch.Generator(device=device).manual_seed(seed * 1000 + i)
        if isinstance(sample, (tuple, list)) and len(sample) == 3:
            # measured data (walnut): observation, ground truth and FBP as given
            observation, ground_truth, filtbackproj = (
                torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
                for a in sample)
        else:
            ground_truth, observation, filtbackproj = F.get_data_from_ground_truth(
                sample, ray_trafo, dataconfig.data.stddev, generator=gen)
        return gen, observation, ground_truth, filtbackproj

    psnrs, ssims, diverged = [], [], []

    def finish(i, recon_row, ground_truth):
        raw = recon_row[..., 0].float().cpu().numpy()
        # divergence guard: a failed run is named in the report, not hidden in a low mean
        if not np.isfinite(raw).all() or np.abs(raw).max() > DIVERGED_ABS:
            diverged.append(i)
            print(f"WARNING: sample {i} diverged (finite={np.isfinite(raw).all()}, "
                  f"|x|max={np.abs(raw[np.isfinite(raw)]).max(initial=0):.3g})")
        r = np.nan_to_num(np.clip(raw, 0, None))
        g = ground_truth[0, ..., 0].cpu().numpy()
        save_recon_info(save_root / f"recon_{i}_info.npz", r, g)
        save_image_png(save_root / f"recon_{i}.png", r)
        psnr, ssim = PSNR(r, g), SSIM(r, g)
        print(f"reconstruction of sample {i}\nPSNR: {psnr}\nSSIM: {ssim}")
        psnrs.append(psnr)
        ssims.append(ssim)

    def make_sampler(observation, ground_truth, filtbackproj, batch_size=1):
        return F.get_standard_sampler(
            args.method, score_fn, sde, ray_trafo, observation,
            num_steps=int(args.num_steps), batch_size=batch_size,
            im_shape=(*ray_trafo.model_im_shape, 1), penalty=float(args.penalty),
            gamma=float(args.gamma), eta=float(args.eta), cg_iter=int(args.cg_iter),
            cg_precision=args.cg_precision, pct_chain_elapsed=float(args.pct_chain_elapsed),
            early_stopping_pct=(None if float(args.early_stopping_pct) == 1.0
                                else float(args.early_stopping_pct)),
            ground_truth=ground_truth, filtbackproj=filtbackproj,
            add_corrector_step=bool(args.add_corrector_step))

    images = islice(iter(dataset), num_images)
    shard_n = int(args.shard_images)
    if shard_n > 0:
        _sample_sharded(ray_trafo, images, shard_n, prepare, finish, make_sampler)
    else:
        sampler = None
        for i, sample in enumerate(images):
            gen, observation, ground_truth, filtbackproj = prepare(i, sample)
            if sampler is None:
                sampler = make_sampler(observation, ground_truth, filtbackproj)
            else:
                # the same shapes: swap the image's data into the sampler
                sampler.observation = observation
                sampler.rhs = ray_trafo.adjoint(observation)
                sampler.filtbackproj = filtbackproj
                sampler.ground_truth = ground_truth
            recon, _ = sampler.sample(generator=gen)
            finish(i, recon[0], ground_truth)

    report = dataclasses.asdict(dataconfig)
    report.update({k: str(v) for k, v in vars(args).items()})
    report["PSNR"] = float(np.mean(psnrs))
    report["SSIM"] = float(np.mean(ssims))
    # a sharded run draws each chunk's chain from one generator: the same
    # distribution as the serial protocol, not the same bits
    report["sampling_mode"] = f"sharded({shard_n})" if shard_n > 0 else "serial"
    report["diverged_images"] = diverged
    write_report(save_root / "report.yaml", report)
    print(json.dumps({"PSNR": report["PSNR"], "SSIM": report["SSIM"]}))
    return save_root


def _sample_sharded(ray_trafo, images, shard_n, prepare, finish, make_sampler):
    """Several images per call (the JAX CLI's `_sample_sharded`): chunks of
    `shard_n` images stacked on the sampler's batch axis (the last chunk
    padded with its last image, whose extra rows are dropped), each image's
    observation drawn as on the serial path, each chunk's chain from one
    generator: the chunk's first image's, continued after its observation,
    as the serial path continues each image's (JAX draws the chunk's chain
    from a key of its own, `fold_in(key, 1)`).  The chunk runs on the one
    card, whatever the number of visible devices, where the JAX CLI shards
    it over a mesh."""
    import torch

    items = [prepare(i, sample) for i, sample in enumerate(images)]
    sampler = None
    for c0 in range(0, len(items), shard_n):
        chunk = items[c0:c0 + shard_n]
        padded = chunk + [chunk[-1]] * (shard_n - len(chunk))
        obs = torch.cat([o for _, o, _, _ in padded])
        fbp = torch.cat([f for _, _, _, f in padded])
        if sampler is None:
            sampler = make_sampler(obs, None, fbp, batch_size=shard_n)
        else:
            sampler.observation = obs
            sampler.rhs = ray_trafo.adjoint(obs)
            sampler.filtbackproj = fbp
        recon, _ = sampler.sample(generator=chunk[0][0])
        for j, (_, _, ground_truth, _) in enumerate(chunk):
            finish(c0 + j, recon[j], ground_truth)


if __name__ == "__main__":
    coordinator(parser.parse_args())
