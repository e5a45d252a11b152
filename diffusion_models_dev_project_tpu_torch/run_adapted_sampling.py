"""Steerable (adapted) sampling CLI of the port.

Counterpart of the JAX package's `run_adapted_sampling.py` for the path the
port has: the disk-ellipse data (the generated test-fold phantoms, which
the JAX CLI reconstructs too), the FFT parallel-beam operator, DDS with
`--adaptation lora`, `full` or `decoder`, one image at a time.
Each image starts from the model's own weights (and for `lora` a fresh
LoRA state, seed = the image's index).  It writes what the JAX CLI writes under
`./outputs/...`: `recon_<i>_info.npz`, `recon_<i>.png`, `report.yaml`, and
prints a JSON line of the mean PSNR and SSIM last.

    python -m diffusion_models_dev_project_tpu_torch.run_adapted_sampling \\
        --load_path checkpoints/flagship_vesde_256_ema.msgpack.npz --num_channels 128 \\
        --dtype bfloat16 --add_cg --num_images 1

runs on the card; `--device cpu` runs the plain PyTorch path on the CPU, at
a small size with `--im_size 64 --num_channels 64 --num_steps 3
--num_optim_step 2` (random weights: no checkpoint has that size).  Values of the JAX CLI that the port does not
have yet raise NotImplementedError naming their ROADMAP.md item.
"""
import argparse
import dataclasses
import json
from itertools import islice

import numpy as np

parser = argparse.ArgumentParser(description="adapted (steerable) sampling")
parser.add_argument("--dataset", default="ellipses", choices=["walnut", "ellipses", "aapm"])
parser.add_argument("--model_learned_on", default="ellipses", choices=["ellipses", "aapm"])
parser.add_argument("--method", default="dds", choices=["dds"])
parser.add_argument("--noise_level", default=0.01)
parser.add_argument("--ema", action="store_true")
parser.add_argument("--num_steps", default=50)
parser.add_argument("--tv_penalty", default=1e-6)
parser.add_argument("--eta", default=0.85)
parser.add_argument("--sde", default="vesde", choices=["vpsde", "vesde", "ddpm"])
parser.add_argument("--adaptation", default="lora", choices=["lora", "full", "decoder"])
parser.add_argument("--num_optim_step", default=10)
parser.add_argument("--adapt_freq", default=1)
parser.add_argument("--lora_include_blocks",
                    default=["input_blocks", "middle_block", "output_blocks", "out"], nargs="+")
parser.add_argument("--lr", default=1e-3)
parser.add_argument("--lora_rank", default=4)
parser.add_argument("--add_cg", action="store_true", help="do DDS steps after adaptation")
parser.add_argument("--cg_iter", default=1)
parser.add_argument("--gamma", default=0.01)
parser.add_argument("--load_path", help="path to a model checkpoint (flax msgpack *.npz, or a "
                    "checkpoint directory of the port's train CLI)")
parser.add_argument("--dc_type", default="cg", choices=["cg", "gd", "none"])
parser.add_argument("--stddev", default=None)
parser.add_argument("--early_stopping_pct", default=1.0)
parser.add_argument("--num_images", default=None)
parser.add_argument("--version", default=1)
parser.add_argument("--im_size", default=None,
                    help="override image size (extension; reference configs are fixed at 256)")
parser.add_argument("--num_channels", default=None, help="override model channels (extension)")
parser.add_argument("--sigma_max", default=None,
                    help="override sde.sigma_max: must match the checkpoint's (extension)")
parser.add_argument("--shard_images", default=0,
                    help="several images per call, each with its own LoRA (not ported yet)")
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")
parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="UNet compute dtype (default: the config's, float32)")


def _check_ported(args):
    if args.dataset != "ellipses" or args.model_learned_on != "ellipses":
        raise NotImplementedError("only the disk-ellipse data and prior are ported; the AAPM and "
                                  "walnut data are ROADMAP.md queue 1 item 9")
    if int(args.shard_images) > 0:
        raise NotImplementedError("--shard_images (several images per call, each with its own "
                                  "LoRA) is ROADMAP.md queue 1 item 10")


def coordinator(args):
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.utils.device import resolve_device
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM
    from diffusion_models_dev_project_tpu_torch.utils.reporting import (save_image_png,
                                                                        save_recon_info,
                                                                        write_report)

    _check_ported(args)
    device = resolve_device(args.device)
    config, dataconfig = get_config(args.sde), get_config(args.sde)
    config.ckpt_path = args.load_path
    if args.im_size is not None:
        for c in (config, dataconfig):
            c.model.image_size = c.data.im_size = int(args.im_size)
    if args.num_channels is not None:
        config.model.num_channels = int(args.num_channels)
    if args.sigma_max is not None:
        config.sde.sigma_max = float(args.sigma_max)
    if args.dtype is not None:
        config.model.dtype = args.dtype
    if args.stddev is not None:
        dataconfig.data.stddev = float(args.stddev)
    save_root = F.get_standard_path(args, run_type="adapt", data_part=dataconfig.data.part)
    print("save to:", save_root)
    save_root.mkdir(parents=True, exist_ok=True)

    sde = F.get_standard_sde(config)
    use_lora = args.adaptation == "lora"       # full and decoder carry no LoRA branches
    model, _, _ = F.get_standard_score(config, sde, use_ema=args.ema,
                                       load_model=args.load_path is not None,
                                       ckpt_path=args.load_path,
                                       lora_rank=int(args.lora_rank) if use_lora else 0,
                                       lora_include_blocks=tuple(args.lora_include_blocks),
                                       device=device, adaptation=args.adaptation)
    ray_trafo = F.get_standard_ray_trafo(dataconfig, device=device)
    dataset = F.get_standard_dataset(dataconfig, ray_trafo)
    num_images = (int(args.num_images) if args.num_images is not None
                  else dataconfig.data.validation.num_images)
    seed = config.seed or 0
    psnrs, ssims = [], []
    for i, image in enumerate(islice(iter(dataset), num_images)):
        gen = torch.Generator(device=device).manual_seed(seed * 1000 + i)
        ground_truth, observation, _ = F.get_data_from_ground_truth(
            image, ray_trafo, dataconfig.data.stddev, generator=gen)
        sampler = F.get_standard_adapted_sampler(
            args.method, model, sde, ray_trafo, observation, num_steps=int(args.num_steps),
            eta=float(args.eta), gamma=float(args.gamma), tv_penalty=float(args.tv_penalty),
            lr=float(args.lr), num_optim_step=int(args.num_optim_step),
            adapt_freq=int(args.adapt_freq), lora_rank=int(args.lora_rank),
            lora_include_blocks=tuple(args.lora_include_blocks), add_cg=bool(args.add_cg),
            dc_type=args.dc_type, cg_iter=int(args.cg_iter),
            early_stopping_pct=float(args.early_stopping_pct), ground_truth=ground_truth,
            lora_seed=i, adaptation=args.adaptation)
        recon, _ = sampler.sample(generator=gen)
        r = recon[0].clamp(min=0)[..., 0].float().cpu().numpy()
        g = ground_truth[0, ..., 0].cpu().numpy()
        save_recon_info(save_root / f"recon_{i}_info.npz", r, g)
        save_image_png(save_root / f"recon_{i}.png", r)
        psnr, ssim = PSNR(r, g), SSIM(r, g)
        print(f"adapted reconstruction of sample {i}\nPSNR: {psnr}\nSSIM: {ssim}")
        psnrs.append(psnr)
        ssims.append(ssim)

    report = dataclasses.asdict(dataconfig)
    report.update({k: str(v) for k, v in vars(args).items()})
    report["PSNR"] = float(np.mean(psnrs))
    report["SSIM"] = float(np.mean(ssims))
    write_report(save_root / "report.yaml", report)
    print(json.dumps({"PSNR": report["PSNR"], "SSIM": report["SSIM"]}))
    return save_root


if __name__ == "__main__":
    coordinator(parser.parse_args())
