"""Steerable (adapted) sampling CLI of the port.

Counterpart of the JAX package's `run_adapted_sampling.py`: DDS with
`--adaptation lora`, `full` or `decoder`, one image at a time, on the JAX
CLI's data (`--dataset ellipses`: the generated test-fold phantoms; `aapm`:
the slices under `AAPM_DATA_PATH`; `walnut`: the measured observation under
`WALNUT_DATA_PATH` with its cone-beam operator) and prior (`--model_learned_on
ellipses` or `aapm`, the AAPM config's UNet, random without `--load_path`).
Each image starts from the model's own weights (and for `lora` a fresh
LoRA state, seed = the image's index).  It writes what the JAX CLI writes under
`./outputs/...`: `recon_<i>_info.npz`, `recon_<i>.png`, `report.yaml`, and
prints a JSON line of the mean PSNR and SSIM last.

    python -m diffusion_models_dev_project_tpu_torch.run_adapted_sampling \\
        --load_path checkpoints/flagship_vesde_256_ema.msgpack.npz --num_channels 128 \\
        --dtype bfloat16 --add_cg --num_images 1

runs on the card; `--device cpu` runs the plain PyTorch path on the CPU, at
a small size with `--im_size 64 --num_channels 64 --num_steps 3
--num_optim_step 2` (random weights: no checkpoint has that size).  `--shard_images
N` adapts and samples N images per call (`AdaptedSampler.sample_batched`):
under `lora` as one chain on the batch axis, each image with its own leaves;
under `full` and `decoder` one image after another.  With several ranks
(`parallel/launch.py::rank_devices`: one per visible card) and N a multiple
of their number W, each chunk's images are split over them, one process per
rank (`parallel/launch.py::launch`), and `sampling_mode` says `sharded(N)
over W ranks`; otherwise it runs on one card, with a warning.  Rank 0 alone
writes the images and the report.
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
                    help="N > 0: N images per call (AdaptedSampler.sample_batched), each with "
                         "its own LoRA, biases and Adam state")
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")
parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="UNet compute dtype (default: the config's, float32)")


def coordinator(args):
    """Run the CLI: sharded over the ranks of `rank_devices` when
    `--shard_images` divides over them, else on one card.  Returns the
    output directory (None on a rank other than 0 of an existing group)."""
    from diffusion_models_dev_project_tpu_torch.parallel.launch import (is_rank0, launch,
                                                                         rank_devices)

    shard_n = int(args.shard_images)
    devices = rank_devices(args.device)
    if shard_n > 0 and len(devices) > 1:
        if shard_n % len(devices) == 0:
            if is_rank0():
                print(f"sharding {shard_n}-image chunks over {len(devices)} ranks")
            return launch(_sharded, devices, None, args)
        if is_rank0():
            print(f"WARNING: --shard_images {shard_n} is not divisible by the {len(devices)} ranks "
                  "— running the batched chain on a SINGLE card; pick a multiple of the rank "
                  "count to shard it")
    return _coordinate(args, None) if is_rank0() else None


def _sharded(args):
    """One rank of a sharded run (`parallel/launch.py::launch`)."""
    from diffusion_models_dev_project_tpu_torch.parallel.mesh import make_mesh

    return _coordinate(args, make_mesh(device=args.device))


def _coordinate(args, mesh):
    """The run; with `mesh`, this rank of a sharded one (rank 0 writes)."""
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
    if args.dtype is not None:
        config.model.dtype = args.dtype
    if args.stddev is not None:
        dataconfig.data.stddev = float(args.stddev)
    lead = mesh is None or mesh.rank == 0
    save_root = F.get_standard_path(args, run_type="adapt", data_part=dataconfig.data.part)
    if lead:
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

    def prepare(i, sample):
        """Image i's data, from its own generator (seed·1000 + i), which
        its chain then goes on drawing from."""
        gen = torch.Generator(device=device).manual_seed(seed * 1000 + i)
        if isinstance(sample, (tuple, list)) and len(sample) == 3:
            # measured data (walnut): observation and ground truth as given
            observation, ground_truth = (
                torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
                for a in sample[:2])
        else:
            ground_truth, observation, _ = F.get_data_from_ground_truth(
                sample, ray_trafo, dataconfig.data.stddev, generator=gen)
        return gen, observation, ground_truth

    def finish(i, recon_row, ground_truth):
        if not lead:
            return
        r = recon_row.clamp(min=0)[..., 0].float().cpu().numpy()
        g = ground_truth[0, ..., 0].cpu().numpy()
        save_recon_info(save_root / f"recon_{i}_info.npz", r, g)
        save_image_png(save_root / f"recon_{i}.png", r)
        psnr, ssim = PSNR(r, g), SSIM(r, g)
        print(f"adapted reconstruction of sample {i}\nPSNR: {psnr}\nSSIM: {ssim}")
        psnrs.append(psnr)
        ssims.append(ssim)

    def make_sampler(observation, ground_truth, lora_seed):
        return F.get_standard_adapted_sampler(
            args.method, model, sde, ray_trafo, observation, num_steps=int(args.num_steps),
            eta=float(args.eta), gamma=float(args.gamma), tv_penalty=float(args.tv_penalty),
            lr=float(args.lr), num_optim_step=int(args.num_optim_step),
            adapt_freq=int(args.adapt_freq), lora_rank=int(args.lora_rank),
            lora_include_blocks=tuple(args.lora_include_blocks), add_cg=bool(args.add_cg),
            dc_type=args.dc_type, cg_iter=int(args.cg_iter),
            early_stopping_pct=float(args.early_stopping_pct), ground_truth=ground_truth,
            lora_seed=lora_seed, adaptation=args.adaptation)

    images = islice(iter(dataset), num_images)
    shard_n = int(args.shard_images)
    if shard_n > 0:
        _sample_sharded(model, images, shard_n, use_lora, device, prepare, finish, make_sampler,
                        mesh)
    else:
        for i, sample in enumerate(images):
            gen, observation, ground_truth = prepare(i, sample)
            recon, _ = make_sampler(observation, ground_truth, lora_seed=i).sample(generator=gen)
            finish(i, recon[0], ground_truth)

    if not lead:
        return save_root
    report = dataclasses.asdict(dataconfig)
    report.update({k: str(v) for k, v in vars(args).items()})
    report["PSNR"] = float(np.mean(psnrs))
    report["SSIM"] = float(np.mean(ssims))
    report["sampling_mode"] = f"sharded({shard_n})" if shard_n > 0 else "serial"
    if mesh is not None:
        report["sampling_mode"] += f" over {mesh.world} ranks"
    write_report(save_root / "report.yaml", report)
    print(json.dumps({"PSNR": report["PSNR"], "SSIM": report["SSIM"]}))
    return save_root


def _sample_sharded(model, images, shard_n, use_lora, device, prepare, finish, make_sampler,
                    mesh):
    """Several images per call (the JAX CLI's batched mode): chunks of
    `shard_n` images (the last padded with its last image, whose extra rows
    are dropped) through `AdaptedSampler.sample_batched`, each image with
    its own LoRA state (`init_lora`, seed = its index, as on the serial
    path), biases and Adam state, its chain drawn from its own generator as
    on the serial path.  With `mesh` every rank prepares every image alike
    and runs its rows of each chunk, as the JAX CLI shards the chunk over
    its mesh."""
    import torch

    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import init_lora

    items = [prepare(i, sample) for i, sample in enumerate(images)]
    sampler = make_sampler(items[0][1], None, lora_seed=0)
    for c0 in range(0, len(items), shard_n):
        chunk = items[c0:c0 + shard_n]
        padded = chunk + [chunk[-1]] * (shard_n - len(chunk))
        gens = [g for g, _, _ in chunk]
        for _ in range(len(padded) - len(chunk)):        # a padded row's own copy
            gens.append(torch.Generator(device=device).set_state(chunk[-1][0].get_state()))
        obs = torch.stack([o for _, o, _ in padded])
        lora_stack = None
        if use_lora:
            states = [init_lora(model, seed=c0 + j) for j in range(len(padded))]
            lora_stack = {k: torch.stack([st[k] for st in states]) for k in states[0]}
        recon = sampler.sample_batched(obs, generator=gens, lora_stack=lora_stack, mesh=mesh)
        for j, (_, _, ground_truth) in enumerate(chunk):
            finish(c0 + j, recon[j, 0], ground_truth)


if __name__ == "__main__":
    coordinator(parser.parse_args())
