"""Score-model training CLI of the port.

Counterpart of the JAX package's `run_score_based_models_train.py`, with
its flags: versioned run directories (`version_{:02d}`) or `--run_dir`
(resumed exactly from its latest checkpoint), the config in `report.yaml`,
warm starts (`--init_ckpt`, `--init_ckpt_partial`), the lr warmup, the
gradient clip, the EMA decay, the sigma-weighted loss, the rolling tail
average, the uncond sample grids of the EMA shadow and the keep-best probe.
It trains on the generated disk-ellipse phantoms of the training fold, or
with `--train_model_on aapm` the AAPM config's model (learn_sigma, 256
channels) on the AAPM slices under `AAPM_DATA_PATH`, on the cards by
default (below), on the CPU with `--device cpu`; `--platform` of the JAX
CLI is `--device` here, and `--debug_nans` fails at the first non-finite loss
or gradient.

    python -m diffusion_models_dev_project_tpu_torch.run_score_based_models_train \\
        --num_channels 128 --dtype bfloat16 --epochs 1 --steps_per_epoch 4 \\
        --init_ckpt checkpoints/flagship_vesde_256_ema.msgpack.npz --lr_warmup 100 \\
        --keep_best_probe dds

warm-starts the flagship prior on the card.  `--device cpu --im_size 64
--num_channels 32 --batch_size 2 --epochs 1 --steps_per_epoch 2` runs in
seconds on the CPU.  `--init_ckpt` reads the JAX package's flax msgpack
trees, the port's own checkpoint directories and reference PyTorch `.pt`
checkpoints (`models/torch_convert.py`).  With several ranks
(`parallel/launch.py::rank_devices`: one per visible card) and a batch that
divides over them, it trains data-parallel, as the JAX CLI shards its batch
over a mesh: one process per rank (`parallel/launch.py::launch`), each
with its rows of the batch, the gradients averaged over the ranks
(`training/trainer.py`); rank 0 alone writes the run directory.  A batch
that does not divide runs on one card, with a warning.
"""
import argparse
import dataclasses
import os

parser = argparse.ArgumentParser(description="training")
parser.add_argument("--sde", default="vesde", choices=["vpsde", "vesde", "ddpm"])
parser.add_argument("--base_path", default="./outputs/score_based_baseline")
parser.add_argument("--train_model_on", default="ellipses", choices=["ellipses", "aapm"],
                    help="aapm trains the learn_sigma (out_channels=2) AAPM-config model on "
                    "the AAPM_DATA_PATH slices")
parser.add_argument("--epochs", default=None, help="override config epochs")
parser.add_argument("--steps_per_epoch", default=None,
                    help="override steps per epoch (default: dataset length / batch)")
parser.add_argument("--batch_size", default=None)
parser.add_argument("--im_size", default=None, help="override image size")
parser.add_argument("--lr", default=None, help="override learning rate")
parser.add_argument("--num_channels", default=None, help="override model width")
parser.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="compute dtype (params stay fp32)")
parser.add_argument("--lr_warmup", default=0, type=int,
                    help="linear lr warmup steps; wanted for --init_ckpt warm starts, where a "
                    "fresh Adam moves every weight by about lr per step")
parser.add_argument("--grad_clip", default=None, help="global-norm gradient clipping")
parser.add_argument("--init_ckpt", default=None,
                    help="warm-start parameters (and the EMA shadow) from a checkpoint (.npz "
                    "msgpack or a checkpoint directory of this CLI) instead of random init; "
                    "optimizer state starts fresh")
parser.add_argument("--init_ckpt_partial", action="store_true",
                    help="with --init_ckpt: copy only the leaves whose shapes match the fresh "
                    "init and keep the fresh init elsewhere (the final conv keeps its zero init)")
parser.add_argument("--run_dir", default=None,
                    help="reuse this run directory instead of a new version_{N}; training "
                    "resumes exactly from its latest checkpoint if one exists")
parser.add_argument("--avg_tail", default=0, type=int,
                    help="export the fp16 average of the EMA shadows of the last K checkpoint "
                    "saves to <run_dir>/avg_ema_tail.msgpack.npz")
parser.add_argument("--sample_freq", default=None,
                    help="an unconditional EMA sample grid every N epochs to <run_dir>/samples; "
                    "overrides config.validation.sample_freq")
parser.add_argument("--val_num_steps", default=None,
                    help="override config.validation.num_steps for the sample grids")
parser.add_argument("--save_every_n_epoch", default=None,
                    help="override config.training.save_model_every_n_epoch")
parser.add_argument("--ema_decay", default=None, help="override config.training.ema_decay")
parser.add_argument("--loss_sigma_alpha", default=None,
                    help="sigma-stratified loss reweighting strength "
                    "(losses.score_matching_loss); 0/None = the reference loss")
parser.add_argument("--keep_best_probe", nargs="?", const="dds", default=None,
                    choices=["dds", "tweedie"],
                    help="score every save's EMA shadow (and the tail average) on held-out val "
                    "images and export the best so far to <run_dir>/best_ema.msgpack.npz: "
                    "'dds' (default) by -PSNR of a 200-step eta=0.15 DDS, 'tweedie' by the "
                    "denoising RMSE over the mid sigma-decades")
parser.add_argument("--debug_nans", action="store_true",
                    help="fail at the first non-finite loss or gradient")
# the port's own
parser.add_argument("--device", default=None, help="cuda (default) or cpu")

PROBE_IMAGES = 2          # val images of the keep-best probe
PROBE_DDS_STEPS = 200


def _make_probe(kind, F, config, get_config, sde, eval_model, device):
    """probe(weights) -> score (lower is better) on the first val images of
    the workload of `get_config`."""
    import numpy as np
    import torch

    from diffusion_models_dev_project_tpu_torch.ops.diffusion import tweedy
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR

    val_cfg = get_config(config.sde.type)
    val_cfg.data.part = "val"
    val_cfg.data.im_size = val_cfg.model.image_size = int(config.data.im_size)
    imgs = []
    for img in F.get_standard_dataset(val_cfg, device=device):
        imgs.append(np.asarray(img))
        if len(imgs) >= PROBE_IMAGES:
            break
    gt = torch.from_numpy(np.stack(imgs)).to(device)

    def load(weights):
        eval_model.load_state_dict(weights, strict=True)

    if kind == "dds":
        trafo = F.get_standard_ray_trafo(val_cfg, device=device)
        g = torch.Generator(device=device).manual_seed(config.seed + 7)
        _, obs, fbp = F.get_data_from_ground_truth(gt, trafo, float(val_cfg.data.stddev),
                                                   generator=g)
        sampler = F.get_standard_sampler(
            "dds", lambda x, t: eval_model(x, t), sde, trafo, obs, num_steps=PROBE_DDS_STEPS,
            batch_size=gt.shape[0], eta=0.15, gamma=0.01, cg_iter=5, filtbackproj=fbp)
        gt_np = gt.cpu().numpy()

        def probe(weights):
            load(weights)
            g = torch.Generator(device=device).manual_seed(config.seed + 13)
            x, _ = sampler.sample(generator=g)
            x = x.float().cpu().numpy()
            return -float(np.mean([PSNR(x[i, ..., 0], gt_np[i, ..., 0])
                                   for i in range(x.shape[0])]))
        return probe

    # Tweedie RMSE at the mid sigma-decades (t fractions covering sigma in
    # [10, 70] for sigma_max = 100)
    fracs = (0.75, 0.85, 0.92, 0.96)
    t_scale = float(config.sde.num_steps) - 1.0 if config.sde.type == "ddpm" else 1.0
    g = torch.Generator(device=device).manual_seed(config.seed + 99)
    zs = torch.randn((len(fracs),) + tuple(gt.shape), generator=g, device=device)

    @torch.no_grad()
    def probe(weights):
        load(weights)
        total = 0.0
        for j, frac in enumerate(fracs):
            t = torch.full((gt.shape[0],), frac * t_scale, device=device)
            if config.sde.type == "ddpm":
                t = t.long()
            mean, std = sde.marginal_prob(gt, t)
            x = mean + std.reshape(-1, 1, 1, 1) * zs[j]
            xhat0 = tweedy(eval_model(x, t), x, sde, t)
            total += float((xhat0 - gt).square().mean().sqrt())
        return total / len(fracs)
    return probe


def _get_config(args):
    if args.train_model_on == "aapm":
        from diffusion_models_dev_project_tpu_torch.configs.aapm_configs import get_config
    else:
        from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import (
            get_config)
    return get_config


def coordinator(args):
    """Train: data-parallel over the ranks of `rank_devices` when the batch
    divides over them, else on one card.  Returns the final `TrainState`;
    a data-parallel run returns rank 0's step and run directory
    (`{"step", "log_dir"}`: the state stays in its checkpoints), and a rank
    other than 0 of an existing group that trains on one card None."""
    from diffusion_models_dev_project_tpu_torch.parallel.launch import (is_rank0, launch,
                                                                         rank_devices)

    devices = rank_devices(args.device)
    batch = (int(args.batch_size) if args.batch_size is not None
             else _get_config(args)(args.sde).training.batch_size)
    if len(devices) > 1:
        if batch % len(devices) == 0:
            if is_rank0():
                print(f"data-parallel training: batch {batch} over {len(devices)} ranks")
            return launch(_data_parallel, devices, None, args)
        if is_rank0():
            print(f"WARNING: the batch of {batch} does not divide over the {len(devices)} ranks — "
                  "training on a SINGLE card; pick a multiple of the rank count")
    return _train(args, None)[0] if is_rank0() else None


def _data_parallel(args):
    """One rank of a data-parallel run (`parallel/launch.py::launch`)."""
    from diffusion_models_dev_project_tpu_torch.parallel.mesh import make_mesh

    state, log_dir = _train(args, make_mesh(device=args.device))
    return {"step": state.step, "log_dir": log_dir}


def _train(args, mesh):
    """(final state, run directory); with `mesh`, this rank of a
    data-parallel run (rank 0 writes)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import diffusion_models_dev_project_tpu_torch.factory as F
    from diffusion_models_dev_project_tpu_torch.training.trainer import train_score_model
    from diffusion_models_dev_project_tpu_torch.utils.checkpoint import Checkpointer
    from diffusion_models_dev_project_tpu_torch.utils.device import resolve_device
    from diffusion_models_dev_project_tpu_torch.utils.reporting import save_image_png, write_report

    get_config = _get_config(args)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    device = resolve_device(args.device)
    config = get_config(args.sde)
    if args.im_size is not None:
        config.data.im_size = config.model.image_size = int(args.im_size)
    if args.epochs is not None:
        config.training.epochs = int(args.epochs)
    if args.batch_size is not None:
        config.training.batch_size = int(args.batch_size)
    if args.lr is not None:
        config.training.lr = float(args.lr)
    if args.num_channels is not None:
        config.model.num_channels = int(args.num_channels)
    if args.dtype is not None:
        config.model.dtype = args.dtype
    if args.val_num_steps is not None:
        config.validation.num_steps = int(args.val_num_steps)
    if args.save_every_n_epoch is not None:
        config.training.save_model_every_n_epoch = int(args.save_every_n_epoch)

    sde = F.get_standard_sde(config)
    model, _, _ = F.get_standard_score(config, sde, load_model=False, device=device, train=True)
    if args.init_ckpt:
        # warm start: the stored weights replace the random init; Adam and the
        # step start fresh, and the EMA warm start seeds the shadow from them
        loaded = F.load_params(str(args.init_ckpt), use_ema=False, cfg=model.cfg)
        with torch.no_grad():
            if args.init_ckpt_partial:
                copied = skipped = 0
                for name, p in model.named_parameters():
                    src = loaded.get(name)
                    if src is not None and tuple(src.shape) == tuple(p.shape):
                        p.copy_(src)
                        copied += 1
                    else:
                        skipped += 1
                say(f"partial warm start from {args.init_ckpt}: {copied} leaves copied, "
                    f"{skipped} kept at fresh init")
            else:
                model.load_state_dict(loaded, strict=True)
                say(f"warm-started params from {args.init_ckpt}")
        # under bf16 compute the masters start on the bf16 grid, off the ties
        # of an fp16 checkpoint that the first updates would tip all one way
        F.round_to_compute_dtype_(model)
    say("Number of parameters:", sum(p.numel() for p in model.parameters()))

    log_dir = None
    if args.run_dir:
        log_dir = args.run_dir
    elif lead:
        ds_name = "AAPM" if args.train_model_on == "aapm" else "DiskEllipses"
        log_dir = os.path.join(args.base_path, ds_name, config.sde.type)
        os.makedirs(log_dir, exist_ok=True)
        version_num = 1
        while os.path.isdir(os.path.join(log_dir, f"version_{version_num:02d}")):
            version_num += 1
        log_dir = os.path.join(log_dir, f"version_{version_num:02d}")
    if lead:
        os.makedirs(log_dir, exist_ok=True)
        print("save model to", log_dir)
        write_report(os.path.join(log_dir, "report.yaml"), dataclasses.asdict(config))
    if mesh is not None:
        # rank 0 picked the version directory and made it; the others follow
        shared = [log_dir]
        dist.broadcast_object_list(shared, src=0, group=mesh.group)
        log_dir = shared[0]

    _, batches = F.get_standard_train_dataset(config, device=device)
    steps_per_epoch = (int(args.steps_per_epoch) if args.steps_per_epoch
                       else max(1, config.data.length // config.training.batch_size))

    sample_freq = (int(args.sample_freq) if args.sample_freq is not None
                   else int(config.validation.sample_freq))
    # the sample grids and the probe run a frozen copy of the model in the
    # compute dtype, into which each candidate's weights are loaded
    eval_model = None
    if lead and (sample_freq > 0 or args.keep_best_probe):
        eval_model, _, _ = F.get_standard_score(config, sde, load_model=False, device=device)

    sample_hook = None
    if sample_freq > 0 and lead:
        val_bs = int(config.validation.batch_size)
        im = int(config.data.im_size)
        val_sampler = F.get_standard_sampler(
            "uncond", lambda x, t: eval_model(x, t), sde, None, None,
            num_steps=int(config.validation.num_steps), batch_size=val_bs, im_shape=(im, im, 1),
            eps=float(config.validation.eps), device=device)
        samples_dir = os.path.join(log_dir, "samples")
        os.makedirs(samples_dir, exist_ok=True)

        def sample_hook(state, epoch):
            eval_model.load_state_dict(state.ema.shadow, strict=True)
            g = torch.Generator(device=device).manual_seed(config.seed * 100003 + epoch)
            x, _ = val_sampler.sample(generator=g)
            x = x.float().cpu().numpy()
            grid = np.clip(np.concatenate([x[i, ..., 0] for i in range(val_bs)], axis=1), 0, 1)
            path = os.path.join(samples_dir, f"epoch_{epoch:04d}.png")
            save_image_png(path, grid)
            print(f"validation samples (epoch {epoch}): {path} mean {grid.mean():.3f} "
                  f"std {grid.std():.3f}")

    probe_hook = None
    if args.keep_best_probe and lead:
        probe_hook = _make_probe(args.keep_best_probe, F, config, get_config, sde, eval_model,
                                 device)

    state = train_score_model(
        model, None, sde, batches,
        epochs=config.training.epochs,
        steps_per_epoch=steps_per_epoch,
        lr=float(config.training.lr),
        lr_warmup_steps=int(args.lr_warmup),
        grad_clip=float(args.grad_clip) if args.grad_clip else None,
        ema_decay=(float(args.ema_decay) if args.ema_decay is not None
                   else config.training.ema_decay),
        loss_kwargs=(dict(sigma_alpha=float(args.loss_sigma_alpha))
                     if args.loss_sigma_alpha else None),
        ema_warm_start_steps=config.training.ema_warm_start_steps,
        log_freq=config.training.log_freq,
        save_model_every_n_epoch=config.training.save_model_every_n_epoch,
        log_dir=log_dir, seed=config.seed,
        checkpointer=Checkpointer(os.path.join(log_dir, "ckpts")),
        sample_hook=sample_hook, sample_freq=sample_freq,
        avg_tail=int(args.avg_tail), probe_hook=probe_hook, debug_nans=bool(args.debug_nans),
        mesh=mesh)
    return state, log_dir


if __name__ == "__main__":
    coordinator(parser.parse_args())
