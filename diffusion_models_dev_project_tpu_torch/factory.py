"""Experiment factory: configs -> SDE, score model, operator, data, sampler.

Port of `factory.py` of the JAX package: the calls that the conditional and
the adapted sampling CLIs make, for the disk-ellipse workload with the FFT
parallel-beam operator.  The AAPM and walnut configs resolve as in the JAX
package; their data and operators raise, naming ROADMAP.md queue 1 item 9.
Each entry point runs on `cuda` unless the caller passes `device="cpu"`, and
raises when CUDA is wanted and absent.
"""
from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .configs import aapm_configs, disk_ellipses_configs, walnut_configs
from .data.ellipses import get_disk_dist_ellipses_dataset
from .models.convert import load_flax_msgpack, params_from_flax
from .models.unet import UNetModel, create_model_config
from .ops.sde import SDE, get_standard_sde  # noqa: F401  (re-export)
from .physics.fft_radon import FFTRayTransform, make_fft_parallel_trafo
from .physics.simulation import simulate
from .sampling.adaptation import get_standard_adapted_sampler, is_adapt_param  # noqa: F401
from .sampling.engine import get_standard_sampler  # noqa: F401  (re-export)
from .utils.device import resolve_device

__all__ = ["get_standard_sde", "get_standard_score", "get_standard_ray_trafo",
           "get_standard_dataset", "get_data_from_ground_truth", "get_standard_configs",
           "get_standard_dataset_configs", "get_standard_path", "get_standard_sampler",
           "get_standard_adapted_sampler"]

NOT_PORTED_DATA = ("the AAPM and walnut data and their operators are not ported yet "
                   "(ROADMAP.md queue 1 item 9)")

DATA_ASSETS = Path(__file__).resolve().parent.parent / "data_assets"


def get_standard_score(config, sde: SDE, use_ema: bool = False, load_model: bool = True,
                       ckpt_path: Optional[str] = None, lora_rank: int = 0,
                       lora_include_blocks=None, device=None):
    """Build the UNet and load a checkpoint; returns (model, params, score_fn)
    with `params` the model's state_dict and `score_fn(x, t)` its forward.

    Every parameter comes back with `requires_grad` off, as the JAX score
    carries no parameter gradient: DPS differentiates the network in x
    alone, and `AdaptedSampler.adapting()` turns its own trainable leaves on.

    Checkpoints are the JAX package's flax msgpack trees (`*.msgpack.npz`,
    fp16 storage loaded as fp32 masters).  Without one the weights are
    random, drawn from `config.seed`.  With
    `config.model.dtype == "bfloat16"` the whole model is then stored and run
    in bf16, as the JAX package's `--params_dtype bfloat16` runs it.
    `use_ema` is accepted for compatibility: the shipped trees are EMA weights.

    With `lora_rank` the model carries LoRA branches over
    `lora_include_blocks` (all three block groups by default), for adapted
    sampling; they start at 0 (`sampling.adaptation.init_lora` draws them).
    Its trainable leaves, the LoRA weights and the non-emb biases, then stay
    fp32 masters under a bf16 compute dtype, as the JAX package keeps every
    parameter (Adam at lr 1e-3 would round updates of bf16 biases away).
    """
    del sde, use_ema
    dev = resolve_device(device)
    ckpt_path = (ckpt_path or config.get("ckpt_path")) if load_model else None
    if ckpt_path and not str(ckpt_path).endswith(".npz"):
        raise ValueError(f"unsupported checkpoint format: {ckpt_path} "
                         "(the port reads flax msgpack *.npz trees)")
    cfg = create_model_config(config.model)
    if lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=int(lora_rank))
        if lora_include_blocks is not None:
            cfg = dataclasses.replace(cfg, lora_include_blocks=tuple(lora_include_blocks))
    with torch.random.fork_rng(devices=[]):     # leave the caller's RNG alone
        torch.manual_seed(config.seed)
        model = UNetModel(cfg)
    if ckpt_path:
        missing, unexpected = model.load_state_dict(
            params_from_flax(load_flax_msgpack(str(ckpt_path))), strict=False)
        if unexpected or [k for k in missing if "_lora." not in k]:
            raise ValueError(f"checkpoint {ckpt_path} does not fit the model: missing "
                             f"{missing[:5]}, unexpected {unexpected[:5]}")
    model = model.to(device=dev).eval().requires_grad_(False)
    for name, p in model.named_parameters():
        if not (lora_rank and is_adapt_param(name)):
            p.data = p.data.to(cfg.torch_dtype)

    def score_fn(x, t):
        return model(x, t)

    return model, model.state_dict(), score_fn


def get_standard_ray_trafo(config, device=None) -> FFTRayTransform:
    """The parallel-beam FFT-shear operator of `config.forward_op`."""
    name = config.forward_op.trafo_name.lower()
    impl = config.forward_op.get("impl", "fft")
    if name != "simple_trafo" or impl != "fft":
        raise NotImplementedError(f"operator {name!r} with impl {impl!r}: {NOT_PORTED_DATA}")
    dev = resolve_device(device)
    return make_fft_parallel_trafo((config.data.im_size, config.data.im_size),
                                   config.forward_op.num_angles, device=dev)


def get_data_from_ground_truth(ground_truth, ray_trafo, white_noise_rel_stddev: float,
                               generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None):
    """(gt, observation, fbp), NHWC, on the operator's device; the noise is
    drawn from `generator` or given as `noise` (standard normal)."""
    if isinstance(ground_truth, np.ndarray):
        ground_truth = torch.from_numpy(ground_truth)
    ground_truth = ground_truth.to(device=ray_trafo.device, dtype=torch.float32)
    if ground_truth.ndim == 3:
        ground_truth = ground_truth[None]
    observation = simulate(ground_truth, ray_trafo, white_noise_rel_stddev,
                           generator=generator, noise=noise)
    return ground_truth, observation, ray_trafo.fbp(observation)


def get_standard_dataset(config, ray_trafo=None, device=None) -> Sequence[np.ndarray]:
    """The evaluation images of `config.data`, NHWC (H, W, 1) fp32 numpy, as
    the JAX package's `get_standard_dataset` gives them: at 256² the shipped
    set of `config.data.part` where one exists
    (`data_assets/disk_ellipses_<part>_256.npz`: `val`), else the test-fold
    disk-ellipse phantoms generated at `config.data.im_size`, rasterised on
    the operator's device (or `device`)."""
    name = config.data.name.lower()
    if name != "diskdistributedellipsesdataset":
        if name in ("walnut", "aapm"):
            raise NotImplementedError(f"dataset {config.data.name!r}: {NOT_PORTED_DATA}")
        raise NotImplementedError(config.data.name)
    path = DATA_ASSETS / f"disk_ellipses_{config.data.part}_256.npz"
    if config.data.im_size == 256 and path.exists():
        images = np.load(path)["images"].astype(np.float32)          # (N, 256, 256, 1)
        return [images[i] for i in range(images.shape[0])]
    return get_disk_dist_ellipses_dataset(
        fold="test", im_size=config.data.im_size, length=config.data.val_length,
        diameter=config.data.diameter, max_n_ellipse=config.data.num_n_ellipse,
        device=ray_trafo.device if ray_trafo is not None else device)


_CONFIG_MODULES = {"ellipses": disk_ellipses_configs, "aapm": aapm_configs,
                   "walnut": walnut_configs}


def get_standard_configs(args):
    """(config, dataconfig): the model config from `args.model_learned_on`,
    the data config from `args.dataset`, both for `args.sde`."""
    model_on = args.model_learned_on.lower()
    if model_on not in ("ellipses", "aapm"):
        raise NotImplementedError(model_on)
    config = _CONFIG_MODULES[model_on].get_config(args.sde.lower())
    config.ckpt_path = getattr(args, "load_path", None)
    return config, get_standard_dataset_configs(args)


def get_standard_dataset_configs(args):
    return _CONFIG_MODULES[args.dataset.lower()].get_config(args.sde.lower())


def get_standard_path(args, run_type: Optional[str] = None,
                      data_part: Optional[str] = None) -> Path:
    """Output-path convention of the JAX package (`get_standard_path`)."""
    path = os.path.join("./outputs", f"{args.model_learned_on}_{args.dataset}")
    if data_part is not None:
        path = os.path.join(path, data_part)
    if run_type == "adapt":
        path = os.path.join(path, "adapt", f"adaptation={args.adaptation}",
                            f"dc_type={args.dc_type}", f"num_steps={args.num_steps}",
                            f"num_optim_step={args.num_optim_step}",
                            f"tv_penalty{args.tv_penalty}")
    elif run_type == "dds":
        path = os.path.join(path, run_type, f"num_steps={args.num_steps}",
                            f"cg_iter={args.cg_iter}", f"gamma={args.gamma}")
    elif run_type in ("dps", "naive"):
        path = os.path.join(path, run_type, f"num_steps={args.num_steps}",
                            f"penalty={args.penalty}")
    if args.dataset != "walnut" and getattr(args, "stddev", None) is not None:
        path = os.path.join(path, f"noise_level={args.stddev}")
    return Path(os.path.join(path, time.strftime("%d-%m-%Y-%H-%M-%S")))
