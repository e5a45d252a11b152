"""Experiment factory: configs -> SDE, score model, operator, data, sampler.

Port of `factory.py` of the JAX package: the calls that the training, the
conditional and the adapted sampling CLIs make, for the disk-ellipse, AAPM
and walnut workloads, with the parallel-beam operator (`fft` or `matrix`)
and the walnut cone-beam operator (`dense` or `ell`).
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
from .data.aapm import AAPMDataset
from .data.ellipses import get_disk_dist_ellipses_dataset
from .models.convert import load_flax_msgpack, params_from_flax
from .models.unet import UNetModel, create_model_config
from .ops.sde import SDE, get_standard_sde  # noqa: F401  (re-export)
from .physics.ray_trafo import make_parallel_beam_trafo
from .physics.simulation import simulate
from .sampling.adaptation import (check_strategy, get_standard_adapted_sampler,  # noqa: F401
                                  is_adapt_param)
from .sampling.engine import get_standard_sampler  # noqa: F401  (re-export)
from .utils.device import resolve_device

__all__ = ["get_standard_sde", "get_standard_score", "get_standard_ray_trafo",
           "get_standard_dataset", "get_standard_train_dataset", "get_data_from_ground_truth",
           "get_standard_configs", "get_standard_dataset_configs", "get_standard_path",
           "get_standard_sampler", "get_standard_adapted_sampler", "load_params",
           "round_to_compute_dtype_"]

NOT_PORTED_TORCH_CKPT = ("reference torch checkpoints (.pt) are not read yet: their converter, the "
                         "JAX package's models/torch_convert.py, is ROADMAP.md queue 1 item 11")

DATA_ASSETS = Path(__file__).resolve().parent.parent / "data_assets"


def load_params(path: str, use_ema: bool = False):
    """The port's state_dict (fp32 tensors on the CPU) stored at `path`, as
    the JAX package's `_load_params` reads it: a flax msgpack tree (`*.npz`,
    fp16 storage widened to fp32 masters) or the port's own checkpoint
    directory (`utils.checkpoint.Checkpointer`: its latest save, the EMA
    shadow with `use_ema`, else the parameters)."""
    path = str(path)
    if path.endswith(".pt"):
        raise NotImplementedError(f"{path}: {NOT_PORTED_TORCH_CKPT}")
    if os.path.isdir(path):
        from .utils.checkpoint import Checkpointer

        state = Checkpointer(path).restore()
        if state is None:
            raise FileNotFoundError(f"no checkpoint found under {path}")
        return {n: v.float() for n, v in
                (state["ema"]["shadow"] if use_ema else state["params"]).items()}
    if path.endswith(".npz"):
        return params_from_flax(load_flax_msgpack(path))
    raise ValueError(f"unrecognized checkpoint format: {path} (the port reads flax msgpack "
                     "*.npz trees and its own checkpoint directories)")


@torch.no_grad()
def round_to_compute_dtype_(model: UNetModel) -> UNetModel:
    """Round every parameter of a bf16-compute `model` in place to its
    nearest bf16 value (ties to even), fp32 masters staying fp32; under fp32
    compute, nothing.  A trainer's warm start does this: a checkpoint loaded
    with `train=True`, and the train CLI's `--init_ckpt`.

    Every leaf is cast to bf16 somewhere: by a bf16 layer's forward, or by
    the bf16 copy that the keep-best probe and the samplers run, as the JAX
    package casts them.  An eighth of the values of an fp16 checkpoint lie
    exactly halfway between two bf16 values, where the cast rounds to even.
    Left there, the first warmup update, far below bf16's resolution, tips
    every such value the update's way: a coherent step of half a bf16 ulp
    on an eighth of the weights, which breaks the flagship prior's
    keep-best probe within two warmup steps (PERF.md §6).  A master on the
    bf16 grid changes its cast only once updates have moved it half an
    ulp.  (Adaptation moves its leaves by about its lr of 1e-3 per step,
    far past the ties, and keeps the stored values, as JAX does.)"""
    if model.cfg.torch_dtype == torch.bfloat16:
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))
    return model


def get_standard_score(config, sde: SDE, use_ema: bool = False, load_model: bool = True,
                       ckpt_path: Optional[str] = None, lora_rank: int = 0,
                       lora_include_blocks=None, device=None, adaptation: Optional[str] = None,
                       train: bool = False):
    """Build the UNet and load a checkpoint; returns (model, params, score_fn)
    with `params` the model's state_dict and `score_fn(x, t)` its forward.

    Checkpoints are the JAX package's flax msgpack trees (`*.msgpack.npz`,
    fp16 storage loaded as fp32 masters) or the port's own checkpoint
    directories (`load_params`; `use_ema` picks the EMA shadow there; the
    shipped trees are EMA weights).  Without one the weights are random,
    drawn from `config.seed` by the JAX package's rule (`models/unet.py`).

    Parameters are stored in the compute dtype (`config.model.dtype`, bf16
    as the JAX package's `--params_dtype bfloat16` runs it) and come back
    with `requires_grad` off, as the JAX score carries no parameter
    gradient: DPS differentiates the network in x alone.  Two exceptions
    keep fp32 masters under a bf16 compute dtype, as the JAX package keeps
    every parameter (Adam at lr 1e-3 or 1e-4 would round updates of bf16
    leaves away):
    - `train`: every parameter, requiring a gradient (the trainer's model);
    - `adaptation` ("lora" by default when `lora_rank` > 0, or "full" or
      "decoder"): the strategy's trainable leaves (`is_adapt_param`), which
      `AdaptedSampler.adapting()` turns on.
    With `train`, under bf16 compute, a checkpoint's masters start at their
    bf16 values (`round_to_compute_dtype_`).

    With `lora_rank` the model carries LoRA branches over
    `lora_include_blocks` (all three block groups by default), for adapted
    sampling; they start at 0 (`sampling.adaptation.init_lora` draws them).
    """
    dev = resolve_device(device)
    ckpt_path = (ckpt_path or config.get("ckpt_path")) if load_model else None
    if adaptation is None and lora_rank:
        adaptation = "lora"
    if adaptation is not None:
        check_strategy(adaptation)
    state = load_params(ckpt_path, use_ema) if ckpt_path else None
    cfg = create_model_config(config.model)
    if lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=int(lora_rank))
        if lora_include_blocks is not None:
            cfg = dataclasses.replace(cfg, lora_include_blocks=tuple(lora_include_blocks))
    with torch.random.fork_rng(devices=[]):     # leave the caller's RNG alone
        torch.manual_seed(config.seed)
        model = UNetModel(cfg)
    if state is not None:
        missing, unexpected = model.load_state_dict(state, strict=False)
        if unexpected or [k for k in missing if "_lora." not in k]:
            raise ValueError(f"checkpoint {ckpt_path} does not fit the model: missing "
                             f"{missing[:5]}, unexpected {unexpected[:5]}")
        if train:
            round_to_compute_dtype_(model)
    model = model.to(device=dev).eval().requires_grad_(train)
    for name, p in model.named_parameters():
        if not (train or (adaptation and is_adapt_param(name, adaptation))):
            p.data = p.data.to(cfg.torch_dtype)

    def score_fn(x, t):
        return model(x, t)

    return model, model.state_dict(), score_fn


def get_standard_train_dataset(config, device=None):
    """(dataset, endless iterator of NHWC batches of `config.training.batch_size`)
    of the training fold (JAX `get_standard_train_dataset`) on `device`:
    generated disk-ellipse phantoms, or the AAPM slices of the train fold
    (every non-test slice outside the val fold)."""
    name = config.data.name.lower()
    dev = resolve_device(device)
    if name == "diskdistributedellipsesdataset":
        ds = get_disk_dist_ellipses_dataset(
            fold="train", im_size=config.data.im_size, length=config.data.length,
            diameter=config.data.diameter, max_n_ellipse=config.data.num_n_ellipse,
            device=dev)
        return ds, ds.batches(config.training.batch_size)
    if name == "aapm":
        ds = AAPMDataset(part="train", base_path=config.data.base_path)
        return ds, ds.batches(config.training.batch_size, device=dev)
    raise NotImplementedError(config.data.name)


def get_standard_ray_trafo(config, device=None):
    """The operator of `config.forward_op` on `device`: `simple_trafo`, the
    parallel-beam operator (`impl` "fft", the default, or "matrix"), or
    `walnut_trafo`, the walnut cone-beam single-slice operator (`impl`
    "dense", the default, or "ell") read from, or assembled into,
    `config.data.data_path`."""
    name = config.forward_op.trafo_name.lower()
    dev = resolve_device(device)
    if name == "simple_trafo":
        return make_parallel_beam_trafo((config.data.im_size, config.data.im_size),
                                        config.forward_op.num_angles,
                                        impl=config.forward_op.impl or "fft", device=dev)
    if name == "walnut_trafo":
        from .physics.walnut import get_walnut_2d_ray_trafo

        return get_walnut_2d_ray_trafo(
            data_path=config.data.data_path, matrix_path=config.data.data_path,
            walnut_id=config.data.walnut_id, orbit_id=config.forward_op.orbit_id,
            angular_sub_sampling=config.forward_op.angular_sub_sampling,
            proj_col_sub_sampling=config.forward_op.proj_col_sub_sampling,
            new_shape=tuple(config.data.new_shape), impl=config.forward_op.impl or "dense",
            device=dev)
    raise NotImplementedError(name)


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
    the JAX package's `get_standard_dataset` gives them:
    - disk ellipses: at 256² the shipped set of `config.data.part` where one
      exists (`data_assets/disk_ellipses_<part>_256.npz`: `val`), else the
      test-fold phantoms generated at `config.data.im_size`, rasterised on
      the operator's device (or `device`);
    - AAPM: the slices of `config.data.part` under `config.data.base_path`;
    - walnut: one (observation, ground truth, FDK) triplet of `ray_trafo`'s
      data, read from `config.data.data_path`."""
    name = config.data.name.lower()
    if name == "walnut":
        from .data.walnut import get_walnut_data

        return get_walnut_data(config, ray_trafo)
    if name == "aapm":
        return AAPMDataset(part=config.data.part, base_path=config.data.base_path)
    if name != "diskdistributedellipsesdataset":
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
