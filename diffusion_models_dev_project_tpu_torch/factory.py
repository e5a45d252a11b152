"""Experiment factory: configs -> SDE, score model, operator, data, sampler.

Port of the main-path part of `factory.py` of the JAX package: the calls
that `run_conditional_sampling.py` makes for a DDS reconstruction on the
disk-ellipse workload.  Each entry point runs on `cuda` unless the caller
passes `device="cpu"`, and raises when CUDA is wanted and absent.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .models.convert import load_flax_msgpack, params_from_flax
from .models.unet import UNetModel, create_model_config
from .ops.sde import SDE, get_standard_sde  # noqa: F401  (re-export)
from .physics.fft_radon import FFTRayTransform, make_fft_parallel_trafo
from .physics.simulation import simulate
from .sampling.engine import get_standard_sampler  # noqa: F401  (re-export)
from .utils.device import resolve_device

__all__ = ["get_standard_sde", "get_standard_score", "get_standard_ray_trafo",
           "get_data_from_ground_truth", "get_standard_sampler"]


def get_standard_score(config, sde: SDE, use_ema: bool = False, load_model: bool = True,
                       ckpt_path: Optional[str] = None, device=None):
    """Build the UNet and load a checkpoint; returns (model, params, score_fn)
    with `params` the model's state_dict and `score_fn(x, t)` its forward.

    Checkpoints are the JAX package's flax msgpack trees (`*.msgpack.npz`,
    fp16 storage loaded as fp32 masters).  Without one the weights are
    random, drawn from `config.seed`.  With
    `config.model.dtype == "bfloat16"` the whole model is then stored and run
    in bf16, as the JAX package's `--params_dtype bfloat16` runs it.
    `use_ema` is accepted for compatibility: the shipped trees are EMA weights.
    """
    del sde, use_ema
    dev = resolve_device(device)
    ckpt_path = (ckpt_path or config.get("ckpt_path")) if load_model else None
    if ckpt_path and not str(ckpt_path).endswith(".npz"):
        raise ValueError(f"unsupported checkpoint format: {ckpt_path} "
                         "(the port reads flax msgpack *.npz trees)")
    cfg = create_model_config(config.model)
    with torch.random.fork_rng(devices=[]):     # leave the caller's RNG alone
        torch.manual_seed(config.seed)
        model = UNetModel(cfg)
    if ckpt_path:
        model.load_state_dict(params_from_flax(load_flax_msgpack(str(ckpt_path))))
    model = model.to(device=dev, dtype=cfg.torch_dtype).eval()

    def score_fn(x, t):
        return model(x, t)

    return model, model.state_dict(), score_fn


def get_standard_ray_trafo(config, device=None) -> FFTRayTransform:
    """The parallel-beam FFT-shear operator of `config.forward_op`."""
    name = config.forward_op.trafo_name.lower()
    impl = config.forward_op.get("impl", "fft")
    if name != "simple_trafo" or impl != "fft":
        raise NotImplementedError(f"operator {name!r} with impl {impl!r} is not ported yet")
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
