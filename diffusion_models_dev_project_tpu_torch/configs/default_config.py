"""Base experiment configuration as plain dataclasses.

Port of `configs/default_config.py` of the JAX package (an ml_collections
tree there) with the same sections, field names and values: `sde`,
`training`, `validation`, `sampling`, `data`, `forward_op`, `model`, and
`seed`.  Sections filled in by a workload config (`data`, `forward_op`, most
of `model`) start empty (None).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

__all__ = ["Config", "get_default_configs"]


class _Section:
    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)


@dataclasses.dataclass
class SDEConfig(_Section):
    type: str
    sigma_min: Optional[float] = None
    sigma_max: Optional[float] = None
    beta_min: Optional[float] = None
    beta_max: Optional[float] = None
    num_steps: Optional[int] = None


@dataclasses.dataclass
class TrainingConfig(_Section):
    batch_size: int = 3
    epochs: int = 100
    log_freq: int = 25
    lr: float = 1e-4
    ema_decay: float = 0.999
    ema_warm_start_steps: int = 400
    save_model_every_n_epoch: int = 25


@dataclasses.dataclass
class ValidationConfig(_Section):
    num_steps: int
    batch_size: int = 6
    snr: float = 0.05
    eps: float = 1e-3
    sample_freq: int = 0


@dataclasses.dataclass
class SamplingConfig(_Section):
    batch_size: int = 1
    eps: float = 1e-3
    travel_length: Optional[int] = None     # DDPM only
    travel_repeat: Optional[int] = None     # DDPM only
    beta_schedule: Optional[str] = None     # AAPM


@dataclasses.dataclass
class DataValidationConfig(_Section):
    num_images: Optional[int] = None


@dataclasses.dataclass
class DataConfig(_Section):
    name: Optional[str] = None
    im_size: Optional[int] = None
    length: Optional[int] = None
    val_length: Optional[int] = None
    stddev: Optional[float] = None
    diameter: Optional[float] = None
    num_n_ellipse: Optional[int] = None
    validation: DataValidationConfig = dataclasses.field(default_factory=DataValidationConfig)
    part: Optional[str] = None
    base_path: Optional[str] = None         # AAPM
    # walnut
    new_shape: Optional[Tuple[int, int]] = None
    data_path: Optional[str] = None
    walnut_id: Optional[int] = None
    fold: Optional[str] = None
    scaling_factor: Optional[float] = None


@dataclasses.dataclass
class ForwardOpConfig(_Section):
    num_angles: Optional[int] = None
    trafo_name: Optional[str] = None
    # the operator's implementation; None takes the factory's default for
    # the operator ("fft" for simple_trafo, "dense" for walnut_trafo)
    impl: Optional[str] = None
    # walnut
    orbit_id: Optional[int] = None
    angular_sub_sampling: Optional[int] = None
    proj_col_sub_sampling: Optional[int] = None


@dataclasses.dataclass
class ModelConfig(_Section):
    max_period: float = 0.005       # kept for parity; the UNet uses 10000
    in_channels: Optional[int] = None
    out_channels: Optional[int] = None
    num_channels: Optional[int] = None
    num_heads: Optional[int] = None
    num_res_blocks: Optional[int] = None
    attention_resolutions: Optional[str] = None
    dropout: Optional[float] = None
    learn_sigma: Optional[bool] = None
    use_scale_shift_norm: Optional[bool] = None
    resblock_updown: Optional[bool] = None
    num_heads_upsample: Optional[int] = None
    num_head_channels: Optional[int] = None
    image_size: Optional[int] = None
    use_new_attention_order: Optional[bool] = None
    channel_mult: str = ""
    dtype: str = "float32"          # UNet compute dtype: "float32" | "bfloat16"


@dataclasses.dataclass
class Config(_Section):
    sde: SDEConfig
    validation: ValidationConfig
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    forward_op: ForwardOpConfig = dataclasses.field(default_factory=ForwardOpConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    seed: int = 1
    ckpt_path: Optional[str] = None


def get_default_configs(sde: str) -> Config:
    sde = sde.lower()
    if sde in ("vesde", "vpsde"):
        # sigma_max ~ max pairwise distance of the data
        sde_cfg = SDEConfig(type=sde, sigma_min=0.01, sigma_max=100.0,
                            beta_min=0.1, beta_max=10.0)
    elif sde == "ddpm":
        sde_cfg = SDEConfig(type=sde, beta_min=0.0001, beta_max=0.02, num_steps=1000)
    else:
        raise NotImplementedError(sde)
    config = Config(sde=sde_cfg,
                    validation=ValidationConfig(num_steps=100 if sde == "ddpm" else 500))
    if sde == "ddpm":
        config.sampling.travel_length = 1
        config.sampling.travel_repeat = 1
    config.model.max_period = 1e4 if sde == "ddpm" else 0.005
    return config
