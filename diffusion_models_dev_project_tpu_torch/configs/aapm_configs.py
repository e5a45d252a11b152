"""AAPM LDCT workload config.

Port of `configs/aapm_configs.py` of the JAX package, with the same field
names and values.  The factory reads its slices (`data/aapm.py`) from
`AAPM_DATA_PATH`, at the time the config is made.
"""
from __future__ import annotations

import os

from .default_config import Config, get_default_configs

__all__ = ["get_config"]


def get_config(sde: str = "ddpm") -> Config:
    config = get_default_configs(sde)

    data = config.data
    data.name = "AAPM"
    data.im_size = 256
    data.base_path = os.environ.get("AAPM_DATA_PATH", "./data/AAPM/L067")
    data.part = "test"
    data.validation.num_images = 56
    data.stddev = 0.01

    forward_op = config.forward_op
    forward_op.num_angles = 60
    forward_op.trafo_name = "simple_trafo"

    config.sampling.beta_schedule = "linear"

    model = config.model
    model.in_channels = 1
    model.out_channels = 2          # learn_sigma model
    model.num_channels = 256
    model.num_heads = 4
    model.num_res_blocks = 1
    model.attention_resolutions = "16"
    model.dropout = 0.0
    model.learn_sigma = True
    model.use_scale_shift_norm = True
    model.resblock_updown = True
    model.num_heads_upsample = -1
    model.num_head_channels = 64
    model.image_size = 256
    model.use_new_attention_order = False
    model.channel_mult = ""

    return config
