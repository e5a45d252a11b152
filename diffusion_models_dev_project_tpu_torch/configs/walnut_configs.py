"""Walnut cone-beam workload config.

Port of `configs/walnut_configs.py` of the JAX package, with the same field
names and values.  The factory builds its cone-beam operator
(`physics/walnut.py`) and reads its data (`data/walnut.py`) from
`WALNUT_DATA_PATH`.
"""
from __future__ import annotations

import os

from .default_config import Config, get_default_configs

__all__ = ["get_config"]


def get_config(sde: str = "vesde") -> Config:
    config = get_default_configs(sde)

    data = config.data
    data.name = "Walnut"
    data.im_size = 501
    data.new_shape = (256, 256)
    data.data_path = os.environ.get("WALNUT_DATA_PATH", "./data/Walnuts")
    data.walnut_id = 1
    data.fold = "test"
    data.scaling_factor = 14.0       # scale values to ~[0, 1]
    data.validation.num_images = 1
    data.stddev = 0.05

    forward_op = config.forward_op
    forward_op.trafo_name = "walnut_trafo"
    forward_op.orbit_id = 2
    forward_op.angular_sub_sampling = 20    # 1200 -> 60 angles
    forward_op.proj_col_sub_sampling = 6    # 768 -> 128 detector columns

    return config
