"""Walnut measurement and ground-truth loaders.

Port of `data/walnut.py` of the JAX package, the reference's observation
pipeline: TIFF projections -> flat/dark-field correction -> Beer-Lambert
negative log -> ASTRA data layout -> sub-sampling -> projection-mask
selection -> flat observation scaled by 14.  Host-side numpy, once per
image; `imageio` is imported only where a TIFF is read.  `get_walnut_data`
gives the (observation, ground truth, FDK) triplet of the operator's data.
"""
from __future__ import annotations

import os
from math import ceil
from typing import Optional, Tuple

import numpy as np

from ..physics.walnut import (DEFAULT_SPEC, MaskedWalnutRayTrafo,
                              SINGLE_SLICE_CONFIGS, WalnutDatasetSpec,
                              first_col_for_sub_sampling,
                              get_single_slice_ray_trafo, load_geom_vecs)

__all__ = ["get_projection_data", "get_walnut_2d_observation",
           "get_walnut_2d_ground_truth", "get_walnut_data",
           "get_single_slice_ind", "INNER_PART_START_0", "INNER_PART_END_0",
           "get_inner_part_defs"]

DEFAULT_WALNUT_SCALING_FACTOR = 14.0
PROJS_NAME = "scan_{:06}.tif"
DARK_NAME = "di000000.tif"
FLAT_NAME = ["io000000.tif", "io000001.tif"]
GT_NB_ITER = 50

# inner-patch index helpers (reference walnut.py:110-167)
INNER_PART_START_0 = 72
INNER_PART_END_0 = 424


def get_inner_part_defs() -> Tuple[int, int]:
    return INNER_PART_START_0, INNER_PART_END_0


def _read_tiff(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path), dtype=np.float32)


def get_projection_data(data_path: str, walnut_id: int = 1, orbit_id: int = 2,
                        angular_sub_sampling: int = 1,
                        proj_row_sub_sampling: int = 1,
                        proj_col_sub_sampling: int = 1,
                        first_proj_row: int = 0, first_proj_col: int = -1,
                        num_proj_rows: int = -1,
                        spec: WalnutDatasetSpec = DEFAULT_SPEC) -> np.ndarray:
    """TIFF -> corrected, linearized, sub-sampled projections in ASTRA
    layout (rows, angles, cols); reference walnut_utils.py:305-359."""
    full = os.path.join(data_path, f"Walnut{walnut_id}", "Projections",
                        f"tubeV{orbit_id}")
    # reverse read order: portrait-mode acquisition (walnut_utils.py:315-317)
    projs_idx = range(spec.max_num_angles, 0, -angular_sub_sampling)
    num_angles = ceil(spec.max_num_angles / angular_sub_sampling)

    def trafo(image):
        return np.transpose(np.flipud(image))

    dark = trafo(_read_tiff(os.path.join(full, DARK_NAME)))
    flat = np.mean([trafo(_read_tiff(os.path.join(full, fn)))
                    for fn in FLAT_NAME], axis=0)
    projs = np.zeros((num_angles, spec.projs_rows, spec.projs_cols), np.float32)
    for i, idx in enumerate(projs_idx):
        projs[i] = trafo(_read_tiff(os.path.join(full, PROJS_NAME.format(idx))))

    projs -= dark
    projs /= (flat - dark)
    np.log(projs, out=projs)
    np.negative(projs, out=projs)
    projs = np.transpose(projs, (1, 0, 2))           # ASTRA layout

    # sub-sample rows/cols on the aligned grids (walnut_utils.py:100-116)
    if first_proj_col == -1:
        first_proj_col = first_col_for_sub_sampling(proj_col_sub_sampling, spec)
    rows = range(first_proj_row, spec.projs_rows, proj_row_sub_sampling)
    if num_proj_rows != -1:
        rows = list(rows)[:num_proj_rows]
    cols = range(first_proj_col, spec.projs_cols, proj_col_sub_sampling)
    projs = projs[list(rows)][:, :, list(cols)]
    return np.ascontiguousarray(projs)


def get_single_slice_ind(walnut_id: int = 1, orbit_id: int = 2,
                         spec: WalnutDatasetSpec = DEFAULT_SPEC,
                         single_slice_config=None) -> int:
    cfg = single_slice_config or SINGLE_SLICE_CONFIGS.get(
        walnut_id, {}).get(orbit_id)
    if cfg is None:
        raise ValueError(f"no single-slice config for walnut {walnut_id}, "
                         f"orbit {orbit_id}")
    return (spec.vol_sz[0] - 1) // 2 + cfg["slice_offset"]


def get_walnut_2d_observation(
        data_path: str, walnut_id: int = 1, orbit_id: int = 2,
        angular_sub_sampling: int = 1, proj_col_sub_sampling: int = 1,
        scaling_factor: float = DEFAULT_WALNUT_SCALING_FACTOR,
        trafo: Optional[MaskedWalnutRayTrafo] = None,
        spec: WalnutDatasetSpec = DEFAULT_SPEC,
        single_slice_config=None, device=None) -> np.ndarray:
    """Flat masked observation, shape (1, 1, n_mask) -> returned as
    (1, 1, n_mask, 1) NHWC-style; reference walnut.py:15-68.  Without
    `trafo` the mask is probed on `device`."""
    if trafo is None:
        vecs = load_geom_vecs(data_path, walnut_id, orbit_id)
        trafo = get_single_slice_ray_trafo(
            vecs, walnut_id=walnut_id, orbit_id=orbit_id,
            angular_sub_sampling=angular_sub_sampling,
            proj_col_sub_sampling=proj_col_sub_sampling,
            single_slice_config=single_slice_config, spec=spec, device=device)
    cfg = single_slice_config or SINGLE_SLICE_CONFIGS[walnut_id][orbit_id]
    projs = get_projection_data(
        data_path, walnut_id, orbit_id,
        angular_sub_sampling=angular_sub_sampling,
        proj_col_sub_sampling=proj_col_sub_sampling,
        first_proj_row=cfg["first_proj_row"],
        num_proj_rows=cfg["num_proj_rows"], spec=spec)
    obs = trafo.flat_projs_in_mask(projs) * scaling_factor
    return obs.astype(np.float32)[None, None, :, None]


def get_walnut_2d_ground_truth(
        data_path: str, walnut_id: int = 1, orbit_id: int = 2,
        scaling_factor: float = DEFAULT_WALNUT_SCALING_FACTOR,
        spec: WalnutDatasetSpec = DEFAULT_SPEC,
        single_slice_config=None) -> np.ndarray:
    """AGD-50 reconstruction slice, shape (1, 501, 501, 1);
    reference walnut.py:70-107."""
    slice_ind = get_single_slice_ind(walnut_id, orbit_id, spec,
                                     single_slice_config)
    path = os.path.join(data_path, f"Walnut{walnut_id}", "Reconstructions",
                        f"full_AGD_{GT_NB_ITER}_{slice_ind:06}.tiff")
    gt = _read_tiff(path) * scaling_factor
    return gt.astype(np.float32)[None, :, :, None]


def get_walnut_data(config, ray_trafo) -> list:
    """Single-image dataset of (observation, ground_truth, fdk) numpy
    triplets, reference walnut.py:169-188.  `ray_trafo` is the 2D operator
    of `physics.walnut.get_walnut_2d_ray_trafo`; the ground truth is resized
    to the model grid when the operator carries a resize."""
    import torch

    from ..physics.ray_trafo import nearest_resize

    data_path = config.data.data_path
    walnut_id = config.data.walnut_id
    orbit_id = config.forward_op.orbit_id
    obs = get_walnut_2d_observation(
        data_path, walnut_id, orbit_id,
        angular_sub_sampling=config.forward_op.angular_sub_sampling,
        proj_col_sub_sampling=config.forward_op.proj_col_sub_sampling,
        device=ray_trafo.device)
    gt = get_walnut_2d_ground_truth(data_path, walnut_id, orbit_id)
    if ray_trafo.resize_shape is not None:
        gt = nearest_resize(torch.from_numpy(gt), ray_trafo.resize_shape).numpy()
    with torch.no_grad():
        fdk = ray_trafo.fbp(torch.from_numpy(obs).to(ray_trafo.device)).cpu().numpy()
    return [(obs, gt, fdk)]
