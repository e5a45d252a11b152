"""Walnut cone-beam workload: geometry, mask, slice matrix, 2D operator.

Port of `physics/walnut.py` of the JAX package:

- `build_proj_geometry` reproduces the reference's measured-geometry
  arithmetic: the per-angle 12-vectors of `scan_geom_corrected.geom`,
  sub-sampled in angles, rows and columns, the detector centre shifted so
  that the sub-sampled grid lies on the full one, the steps scaled;
- `MaskedWalnutRayTrafo` builds the projection mask by probing the forward
  projector (`cone_beam.fp3d`, on the operator's device) with a unit slice
  and keeping the top row per (angle, column);
- the single-slice matrix comes from the native assembler in one pass over
  the masked rays, and is saved and loaded in the reference's `.mat` schema
  (`scipy.io`), so that a matrix saved by either package loads in the other;
- `get_walnut_2d_ray_trafo` returns the ELL `RayTransform` over the sparse
  matrix with the 501² -> model-grid resize (`impl="ell"`), or the dense
  operator with the upsample folded in (`impl="dense"`, formed on the device
  and cached beside the `.mat`), each with an FDK-style fbp: cosine
  pre-weights, a ramp filter along the detector columns per angle, and the
  operator's adjoint, scaled by a least-squares fit on a smooth blob.

The operator that `get_walnut_2d_ray_trafo` returns carries the wall
seconds of its build by step in `build_seconds`: the mask probe, the
assembly, the `.mat` save or load, the densify (or the ELL tables) and the
FDK calibration.
"""
from __future__ import annotations

import dataclasses
import os
import time
from math import ceil
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.fbp import fourier_filter
from ..utils.device import resolve_device
from .cone_beam import ConeVecGeometry, make_fp3d, masked_slice_matrix
from .ray_trafo import DenseRayTransform, densify_model_grid, make_matmul_trafo, nearest_resize

__all__ = ["SINGLE_SLICE_CONFIGS", "WalnutDatasetSpec", "DEFAULT_SPEC", "build_proj_geometry",
           "MaskedWalnutRayTrafo", "get_single_slice_ray_trafo", "save_masked_ray_trafo_matrix",
           "load_masked_ray_trafo_matrix", "matrix_filename", "get_walnut_2d_ray_trafo",
           "first_col_for_sub_sampling", "load_geom_vecs", "make_walnut_fbp"]

# ---- dataset facts (reference walnut_utils.py:28-90)
VOXEL_PER_MM = 10
PROJS_ROWS = 972
PROJS_COLS = 768
MAX_NUM_ANGLES = 1200
VOL_SZ = 3 * (50 * VOXEL_PER_MM + 1,)          # (501, 501, 501)
VOX_SZ = 1.0 / VOXEL_PER_MM
VECS_NAME = "scan_geom_corrected.geom"
# samples (rays x steps a ray) of one chunk of angles of the mask probe:
# about 2^25 keep the probe's temporaries at a few GB
PROBE_SAMPLES = 1 << 25


@dataclasses.dataclass(frozen=True)
class WalnutDatasetSpec:
    """Acquisition-format constants; the default is the CWI walnut dataset,
    tests use miniature specs."""

    projs_rows: int = PROJS_ROWS
    projs_cols: int = PROJS_COLS
    max_num_angles: int = MAX_NUM_ANGLES
    vol_sz: Tuple[int, int, int] = VOL_SZ
    vox_sz: float = VOX_SZ


DEFAULT_SPEC = WalnutDatasetSpec()

SINGLE_SLICE_CONFIGS = {
    1: {2: dict(num_slices=9, slice_offset=3, num_proj_rows=9, first_proj_row=474)},
    2: {2: dict(num_slices=25, slice_offset=-11, num_proj_rows=9, first_proj_row=474)},
    3: {2: dict(num_slices=25, slice_offset=-11, num_proj_rows=9, first_proj_row=474)},
    4: {2: dict(num_slices=25, slice_offset=-11, num_proj_rows=9, first_proj_row=475)},
    5: {2: dict(num_slices=25, slice_offset=-11, num_proj_rows=9, first_proj_row=474)},
}


def first_col_for_sub_sampling(factor: int, spec: WalnutDatasetSpec = DEFAULT_SPEC) -> int:
    num = ceil(spec.projs_cols / factor)
    return (spec.projs_cols - ((num - 1) * factor + 1)) // 2


def load_geom_vecs(data_path: str, walnut_id: int, orbit_id: int) -> np.ndarray:
    path = os.path.join(data_path, f"Walnut{walnut_id}", "Projections", f"tubeV{orbit_id}",
                        VECS_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"walnut geometry file missing: {path} (the CWI walnut data is "
                                "not in the repository; set WALNUT_DATA_PATH)")
    return np.loadtxt(path)


def build_proj_geometry(vecs_all: np.ndarray, *, angular_sub_sampling: int = 10,
                        proj_row_sub_sampling: int = 1, proj_col_sub_sampling: int = 1,
                        first_proj_row: int = 0, first_proj_col: int = -1,
                        num_proj_rows: int = -1, num_slices: int = -1,
                        spec: WalnutDatasetSpec = DEFAULT_SPEC) -> ConeVecGeometry:
    """Sub-sampled cone_vec geometry from the full-resolution vectors
    (reference `get_proj_geom`, walnut_utils.py:239-303)."""
    vecs = np.array(vecs_all[::angular_sub_sampling], np.float64)
    if num_slices == -1:
        num_slices = spec.vol_sz[0]
    max_rows = len(range(first_proj_row, spec.projs_rows, proj_row_sub_sampling))
    num_proj_rows = max_rows if num_proj_rows == -1 else num_proj_rows
    assert num_proj_rows <= max_rows
    if first_proj_col == -1:
        first_proj_col = first_col_for_sub_sampling(proj_col_sub_sampling, spec)
    num_proj_cols = len(range(first_proj_col, spec.projs_cols, proj_col_sub_sampling))
    # shift the detector centre so that the sub-sampled grid lies on the
    # requested rows and columns of the full grid
    row_margin_end = (spec.projs_rows - 1) - (
        first_proj_row + (num_proj_rows - 1) * proj_row_sub_sampling)
    vecs[:, 3:6] += (first_proj_row - row_margin_end) / 2 * vecs[:, 9:12]
    col_margin_end = (spec.projs_cols - 1) - (
        first_proj_col + (num_proj_cols - 1) * proj_col_sub_sampling)
    vecs[:, 3:6] += (first_proj_col - col_margin_end) / 2 * vecs[:, 6:9]
    vecs[:, 9:12] *= proj_row_sub_sampling
    vecs[:, 6:9] *= proj_col_sub_sampling
    return ConeVecGeometry(vecs=vecs, num_rows=num_proj_rows, num_cols=num_proj_cols,
                           vol_shape=(num_slices, spec.vol_sz[1], spec.vol_sz[2]),
                           vox_size=spec.vox_sz)


# ------------------------------------------------------------- masked trafo
@dataclasses.dataclass
class MaskedWalnutRayTrafo:
    """Single-slice-masked walnut ray transform (walnut_utils.py:634-1071);
    its mask probe runs on `device` (cuda by default)."""

    geom: ConeVecGeometry
    vol_mask_slice: int
    proj_mask: np.ndarray = dataclasses.field(init=False)      # (R, A, C) bool
    proj_mask_select_k_rows: int = 1
    oversample: float = 2.0
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.proj_mask = self._build_proj_mask()
        assert np.all(np.any(self.proj_mask, axis=0)), (
            "The projection mask should select at least one row at each (angle, column)-position.")
        self.num_projs_in_mask = int(self.proj_mask.sum())

    def _build_proj_mask(self) -> np.ndarray:
        """Probe the forward projector with a unit slice and with the full
        slab; keep per (angle, column) the rows where the slice's share of
        the slab's projection is largest."""
        g = self.geom
        rays_per_angle = g.num_rows * g.num_cols * g.n_steps(self.oversample)
        fp = make_fp3d(g, self.oversample, max(1, PROBE_SAMPLES // rays_per_angle), self.device)
        vol_test = torch.zeros(g.vol_shape, device=self.device)
        vol_test[self.vol_mask_slice] = 1.0
        projs = fp(vol_test).cpu().numpy()
        if self.proj_mask_select_k_rows is None:
            return projs > 0.0
        projs_sum = fp(torch.ones(g.vol_shape, device=self.device)).cpu().numpy()
        fraction = np.zeros(g.proj_shape)
        valid = projs_sum > 0.0
        fraction[valid] = projs[valid] / projs_sum[valid]
        mask = np.zeros(g.proj_shape, bool)
        for _ in range(self.proj_mask_select_k_rows):
            idx = np.expand_dims(np.argmax(fraction, axis=0), 0)
            assert np.all(np.take_along_axis(projs, idx, axis=0) > 0.0)
            np.put_along_axis(mask, idx, True, axis=0)
            np.put_along_axis(fraction, idx, 0.0, axis=0)
        return mask

    def flat_projs_in_mask(self, projs: np.ndarray) -> np.ndarray:
        """(R, A, C) -> (n_mask,), reference walnut_utils.py:918-928."""
        return np.asarray(projs)[self.proj_mask]

    def inds_in_flat_projs_per_angle(self):
        """Per-angle indices into the flat masked observation."""
        inds = np.full(self.geom.proj_shape, -1, np.int64)
        inds[self.proj_mask] = np.arange(self.proj_mask.sum())
        return [inds[:, a, :][self.proj_mask[:, a, :]] for a in range(self.geom.num_angles)]

    def assemble_matrix(self):
        """Sparse (n_mask, Y*X) single-slice system matrix (native assembler)."""
        return masked_slice_matrix(self.geom, self.proj_mask, oversample=self.oversample)


def get_single_slice_ray_trafo(vecs_all: np.ndarray, walnut_id: int = 1, orbit_id: int = 2,
                               angular_sub_sampling: int = 10, proj_col_sub_sampling: int = 1,
                               single_slice_config: Optional[dict] = None,
                               spec: WalnutDatasetSpec = DEFAULT_SPEC,
                               device=None) -> MaskedWalnutRayTrafo:
    """Reference `get_single_slice_ray_trafo` (walnut_utils.py:390-417)."""
    cfg = single_slice_config or SINGLE_SLICE_CONFIGS.get(walnut_id, {}).get(orbit_id)
    if cfg is None:
        raise ValueError("No single slice ray trafo configuration known for "
                         f"walnut_id={walnut_id:d}, orbit_id={orbit_id:d}")
    geom = build_proj_geometry(
        vecs_all, angular_sub_sampling=angular_sub_sampling,
        proj_col_sub_sampling=proj_col_sub_sampling, first_proj_row=cfg["first_proj_row"],
        num_proj_rows=cfg["num_proj_rows"], num_slices=cfg["num_slices"], spec=spec)
    vol_mask_slice = (cfg["num_slices"] - 1) // 2 + cfg["slice_offset"]
    return MaskedWalnutRayTrafo(geom=geom, vol_mask_slice=vol_mask_slice, device=device)


# --------------------------------------------------------- .mat persistence
def matrix_filename(walnut_id: int, orbit_id: int, angular_sub_sampling: int,
                    proj_col_sub_sampling: int) -> str:
    """Reference filename convention (walnut_utils.py:1174-1184)."""
    name = (f"single_slice_ray_trafo_matrix_walnut{walnut_id:d}_"
            f"orbit{orbit_id:d}_ass{angular_sub_sampling:d}")
    if proj_col_sub_sampling != 1:
        name += f"_css{proj_col_sub_sampling:d}"
    return name + ".mat"


def save_masked_ray_trafo_matrix(file_path: str, trafo: MaskedWalnutRayTrafo, matrix,
                                 walnut_id: int, orbit_id: int, angular_sub_sampling: int,
                                 proj_col_sub_sampling: int) -> None:
    """Write the reference's `.mat` schema (walnut_utils.py:1127-1166)."""
    import scipy.io

    scipy.io.savemat(file_path, {
        "ray_trafo_matrix": matrix.astype(np.float64),
        "walnut_id": walnut_id, "orbit_id": orbit_id,
        "angular_sub_sampling": angular_sub_sampling,
        "proj_col_sub_sampling": proj_col_sub_sampling,
        "num_slices": trafo.geom.vol_shape[0],
        "num_proj_rows": trafo.geom.num_rows,
        "vol_mask_slice": np.array([trafo.vol_mask_slice + 1, trafo.vol_mask_slice + 1]),
        "proj_mask": trafo.proj_mask,
    })


def load_masked_ray_trafo_matrix(file_path: str):
    import scipy.io

    return scipy.io.loadmat(file_path, variable_names=["ray_trafo_matrix"])[
        "ray_trafo_matrix"].astype("float32")


# ----------------------------------------------------------- 2D ray trafo
def _fdk_weights(geom: ConeVecGeometry, proj_mask: np.ndarray) -> np.ndarray:
    """FDK cosine pre-weights d_so / ||p - src|| of the masked rays, in mask order."""
    det = geom.detector_positions()
    ang = np.broadcast_to(np.arange(geom.num_angles)[None, :, None], proj_mask.shape)
    src = geom.vecs[:, 0:3]
    d_so = np.linalg.norm(src - geom.vecs[:, 3:6], axis=-1).mean()
    dist = np.linalg.norm(det[proj_mask] - src[ang[proj_mask]], axis=-1)
    return (d_so / dist).astype(np.float32)


def make_walnut_fbp(trafo: MaskedWalnutRayTrafo, device=None):
    """FDK-style filter of the flat masked observation, (B, n_mask) ->
    (B, n_mask) on `device`: cosine weights, then a ramp filter along the
    detector columns of each angle; the operator's adjoint and scale follow
    in `get_walnut_2d_ray_trafo`."""
    dev = resolve_device(device)
    geom, mask = trafo.geom, trafo.proj_mask
    A, C = geom.num_angles, geom.num_cols
    # flat index of each (angle, col) in mask order; needs one row per (angle, col)
    assert trafo.proj_mask_select_k_rows == 1
    inds = np.full(geom.proj_shape, -1, np.int64)
    inds[mask] = np.arange(mask.sum())
    flat_of_ac = inds.max(axis=0)                     # (A, C)
    assert (flat_of_ac >= 0).all()
    gather = torch.from_numpy(flat_of_ac.reshape(-1)).to(dev)
    scatter = torch.from_numpy(np.argsort(flat_of_ac.reshape(-1))).to(dev)
    weights = torch.from_numpy(_fdk_weights(geom, mask)).to(dev)
    padded = max(64, int(2 ** np.ceil(np.log2(2 * C))))
    resp = torch.from_numpy(fourier_filter(padded, "ramp")).to(dev)

    def filter_flat(y_flat: torch.Tensor) -> torch.Tensor:
        y = (y_flat * weights[None])[:, gather].reshape(-1, A, C)
        yp = torch.nn.functional.pad(y, (0, padded - C))
        filt = torch.fft.irfft(torch.fft.rfft(yp, dim=-1) * resp, n=padded, dim=-1)[..., :C]
        filt = filt * (np.pi / (2.0 * A))
        return filt.reshape(-1, A * C)[:, scatter]

    return filter_flat


def get_walnut_2d_ray_trafo(data_path: str, matrix_path: Optional[str] = None,
                            walnut_id: int = 1, orbit_id: int = 2, angular_sub_sampling: int = 1,
                            proj_col_sub_sampling: int = 1,
                            new_shape: Optional[Tuple[int, int]] = None,
                            vecs_all: Optional[np.ndarray] = None,
                            assemble_if_missing: bool = True,
                            single_slice_config: Optional[dict] = None,
                            spec: WalnutDatasetSpec = DEFAULT_SPEC, impl: str = "ell",
                            device=None):
    """Reference `get_walnut_2d_ray_trafo` (walnut_2d_ray_trafo.py:26-85): the
    2D operator over the 501² native grid with flat masked observations,
    FDK fbp and an optional resize to the model grid `new_shape`, on
    `device`.  `impl="ell"` mirrors the reference's operator pair (its
    resize-then-transpose "adjoint" too); `impl="dense"` folds the
    upsample into a dense matrix (the same forward, an exact adjoint)."""
    if impl not in ("ell", "dense"):
        raise ValueError(f"unknown walnut operator impl {impl!r}: 'ell' or 'dense'")
    dev = resolve_device(device)
    build_seconds = {}
    matrix_path = data_path if matrix_path is None else matrix_path
    if vecs_all is None:
        vecs_all = load_geom_vecs(data_path, walnut_id, orbit_id)
    t0 = time.perf_counter()
    trafo3 = get_single_slice_ray_trafo(
        vecs_all, walnut_id=walnut_id, orbit_id=orbit_id,
        angular_sub_sampling=angular_sub_sampling, proj_col_sub_sampling=proj_col_sub_sampling,
        single_slice_config=single_slice_config, spec=spec, device=dev)
    build_seconds["mask_probe"] = time.perf_counter() - t0

    mat_file = os.path.join(matrix_path, matrix_filename(
        walnut_id, orbit_id, angular_sub_sampling, proj_col_sub_sampling))
    t0 = time.perf_counter()
    if os.path.exists(mat_file):
        matrix = load_masked_ray_trafo_matrix(mat_file)
        build_seconds["mat_load"] = time.perf_counter() - t0
    elif assemble_if_missing:
        matrix = trafo3.assemble_matrix()
        build_seconds["assembly"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_masked_ray_trafo_matrix(mat_file, trafo3, matrix, walnut_id, orbit_id,
                                     angular_sub_sampling, proj_col_sub_sampling)
        build_seconds["mat_save"] = time.perf_counter() - t0
    else:
        raise FileNotFoundError(mat_file)

    im_shape = trafo3.geom.vol_shape[1:]
    obs_shape = (1, trafo3.num_projs_in_mask)
    filter_flat = make_walnut_fbp(trafo3, dev)

    def custom_fbp(rt, y):
        b, c = y.shape[0], y.shape[-1]
        filt = filter_flat(y.reshape(b * c, -1)).reshape(y.shape)
        return rt.adjoint(filt) * rt.fbp_scale

    t0 = time.perf_counter()
    if impl == "dense" and new_shape is not None:
        # A · R_up (2 GB at protocol scale), cached beside the .mat as the
        # JAX package caches it
        dense_file = mat_file.replace(".mat", f"_dense_{new_shape[0]}x{new_shape[1]}.npy")
        if os.path.exists(dense_file):
            dense = torch.from_numpy(np.load(dense_file)).to(dev)
        else:
            dense = densify_model_grid(matrix, im_shape, new_shape, dev)
            np.save(dense_file, dense.cpu().numpy())
        rt = DenseRayTransform(matrix=dense, im_shape=im_shape, obs_shape=obs_shape,
                               resize_shape=tuple(new_shape), custom_fbp=custom_fbp)
        build_seconds["densify"] = time.perf_counter() - t0
    else:
        rt = make_matmul_trafo(matrix, im_shape, obs_shape,
                               resize_shape=None if new_shape is None else tuple(new_shape),
                               calibrate_fbp=False, custom_fbp=custom_fbp, device=dev)
        build_seconds["ell_tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.fbp_scale = _calibrate_walnut_fbp(rt)
    build_seconds["fdk_calibration"] = time.perf_counter() - t0
    rt.inds_in_flat_projs_per_angle = trafo3.inds_in_flat_projs_per_angle()
    rt.build_seconds = build_seconds
    return rt


def _calibrate_walnut_fbp(rt) -> float:
    """Least-squares global FDK scale on a smooth blob (the same fit as
    `fft_radon.calibrate_fbp_scale`, with the walnut's blob)."""
    h, w = rt.im_shape
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    blob = np.exp(-((xx ** 2 + yy ** 2) / 0.1)).astype(np.float32)
    x = torch.from_numpy(blob)[None, :, :, None].to(rt.device)
    if rt.resize_shape is not None:
        x = nearest_resize(x, rt.resize_shape)
        blob = x[0, :, :, 0].cpu().numpy()
    old, rt.fbp_scale = rt.fbp_scale, 1.0
    rec = rt.fbp(rt.apply(x))[0, :, :, 0].cpu().numpy()
    rt.fbp_scale = old
    denom = float((rec * rec).sum())
    return float((blob * rec).sum() / denom) if denom > 0 else 1.0
