"""Parallel-beam CT geometry and host-side system-matrix assembly (numpy).

Copy of the JAX package's `physics/geometry.py`.  `parallel_beam_geometry`
follows `odl.tomo.parallel_beam_geometry`: unit image cells centred at the
origin, rho = half the image diagonal, `2*ceil(rho) + 1` detector bins
spanning [-rho, rho], and angles at the midpoints of a uniform partition of
[0, pi).  `joseph_system_matrix` assembles the Joseph-method matrix once per
geometry in the native assembler (`native.py`); its numpy body is the plain
twin `joseph_system_matrix_plain`.  `ell_from_coo` lays a COO matrix out in
padded rows (ELL), the layout of `ray_trafo.RayTransform`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["ParallelBeamGeometry", "parallel_beam_geometry", "joseph_system_matrix",
           "joseph_system_matrix_plain", "ell_from_coo", "EllTables"]


@dataclasses.dataclass(frozen=True)
class ParallelBeamGeometry:
    im_shape: Tuple[int, int]
    angles: np.ndarray  # radians, shape (num_angles,)
    det_count: int
    det_spacing: float

    @property
    def obs_shape(self) -> Tuple[int, int]:
        return (len(self.angles), self.det_count)


def parallel_beam_geometry(im_shape: Tuple[int, int], num_angles: int) -> ParallelBeamGeometry:
    h, w = im_shape
    corners = np.array([[h / 2, w / 2]])
    rho = float(np.linalg.norm(corners, axis=1).max())
    det_count = 2 * int(np.ceil(rho)) + 1
    det_spacing = 2 * rho / det_count
    angles = (np.arange(num_angles) + 0.5) * np.pi / num_angles
    return ParallelBeamGeometry(im_shape=(h, w), angles=angles.astype(np.float64),
                                det_count=det_count, det_spacing=det_spacing)


def joseph_system_matrix(geom: ParallelBeamGeometry):
    """A as COO triplets (rows, cols, vals) by Joseph's method, from the
    native assembler.  Row = angle_idx * det_count + det_idx; col = i * W + j."""
    from .native import native_joseph_coo

    return native_joseph_coo(geom.angles, geom.im_shape[0], geom.im_shape[1], geom.det_count,
                             geom.det_spacing)


def joseph_system_matrix_plain(geom: ParallelBeamGeometry):
    """The numpy body of the JAX package's `joseph_system_matrix`: the plain
    twin of the native assembler, the same triplets in another order."""
    H, W = geom.im_shape
    D = geom.det_count
    xs = np.arange(W) - (W - 1) / 2.0        # physical x of column j
    ys = (H - 1) / 2.0 - np.arange(H)        # physical y of row i
    t = (np.arange(D) - (D - 1) / 2.0) * geom.det_spacing

    rows_all, cols_all, vals_all = [], [], []
    for a_idx, th in enumerate(geom.angles):
        c, s = np.cos(th), np.sin(th)
        if abs(c) >= abs(s):
            # drive along image rows: x = (t - y*s) / c
            X = (t[:, None] - ys[None, :] * s) / c          # (D, H)
            j = X + (W - 1) / 2.0
            j0 = np.floor(j).astype(np.int64)
            frac = j - j0
            step = 1.0 / abs(c)
            d_idx, i_idx = np.meshgrid(np.arange(D), np.arange(H), indexing="ij")
            base_row = a_idx * D + d_idx
            for jj, wgt in ((j0, (1.0 - frac) * step), (j0 + 1, frac * step)):
                valid = (jj >= 0) & (jj < W)
                rows_all.append(base_row[valid])
                cols_all.append((i_idx[valid] * W + jj[valid]))
                vals_all.append(wgt[valid])
        else:
            # drive along image columns: y = (t - x*c) / s
            Y = (t[:, None] - xs[None, :] * c) / s          # (D, W)
            i = (H - 1) / 2.0 - Y
            i0 = np.floor(i).astype(np.int64)
            frac = i - i0
            step = 1.0 / abs(s)
            d_idx, j_idx = np.meshgrid(np.arange(D), np.arange(W), indexing="ij")
            base_row = a_idx * D + d_idx
            for ii, wgt in ((i0, (1.0 - frac) * step), (i0 + 1, frac * step)):
                valid = (ii >= 0) & (ii < H)
                rows_all.append(base_row[valid])
                cols_all.append((ii[valid] * W + j_idx[valid]))
                vals_all.append(wgt[valid])

    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    vals = np.concatenate(vals_all).astype(np.float32)
    keep = vals != 0
    return rows[keep], cols[keep], vals[keep]


@dataclasses.dataclass
class EllTables:
    """Padded-row (ELL) sparse layout: out[r] = sum_k w[r,k] * x[idx[r,k]]."""

    idx: np.ndarray   # (R, K) int32, zero-padded
    w: np.ndarray     # (R, K) float32, zero-padded
    n_cols: int       # dense input dimension


def ell_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_rows: int, n_cols: int, pad_to_multiple: int = 8) -> EllTables:
    """COO triplets in ELL layout, each row padded with (index 0, weight 0)
    to the longest row, rounded up to `pad_to_multiple`."""
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    counts = np.bincount(rows_s, minlength=n_rows)
    K = int(counts.max())
    K = int(np.ceil(K / pad_to_multiple) * pad_to_multiple)
    idx = np.zeros((n_rows, K), dtype=np.int32)
    w = np.zeros((n_rows, K), dtype=np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(rows_s)) - offsets[rows_s]
    idx[rows_s, within] = cols_s
    w[rows_s, within] = vals_s
    return EllTables(idx=idx, w=w, n_cols=n_cols)
