"""3D cone-beam projector over `cone_vec` geometries, on torch tensors.

Port of `physics/cone_beam.py` of the JAX package:

- the geometry is ASTRA's `cone_vec` parameterisation, one 12-vector per
  angle (src, det centre d, col step u, row step v) in world units, so the
  CWI walnut `.geom` files load unchanged;
- the forward projection is ray-driven: each source->detector-pixel ray is
  clipped against the volume's box and sampled uniformly at half-voxel
  pitch with trilinear interpolation (trapezoid weights), in fp32 on the
  volume's device.  `make_fp3d(angle_chunk=k)` projects k angles at a time,
  so that the gathers' temporaries stay bounded at large detectors;
- the backprojection `bp3d` is the exact adjoint: the vector-Jacobian
  product of `fp3d` through autograd;
- `masked_slice_matrix` assembles the single-slice 2D system matrix of the
  rays a mask selects in the native assembler (`native.py`); its numpy
  body `masked_slice_matrix_plain` is the plain twin.  The edge-padded slab
  makes the integrand z-independent, so each ray's z weights collapse to
  their sum.

Volume layout (Z, Y, X), voxels of side `vox_size` centred at the origin;
detector pixel (r, c) sits at d + (c - (C-1)/2) u + (r - (R-1)/2) v.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["ConeVecGeometry", "circular_cone_vecs", "fp3d", "bp3d", "make_fp3d",
           "masked_slice_matrix", "masked_slice_matrix_plain"]


@dataclasses.dataclass(frozen=True)
class ConeVecGeometry:
    """`cone_vec` acquisition geometry (ASTRA convention)."""

    vecs: np.ndarray                 # (A, 12) float64
    num_rows: int                    # detector rows  (v axis)
    num_cols: int                    # detector cols  (u axis)
    vol_shape: Tuple[int, int, int]  # (Z, Y, X)
    vox_size: float = 1.0

    @property
    def num_angles(self) -> int:
        return self.vecs.shape[0]

    @property
    def proj_shape(self) -> Tuple[int, int, int]:
        """ASTRA data layout: (rows, angles, cols)."""
        return (self.num_rows, self.num_angles, self.num_cols)

    def half_extent(self) -> np.ndarray:
        """Half side lengths of the volume's box in world units, xyz order."""
        nz, ny, nx = self.vol_shape
        return np.array([nx, ny, nz], np.float64) * self.vox_size / 2.0

    def detector_positions(self) -> np.ndarray:
        """World positions of all detector pixels, (R, A, C, 3)."""
        v = self.vecs
        r = np.arange(self.num_rows) - (self.num_rows - 1) / 2.0
        c = np.arange(self.num_cols) - (self.num_cols - 1) / 2.0
        return (v[None, :, None, 3:6]
                + c[None, None, :, None] * v[None, :, None, 6:9]
                + r[:, None, None, None] * v[None, :, None, 9:12])

    def n_steps(self, oversample: float = 2.0) -> int:
        """Sample count covering the volume's diagonal."""
        diag = 2.0 * float(np.linalg.norm(self.half_extent()))
        return int(np.ceil(diag / (self.vox_size / oversample))) + 1


def circular_cone_vecs(num_angles: int, src_radius: float, det_radius: float,
                       det_spacing: Tuple[float, float] = (1.0, 1.0)) -> np.ndarray:
    """Synthetic circular-orbit cone_vec vectors (source in the z = 0 plane),
    for tests and for workloads without a measured geometry file."""
    th = np.linspace(0, 2 * np.pi, num_angles, endpoint=False)
    src = np.stack([np.sin(th) * src_radius, -np.cos(th) * src_radius, np.zeros_like(th)], -1)
    det = np.stack([-np.sin(th) * det_radius, np.cos(th) * det_radius, np.zeros_like(th)], -1)
    u = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1) * det_spacing[0]
    v = np.stack([np.zeros_like(th), np.zeros_like(th), np.ones_like(th)], -1) * det_spacing[1]
    return np.concatenate([src, det, u, v], axis=1)


# -------------------------------------------------------------- projector
def _trilinear_gather(vol: torch.Tensor, pts: torch.Tensor, vox: float, vol_shape) -> torch.Tensor:
    """`vol` (Z, Y, X) at world points `pts` (..., 3, xyz), trilinear, zero
    outside."""
    nz, ny, nx = vol_shape
    flat = vol.reshape(-1)

    def axis(i):
        i0 = torch.floor(i)
        return i0.long(), i - i0

    x0, fx = axis(pts[..., 0] / vox + (nx - 1) / 2.0)
    y0, fy = axis(pts[..., 1] / vox + (ny - 1) / 2.0)
    z0, fz = axis(pts[..., 2] / vox + (nz - 1) / 2.0)
    out = torch.zeros(pts.shape[:-1], dtype=vol.dtype, device=vol.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy) * (fz if dz else 1 - fz)
                valid = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny) & (zi >= 0) & (zi < nz)
                idx = ((zi.clamp(0, nz - 1) * ny + yi.clamp(0, ny - 1)) * nx
                       + xi.clamp(0, nx - 1))
                out = out + torch.where(valid, w, 0.0) * flat[idx]
    return out


def _ray_aabb(src: torch.Tensor, dirn: torch.Tensor, half: torch.Tensor):
    """Entry and exit parameters of the rays src + t·dirn with the centred box."""
    eps = 1e-12
    safe = torch.where(dirn.abs() < eps, torch.where(dirn < 0, -eps, eps), dirn)
    inv = 1.0 / safe
    t1, t2 = (-half - src) * inv, (half - src) * inv
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def _fp_rays(vol: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, geom: ConeVecGeometry,
             n_steps: int) -> torch.Tensor:
    """Line integrals along the rays src -> dst (..., 3)."""
    half = torch.tensor(geom.half_extent(), dtype=torch.float32, device=vol.device)
    dirn = dst - src
    t_in, t_out = _ray_aabb(src, dirn, half)
    t_out = torch.maximum(t_out, t_in)             # no intersection -> zero length
    ts = torch.linspace(0.0, 1.0, n_steps, device=vol.device)
    t = t_in[..., None] + (t_out - t_in)[..., None] * ts
    pts = src[..., None, :] + t[..., None] * dirn[..., None, :]
    vals = _trilinear_gather(vol, pts, geom.vox_size, geom.vol_shape)
    seg = (t_out - t_in) * torch.linalg.vector_norm(dirn, dim=-1) / (n_steps - 1)
    w = torch.ones(n_steps, device=vol.device)
    w[0] = w[-1] = 0.5
    return (vals * w).sum(-1) * seg


def make_fp3d(geom: ConeVecGeometry, oversample: float = 2.0, angle_chunk: Optional[int] = None,
              device=None):
    """`fp(vol) -> projs` with the geometry's tables on `device`: volume
    (Z, Y, X) -> projections (R, A, C), `angle_chunk` angles at a time (all
    at once when None)."""
    dev = resolve_device(device)
    n_steps = geom.n_steps(oversample)
    det = torch.tensor(geom.detector_positions(), dtype=torch.float32, device=dev)  # (R, A, C, 3)
    srcs = torch.tensor(geom.vecs[:, 0:3], dtype=torch.float32, device=dev)         # (A, 3)

    def fp(vol: torch.Tensor) -> torch.Tensor:
        vol = torch.as_tensor(vol, device=dev).float()
        step = angle_chunk or geom.num_angles
        return torch.cat([_fp_rays(vol, srcs[None, a0:a0 + step, None, :], det[:, a0:a0 + step],
                                   geom, n_steps)
                          for a0 in range(0, geom.num_angles, step)], dim=1)

    return fp


def _device_of(x, device):
    return x.device if isinstance(x, torch.Tensor) and device is None else resolve_device(device)


def fp3d(vol, geom: ConeVecGeometry, oversample: float = 2.0, angle_chunk: Optional[int] = None,
         device=None) -> torch.Tensor:
    """Forward projection, volume (Z, Y, X) -> projections (R, A, C), on the
    volume's device (a numpy volume goes to `device`)."""
    return make_fp3d(geom, oversample, angle_chunk, _device_of(vol, device))(vol)


def bp3d(projs, geom: ConeVecGeometry, oversample: float = 2.0, angle_chunk: Optional[int] = None,
         device=None) -> torch.Tensor:
    """Exact-adjoint backprojection, projections (R, A, C) -> volume
    (Z, Y, X): the vector-Jacobian product of `fp3d`."""
    dev = _device_of(projs, device)
    fp = make_fp3d(geom, oversample, angle_chunk, dev)
    projs = torch.as_tensor(projs, device=dev).float()
    with torch.enable_grad():
        vol = torch.zeros(geom.vol_shape, device=dev, requires_grad=True)
        (out,) = torch.autograd.grad(fp(vol), vol, projs)
    return out


# ---------------------------------------------------- slice matrix assembly
def _masked_rays(geom: ConeVecGeometry, ray_mask: np.ndarray):
    """(src, det) world positions (N, 3) of the rays `ray_mask` (R, A, C) selects."""
    det = geom.detector_positions()[ray_mask]
    ang_idx = np.broadcast_to(np.arange(geom.num_angles)[None, :, None], ray_mask.shape)[ray_mask]
    return geom.vecs[ang_idx, 0:3], det


def _csr(rows, cols, vals, shape):
    import scipy.sparse as sp

    mat = sp.coo_matrix((vals, (rows, cols)), shape=shape)
    mat.sum_duplicates()
    return mat.tocsr()


def masked_slice_matrix(geom: ConeVecGeometry, ray_mask: np.ndarray, oversample: float = 2.0):
    """The 2D system matrix of the edge-padded single-slice volume over the
    rays `ray_mask` (R, A, C) selects, from the native assembler: a scipy
    CSR (n_masked_rays, Y*X) mapping a flat (Y, X) slice to the masked flat
    projections, consistent with `fp3d` of the edge-padded volume."""
    from .native import native_cone_slice_coo

    src, det = _masked_rays(geom, ray_mask)
    rows, cols, vals = native_cone_slice_coo(src, det, geom.vol_shape, geom.vox_size,
                                             geom.n_steps(oversample))
    return _csr(rows, cols, vals, (det.shape[0], geom.vol_shape[1] * geom.vol_shape[2]))


def masked_slice_matrix_plain(geom: ConeVecGeometry, ray_mask: np.ndarray,
                              oversample: float = 2.0, chunk: int = 512):
    """The numpy body of the JAX package's `masked_slice_matrix`: the plain
    twin of the native assembler, `chunk` rays at a time."""
    nz, ny, nx = geom.vol_shape
    half = geom.half_extent()
    n_steps = geom.n_steps(oversample)
    src, det = _masked_rays(geom, ray_mask)
    n_rays = det.shape[0]
    rows_all, cols_all, vals_all = [], [], []
    for start in range(0, n_rays, chunk):
        s = np.asarray(src[start:start + chunk], np.float64)
        d = np.asarray(det[start:start + chunk], np.float64)
        dirn = d - s
        eps = 1e-12
        safe = np.where(np.abs(dirn) < eps, np.where(dirn < 0, -eps, eps), dirn)
        inv = 1.0 / safe
        t1, t2 = (-half - s) * inv, (half - s) * inv
        t_in = np.minimum(t1, t2).max(-1)
        t_out = np.maximum(np.maximum(t1, t2).min(-1), t_in)
        ts = np.linspace(0.0, 1.0, n_steps)
        t = t_in[:, None] + (t_out - t_in)[:, None] * ts
        pts = s[:, None, :] + t[..., None] * dirn[:, None, :]
        seg = (t_out - t_in) * np.linalg.norm(dirn, axis=-1) / (n_steps - 1)
        wtrap = np.ones(n_steps)
        wtrap[0] = wtrap[-1] = 0.5
        wstep = seg[:, None] * wtrap[None, :]
        ix = pts[..., 0] / geom.vox_size + (nx - 1) / 2.0
        iy = pts[..., 1] / geom.vox_size + (ny - 1) / 2.0
        iz = pts[..., 2] / geom.vox_size + (nz - 1) / 2.0
        # every z-slice of the edge-padded slab carries the same image: the z
        # contribution is the sum of the valid trilinear z-corner weights
        z0 = np.floor(iz).astype(np.int64)
        fzw = iz - z0
        wz = (np.where((z0 >= 0) & (z0 < nz), 1.0 - fzw, 0.0)
              + np.where((z0 + 1 >= 0) & (z0 + 1 < nz), fzw, 0.0))
        x0 = np.floor(ix).astype(np.int64)
        y0 = np.floor(iy).astype(np.int64)
        fxw, fyw = ix - x0, iy - y0
        ray_ids = np.broadcast_to(np.arange(start, start + s.shape[0])[:, None], ix.shape)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                w = (fxw if dx else 1 - fxw) * (fyw if dy else 1 - fyw) * wz * wstep
                valid = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
                rows_all.append(ray_ids[valid])
                cols_all.append(yi[valid] * nx + xi[valid])
                vals_all.append(w[valid].astype(np.float32))
    return _csr(np.concatenate(rows_all), np.concatenate(cols_all), np.concatenate(vals_all),
                (n_rays, ny * nx))
