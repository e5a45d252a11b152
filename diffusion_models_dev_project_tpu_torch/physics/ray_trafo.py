"""Matrix-defined CT operators: ELL sparse and dense, on NHWC tensors.

Port of `physics/ray_trafo.py` of the JAX package.  An operator has

    apply(x)    : (B, H, W, C) image        -> (B, A, D, C) sinogram
    adjoint(y)  : (B, A, D, C) sinogram     -> (B, H, W, C) image
    fbp(y)      : ramp-filtered adjoint     -> (B, H, W, C) image

- `RayTransform` stores the matrix twice in padded-row (ELL) layout, A and
  Aᵀ.  Its matvec is a `torch.autograd.Function` whose backward gathers
  through the other table, as the JAX `custom_vjp` does: the gradient is
  another gather, never a scatter.  With `resize_shape` (walnut: model grid
  256² against the native 501²) the image is resized by nearest neighbour
  on the way in and out; the pair then keeps the reference's
  resize-then-transpose "adjoint", which is not the exact transpose.
- `DenseRayTransform` holds A' = A · R_up (R_up the nearest upsample from
  the model grid) as one dense fp32 matrix: apply and adjoint are matmuls
  and the adjoint is exact.  `densify_model_grid` forms A' on the device
  with `index_add_` over the sparse matrix's entries.

Nearest resize follows `jax.image.resize(method="nearest")`: output index i
reads input index floor((i + 0.5) * n_in / n_out) (`nearest_indices`), not
`F.interpolate(mode="nearest")`'s floor(i * n_in / n_out).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.fbp import ramp_filter_sinogram
from ..utils.device import resolve_device
from .fft_radon import calibrate_fbp_scale
from .geometry import ell_from_coo, joseph_system_matrix, parallel_beam_geometry

__all__ = ["RayTransform", "DenseRayTransform", "make_parallel_beam_trafo", "make_matmul_trafo",
           "densify_model_grid", "nearest_indices", "nearest_resize"]


# ----------------------------------------------------------------- ELL matvec
def _ell(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b, r] = sum_k w[r, k] * x[b, idx[r, k]]."""
    return (x[:, idx] * w).sum(-1)


class _EllMatvec(torch.autograd.Function):
    """`_ell` through (idx, w); its gradient in x gathers through the same
    matrix's transposed tables (idx_t, w_t)."""

    @staticmethod
    def forward(ctx, x, idx, w, idx_t, w_t):
        ctx.save_for_backward(idx_t, w_t)
        return _ell(x, idx, w)

    @staticmethod
    def backward(ctx, g):
        idx_t, w_t = ctx.saved_tensors
        return _ell(g, idx_t, w_t), None, None, None, None


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output index of a nearest resize n_in -> n_out,
    as `jax.image.resize(method="nearest")` takes it."""
    return np.minimum(np.floor((np.arange(n_out) + 0.5) * n_in / n_out).astype(np.int64), n_in - 1)


def nearest_resize(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC images to `shape`."""
    _, h, w, _ = x.shape
    rows = torch.from_numpy(nearest_indices(h, shape[0])).to(x.device)
    cols = torch.from_numpy(nearest_indices(w, shape[1])).to(x.device)
    return x[:, rows][:, :, cols]


def _flat_images(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.permute(0, 3, 1, 2).reshape(b * c, h * w)


@dataclasses.dataclass
class RayTransform:
    """A (possibly resized) linear CT operator in ELL layout, fp32 on the
    tables' device."""

    fwd_idx: torch.Tensor          # (R, Kf) int64
    fwd_w: torch.Tensor            # (R, Kf) f32
    adj_idx: torch.Tensor          # (N, Ka) int64
    adj_w: torch.Tensor            # (N, Ka) f32
    im_shape: Tuple[int, int]
    obs_shape: Tuple[int, ...]
    angles: Optional[np.ndarray] = None
    fbp_scale: float = 1.0
    fbp_filter: str = "ramp"
    resize_shape: Optional[Tuple[int, int]] = None   # model-grid shape, if any
    # geometry-specific fbp, e.g. the walnut FDK (physics/walnut.py),
    # called as custom_fbp(self, y)
    custom_fbp: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return self.fwd_w.device

    @property
    def model_im_shape(self) -> Tuple[int, int]:
        """Shape of images as the model sees them (the resized grid if set)."""
        return self.resize_shape if self.resize_shape is not None else self.im_shape

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Forward projection, NHWC -> (B, *obs_shape, C)."""
        b, c = x.shape[0], x.shape[-1]
        if self.resize_shape is not None:
            x = nearest_resize(x, self.im_shape)
        obs = _EllMatvec.apply(_flat_images(x), self.fwd_idx, self.fwd_w, self.adj_idx, self.adj_w)
        return obs.reshape(b, c, *self.obs_shape).movedim(1, -1)

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        """The transposed tables, (B, *obs_shape, C) -> NHWC (then resized)."""
        b, c = y.shape[0], y.shape[-1]
        flat = y.movedim(-1, 1).reshape(b * c, -1)
        x = _EllMatvec.apply(flat, self.adj_idx, self.adj_w, self.fwd_idx, self.fwd_w)
        x = x.reshape(b, c, *self.im_shape).permute(0, 2, 3, 1)
        if self.resize_shape is not None:
            x = nearest_resize(x, self.resize_shape)
        return x

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def fbp(self, y: torch.Tensor) -> torch.Tensor:
        """Filtered back-projection: the adjoint of the ramp-filtered
        sinogram times a calibrated scale, or `custom_fbp`."""
        if self.custom_fbp is not None:
            return self.custom_fbp(self, y)
        return self.adjoint(ramp_filter_sinogram(y, filter_name=self.fbp_filter)) * self.fbp_scale


@dataclasses.dataclass
class DenseRayTransform:
    """The matrix operator precomposed with the model-grid upsample and
    stored dense, A' = A · R_up, (n_obs, model pixels) fp32: apply and
    adjoint are one matmul each, and `adjoint` is the exact transpose of
    `apply`."""

    matrix: torch.Tensor                       # (n_obs, n_model_pixels)
    im_shape: Tuple[int, int]
    obs_shape: Tuple[int, ...]
    fbp_scale: float = 1.0
    fbp_filter: str = "ramp"
    custom_fbp: Optional[Callable] = None
    resize_shape: Optional[Tuple[int, int]] = None   # the model grid

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    @property
    def model_im_shape(self) -> Tuple[int, int]:
        return self.resize_shape if self.resize_shape is not None else self.im_shape

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        obs = _flat_images(x) @ self.matrix.T
        return obs.reshape(b, c, *self.obs_shape).movedim(1, -1)

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        b, c = y.shape[0], y.shape[-1]
        x = y.movedim(-1, 1).reshape(b * c, -1) @ self.matrix
        h, w = self.model_im_shape
        return x.reshape(b, c, h, w).permute(0, 2, 3, 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def fbp(self, y: torch.Tensor) -> torch.Tensor:
        if self.custom_fbp is not None:
            return self.custom_fbp(self, y)
        return self.adjoint(ramp_filter_sinogram(y, filter_name=self.fbp_filter)) * self.fbp_scale


def densify_model_grid(matrix, im_shape: Tuple[int, int], model_shape: Tuple[int, int],
                       device=None) -> torch.Tensor:
    """A' = A · R_up on `device`, (n_obs, h*w) fp32: each entry (r, c) of
    the sparse (scipy) or dense (numpy) matrix A over the native grid
    `im_shape` is added into the model pixel that native pixel c takes its
    value from under the nearest upsample."""
    import scipy.sparse as sp

    dev = resolve_device(device)
    H, W = im_shape
    h, w = model_shape
    native_to_model = (nearest_indices(h, H)[:, None] * w + nearest_indices(w, W)[None, :]).ravel()
    coo = (matrix if sp.issparse(matrix) else sp.coo_matrix(np.asarray(matrix))).tocoo()
    n_obs = coo.shape[0]
    rows = torch.from_numpy(coo.row.astype(np.int64)).to(dev)
    cols = torch.from_numpy(native_to_model[coo.col]).to(dev)
    vals = torch.from_numpy(coo.data.astype(np.float32)).to(dev)
    dense = torch.zeros(n_obs * h * w, dtype=torch.float32, device=dev)
    dense.index_add_(0, rows * (h * w) + cols, vals)
    return dense.reshape(n_obs, h * w)


def _ell_pair(rows, cols, vals, n_rows: int, n_cols: int, dev: torch.device):
    """(fwd_idx, fwd_w, adj_idx, adj_w) of a COO matrix, on `dev`."""
    fwd = ell_from_coo(rows, cols, vals, n_rows, n_cols)
    adj = ell_from_coo(cols, rows, vals, n_cols, n_rows)
    to = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)  # noqa: E731
    return (to(fwd.idx, torch.int64), to(fwd.w, torch.float32),
            to(adj.idx, torch.int64), to(adj.w, torch.float32))


# ------------------------------------------------------------- constructors
_TRAFO_CACHE: dict = {}


def make_parallel_beam_trafo(im_shape: Tuple[int, int], num_angles: int, cache: bool = True,
                             impl: str = "fft", device=None):
    """The 2D parallel-beam operator on `parallel_beam_geometry`, cached per
    geometry and device: `impl="fft"` the FFT-shear projector
    (`fft_radon.py`), `impl="matrix"` the exact Joseph matrix in ELL layout."""
    dev = resolve_device(device)
    key = ("parallel", tuple(im_shape), num_angles, impl, str(dev))
    if cache and key in _TRAFO_CACHE:
        return _TRAFO_CACHE[key]
    if impl == "fft":
        from .fft_radon import make_fft_parallel_trafo

        trafo = make_fft_parallel_trafo(im_shape, num_angles, device=dev)
    elif impl == "matrix":
        geom = parallel_beam_geometry(im_shape, num_angles)
        rows, cols, vals = joseph_system_matrix(geom)
        tables = _ell_pair(rows, cols, vals, int(np.prod(geom.obs_shape)), int(np.prod(im_shape)),
                           dev)
        trafo = RayTransform(*tables, im_shape=tuple(im_shape), obs_shape=geom.obs_shape,
                             angles=geom.angles)
        trafo.fbp_scale = calibrate_fbp_scale(trafo)
    else:
        raise ValueError(f"unknown parallel-beam impl {impl!r}: 'fft' or 'matrix'")
    if cache:
        _TRAFO_CACHE[key] = trafo
    return trafo


def make_matmul_trafo(matrix, im_shape: Tuple[int, int], obs_shape: Tuple[int, ...],
                      resize_shape: Optional[Tuple[int, int]] = None,
                      angles: Optional[np.ndarray] = None, calibrate_fbp: bool = True,
                      custom_fbp=None, device=None) -> RayTransform:
    """ELL operator of an explicit matrix (scipy sparse or dense numpy) over
    the image grid `im_shape`, optionally resized to `resize_shape`."""
    import scipy.sparse as sp

    if sp.issparse(matrix):
        coo = matrix.tocoo()
        rows, cols, vals = (coo.row.astype(np.int64), coo.col.astype(np.int64),
                            coo.data.astype(np.float32))
    else:
        matrix = np.asarray(matrix, dtype=np.float32)
        rows, cols = np.nonzero(matrix)
        vals = matrix[rows, cols]
    tables = _ell_pair(rows, cols, vals, int(np.prod(obs_shape)), int(np.prod(im_shape)),
                       resolve_device(device))
    trafo = RayTransform(*tables, im_shape=tuple(im_shape), obs_shape=tuple(obs_shape),
                         angles=angles, resize_shape=resize_shape, custom_fbp=custom_fbp)
    if calibrate_fbp and custom_fbp is None and len(obs_shape) == 2:
        trafo.fbp_scale = calibrate_fbp_scale(trafo)
    return trafo
