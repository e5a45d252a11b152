"""Gather-free parallel-beam Radon transform via FFT shear rotations.

Port of `physics/fft_radon.py` of the JAX package.  Each angle θ is reduced
to |φ| ≤ 45° around a `rot90`, and its projection is one sinc shear along
the rows followed by a row sum and a sec-scaled detector resampling:

    project(θ)[t] = sec φ · Σ_rows  shear_x(image, −tan φ)[row, t·sec φ]

The shear is a DFT-as-matmul along rows, the row sum is taken in the
frequency domain, and the detector resampling is a per-angle matrix, so the
whole projection is a chain of batched matmuls (cuBLAS here, in fp32).  The
angles are stacked in B chunks of G on a leading axis (`k90s` holds each
chunk's quarter turn, `inv_perm` maps the stacked order back to the
geometry's).  The tables are built on the host in numpy (float64, stored as
float32) and moved to the operator's device once.

The reference gets its adjoint from `jax.linear_transpose`; here the
transposes of `_front` and `_apply_flat` are written out: the zero pad
becomes a crop, `rot90(-k)` becomes `rot90(+k)`, each einsum is
transposed, and the `inv_perm` gather becomes a scatter-add.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.fbp import ramp_filter_sinogram
from .geometry import parallel_beam_geometry

__all__ = ["FFTRayTransform", "make_fft_parallel_trafo", "calibrate_fbp_scale"]


def _canvas_size(im_shape: Tuple[int, int]) -> int:
    """Canvas on which content never wraps under the shears (2.5 d, rounded
    up to a multiple of 64)."""
    d = max(im_shape)
    return int(int(np.ceil(2.5 * d / 64)) * 64)


def _dft_matrices(P: int):
    """Real rfft/irfft bases: X = x @ (Fr + i Fi); x = Re(X) @ Br + Im(X) @ Bi."""
    n = np.arange(P)
    k = np.arange(P // 2 + 1)
    ang = 2 * np.pi * np.outer(n, k) / P                 # (P, Pf)
    Fr, Fi = np.cos(ang), -np.sin(ang)
    w = np.full(P // 2 + 1, 2.0)
    w[0] = 1.0
    if P % 2 == 0:
        w[-1] = 1.0
    Br = (w[:, None] * np.cos(ang.T) / P)                # (Pf, P)
    Bi = (-w[:, None] * np.sin(ang.T) / P)
    return tuple(m.astype(np.float32) for m in (Fr, Fi, Br, Bi))


def _shear_phases(phis_g: np.ndarray, P: int):
    """Phase ramps of the per-angle x-shear with a = −tan φ: (G, P, Pf) cos/sin."""
    k = np.arange(P // 2 + 1, dtype=np.float64)
    r = np.arange(P, dtype=np.float64) - (P - 1) / 2
    a = -np.tan(phis_g)                                         # (G,)
    ang = -2 * np.pi * (a[:, None, None] * r[None, :, None]) * k / P
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _det_interp_matrices(P: int, det_count: int, det_spacing: float,
                         phis: np.ndarray) -> np.ndarray:
    """Per-angle sec-scaled linear resampling from the canvas column grid to
    the detector: (A, P, D)."""
    A = len(phis)
    M = np.zeros((A, P, det_count), np.float32)
    tk = (np.arange(det_count) - (det_count - 1) / 2) * det_spacing
    d = np.arange(det_count)
    for a, phi in enumerate(phis):
        sec = 1.0 / np.cos(phi)
        pos = tk * sec + (P - 1) / 2
        j0 = np.floor(pos).astype(int)
        frac = pos - j0
        lo = (j0 >= 0) & (j0 < P)
        hi = (j0 + 1 >= 0) & (j0 + 1 < P)
        M[a, j0[lo], d[lo]] = (1 - frac[lo]) * abs(sec)
        M[a, j0[hi] + 1, d[hi]] = frac[hi] * abs(sec)
    return M


@dataclasses.dataclass
class FFTRayTransform:
    """Parallel-beam operator: `apply`, `adjoint`, `gram` and `fbp` on NHWC
    images and (B, A, D, C) sinograms, fp32 on the tables' device."""

    det_matrix: torch.Tensor                 # (B, G, P, D)
    shear_cos: torch.Tensor                  # (B, G, P, Pf)
    shear_sin: torch.Tensor                  # (B, G, P, Pf)
    dft: tuple                               # (Fr, Fi, Br, Bi)
    im_shape: Tuple[int, int]
    obs_shape: Tuple[int, int]
    canvas: int
    k90s: Tuple[int, ...]                    # per-chunk quarter turns
    inv_perm: torch.Tensor                   # angle a -> its slot in (B·G)
    angles: Optional[np.ndarray] = None
    fbp_scale: float = 1.0
    fbp_filter: str = "ramp"
    # fused-Gram tables (Q1, Q2, Q4), each (B, G, Pf, Pf); None until with_gram()
    gram_q: Optional[tuple] = None

    @property
    def device(self) -> torch.device:
        return self.det_matrix.device

    @property
    def model_im_shape(self) -> Tuple[int, int]:
        return self.im_shape

    # --- forward -----------------------------------------------------------
    def _front(self, x: torch.Tensor):
        """(N, H, W) image -> row-frequency projections (Zr, Zi), each (B, N, G, Pf)."""
        P = self.canvas
        h, w = self.im_shape
        oy, ox = (P - h) // 2, (P - w) // 2
        base = x.new_zeros((x.shape[0], P, P))
        base[:, oy:oy + h, ox:ox + w] = x
        Fr, Fi, _, _ = self.dft
        ims = torch.stack([torch.rot90(base, -(k % 4), dims=(-2, -1)) for k in self.k90s])
        Xr, Xi = ims @ Fr, ims @ Fi                          # (B, N, P, Pf)
        pr, pi = self.shear_cos, self.shear_sin
        Zr = (torch.einsum("bnpk,bgpk->bngk", Xr, pr)
              - torch.einsum("bnpk,bgpk->bngk", Xi, pi))
        Zi = (torch.einsum("bnpk,bgpk->bngk", Xr, pi)
              + torch.einsum("bnpk,bgpk->bngk", Xi, pr))
        return Zr, Zi

    def _front_t(self, Zr: torch.Tensor, Zi: torch.Tensor) -> torch.Tensor:
        """Transpose of `_front`: (B, N, G, Pf) pair -> (N, H, W)."""
        P = self.canvas
        h, w = self.im_shape
        oy, ox = (P - h) // 2, (P - w) // 2
        Fr, Fi, _, _ = self.dft
        pr, pi = self.shear_cos, self.shear_sin
        Xr = (torch.einsum("bngk,bgpk->bnpk", Zr, pr)
              + torch.einsum("bngk,bgpk->bnpk", Zi, pi))
        Xi = (torch.einsum("bngk,bgpk->bnpk", Zi, pr)
              - torch.einsum("bngk,bgpk->bnpk", Zr, pi))
        ims = Xr @ Fr.T + Xi @ Fi.T                          # (B, N, P, P)
        base = sum(torch.rot90(ims[i], k % 4, dims=(-2, -1))
                   for i, k in enumerate(self.k90s))
        return base[:, oy:oy + h, ox:ox + w]

    def _apply_flat(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W) -> (N, A, D)."""
        _, _, Br, Bi = self.dft
        Zr, Zi = self._front(x)
        colsum = Zr @ Br + Zi @ Bi                           # (B, N, G, P)
        sino = torch.einsum("bngp,bgpd->bngd", colsum, self.det_matrix)
        stacked = sino.permute(1, 0, 2, 3).reshape(x.shape[0], -1, self.obs_shape[1])
        return stacked[:, self.inv_perm, :]

    def _apply_flat_t(self, y: torch.Tensor) -> torch.Tensor:
        """Transpose of `_apply_flat`: (N, A, D) -> (N, H, W)."""
        _, _, Br, Bi = self.dft
        nB, nG = self.det_matrix.shape[:2]
        stacked = y.new_zeros((y.shape[0], nB * nG, y.shape[2]))
        stacked.index_add_(1, self.inv_perm, y)
        sino = stacked.reshape(y.shape[0], nB, nG, -1).permute(1, 0, 2, 3)
        colsum = torch.einsum("bngd,bgpd->bngp", sino, self.det_matrix)
        return self._front_t(colsum @ Br.T, colsum @ Bi.T)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> (B, A, D, C) sinogram."""
        b, h, w, c = x.shape
        flat = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
        obs = self._apply_flat(flat)
        return obs.reshape(b, c, *self.obs_shape).permute(0, 2, 3, 1)

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        """Exact transpose of `apply`: (B, A, D, C) -> NHWC."""
        b, c = y.shape[0], y.shape[-1]
        flat = y.permute(0, 3, 1, 2).reshape(b * c, *self.obs_shape)
        x = self._apply_flat_t(flat)
        return x.reshape(b, c, *self.im_shape).permute(0, 2, 3, 1)

    # --- fused Gram ----------------------------------------------------------
    def with_gram(self) -> "FFTRayTransform":
        """A copy carrying the fused-Gram tables: with A = S·T·C (C = `_front`,
        T = detector resolve, S = angle selection), AᵀA = Cᵀ (Tᵀ SᵀS T) C, and
        the middle is per angle the real 2x2-block [[Q1, Q2ᵀ], [Q2, Q4]] with
        Q1 = Br·W·Brᵀ, Q2 = Bi·W·Brᵀ, Q4 = Bi·W·Biᵀ, W = M·Mᵀ.  Padded
        duplicate slots are zeroed.  Built once in float64 and memoised."""
        if self.gram_q is not None:
            return self
        cached = getattr(self, "_gram_cache", None)
        if cached is not None:
            return cached
        det = self.det_matrix.double().cpu().numpy()        # (B, G, P, D)
        _, _, Br, Bi = (m.double().cpu().numpy() for m in self.dft)
        nB, nG = det.shape[:2]
        selected = np.zeros(nB * nG, bool)
        selected[self.inv_perm.cpu().numpy()] = True
        Pf = Br.shape[0]
        q1, q2, q4 = (np.zeros((nB, nG, Pf, Pf), np.float32) for _ in range(3))
        for b in range(nB):
            for g in range(nG):
                if not selected[b * nG + g]:
                    continue
                M = det[b, g]                                # (P, D)
                u = M @ (M.T @ Br.T)                         # W·Brᵀ
                v = M @ (M.T @ Bi.T)                         # W·Biᵀ
                q1[b, g], q2[b, g], q4[b, g] = Br @ u, Bi @ u, Bi @ v
        out = dataclasses.replace(
            self, gram_q=tuple(torch.from_numpy(q).to(self.device) for q in (q1, q2, q4)))
        self._gram_cache = out
        return out

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        """AᵀA x (== `adjoint(apply(x))` to round-off), NHWC."""
        if self.gram_q is None:
            return self.adjoint(self.apply(x))
        q1, q2, q4 = self.gram_q
        b, h, w, c = x.shape
        flat = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
        Zr, Zi = self._front(flat)
        Zpr = (torch.einsum("bngk,bgkj->bngj", Zr, q1)
               + torch.einsum("bngk,bgkj->bngj", Zi, q2))
        Zpi = (torch.einsum("bngk,bgjk->bngj", Zr, q2)
               + torch.einsum("bngk,bgkj->bngj", Zi, q4))
        out = self._front_t(Zpr, Zpi)
        return out.reshape(b, c, h, w).permute(0, 2, 3, 1)

    def fbp(self, y: torch.Tensor) -> torch.Tensor:
        return self.adjoint(ramp_filter_sinogram(y, filter_name=self.fbp_filter)) * self.fbp_scale


def calibrate_fbp_scale(trafo) -> float:
    """The scalar making FBP(A(blob)) ~ blob for a smooth phantom (the JAX
    package's `physics/ray_trafo.py::_calibrate_fbp_scale`)."""
    h, w = trafo.im_shape
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    blob = np.exp(-((xx ** 2 + yy ** 2) / 0.15)).astype(np.float32)
    x = torch.from_numpy(blob)[None, :, :, None].to(trafo.device)
    rec = trafo.fbp(trafo.apply(x))[0, :, :, 0].cpu().numpy()
    return float((blob * rec).sum() / (rec * rec).sum())


def make_fft_parallel_trafo(im_shape: Tuple[int, int], num_angles: int,
                            device="cpu") -> FFTRayTransform:
    """The FFT-shear operator on `parallel_beam_geometry`, its tables on `device`."""
    geom = parallel_beam_geometry(im_shape, num_angles)
    P = _canvas_size(im_shape)
    # quadrant reduction: theta = k90*(pi/2) + phi, |phi| <= pi/4
    k90s_all = np.round(geom.angles / (np.pi / 2)).astype(int)
    phis = geom.angles - k90s_all * (np.pi / 2)
    groups = {}
    for i, k in enumerate(k90s_all):
        groups.setdefault(int(k), []).append(i)
    # uniform chunk size: gcd chunking when the group sizes share a large
    # divisor (60 angles: [15, 30, 15] -> 4 chunks of 15), else pad every
    # group to the largest by repeating its last angle
    gsz = math.gcd(*(len(v) for v in groups.values()))
    gcd_chunks = [(k, idxs[s:s + gsz])
                  for k, idxs in sorted(groups.items())
                  for s in range(0, len(idxs), gsz)]
    if len(gcd_chunks) <= 2 * len(groups):
        chunks = gcd_chunks
    else:
        G = max(len(v) for v in groups.values())
        chunks = [(k, idxs + [idxs[-1]] * (G - len(idxs)))
                  for k, idxs in sorted(groups.items())]
    det_all = _det_interp_matrices(P, geom.det_count, geom.det_spacing, phis)
    det_stack, cos_stack, sin_stack, flat_order = [], [], [], []
    for _, idxs in chunks:
        det_stack.append(det_all[np.asarray(idxs)])
        pr, pi = _shear_phases(phis[np.asarray(idxs)], P)
        cos_stack.append(pr)
        sin_stack.append(pi)
        flat_order.extend(idxs)
    # each angle -> its FIRST slot (assigned in reverse so earlier slots win)
    inv_perm = np.empty(num_angles, np.int64)
    flat = np.asarray(flat_order)
    inv_perm[flat[::-1]] = np.arange(len(flat))[::-1]
    dev = torch.device(device)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    trafo = FFTRayTransform(
        det_matrix=to(np.stack(det_stack)),
        shear_cos=to(np.stack(cos_stack)), shear_sin=to(np.stack(sin_stack)),
        dft=tuple(to(m) for m in _dft_matrices(P)),
        im_shape=tuple(im_shape), obs_shape=geom.obs_shape, canvas=P,
        k90s=tuple(k for k, _ in chunks), inv_perm=to(inv_perm),
        angles=geom.angles)
    trafo.fbp_scale = calibrate_fbp_scale(trafo)
    return trafo
