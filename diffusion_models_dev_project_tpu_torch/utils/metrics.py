"""Image quality metrics: PSNR and SSIM (numpy).

Copy of `utils/metrics.py` of the JAX package, with its conventions:
- PSNR: 20 log10(range) - 10 log10(mse), data range = max(gt) - min(gt),
- SSIM: skimage `structural_similarity` defaults — 7x7 uniform filter,
  K1=0.01, K2=0.03, no gaussian weighting, in numpy.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PSNR", "SSIM"]


def PSNR(reconstruction, ground_truth, data_range=None) -> float:
    gt = np.asarray(ground_truth, dtype=np.float64)
    rec = np.asarray(reconstruction, dtype=np.float64)
    mse = np.mean((rec - gt) ** 2)
    if mse == 0.0:
        return float("inf")
    if data_range is None:
        data_range = np.max(gt) - np.min(gt)
    return float(20 * np.log10(data_range) - 10 * np.log10(mse))


def _uniform_filter2d(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with reflect padding, matching scipy's uniform_filter."""
    # scipy.ndimage.uniform_filter default mode is 'reflect'
    pad_lo = size // 2
    pad_hi = size - 1 - pad_lo
    xp = np.pad(x, ((pad_lo, pad_hi), (pad_lo, pad_hi)), mode="reflect")
    c = np.cumsum(np.cumsum(xp, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (c[size:, size:] - c[:-size, size:] - c[size:, :-size] + c[:-size, :-size])
    return s / (size * size)


def SSIM(reconstruction, ground_truth, data_range=None, win_size: int = 7,
         K1: float = 0.01, K2: float = 0.03) -> float:
    x = np.asarray(reconstruction, dtype=np.float64)
    y = np.asarray(ground_truth, dtype=np.float64)
    if x.shape != y.shape or x.ndim != 2:
        raise ValueError(f"SSIM wants two equal 2-D images, got {x.shape} and {y.shape}")
    if data_range is None:
        data_range = np.max(y) - np.min(y)

    # skimage structural_similarity with gaussian_weights=False:
    # local statistics via uniform filter, sample covariance normalization
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    ux = _uniform_filter2d(x, win_size)
    uy = _uniform_filter2d(y, win_size)
    uxx = _uniform_filter2d(x * x, win_size)
    uyy = _uniform_filter2d(y * y, win_size)
    uxy = _uniform_filter2d(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux ** 2 + uy ** 2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    # skimage crops win_size//2 border before averaging
    pad = (win_size - 1) // 2
    return float(S[pad:S.shape[0] - pad, pad:S.shape[1] - pad].mean())
