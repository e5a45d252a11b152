"""Fourier ramp filtering for filtered back-projection.

Port of `ops/fbp.py` of the JAX package: zero-pad the detector axis to a
power of two, multiply the spectrum by the filter's response, transform
back, crop and scale by pi / (2 * n_angles).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ramp_filter_sinogram", "fourier_filter"]


def fourier_filter(size: int, filter_name: str = "ramp") -> np.ndarray:
    """Frequency response of the reconstruction filter on an rfft grid."""
    f = np.fft.rfftfreq(size)
    ramp = 2.0 * np.abs(f)
    if filter_name == "ramp":
        resp = ramp
    elif filter_name == "shepp-logan":
        resp = ramp * np.sinc(f)
    elif filter_name == "cosine":
        resp = ramp * np.cos(np.pi * f / 2.0)
    elif filter_name == "hann":
        resp = ramp * (1.0 + np.cos(2.0 * np.pi * f)) / 2.0
    else:
        raise ValueError(f"unknown filter {filter_name!r}")
    return resp.astype(np.float32)


def ramp_filter_sinogram(sino: torch.Tensor, filter_name: str = "ramp") -> torch.Tensor:
    """Filter a (B, A, D, C) sinogram along the detector axis; same shape
    and dtype."""
    _, a, d, _ = sino.shape
    padded = max(64, int(2 ** np.ceil(np.log2(2 * d))))
    x = torch.movedim(sino.float(), 2, -1)                     # (B, A, C, D)
    x = torch.nn.functional.pad(x, (0, padded - d))
    resp = torch.from_numpy(fourier_filter(padded, filter_name)).to(x.device)
    filt = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * resp, n=padded, dim=-1)[..., :d]
    filt = filt * (np.pi / (2.0 * a))
    return torch.movedim(filt, -1, 2).to(sino.dtype)
