"""Reverse-diffusion sampling loop (DDS in this slice of the port).

Port of `SamplerSpec`, `_time_arrays`, `DiffusionSampler` and
`get_standard_sampler` of `sampling/engine.py` of the JAX package.  The JAX
package compiles the loop into one `lax.scan`; here it is a Python loop of
`dds_step`s.  The returned reconstruction is the last Tweedie estimate.

Noise comes from a `torch.Generator`, or is injected as `noises`: one prior
draw followed by one draw per step, all standard normal of the chain's shape.
The JAX package draws from split PRNG keys, which no torch generator can
reproduce, so parity tests hand its draws over this way.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.sde import DDPM, SDE
from ..ops.time_grids import ddpm_time_pairs, score_time_grid
from . import predictors as P

__all__ = ["SamplerSpec", "DiffusionSampler", "get_standard_sampler"]

_PORTED_METHODS = ("dds",)


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    method: str
    num_steps: int = 1000
    batch_size: int = 1
    im_shape: Tuple[int, int, int] = (256, 256, 1)   # (H, W, C)
    eps: float = 1e-3
    start_time_step: int = 0
    gamma: float = 0.01
    eta: float = 0.15
    cg_iter: int = 5
    use_simplified_eqn: bool = True
    # DDPM jump schedule
    travel_length: int = 1
    travel_repeat: int = 1
    early_stopping_pct: Optional[float] = None
    # accepted for compatibility and ignored: on the TPU it selects bf16x3
    # matmuls for CG; the port runs CG in fp32 with TF32 off
    cg_precision: Optional[str] = "high"

    def __post_init__(self):
        if self.method not in _PORTED_METHODS:
            raise NotImplementedError(
                f"sampling method {self.method!r} is not ported yet; the port has "
                f"{_PORTED_METHODS}")


def _time_arrays(sde: SDE, spec: SamplerSpec):
    """Per-step (t, t_prev, datafitscale) arrays and the step size."""
    if isinstance(sde, DDPM):
        pairs = ddpm_time_pairs(sde.num_steps, spec.num_steps, spec.travel_length,
                                spec.travel_repeat, spec.early_stopping_pct)
        ts = pairs[:, 0].astype(np.int32)
        tps = pairs[:, 1].astype(np.int32)
        dfs = np.ones(len(pairs), dtype=np.float32)
        step_size = 1.0
    else:
        grid = score_time_grid(spec.num_steps, spec.eps)
        step_size = float(grid[0] - grid[1])
        ts = grid
        # t_prev clamped at 0 so VP marginals stay defined on the last step
        tps = np.maximum(grid - step_size, 0.0).astype(np.float32)
        dfs = (grid / spec.num_steps).astype(np.float32)
    if spec.start_time_step:
        ts, tps, dfs = (a[spec.start_time_step:] for a in (ts, tps, dfs))
    return ts, tps, dfs, step_size


class DiffusionSampler:
    """Conditional DDS sampler: `score_fn(x, t)` gives the model output (score
    or epsilon) for NHWC `x`; `ray_trafo` and `observation` define the data."""

    def __init__(self, score_fn: Callable, sde: SDE, spec: SamplerSpec, ray_trafo,
                 observation: torch.Tensor, filtbackproj: Optional[torch.Tensor] = None):
        self.score_fn = score_fn
        self.sde = sde
        self.spec = spec
        if hasattr(ray_trafo, "with_gram"):
            ray_trafo = ray_trafo.with_gram()      # fused AᵀA tables for CG
        self.ray_trafo = ray_trafo
        self.observation = observation
        self.filtbackproj = filtbackproj
        self.rhs = ray_trafo.adjoint(observation)  # Aᵀy, once
        self._time_data = _time_arrays(sde, spec)

    @property
    def num_draws(self) -> int:
        """Standard-normal draws per chain: the prior, then one per step."""
        return 1 + len(self._time_data[0])

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence[torch.Tensor]] = None):
        """Run the reverse diffusion; returns (x_mean, None) like the JAX
        package's `sample` without a trace."""
        spec, sde = self.spec, self.sde
        ts, tps, _, _ = self._time_data
        b = spec.batch_size
        shape = (b, *spec.im_shape)
        device = self.rhs.device
        if noises is not None and len(noises) != self.num_draws:
            raise ValueError(f"{len(noises)} noise draws for {self.num_draws} needed")

        def draw(i):
            if noises is not None:
                return torch.as_tensor(noises[i], dtype=torch.float32, device=device)
            return torch.randn(shape, generator=generator, device=device)

        if spec.start_time_step > 0 and self.filtbackproj is not None:
            # chain initialised from the FBP at the first time step
            std = sde.marginal_prob_std(torch.full((b,), float(ts[0]), device=device))
            x = self.filtbackproj + draw(0) * std.reshape(b, 1, 1, 1)
        else:
            x = sde.prior_sampling(shape, noise=draw(0))
        t_dtype = torch.int64 if isinstance(sde, DDPM) else torch.float32
        x_mean = torch.zeros_like(x)
        for i, (t, t_prev) in enumerate(zip(ts.tolist(), tps.tolist())):
            tvec = torch.full((b,), t, dtype=t_dtype, device=device)
            tpvec = torch.full((b,), t_prev, dtype=t_dtype, device=device)
            x, x_mean = P.dds_step(self.score_fn, sde, x, tvec, tpvec, self.rhs,
                                   self.ray_trafo, spec.gamma, spec.eta, spec.cg_iter,
                                   draw(i + 1), use_simplified_eqn=spec.use_simplified_eqn)
        return x_mean, None


def get_standard_sampler(method: str, score_fn, sde, ray_trafo, observation, *,
                         num_steps: int = 1000, batch_size: int = 1, im_shape=None,
                         eps: float = 1e-3, gamma: float = 0.01, eta: float = 0.15,
                         cg_iter: int = 5, pct_chain_elapsed: float = 0.0,
                         travel_length: int = 1, travel_repeat: int = 1,
                         early_stopping_pct=None, filtbackproj=None,
                         cg_precision="high") -> DiffusionSampler:
    """Factory with the JAX package's defaults and flags (DDS only)."""
    import math

    if im_shape is None:
        h, w = ray_trafo.model_im_shape
        im_shape = (h, w, 1)
    spec = SamplerSpec(
        method=method.lower(), num_steps=int(num_steps), batch_size=batch_size,
        im_shape=tuple(im_shape), eps=eps, gamma=float(gamma), eta=float(eta),
        cg_iter=int(cg_iter),
        start_time_step=math.ceil(float(pct_chain_elapsed) * int(num_steps)),
        travel_length=travel_length, travel_repeat=travel_repeat,
        early_stopping_pct=early_stopping_pct, use_simplified_eqn=True,
        cg_precision=cg_precision)
    return DiffusionSampler(score_fn, sde, spec, ray_trafo, observation,
                            filtbackproj=filtbackproj)
