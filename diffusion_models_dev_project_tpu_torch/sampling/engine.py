"""Reverse-diffusion sampling loop: naive, DPS, DDS and unconditional.

Port of `SamplerSpec`, `_time_arrays`, `DiffusionSampler` and
`get_standard_sampler` of `sampling/engine.py` of the JAX package.  DDS
solves its data consistency by CG or, with `dc_mode="woodbury"` on a dense
matrix operator, exactly through S⁻¹ built once per sampler
(`ops/woodbury.py`).  The JAX
package compiles the loop into one `lax.scan`; here it is a Python loop of
predictor steps, each followed by the Langevin corrector when it is on.  The
returned reconstruction is the last step's `x_mean` (for DDS and DPS the
last Tweedie estimate).  With a ground truth, the per-step PSNR of `x_mean`
is kept on the device and returned with `return_trace=True`.

Noise comes from a `torch.Generator`, or is injected as `noises`: one prior
draw, then per step one draw for the predictor and one per corrector step,
all standard normal of the chain's shape, in the order the JAX engine
splits its keys.  No torch generator can reproduce JAX's split keys, so
parity tests hand its draws over this way.

With a `mesh` of several ranks (`parallel/mesh.py`; JAX: the batch axis
sharded over the mesh's `data` axis) each rank runs its rows of the batch:
of the observation, Aᵀy and the FBP, and of every draw, which it makes for
the whole batch and cuts, so that the chain sees the one-process run's
noise.  The norms that span the batch (naive's and DPS's data fit, the
corrector's step size) are all-reduced; the result is gathered on every
rank, and the PSNR trace (of image 0) is rank 0's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.sde import DDPM, SDE
from ..ops.woodbury import build_woodbury_sinv
from ..ops.time_grids import ddpm_time_pairs, score_time_grid
from ..parallel.mesh import gather_batch, replicate
from ..utils.device import resolve_device
from . import predictors as P

__all__ = ["SamplerSpec", "DiffusionSampler", "get_standard_sampler"]

_KNOWN_METHODS = ("naive", "dps", "dds", "uncond")
_DC_MODES = ("cg", "woodbury")


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    method: str
    num_steps: int = 1000
    batch_size: int = 1
    im_shape: Tuple[int, int, int] = (256, 256, 1)   # (H, W, C)
    eps: float = 1e-3
    start_time_step: int = 0
    penalty: float = 1.0             # naive and DPS
    gamma: float = 0.01
    eta: float = 0.15
    cg_iter: int = 5
    use_simplified_eqn: bool = True
    # Langevin corrector steps after each predictor step (VE/VP)
    corrector_steps: int = 0
    corrector_snr: float = 0.16
    # DDPM jump schedule
    travel_length: int = 1
    travel_repeat: int = 1
    early_stopping_pct: Optional[float] = None
    # accepted for compatibility and ignored: on the TPU it selects bf16x3
    # matmuls for CG; the port runs CG in fp32 with TF32 off
    cg_precision: Optional[str] = "high"
    # DDS data consistency: "cg" (cg_iter CG iterations, the reference's) or
    # "woodbury", the exact solve of ops/woodbury.py, for an operator with a
    # dense `.matrix` (physics/ray_trafo.py::DenseRayTransform)
    dc_mode: str = "cg"

    def __post_init__(self):
        if self.method not in _KNOWN_METHODS:
            raise NotImplementedError(f"unknown sampling method {self.method!r}; expected one "
                                      f"of {_KNOWN_METHODS}")
        if self.dc_mode not in _DC_MODES:
            raise ValueError(f"unknown dc_mode {self.dc_mode!r}; expected one of {_DC_MODES}")


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
    """Conditional or unconditional sampler: `score_fn(x, t)` gives the model
    output (score or epsilon) for NHWC `x`; `ray_trafo` and `observation`
    define the data (None for `uncond`), `ground_truth` turns on the PSNR
    trace.  Without an observation the chain runs on `device` (default
    CUDA)."""

    def __init__(self, score_fn: Callable, sde: SDE, spec: SamplerSpec, ray_trafo=None,
                 observation: Optional[torch.Tensor] = None,
                 ground_truth: Optional[torch.Tensor] = None,
                 filtbackproj: Optional[torch.Tensor] = None, device=None):
        self.score_fn = score_fn
        self.sde = sde
        self.spec = spec
        if spec.method == "dds" and hasattr(ray_trafo, "with_gram"):
            ray_trafo = ray_trafo.with_gram()      # fused AᵀA tables for CG
        if spec.method in ("naive", "dps", "dds") and (ray_trafo is None or observation is None):
            raise ValueError(f"method {spec.method!r} needs a ray_trafo and an observation")
        self.ray_trafo = ray_trafo
        self.observation = observation
        self.ground_truth = ground_truth
        self.filtbackproj = filtbackproj
        self.device = observation.device if observation is not None else resolve_device(device)
        # Aᵀy, once
        self.rhs = ray_trafo.adjoint(observation) if observation is not None else None
        # (gamma⁻¹ I + A Aᵀ)⁻¹, once per sampler, for the exact Woodbury solve
        self.dc_sinv = None
        if spec.method == "dds" and spec.dc_mode == "woodbury":
            if not hasattr(ray_trafo, "matrix"):
                raise ValueError("dc_mode='woodbury' needs a matrix-backed operator "
                                 f"(DenseRayTransform); got {type(ray_trafo).__name__}")
            self.dc_sinv = build_woodbury_sinv(ray_trafo, spec.gamma)
        self._time_data = _time_arrays(sde, spec)
        self._step_size = self._time_data[3]

    @property
    def corrector_steps(self) -> int:
        """Langevin steps after each predictor step (none for DDPM)."""
        return self.spec.corrector_steps if self.sde.prediction_type == "score" else 0

    @property
    def num_draws(self) -> int:
        """Standard-normal draws per chain: the prior, then per step one for
        the predictor and one per corrector step."""
        return 1 + len(self._time_data[0]) * (1 + self.corrector_steps)

    def _step(self, x, t, t_prev, datafitscale, noise, nloglik, observation=None, rhs=None):
        """One predictor step, dispatched as the JAX engine's `_step`, on the
        chain's rows of the observation and of Aᵀy (by default the
        sampler's)."""
        spec, sde = self.spec, self.sde
        observation = self.observation if observation is None else observation
        rhs = self.rhs if rhs is None else rhs
        if spec.method == "uncond":
            if sde.prediction_type == "score":
                return P.euler_maruyama_step(self.score_fn, sde, x, t, self._step_size, noise)
            return P.wrapper_ddim_step(self.score_fn, sde, x, t, t_prev, noise)
        if spec.method == "dds":
            return P.dds_step(self.score_fn, sde, x, t, t_prev, rhs, self.ray_trafo,
                              spec.gamma, spec.eta, spec.cg_iter, noise,
                              use_simplified_eqn=spec.use_simplified_eqn,
                              observation=observation, dc_sinv=self.dc_sinv)
        if isinstance(sde, DDPM):
            if spec.method == "dps":
                return P.ancestral_step(self.score_fn, sde, x, t, noise, nloglik, spec.penalty)
            raise NotImplementedError(f"{spec.method} for DDPM")
        return P.euler_maruyama_step(self.score_fn, sde, x, t, self._step_size, noise,
                                     nloglik=nloglik, datafitscale=datafitscale,
                                     penalty=spec.penalty, aTweedy=spec.method == "dps")

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence[torch.Tensor]] = None, return_trace: bool = False,
               mesh=None):
        """Run the reverse diffusion; returns (x_mean, trace) with `trace` the
        per-step PSNR of x_mean against `ground_truth` (zeros without one), a
        tensor on the chain's device, when `return_trace`, else (x_mean, None).
        With a `mesh` of several ranks (`parallel/mesh.py::make_mesh`) the
        batch is sharded over them (see the module's docstring); every rank
        returns the whole batch."""
        spec, sde = self.spec, self.sde
        ts, tps, dfs, _ = self._time_data
        rows = slice(None) if mesh is None else mesh.rows(spec.batch_size)
        b = spec.batch_size // (1 if mesh is None else mesh.world)
        shape = (b, *spec.im_shape)
        device = self.device
        if noises is not None and len(noises) != self.num_draws:
            raise ValueError(f"{len(noises)} noise draws for {self.num_draws} needed")
        draws = iter(noises) if noises is not None else None

        def draw():
            """The whole batch's next draw; this rank's rows of it."""
            if draws is not None:
                return torch.as_tensor(next(draws), dtype=torch.float32, device=device)[rows]
            return torch.randn((spec.batch_size, *spec.im_shape), generator=generator,
                               device=device)[rows]

        def local(a):
            return None if a is None else a[rows]

        observation, rhs = local(self.observation), local(self.rhs)
        if spec.start_time_step > 0 and self.filtbackproj is not None:
            # chain initialised from the FBP at the first time step
            std = sde.marginal_prob_std(torch.full((b,), float(ts[0]), device=device))
            x = local(self.filtbackproj) + draw() * std.reshape(b, 1, 1, 1)
        else:
            x = sde.prior_sampling(shape, noise=draw())
        gt = self.ground_truth
        if gt is not None:
            gt_range = 20 * torch.log10(gt.max() - gt.min())
        trace = torch.zeros(len(ts), device=device)
        nloglik = (P.make_nloglik(self.ray_trafo, observation, mesh)
                   if spec.method in ("naive", "dps") else None)
        t_dtype = torch.int64 if isinstance(sde, DDPM) else torch.float32
        x_mean = torch.zeros_like(x)
        for i, (t, t_prev, datafitscale) in enumerate(zip(ts.tolist(), tps.tolist(),
                                                          dfs.tolist())):
            tvec = torch.full((b,), t, dtype=t_dtype, device=device)
            tpvec = torch.full((b,), t_prev, dtype=t_dtype, device=device)
            x, x_mean = self._step(x, tvec, tpvec, datafitscale, draw(), nloglik, observation,
                                   rhs)
            if self.corrector_steps:
                x = P.langevin_corrector(self.score_fn, sde, x, tvec,
                                         [draw() for _ in range(self.corrector_steps)],
                                         nloglik=nloglik, datafitscale=datafitscale,
                                         penalty=spec.penalty, snr=spec.corrector_snr, mesh=mesh)
            if gt is not None:
                # rank 0's first row is image 0
                mse = (x_mean[0, ..., 0] - gt[0, ..., 0]).square().mean()
                trace[i] = gt_range - 10 * torch.log10(mse)
        if mesh is not None:
            x_mean, trace = gather_batch(mesh, x_mean), replicate(mesh, trace)
        return (x_mean, trace) if return_trace else (x_mean, None)


def get_standard_sampler(method: str, score_fn, sde, ray_trafo, observation, *,
                         num_steps: int = 1000, batch_size: int = 1, im_shape=None,
                         eps: float = 1e-3, penalty: float = 1.0, gamma: float = 0.01,
                         eta: float = 0.15, cg_iter: int = 5, pct_chain_elapsed: float = 0.0,
                         travel_length: int = 1, travel_repeat: int = 1,
                         early_stopping_pct=None, ground_truth=None, filtbackproj=None,
                         score_apply=None, score_params=None, add_corrector_step: bool = False,
                         corrector_snr: float = 0.16, cg_precision="high", dc_mode="cg",
                         device=None) -> DiffusionSampler:
    """Factory with the JAX package's defaults and keywords.  `score_apply(
    params, x, t)` with `score_params` may stand in for `score_fn`, as in the
    JAX package; `device` places a chain that has no observation."""
    import math

    if score_fn is None and score_apply is not None:
        score_fn = lambda x, t: score_apply(score_params, x, t)  # noqa: E731
    if im_shape is None:
        h, w = ray_trafo.model_im_shape
        im_shape = (h, w, 1)
    spec = SamplerSpec(
        method=method.lower(), num_steps=int(num_steps), batch_size=batch_size,
        im_shape=tuple(im_shape), eps=eps, penalty=float(penalty), gamma=float(gamma),
        eta=float(eta), cg_iter=int(cg_iter),
        start_time_step=math.ceil(float(pct_chain_elapsed) * int(num_steps)),
        travel_length=travel_length, travel_repeat=travel_repeat,
        early_stopping_pct=early_stopping_pct, use_simplified_eqn=True,
        corrector_steps=1 if add_corrector_step else 0, corrector_snr=float(corrector_snr),
        cg_precision=cg_precision, dc_mode=dc_mode)
    return DiffusionSampler(score_fn, sde, spec, ray_trafo, observation,
                            ground_truth=ground_truth, filtbackproj=filtbackproj, device=device)
