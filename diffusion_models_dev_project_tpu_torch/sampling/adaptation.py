"""Steerable test-time adaptation inside the DDS sampling loop.

Port of `sampling/adaptation.py` of the JAX package, with its three
strategies (`is_adapt_param`): `lora` trains the LoRA branches of the UNet
and its non-emb biases, `full` every parameter, `decoder` the output blocks
and the final norm and conv but their time-embedding projections.  At
every `adapt_freq`-th step the sampler trains them for `num_optim_step`
Adam steps on

    mean((A x̂ - y)²) + tv_penalty · TV(x̂),   x̂ = DC(Tweedie(score(x, t)))

with a fresh Adam per adaptation (β 0.9/0.999, ε 1e-8 outside the square
root, as `optax.adam`).  Then the adapted score (`lora_scale` 1) drives
Tweedie and the data consistency, and the prior score (`lora_scale` 0)
drives the DDIM step; `full` and `decoder` models carry no LoRA branches,
so there `lora_scale` changes nothing and the adapted score drives both, as
in the JAX package.  The result is the last Tweedie estimate under the
adapted score.

The JAX package compiles the two-level loop into one program; here it is a
Python loop under `torch.no_grad()`, each adaptation under
`torch.enable_grad()`.  The gradient runs through the port's hand kernels:
the conv3x3 input and weight gradients and the attention backward
(`ops/`).  The other weights stay frozen; the trainable leaves
(`split_adapt_params`) are fp32 masters, cast at use
(`factory.get_standard_score(..., adaptation=...)`).  Noise comes from a
`torch.Generator` or is injected as `noises`: the prior draw, then one draw
per step.

Several images per call (`sample_batched`, JAX's vmapped multi-image mode):
under `lora` the images share the chain's batch axis, and each trainable
leaf becomes a stack with one row per image, swapped into the model by
`torch.func.functional_call` (models/unet.py), so that each image keeps its
own LoRA, its own biases and its own Adam state.  The inner loss is the sum
of the images' own losses, so each row's gradient is its image's alone.
`full` and `decoder` train every base weight they touch per image, which
leaves no shared weight to batch: their images run one after another
through the single-image program.  With a `mesh` of several ranks
(`parallel/mesh.py`; JAX: a `shard_map` of the vmapped program over the
mesh's `data` axis) each rank takes its rows of the images (observations,
LoRA states, draws) and runs them so; the result is gathered.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..models.unet import LoRAConv, LoRADense
from ..ops.cg import cg
from ..ops.diffusion import ddim, tweedy
from ..ops.sde import DDPM, SDE
from ..parallel.mesh import gather_batch
from .engine import SamplerSpec, _time_arrays
from .predictors import make_dc_op

__all__ = ["STRATEGIES", "check_strategy", "tv_loss", "is_adapt_param", "split_adapt_params",
           "init_lora", "AdaptSpec", "AdaptedSampler", "BatchedImages",
           "get_standard_adapted_sampler"]

STRATEGIES = ("lora", "full", "decoder")


def check_strategy(impl: str) -> None:
    """Raise NotImplementedError unless `impl` is one of `STRATEGIES`."""
    if impl not in STRATEGIES:
        raise NotImplementedError(f"adaptation strategy {impl!r}; the port has {STRATEGIES}")


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation of NHWC `x` with the reference's corner
    cropping (JAX `tv_loss`)."""
    dw = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs()
    dh = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs()
    return (dw[:, :-1, :, :] + dh[:, :, :-1, :]).sum()


def _is_lora(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2].endswith("_lora")


def is_adapt_param(name: str, impl: str = "lora") -> bool:
    """Whether parameter `name` of the port's UNet is trained by strategy
    `impl` (JAX `_is_adapt_param`, on the port's names, which follow the
    flax tree): `full`, every parameter; `decoder`, the `out_*` blocks and
    `final_norm` / `final_conv`, but the ResBlocks' time-embedding
    projections `emb`; `lora`, every bias outside `emb` (GroupNorm biases
    included) and every LoRA weight (the JAX package carries those in their
    own collection).  Another strategy raises NotImplementedError."""
    parts = name.split(".")
    if impl == "full":
        return True
    if impl == "decoder":
        in_decoder = parts[0].startswith("out_") or parts[0] in ("final_norm", "final_conv")
        return in_decoder and "emb" not in parts[:-1]
    check_strategy(impl)
    return _is_lora(name) or (parts[-1] == "bias" and "emb" not in parts[:-1])


def split_adapt_params(model: torch.nn.Module, impl: str = "lora"
                       ) -> Tuple[Dict[str, torch.nn.Parameter], Dict[str, torch.nn.Parameter]]:
    """(trainable, frozen) parameters of `model` by name, for strategy `impl`."""
    train, frozen = {}, {}
    for name, p in model.named_parameters():
        (train if is_adapt_param(name, impl) else frozen)[name] = p
    return train, frozen


def init_lora(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A fresh LoRA state for `model`, the values of JAX `init_lora`: every
    `down` drawn from N(0, 1/r²) with numpy's generator of `seed`, every `up`
    0, so the branches start as exact no-ops.  The draws follow the JAX
    `lora` tree: its leaves in sorted path order ((module, ..., "down" |
    "up"), the flax module names of `models/unet.py`), each `down` drawn in
    the flax layout (3x3 HWIO (3, 3, Cin, r), 1x1 (1, 1, Cin, r), dense
    (Cin, r)) and laid out as the port holds it (`models/convert.py::
    lora_from_flax`).  fp32, on the model's device."""
    rng = np.random.default_rng(seed)
    mods = {tuple(name.split(".")): mod for name, mod in model.named_modules()
            if isinstance(mod, (LoRAConv, LoRADense))}
    out = {}
    for path in sorted(p + (leaf,) for p in mods for leaf in ("down", "up")):
        mod = mods[path[:-1]]
        name = ".".join(path)
        if path[-1] == "up":
            out[name] = torch.zeros(tuple(mod.up.shape), device=mod.up.device)
            continue
        rank = mod.up.shape[1]
        if mod.down.ndim == 4:                    # 3x3: HWIO in both
            down = rng.normal(0.0, 1.0 / rank, tuple(mod.down.shape))
        else:                                     # 1x1 conv (1, 1, Cin, r), dense (Cin, r)
            flax_shape = ((1, 1) if isinstance(mod, LoRAConv) else ()) + tuple(mod.down.shape[::-1])
            down = rng.normal(0.0, 1.0 / rank, flax_shape).reshape(mod.down.shape[::-1]).T
        out[name] = torch.from_numpy(np.ascontiguousarray(down, dtype=np.float32)).to(
            mod.down.device)
    return out


class BatchedImages(NamedTuple):
    """N images of a `lora` chain (`AdaptedSampler.batched_inputs`): the
    stacked trainable leaves (name -> (N, ...)), the observations as one
    batch and their Aᵀy."""
    leaves: Dict[str, torch.Tensor]
    observation: torch.Tensor
    rhs: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaptSpec:
    """Adaptation hyper-parameters (JAX `AdaptSpec`)."""

    num_optim_step: int = 10
    adapt_freq: int = 1
    lr: float = 1e-3
    tv_penalty: float = 1e-6
    gamma: float = 0.01
    dc_type: str = "cg"            # 'cg' | 'gd' | 'none'
    add_cg: bool = False
    cg_iter: int = 1
    impl: str = "lora"             # 'lora' | 'full' | 'decoder'

    def __post_init__(self):
        check_strategy(self.impl)
        if self.dc_type not in ("cg", "gd", "none"):
            raise NotImplementedError(f"dc_type {self.dc_type!r}")


class AdaptedSampler:
    """Adapted (steerable) DDS sampler over the UNet `model`, starting every
    `sample` from the LoRA state `lora` (empty for `full` and `decoder`)
    and the model's other trainable leaves as they were when the sampler
    was made; the model's parameters are restored after each `sample`."""

    def __init__(self, model, lora: Dict[str, torch.Tensor], sde: SDE, spec: SamplerSpec,
                 adapt: AdaptSpec, ray_trafo, observation: torch.Tensor,
                 ground_truth: Optional[torch.Tensor] = None):
        self.model = model
        self.sde = sde
        self.spec = spec
        self.adapt = adapt
        if adapt.dc_type == "cg" and hasattr(ray_trafo, "with_gram"):
            ray_trafo = ray_trafo.with_gram()      # fused AᵀA for the CG loop
        self.ray_trafo = ray_trafo
        self.observation = observation
        self.lora = lora
        self.rhs = ray_trafo.adjoint(observation)
        self.ground_truth = (None if ground_truth is None else
                             torch.as_tensor(ground_truth, dtype=torch.float32,
                                             device=self.rhs.device))
        self.trainable, _ = split_adapt_params(model, adapt.impl)
        if set(n for n in self.trainable if _is_lora(n)) != set(lora):
            raise ValueError("the LoRA state does not name the model's LoRA weights")
        # the start state of the trainable leaves that are not LoRA weights
        self.start = {n: p.detach().clone() for n, p in self.trainable.items() if not _is_lora(n)}
        self._time_data = _time_arrays(sde, spec)

    @property
    def num_draws(self) -> int:
        """Standard-normal draws per chain: the prior, then one per step."""
        return 1 + len(self._time_data[0])

    def score(self, x, t, lora_scale: float, use_kernel: bool = True, leaves=None):
        """The model's output; with `leaves` (stacked per image, see
        `batched_inputs`) in place of the trainable parameters."""
        kw = {"use_kernel": use_kernel, "lora_scale": lora_scale}
        if leaves is None:
            return self.model(x, t, **kw)
        return functional_call(self.model, leaves, (x, t), kw)

    def data_consistency(self, xhat0: torch.Tensor, dc_type: str, n_iter: int,
                         rhs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x̂0 -> data-consistent x̂ (JAX `_data_consistency`), for the
        sampler's Aᵀy or the given `rhs`."""
        gamma, trafo = self.adapt.gamma, self.ray_trafo
        rhs = self.rhs if rhs is None else rhs
        if dc_type == "cg":
            return cg(make_dc_op(trafo, gamma), xhat0, xhat0 + gamma * rhs, n_iter=n_iter)
        if dc_type == "gd":
            return xhat0 - gamma * trafo.adjoint(trafo.apply(xhat0)) + gamma * rhs
        return xhat0

    def adaptation_loss(self, x: torch.Tensor, t: torch.Tensor, use_kernel: bool = True,
                        images: Optional[BatchedImages] = None) -> torch.Tensor:
        """The inner loss: score -> Tweedie -> data consistency ->
        mean((A x̂ - y)²) + tv_penalty · TV(x̂).  With `images`
        (`batched_inputs`), x holds one row per image, the score runs with
        their stacked leaves, and the loss is the sum of the images' own."""
        ad = self.adapt
        leaves, obs, rhs = (None, self.observation, None) if images is None else images
        xhat0 = tweedy(self.score(x, t, 1.0, use_kernel, leaves), x, self.sde, t)
        xhat = self.data_consistency(xhat0, ad.dc_type, ad.cg_iter, rhs)
        sq = (self.ray_trafo.apply(xhat) - obs).square()
        data = sq.mean() if images is None else sq.reshape(sq.shape[0], -1).mean(dim=1).sum()
        return data + ad.tv_penalty * tv_loss(xhat)

    def adapt_step(self, x: torch.Tensor, t: torch.Tensor,
                   images: Optional[BatchedImages] = None) -> None:
        """One adaptation: a fresh Adam, `num_optim_step` steps on the loss,
        over the model's trainable leaves or the images' stacked ones (one
        Adam over the stacks is one Adam per image: its update is
        elementwise)."""
        ad = self.adapt
        params = list((self.trainable if images is None else images.leaves).values())
        opt = torch.optim.Adam(params, lr=ad.lr, betas=(0.9, 0.999), eps=1e-8)
        with torch.enable_grad():
            for _ in range(ad.num_optim_step):
                opt.zero_grad(set_to_none=True)
                self.adaptation_loss(x, t, images=images).backward()
                opt.step()

    @contextlib.contextmanager
    def adapting(self):
        """Within: the trainable leaves hold the start state (the LoRA state
        and the other leaves as at construction) and are the only parameters
        that require a gradient; after: every parameter is as it was."""
        params = self.trainable
        saved = {n: p.detach().clone() for n, p in params.items()}
        flags = {n: p.requires_grad for n, p in self.model.named_parameters()}
        try:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(self.lora[n] if _is_lora(n) else self.start[n])
            self.model.requires_grad_(False)
            for p in params.values():
                p.requires_grad_(True)
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
            for n, p in self.model.named_parameters():
                p.requires_grad_(flags[n])

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None,
               noises: Optional[Sequence[torch.Tensor]] = None, return_trace: bool = False):
        """Adapt and sample; returns (x_mean, trace) with `trace` the per-step
        PSNR of Tweedie against `ground_truth` (zeros without one) when
        `return_trace`, else (x_mean, None)."""
        if noises is not None and len(noises) != self.num_draws:
            raise ValueError(f"{len(noises)} noise draws for {self.num_draws} needed")
        with self.adapting():
            x_mean, trace = self._run(generator, noises)
        return (x_mean, trace) if return_trace else (x_mean, None)

    def _run(self, generator, noises):
        shape = (self.spec.batch_size, *self.spec.im_shape)
        device = self.rhs.device

        def draw(i):
            if noises is not None:
                return torch.as_tensor(noises[i], dtype=torch.float32, device=device)
            return torch.randn(shape, generator=generator, device=device)

        return self._chain(shape[0], draw)

    def _chain(self, b, draw, images=None):
        """The two-level loop over a chain of `b` rows, draw i from
        `draw(i)`, with the model's trainable leaves or the `images`'
        stacked ones; (x_mean, PSNR trace)."""
        spec, ad, sde = self.spec, self.adapt, self.sde
        ts, tps, _, _ = self._time_data
        device = self.rhs.device
        t_dtype = torch.int64 if isinstance(sde, DDPM) else torch.float32
        leaves = None if images is None else images.leaves
        extra = () if images is None else (images,)

        def tvec(t):
            return torch.full((b,), t, dtype=t_dtype, device=device)

        gt = self.ground_truth if images is None else None
        x = sde.prior_sampling((b, *spec.im_shape), noise=draw(0))
        trace = []
        for i, (t, t_prev) in enumerate(zip(ts.tolist(), tps.tolist())):
            tv, tpv = tvec(t), tvec(t_prev)
            if i % ad.adapt_freq == 0:
                self.adapt_step(x, tv, *extra)
            # the adapted score drives the denoised estimate ...
            xhat0 = tweedy(self.score(x, tv, 1.0, leaves=leaves), x, sde, tv)
            xhat = (self.data_consistency(xhat0, ad.dc_type, ad.cg_iter,
                                          None if images is None else images.rhs)
                    if ad.add_cg else xhat0)
            # ... the prior score (LoRA off) drives the DDIM direction
            x = ddim(sde, self.score(x, tv, 0.0, leaves=leaves), xhat, tv, tpv, spec.eta,
                     draw(i + 1), use_simplified_eqn=spec.use_simplified_eqn)
            if gt is not None:
                mse = (xhat0[0, ..., 0] - gt[0, ..., 0]).square().mean()
                trace.append(20 * torch.log10(gt.max() - gt.min()) - 10 * torch.log10(mse))
        t_last = tvec(ts[-1].item())
        x_mean = tweedy(self.score(x, t_last, 1.0, leaves=leaves), x, sde, t_last)
        trace = torch.stack(trace) if trace else torch.zeros(len(ts), device=device)
        return x_mean, trace

    def batched_inputs(self, observations: torch.Tensor,
                       lora_stack: Optional[Dict[str, torch.Tensor]] = None) -> BatchedImages:
        """The `lora` chain's inputs for N images: `observations` (N,
        *observation shape) as one batch of N rows with its Aᵀy, and every
        trainable leaf stacked (N, ...) as a fresh fp32 leaf that requires a
        gradient: the LoRA weights from `lora_stack` (N stacked
        `init_lora` states) or the sampler's one LoRA state, the other leaves
        (biases) from their start state."""
        device = self.rhs.device
        obs = torch.as_tensor(observations, dtype=torch.float32, device=device)
        n = obs.shape[0]
        if obs.shape[1:] != self.observation.shape or self.spec.batch_size != 1:
            raise ValueError(f"sample_batched takes (N, *{tuple(self.observation.shape)}) "
                             f"observations of a batch-1 sampler, not {tuple(obs.shape)}")
        obs = obs.reshape(n, *obs.shape[2:])
        leaves = {}
        for name in self.trainable:
            if _is_lora(name) and lora_stack is not None:
                rows = torch.as_tensor(lora_stack[name], dtype=torch.float32, device=device)
                if rows.shape[0] != n:
                    raise ValueError(f"lora_stack[{name!r}] holds {rows.shape[0]} rows, not {n}")
            else:
                row = self.lora[name] if _is_lora(name) else self.start[name]
                rows = row.float().expand(n, *row.shape)
            leaves[name] = rows.clone().requires_grad_(True)
        return BatchedImages(leaves, obs, self.ray_trafo.adjoint(obs))

    @torch.no_grad()
    def sample_batched(self, observations: torch.Tensor, noises=None, generator=None,
                       lora_stack: Optional[Dict[str, torch.Tensor]] = None,
                       mesh=None) -> torch.Tensor:
        """Adapt and sample N images in one call (JAX `sample_batched`); the
        result is (N, 1, H, W, 1), image n in row n, with no PSNR trace (no
        ground truth, as in JAX).

        `observations` is (N, *observation shape), each row an observation
        of the sampler's own shape.  Under `lora` the N images run as one
        chain on the batch axis, each with its own leaves (`batched_inputs`:
        `lora_stack` holds N stacked LoRA states, one `init_lora` per
        image; without it every image starts from the sampler's LoRA state)
        and the model's parameters are left as they were.  Under `full` and
        `decoder` every trained weight belongs to its image, so the images
        run one after another through `sample`, each from the start state:
        what JAX's vmap of the single-image program computes.

        `noises` is stacked per image, (N, draws, 1, H, W, 1) or N sequences,
        row n being image n's draws in `sample`'s order; `generator` is one
        `torch.Generator` for the whole batch or a sequence of N, one per
        image, each drawing what `sample(generator=...)` would draw.

        With a `mesh` of several ranks (`parallel/mesh.py::make_mesh`) each
        rank runs its rows of the N images, of `lora_stack` and of `noises`
        or the generators (one generator draws for the whole batch, and the
        rank keeps its rows), as above; every rank returns all N."""
        n = len(observations)
        if noises is not None and (len(noises) != n
                                   or any(len(nz) != self.num_draws for nz in noises)):
            raise ValueError(f"noises: {n} images x {self.num_draws} draws wanted")
        gens = generator if isinstance(generator, (list, tuple)) else None
        if gens is not None and len(gens) != n:
            raise ValueError(f"{len(gens)} generators for {n} images")
        rows = slice(0, n) if mesh is None else mesh.rows(n)
        observations = observations[rows]
        noises = None if noises is None else noises[rows]
        gens = None if gens is None else gens[rows]
        if lora_stack is not None:
            lora_stack = {k: v[rows] for k, v in lora_stack.items()}
        if self.adapt.impl != "lora":
            # one generator for all: this rank's images draw after the earlier ones'
            x_mean = self._sample_one_by_one(observations, noises,
                                             gens if gens is not None else generator,
                                             skip_images=rows.start)
        else:
            x_mean = self._sample_lora(observations, noises, gens, generator, lora_stack, n, rows)
        return x_mean if mesh is None else gather_batch(mesh, x_mean)

    def _sample_lora(self, observations, noises, gens, generator, lora_stack, n, rows):
        """`lora`: the images (`rows` of N) as one chain on the batch axis."""
        images = self.batched_inputs(observations, lora_stack)
        device = images.observation.device
        shape = (1, *self.spec.im_shape)
        k = len(observations)

        def draw(i):
            if noises is not None:
                return torch.cat([torch.as_tensor(nz[i], dtype=torch.float32, device=device)
                                  for nz in noises])
            if gens is not None:
                return torch.cat([torch.randn(shape, generator=g, device=device) for g in gens])
            return torch.randn((n, *shape[1:]), generator=generator, device=device)[rows]

        flags = {name: p.requires_grad for name, p in self.model.named_parameters()}
        try:
            self.model.requires_grad_(False)        # the base weights stay frozen
            x_mean, _ = self._chain(k, draw, images)
        finally:
            for name, p in self.model.named_parameters():
                p.requires_grad_(flags[name])
        return x_mean.reshape(k, 1, *self.spec.im_shape)

    def _sample_one_by_one(self, observations, noises, generator, skip_images=0):
        """`full` and `decoder`: each image through `sample`, its data
        swapped into the sampler; one shared `generator` first draws (and
        drops) what `skip_images` earlier images would."""
        saved = self.observation, self.rhs, self.ground_truth
        device = self.rhs.device
        outs = []
        if generator is not None and not isinstance(generator, (list, tuple)):
            shape = (self.spec.batch_size, *self.spec.im_shape)
            for _ in range(skip_images * self.num_draws):
                torch.randn(shape, generator=generator, device=device)
        try:
            self.ground_truth = None
            for j, obs in enumerate(observations):
                self.observation = torch.as_tensor(obs, dtype=torch.float32, device=device)
                self.rhs = self.ray_trafo.adjoint(self.observation)
                gen = generator[j] if isinstance(generator, (list, tuple)) else generator
                outs.append(self.sample(generator=gen,
                                        noises=None if noises is None else noises[j])[0])
        finally:
            self.observation, self.rhs, self.ground_truth = saved
        return torch.stack(outs)


def get_standard_adapted_sampler(
    method: str, model, sde: SDE, ray_trafo, observation, *, num_steps: int = 50,
    batch_size: int = 1, im_shape=None, eps: float = 1e-3, eta: float = 0.85,
    gamma: float = 0.01, tv_penalty: float = 1e-6, lr: float = 1e-3, num_optim_step: int = 10,
    adapt_freq: int = 1, lora_rank: int = 4,
    lora_include_blocks=("input_blocks", "middle_block", "output_blocks", "out"),
    add_cg: bool = False, dc_type: str = "cg", cg_iter: int = 1,
    early_stopping_pct: Optional[float] = None, travel_length: int = 1, travel_repeat: int = 1,
    ground_truth=None, lora_seed: int = 0, adaptation: str = "lora",
) -> AdaptedSampler:
    """Factory with the JAX package's defaults and flags; the model's
    parameters take the place of the JAX `params` argument.  For `lora` the
    model must be built with `lora_rank` and `lora_include_blocks` in its
    `UNetConfig` (`factory.get_standard_score(..., lora_rank=...)`), and a
    fresh LoRA state is drawn from `lora_seed`; for `full` and `decoder` it
    carries no LoRA (`lora_rank` 0) and its strategy's leaves are trained
    (`factory.get_standard_score(..., adaptation=...)` keeps them fp32)."""
    if method.lower() != "dds":
        raise NotImplementedError(method)
    check_strategy(adaptation)
    cfg = model.cfg
    if adaptation == "lora" and (cfg.lora_rank != int(lora_rank)
                                 or tuple(cfg.lora_include_blocks) != tuple(lora_include_blocks)):
        raise ValueError(f"the model carries LoRA rank {cfg.lora_rank} over "
                         f"{cfg.lora_include_blocks}, not {lora_rank} over {lora_include_blocks}")
    if adaptation != "lora" and cfg.lora_rank:
        raise ValueError(f"adaptation={adaptation!r} expects a model without LoRA (lora_rank 0), "
                         f"not {cfg.lora_rank}")
    if im_shape is None:
        h, w = ray_trafo.model_im_shape
        im_shape = (h, w, 1)
    # the port's SamplerSpec takes method "dds": it only supplies the time grid and eta here
    spec = SamplerSpec(
        method="dds", num_steps=int(num_steps), batch_size=batch_size, im_shape=tuple(im_shape),
        eps=float(eps), eta=float(eta), use_simplified_eqn=True, travel_length=travel_length,
        travel_repeat=travel_repeat,
        early_stopping_pct=(None if early_stopping_pct in (None, 1.0)
                            else float(early_stopping_pct)))
    adapt = AdaptSpec(num_optim_step=int(num_optim_step), adapt_freq=int(adapt_freq),
                      lr=float(lr), tv_penalty=float(tv_penalty), gamma=float(gamma),
                      dc_type=dc_type, add_cg=bool(add_cg), cg_iter=int(cg_iter),
                      impl=adaptation)
    lora = init_lora(model, seed=lora_seed) if adaptation == "lora" else {}
    return AdaptedSampler(model, lora, sde, spec, adapt, ray_trafo, observation,
                          ground_truth=ground_truth)
