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

Not ported yet: `sample_batched`, the vmapped multi-image mode (ROADMAP.md
queue 1 item 10).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.unet import LoRAConv, LoRADense
from ..ops.cg import cg
from ..ops.diffusion import ddim, tweedy
from ..ops.sde import DDPM, SDE
from .engine import SamplerSpec, _time_arrays
from .predictors import make_dc_op

__all__ = ["STRATEGIES", "check_strategy", "tv_loss", "is_adapt_param", "split_adapt_params",
           "init_lora", "AdaptSpec", "AdaptedSampler", "get_standard_adapted_sampler"]

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
    """A fresh LoRA state for `model` (JAX `init_lora`): every `down` drawn
    from N(0, 1/r²) with numpy's generator of `seed`, every `up` 0, so the
    branches start as exact no-ops.  fp32, on the model's device."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (LoRAConv, LoRADense)):
            rank = mod.up.shape[1]
            down = rng.normal(0.0, 1.0 / rank, tuple(mod.down.shape)).astype(np.float32)
            out[f"{name}.down"] = torch.from_numpy(down).to(mod.down.device)
            out[f"{name}.up"] = torch.zeros(tuple(mod.up.shape), device=mod.up.device)
    return out


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

    def score(self, x, t, lora_scale: float, use_kernel: bool = True):
        return self.model(x, t, use_kernel=use_kernel, lora_scale=lora_scale)

    def data_consistency(self, xhat0: torch.Tensor, dc_type: str, n_iter: int) -> torch.Tensor:
        """x̂0 -> data-consistent x̂ (JAX `_data_consistency`)."""
        gamma, trafo = self.adapt.gamma, self.ray_trafo
        if dc_type == "cg":
            return cg(make_dc_op(trafo, gamma), xhat0, xhat0 + gamma * self.rhs, n_iter=n_iter)
        if dc_type == "gd":
            return xhat0 - gamma * trafo.adjoint(trafo.apply(xhat0)) + gamma * self.rhs
        return xhat0

    def adaptation_loss(self, x: torch.Tensor, t: torch.Tensor,
                        use_kernel: bool = True) -> torch.Tensor:
        """The inner loss: score -> Tweedie -> data consistency ->
        mean((A x̂ - y)²) + tv_penalty · TV(x̂)."""
        ad = self.adapt
        xhat0 = tweedy(self.score(x, t, 1.0, use_kernel), x, self.sde, t)
        xhat = self.data_consistency(xhat0, ad.dc_type, ad.cg_iter)
        resid = self.ray_trafo.apply(xhat) - self.observation
        return resid.square().mean() + ad.tv_penalty * tv_loss(xhat)

    def adapt_step(self, x: torch.Tensor, t: torch.Tensor) -> None:
        """One adaptation: a fresh Adam, `num_optim_step` steps on the loss."""
        ad = self.adapt
        opt = torch.optim.Adam(list(self.trainable.values()), lr=ad.lr, betas=(0.9, 0.999),
                               eps=1e-8)
        with torch.enable_grad():
            for _ in range(ad.num_optim_step):
                opt.zero_grad(set_to_none=True)
                self.adaptation_loss(x, t).backward()
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
        spec, ad, sde = self.spec, self.adapt, self.sde
        ts, tps, _, _ = self._time_data
        b = spec.batch_size
        shape = (b, *spec.im_shape)
        device = self.rhs.device
        t_dtype = torch.int64 if isinstance(sde, DDPM) else torch.float32

        def draw(i):
            if noises is not None:
                return torch.as_tensor(noises[i], dtype=torch.float32, device=device)
            return torch.randn(shape, generator=generator, device=device)

        def tvec(t):
            return torch.full((b,), t, dtype=t_dtype, device=device)

        gt = self.ground_truth
        x = sde.prior_sampling(shape, noise=draw(0))
        trace = []
        for i, (t, t_prev) in enumerate(zip(ts.tolist(), tps.tolist())):
            tv, tpv = tvec(t), tvec(t_prev)
            if i % ad.adapt_freq == 0:
                self.adapt_step(x, tv)
            # the adapted score drives the denoised estimate ...
            xhat0 = tweedy(self.score(x, tv, 1.0), x, sde, tv)
            xhat = (self.data_consistency(xhat0, ad.dc_type, ad.cg_iter)
                    if ad.add_cg else xhat0)
            # ... the prior score (LoRA off) drives the DDIM direction
            x = ddim(sde, self.score(x, tv, 0.0), xhat, tv, tpv, spec.eta, draw(i + 1),
                     use_simplified_eqn=spec.use_simplified_eqn)
            if gt is not None:
                mse = (xhat0[0, ..., 0] - gt[0, ..., 0]).square().mean()
                trace.append(20 * torch.log10(gt.max() - gt.min()) - 10 * torch.log10(mse))
        t_last = tvec(ts[-1].item())
        x_mean = tweedy(self.score(x, t_last, 1.0), x, sde, t_last)
        trace = torch.stack(trace) if trace else torch.zeros(len(ts), device=device)
        return x_mean, trace

    def sample_batched(self, *args, **kwargs):
        raise NotImplementedError("AdaptedSampler.sample_batched (several images, each with its "
                                  "own LoRA) is not ported yet: ROADMAP.md queue 1 item 10")


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
