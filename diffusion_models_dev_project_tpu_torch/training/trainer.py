"""Score-model training loop: an eager step on fp32 masters, exact resume.

Port of `training/trainer.py` of the JAX package.  There the step (loss,
gradients, Adam, EMA) is one jitted program; here it is eager PyTorch on the
model's fp32 master parameters, whose forward and backward run through the
hand kernels on the card (conv3x3 forward, input and weight gradients;
attention forward and backward).  What it keeps of the JAX step:

- the optimizer is optax's `chain(clip_by_global_norm(c), adam(schedule))`:
  `Optimizer` clips by max_norm / ‖g‖ (no epsilon, only when ‖g‖ ≥ c),
  reads the linear warmup at the count before its increment (the first
  step runs at lr 0) and runs `torch.optim.Adam` (β 0.9 / 0.999, ε 1e-8
  outside the square root, bias correction by step), which computes
  optax's update;
- the EMA warm start: while the step before the update is below
  `ema_warm_start_steps` the shadow is the new parameters and its count 0;
- the resume rule (`start_epoch = step // steps_per_epoch`, the data
  iterator restarts), the save condition (`epoch % save_every == 0` or the
  last epoch), the rolling tail average and the keep-best probe with
  `best_ema.json`, exported as fp16 flax msgpack (`models/convert.py`).

Randomness: the JAX step splits a key per step; here step `s` draws its t
and z from a generator seeded with (seed, s), so a resumed run draws what
the uninterrupted run drew.

Data parallelism (JAX: the state replicated and the batch sharded over the
mesh's `data` axis, XLA's gradient psum): with a mesh of W ranks
(`parallel/mesh.py`, one process per card) every rank builds the same
global batch and draws its t and z, and keeps its rows of the three.  Its
loss is the mean over its rows, and the ranks' gradients (and losses) are
all-reduced as a mean before the clip: with equal shards that is the
global batch's gradient.  Adam and the EMA then run alike on every rank,
so the replicas stay bitwise equal.  Rank 0 alone logs, saves (a barrier
on each side), probes and exports; a resumed run restores on every rank.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.convert import flax_from_params, save_flax_msgpack
from ..ops.sde import SDE
from ..parallel.mesh import all_reduce_mean_, replicate, shard_batch
from .ema import EmaState, ema_copy, ema_init, ema_update
from .losses import draw_time_and_noise, epsilon_matching_loss, score_matching_loss

__all__ = ["Optimizer", "TrainLog", "TrainState", "make_train_step", "step_generator",
           "train_score_model"]


class Optimizer:
    """optax's `chain(clip_by_global_norm(grad_clip), adam(schedule))` over
    the fp32 tensors `params` (name -> parameter), schedule
    `linear_schedule(0, lr, lr_warmup_steps)` or the constant `lr`."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, lr_warmup_steps: int = 0,
                 grad_clip: Optional[float] = None):
        self.params = params
        self.lr, self.lr_warmup_steps = float(lr), int(lr_warmup_steps)
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.adam = torch.optim.Adam(list(params.values()), lr=self.lr, betas=(0.9, 0.999),
                                     eps=1e-8)
        self.count = 0

    def lr_at(self, count: int) -> float:
        if self.lr_warmup_steps <= 0:
            return self.lr
        return self.lr * min(count, self.lr_warmup_steps) / self.lr_warmup_steps

    @torch.no_grad()
    def clip_(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax's clip_by_global_norm in place, without a host sync:
        g <- (g / ‖g‖) * max_norm where ‖g‖ ≥ max_norm.  Returns ‖g‖."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, self.grad_clip)))
        return norm

    def step(self, grads: List[torch.Tensor]) -> None:
        """One update of the parameters from their gradients (in order)."""
        if self.grad_clip:
            self.clip_(grads)
        for p, g in zip(self.params.values(), grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        for p in self.params.values():
            p.grad = None
        self.count += 1

    def moments(self) -> Dict[str, tuple]:
        """name -> (first, second) Adam moments (for tests)."""
        return {n: (self.adam.state[p]["exp_avg"], self.adam.state[p]["exp_avg_sq"])
                for n, p in self.params.items() if p in self.adam.state}

    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


@dataclasses.dataclass
class TrainState:
    """The trained parameters (fp32 masters, name -> parameter of the
    model), the optimizer, the EMA and the step count."""

    params: Dict[str, torch.nn.Parameter]
    opt: Optimizer
    ema: EmaState
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"params": {n: p.detach() for n, p in self.params.items()},
                "opt_state": self.opt.state_dict(),
                "ema": {"shadow": self.ema.shadow, "num_updates": self.ema.num_updates},
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for n, p in self.params.items():
            p.copy_(state["params"][n])
        self.opt.load_state_dict(state["opt_state"])
        for n, s in self.ema.shadow.items():
            s.copy_(state["ema"]["shadow"][n])
        self.ema.num_updates = int(state["ema"]["num_updates"])
        self.step = int(state["step"])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s t and z: a function of (seed, step)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 2 ** 32 + int(step))


def make_train_step(model_apply: Callable, sde: SDE, optimizer: Optimizer, ema_decay: float,
                    ema_warm_start_steps: int, loss_kwargs: Optional[dict] = None,
                    debug_nans: bool = False, mesh=None):
    """The step (state, batch, generator | t and z) -> loss of the JAX
    `make_train_step`: loss and gradients of `model_apply(x, t)` over
    `optimizer.params`, the clipped Adam update, the EMA (warm start while
    `state.step < ema_warm_start_steps`).  `loss_kwargs` go to the loss
    (`sigma_alpha`; the epsilon loss drops it).  With `debug_nans` a
    non-finite loss or gradient raises FloatingPointError.  With a `mesh`
    of several ranks, `batch` (and `t`, `z`) are this rank's rows, and the
    loss and gradients are all-reduced as a mean over the ranks before the
    clip; the returned loss is that mean."""
    score = sde.prediction_type == "score"
    loss_impl = score_matching_loss if score else epsilon_matching_loss
    loss_kwargs = dict(loss_kwargs or {})
    if not score and "sigma_alpha" in loss_kwargs:
        print("note: sigma_alpha ignored for the epsilon-matching loss")
        loss_kwargs.pop("sigma_alpha")
    params = optimizer.params

    def step_fn(state: TrainState, batch: torch.Tensor,
                generator: Optional[torch.Generator] = None, t: Optional[torch.Tensor] = None,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.enable_grad():
            loss = loss_impl(batch, model_apply, sde, generator=generator, t=t, z=z,
                             **loss_kwargs)
            grads = list(torch.autograd.grad(loss, list(params.values())))
        loss = loss.detach()
        if mesh is not None:
            all_reduce_mean_(mesh, grads + [loss])
        if debug_nans and not (torch.isfinite(loss)
                               and all(torch.isfinite(g).all() for g in grads)):
            raise FloatingPointError(f"non-finite loss or gradient at step {state.step}")
        optimizer.step(grads)
        if state.step < ema_warm_start_steps:
            ema_copy(state.ema, params)
        else:
            ema_update(state.ema, params, ema_decay)
        state.step += 1
        return loss

    return step_fn


@dataclasses.dataclass
class TrainLog:
    """Metrics sink: one JSON line per scalar in `<log_dir>/train_log.jsonl`."""

    log_dir: str

    def __post_init__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "train_log.jsonl"), "a")

    def scalar(self, name, value, step):
        self._f.write(json.dumps({"name": name, "value": float(value), "step": int(step),
                                  "time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _host_fp32(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A host copy (never a view: the shadow changes in place)."""
    return {n: v.detach().float().cpu().numpy().copy() for n, v in tree.items()}


def _tail_average_fp32(avg_buf) -> Dict[str, np.ndarray]:
    k = float(len(avg_buf))
    return {n: (np.sum([s[n].astype(np.float64) for s in avg_buf], axis=0) / k).astype(np.float32)
            for n in avg_buf[0]}


def _export_msgpack(state: Dict[str, Any], path: str) -> str:
    """The port's parameters (name -> array) as an fp16 flax msgpack tree."""
    return save_flax_msgpack(flax_from_params(state, np.float16), path)


def _export_tail_average(avg_buf, log_dir: str) -> str:
    return _export_msgpack(_tail_average_fp32(avg_buf),
                           os.path.join(log_dir, "avg_ema_tail.msgpack.npz"))


def train_score_model(
    model: torch.nn.Module,
    init_params: Optional[Dict[str, torch.Tensor]],
    sde: SDE,
    train_iter: Iterable,
    *,
    epochs: int,
    steps_per_epoch: int,
    lr: float = 1e-4,
    lr_warmup_steps: int = 0,
    grad_clip: Optional[float] = None,
    ema_decay: float = 0.999,
    ema_warm_start_steps: int = 400,
    log_freq: int = 25,
    save_model_every_n_epoch: int = 25,
    log_dir: str = "./runs",
    seed: int = 1,
    mesh=None,
    checkpointer=None,
    sample_hook: Optional[Callable] = None,
    sample_freq: int = 0,
    loss_kwargs: Optional[dict] = None,
    avg_tail: int = 0,
    probe_hook: Optional[Callable] = None,
    debug_nans: bool = False,
) -> TrainState:
    """Train the parameters of `model` that require a gradient (fp32
    masters; `init_params`, a state_dict, is copied into the model first);
    returns the final `TrainState`.  The arguments are the JAX
    `train_score_model`'s, with `model` (its forward `model(x, t)`) for
    its `model_apply`; `mesh` (`parallel/mesh.py::make_mesh`) is None or
    one device, or this rank of a data-parallel group (see the module's
    docstring); `debug_nans` fails at the first non-finite loss or gradient.

    `train_iter` yields NHWC numpy or torch batches.  `checkpointer` is a
    `utils.checkpoint.Checkpointer`; its latest save is resumed exactly.
    `sample_hook(state, epoch)` runs every `sample_freq` epochs.
    `avg_tail=K` (K >= 2) exports the uniform average of the EMA shadows of
    the last K saves to `{log_dir}/avg_ema_tail.msgpack.npz` (fp16) after
    every save.  `probe_hook(weights) -> float` (lower is better) scores
    every save's EMA shadow and the tail average cast from fp32 to bf16, as
    the JAX trainer casts them (`weights`: name -> bf16 tensor on the
    model's device); the best so far goes to `{log_dir}/best_ema.msgpack.npz`
    (fp16) with `best_ema.json`, whose score a resumed run starts from."""
    device = next(model.parameters()).device
    if mesh is not None and mesh.device != device:
        raise ValueError(f"the mesh's device {mesh.device} is not the model's {device}")
    if mesh is not None and mesh.world == 1:
        mesh = None
    lead = mesh is None or mesh.rank == 0          # logs, saves, probes and exports
    if init_params is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(init_params[name])
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if not params or any(p.dtype != torch.float32 for p in params.values()):
        raise ValueError("train_score_model trains fp32 master parameters that require a "
                         "gradient (factory.get_standard_score(..., train=True))")
    if mesh is not None:
        with torch.no_grad():
            replicate(mesh, list(params.values()))      # rank 0's start, in place
    opt = Optimizer(params, lr, lr_warmup_steps, grad_clip)
    state = TrainState(params, opt, ema_init(params), 0)
    start_epoch = 0
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state.load_state_dict(checkpointer.restore())
        start_epoch = state.step // max(steps_per_epoch, 1)
        if lead:
            print(f"resumed from step {state.step} (epoch {start_epoch})")
    step_fn = make_train_step(lambda x, t: model(x, t), sde, opt, ema_decay, ema_warm_start_steps,
                              loss_kwargs=loss_kwargs, debug_nans=debug_nans, mesh=mesh)
    log = TrainLog(log_dir) if lead else None
    avg_buf = deque(maxlen=int(avg_tail)) if avg_tail >= 2 else None
    best_probe = None
    if probe_hook is not None and lead:
        # a resumed run keeps the best score so far, so that a worse later
        # snapshot cannot overwrite the export
        try:
            with open(os.path.join(log_dir, "best_ema.json")) as f:
                best_probe = float(json.load(f)["score"])
            print(f"probe: resuming with best-so-far {best_probe:.5f}")
        except (OSError, ValueError, KeyError):
            pass

    data_it = iter(train_iter)
    for epoch in range(start_epoch, epochs):
        losses = []
        for i in range(steps_per_epoch):
            # the global batch and its draws; with a mesh, this rank's rows of each
            batch = torch.as_tensor(next(data_it)).to(device=device, dtype=torch.float32)
            t, z = draw_time_and_noise(batch, sde, step_generator(seed, state.step, device))
            if mesh is not None:
                batch, t, z = shard_batch(mesh, (batch, t, z))
            loss = step_fn(state, batch, t=t, z=z)
            losses.append(loss)
            if i % log_freq == 0 and lead:
                log.scalar("train/loss", float(loss), epoch * steps_per_epoch + i + 1)
        mean_loss = float(torch.stack(losses).mean())
        if lead:
            log.scalar("train/mean_loss_per_epoch", mean_loss, epoch + 1)
            print(f"epoch {epoch}: mean loss {mean_loss:.5f}")

        save = checkpointer is not None and (epoch % save_model_every_n_epoch == 0
                                             or epoch == epochs - 1)
        if save and mesh is not None:
            dist.barrier(group=mesh.group)
        if save and lead:
            t_save = time.time()
            checkpointer.save(state.state_dict(), step=state.step)
            log.scalar("save/checkpoint_seconds", time.time() - t_save, state.step)
            shadow = None
            if avg_buf is not None:
                # snapshots stay fp32: between saves the EMA moves by about
                # fp16's resolution, so only the export is fp16
                shadow = _host_fp32(state.ema.shadow)
                avg_buf.append(shadow)
                if len(avg_buf) >= 2:
                    _export_tail_average(avg_buf, log_dir)
            if probe_hook is not None:
                ema_host = shadow if shadow is not None else _host_fp32(state.ema.shadow)
                candidates = [("ema", ema_host)]
                if avg_buf is not None and len(avg_buf) >= 2:
                    candidates.append((f"avg_tail{len(avg_buf)}", _tail_average_fp32(avg_buf)))
                for tag, export_src in candidates:
                    weights = {n: torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
                               for n, a in export_src.items()}
                    t_probe = time.time()
                    score = float(probe_hook(weights))
                    log.scalar(f"probe/{tag}_seconds", time.time() - t_probe, state.step)
                    log.scalar(f"probe/{tag}", score, state.step)
                    if best_probe is None or score < best_probe:
                        best_probe = score
                        _export_msgpack(export_src, os.path.join(log_dir, "best_ema.msgpack.npz"))
                        with open(os.path.join(log_dir, "best_ema.json"), "w") as f:
                            json.dump({"score": score, "step": state.step, "source": tag}, f)
                        print(f"probe: new best {score:.5f} ({tag} @ step {state.step}) -> "
                              "best_ema.msgpack.npz")
        if save and mesh is not None:
            dist.barrier(group=mesh.group)
        if sample_freq > 0 and epoch % sample_freq == 0 and sample_hook is not None and lead:
            sample_hook(state, epoch)
    if lead:
        log.close()
    return state
