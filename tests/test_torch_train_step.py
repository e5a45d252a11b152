"""The port's training losses and train step against the JAX package.

A small UNet (32², 64 and 128 channels, attention on the second level) gets the same
weights on both sides through `params_from_flax`; every leaf is drawn
nonzero with numpy, so that the layers JAX initialises at zero carry
gradient too.  Both sides compute in fp32.  The JAX losses split a key into
t and z (`training/losses.py`); the test draws them from the same keys that
`make_train_step` gets and passes them to the port.

Tolerances, set before the first run:
- losses rtol 1e-5, gradients max|Δ| <= 1e-4 max|g| per leaf (fp32 on both
  sides through a UNet forward and backward, sums in another order);
- after k Adam steps: moments max|Δ| <= 1e-4 (first) and 2e-4 (second) of
  the leaf's max; parameters and EMA shadow within 2 lr k of each other
  everywhere, and within lr / 100 on all but 1e-4 of the model's elements.
  Adam moves an element by about lr sign(g) where |g| >> eps, so an
  element whose gradient sits near zero may step differently on two
  correct implementations.  The key third of each attention `qkv` bias,
  whose gradient is exactly 0 (a constant added to a softmax row), steps
  by rounding noise on both sides (up to 4.8 lr apart after 5 steps, in
  the first run): it is held to the first bound only.  A wrong schedule,
  clip, bias correction or EMA rule moves nearly every element by a
  sizeable part of lr;
- the losses of steps after the first see parameters that differ within
  those bounds: rtol 1e-4 (the first run met 1.15e-5 on a loss of 1.4e4).

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

B = 2
LR, WARMUP = 1e-3, 3
EMA_DECAY, EMA_WARM = 0.99, 2
SIGMA_ALPHA = 0.5
TOL_GRAD = 1e-4
TOL_LOSS_AFTER = 1e-4
HEAD_CHANNELS = 16
STEP_FRACTION = 1e-2        # of lr: the bound on all but 1e-4 of the elements
OUTLIERS = 1e-4


def _small(get_config, sde="vesde"):
    """Two channels per GroupNorm group at least: with one, a conv bias
    right before a GroupNorm has a gradient of exactly 0."""
    c = get_config(sde)
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 64
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "16"      # downsample rate 2: the second level
    c.model.num_head_channels = HEAD_CHANNELS
    return c


# ------------------------------------------------------------- torch halves
def _torch_model(sde_name, arrays):
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    c = _small(get_config, sde_name)
    sde = TF.get_standard_sde(c)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu", train=True)
    model.load_state_dict(params_from_flax(child.unflatten(arrays, "params/")), strict=True)
    return model, sde


def loss_and_grads(sde_name, sigma_alpha, batch, t, z, **arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.training import losses as L

    model, sde = _torch_model(str(sde_name), arrays)
    params = dict(model.named_parameters())
    assert all(p.requires_grad and p.dtype == torch.float32 for p in params.values())
    x, tt, zz = torch.from_numpy(batch), torch.from_numpy(t), torch.from_numpy(z)
    if str(sde_name) == "ddpm":
        loss = L.epsilon_matching_loss(x, model, sde, t=tt, z=zz)
    else:
        loss = L.score_matching_loss(x, model, sde, sigma_alpha=float(sigma_alpha), t=tt, z=zz)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"loss": loss.detach().numpy(), **{n: g.numpy() for n, g in zip(params, grads)}}


def train_steps(batches, ts, zs, clip, **arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.training import trainer as T
    from diffusion_models_dev_project_tpu_torch.training.ema import ema_init

    model, sde = _torch_model("vesde", arrays)
    params = dict(model.named_parameters())
    opt = T.Optimizer(params, LR, WARMUP, float(clip))
    state = T.TrainState(params, opt, ema_init(params), 0)
    step = T.make_train_step(lambda x, t: model(x, t), sde, opt, EMA_DECAY, EMA_WARM,
                             loss_kwargs={"sigma_alpha": SIGMA_ALPHA})
    losses = [step(state, torch.from_numpy(b), t=torch.from_numpy(t), z=torch.from_numpy(z))
              for b, t, z in zip(batches, ts, zs)]
    assert state.step == opt.count == len(batches)
    out = {"losses": torch.stack(losses).numpy(), "num_updates": np.array(state.ema.num_updates)}
    for n, p in params.items():
        m, v = opt.moments()[n]
        out.update({f"p/{n}": p.detach().numpy(), f"mu/{n}": m.numpy(), f"nu/{n}": v.numpy(),
                    f"ema/{n}": state.ema.shadow[n].numpy()})
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.models import unet as JU  # noqa: E402
from diffusion_models_dev_project_tpu.training import losses as jl  # noqa: E402
from diffusion_models_dev_project_tpu.training.ema import ema_init as j_ema_init  # noqa: E402
from diffusion_models_dev_project_tpu.training.trainer import TrainState, make_train_step  # noqa: E402


def _model_and_params():
    jc = _small(jget)
    jmodel = JU.UNetModel(JU.create_model_config(jc.model))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
                            jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(31)
    flat = traverse_util.flatten_dict(shapes)
    params = traverse_util.unflatten_dict({
        path: (float(path[-1] == "scale") + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
        for path, leaf in flat.items()})
    return jmodel, params


def _port_name(path):
    *mods, leaf = path
    return ".".join([*mods, "weight" if leaf in ("kernel", "scale") else "bias"])


def _port_layout(tree):
    """name -> array of a params-shaped JAX tree in the port's layout."""
    out = {}
    for path, a in traverse_util.flatten_dict(tree).items():
        a = np.asarray(a)
        if path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        elif path[-1] == "kernel" and a.shape[:2] == (1, 1):
            a = a.reshape(a.shape[2:]).T
        out[_port_name(path)] = a
    return out


def _draw_t_z(key, x, sde, eps=1e-5):
    """The t and z that `score_matching_loss` / `epsilon_matching_loss`
    draw from `key` (training/losses.py:43, :59)."""
    kt, kz = jax.random.split(key)
    if sde.prediction_type == "score":
        t = jax.random.uniform(kt, (x.shape[0],)) * (1.0 - eps) + eps
    else:
        t = jax.random.randint(kt, (x.shape[0],), 1, sde.num_steps)
    return np.asarray(t), np.asarray(jax.random.normal(kz, x.shape, x.dtype))


def _batch(seed):
    return np.random.default_rng(seed).uniform(0, 1, (B, 32, 32, 1)).astype(np.float32)


@pytest.mark.parametrize("sde_name,sigma_alpha", [("vesde", 0.0), ("vesde", SIGMA_ALPHA),
                                                  ("ddpm", 0.0)],
                         ids=["score", "score_sigma_alpha", "epsilon"])
def test_loss_and_gradients_match_jax(tmp_path, sde_name, sigma_alpha):
    jmodel, params = _model_and_params()
    sde = JF.get_standard_sde(_small(jget, sde_name))
    batch = _batch(41)
    key = jax.random.PRNGKey(42)
    t, z = _draw_t_z(key, batch, sde)
    pending = child.start(__file__, "loss_and_grads", tmp_path, sde_name=sde_name,
                          sigma_alpha=sigma_alpha, batch=batch, t=t, z=z,
                          **child.flatten(params, "params/"))

    def loss_fn(p):
        model = lambda x, tt: jmodel.apply({"params": p}, x, tt)      # noqa: E731
        if sde.prediction_type == "score":
            return jl.score_matching_loss(key, jnp.asarray(batch), model, sde,
                                          sigma_alpha=sigma_alpha)
        return jl.epsilon_matching_loss(key, jnp.asarray(batch), model, sde)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = pending.result()
    np.testing.assert_allclose(out["loss"], np.asarray(loss), rtol=1e-5)
    want = _port_layout(grads)
    assert sorted(want) == sorted(k for k in out if k != "loss")
    assert all(np.abs(g).max() > 0 for g in want.values())      # none is vacuous
    for name, g in want.items():
        assert np.abs(out[name] - g).max() <= TOL_GRAD * np.abs(g).max(), name


def _zero_gradient(name, shape):
    """The elements of leaf `name` whose gradient is exactly 0: the key
    third of an attention `qkv` bias ([head][q|k|v][ch] order, heads of
    `num_head_channels`)."""
    mask = np.zeros(shape, bool)
    if name.endswith(".qkv.bias"):
        mask.reshape(-1, 3, HEAD_CHANNELS)[:, 1] = True
    return mask


def _close_after_steps(got, ref, k):
    """got, ref: name -> array.  Every element within 2 lr k; all but a
    fraction OUTLIERS of the model's other elements within lr *
    STEP_FRACTION, those whose gradient is exactly 0 left out."""
    far = total = 0
    for name, r in ref.items():
        d = np.abs(got[name] - r)
        assert d.max() <= 2 * LR * k, name
        d = d[~_zero_gradient(name, d.shape)]
        far += int(np.sum(d > STEP_FRACTION * LR))
        total += d.size
    assert far <= OUTLIERS * total, (far, total)


@pytest.mark.parametrize("n_steps", [1, 5])
def test_train_steps_match_make_train_step(tmp_path, n_steps):
    """Adam with the warmup and the global-norm clip, the σ-weighted loss,
    and the EMA across its warm start (steps 0 and 1 copy, then the ramp)."""
    jmodel, params = _model_and_params()
    sde = JF.get_standard_sde(_small(jget))
    apply = lambda p, x, t: jmodel.apply({"params": p}, x, t)      # noqa: E731
    batches = [_batch(50 + k) for k in range(n_steps)]
    key = jax.random.PRNGKey(7)
    subs = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    draws = [_draw_t_z(sub, b, sde) for sub, b in zip(subs, batches)]
    # a clip that binds: half the first step's gradient norm
    g0 = jax.grad(lambda p: jl.score_matching_loss(subs[0], jnp.asarray(batches[0]),
                                                   lambda x, t: apply(p, x, t), sde,
                                                   sigma_alpha=SIGMA_ALPHA))(params)
    clip = 0.5 * float(optax.global_norm(g0))
    pending = child.start(__file__, "train_steps", tmp_path, batches=np.stack(batches),
                          ts=np.stack([d[0] for d in draws]), zs=np.stack([d[1] for d in draws]),
                          clip=clip, **child.flatten(params, "params/"))
    opt = optax.chain(optax.clip_by_global_norm(clip),
                      optax.adam(optax.linear_schedule(0.0, LR, WARMUP)))
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(p0, opt.init(p0), j_ema_init(p0), jnp.zeros((), jnp.int32))
    step_fn = make_train_step(apply, sde, opt, EMA_DECAY, EMA_WARM,
                              loss_kwargs={"sigma_alpha": SIGMA_ALPHA})
    losses = []
    for b, sub in zip(batches, subs):
        state, loss = step_fn(state, jnp.asarray(b), sub)
        losses.append(float(loss))
    out = pending.result()
    # the first loss sees equal parameters; later ones parameters that
    # differ as bounded below
    np.testing.assert_allclose(out["losses"][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(out["losses"], losses, rtol=TOL_LOSS_AFTER)
    assert int(out["num_updates"]) == int(state.ema.num_updates) == max(0, n_steps - EMA_WARM)
    adam = state.opt_state[1][0]
    for tag, tree in (("mu", adam.mu), ("nu", adam.nu)):
        tol = 1e-4 if tag == "mu" else 2e-4
        for name, ref in _port_layout(tree).items():
            got = out[f"{tag}/{name}"]
            assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), (tag, name)
    start = _port_layout(params)
    for tag, tree in (("p", state.params), ("ema", state.ema.shadow)):
        ref = _port_layout(tree)
        _close_after_steps({n: out[f"{tag}/{n}"] for n in ref}, ref, n_steps)
    # not vacuous: with the warmup's lr 0 the first step leaves the params
    # alone; later steps move them by about the scheduled lr
    moved = max(np.abs(out[f"p/{n}"] - start[n]).max() for n in start)
    assert moved == 0 if n_steps == 1 else moved > 0.5 * LR
