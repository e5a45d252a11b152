"""The port's steerable adaptation against the JAX package.

A tiny LoRA UNet (32², one level, the middle block's attention) gets the
same weights and LoRA state on both sides, through `params_from_flax` and
`lora_from_flax`; the `full` and `decoder` strategies run the same UNet
without LoRA and train its base weights (through the conv3x3 weight
gradient).  Every leaf is drawn nonzero with numpy, the LoRA
up-projections included: the layers that JAX initialises at zero
(`conv2`, `proj`, `final_conv`, every `up`) would otherwise leave gradients
that are zero on both sides.  Both sides compute in fp32; the JAX sampler's draws are
recomputed from its keys and injected into the port.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

RANK = 2
N_STEPS, N_OPTIM, ADAPT_FREQ = 3, 2, 2
KW = dict(lora_rank=RANK, add_cg=True, cg_iter=1, dc_type="cg", eta=0.85, gamma=0.01,
          tv_penalty=1e-6, lr=1e-3)
# the chain after Adam, with its PSNR trace: an Adam step moves each leaf by
# up to lr = 1e-3 whatever the size of its gradient, so a gradient near
# Adam's eps could step differently on the two sides.  At this size the two
# chains met within 4.2e-7 of max|x_mean| and 7.6e-6 dB; the bounds leave
# room for such a step, while a wrong step, draw or branch moves x_mean by
# ~1e-2 or more
TOL_CHAIN = 1e-4
TOL_TRACE_DB = 1e-3


def _tiny(get_config):
    """32², one level of 64 channels (two per GroupNorm group: with one, a
    conv bias right before a GroupNorm has a gradient of exactly 0), the
    middle block's attention over 8 heads, ResBlocks with 1x1 skips."""
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 64
    c.model.channel_mult = "1"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


# ------------------------------------------------------------- torch halves
def _torch_model(arrays):
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models.convert import lora_from_flax, params_from_flax

    tc = _tiny(tget)
    tsd = TF.get_standard_sde(tc)
    model, _, _ = TF.get_standard_score(tc, tsd, load_model=False, lora_rank=RANK, device="cpu")
    lora = lora_from_flax(child.unflatten(arrays, "lora/"))
    model.load_state_dict({**params_from_flax(child.unflatten(arrays, "params/")), **lora},
                          strict=True)
    return TF, tc, tsd, model, lora, TF.get_standard_ray_trafo(tc, device="cpu")


def lora_unet(x, t, **arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.models.unet import LoRAConv, LoRADense
    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import split_adapt_params

    _, _, _, model, lora, _ = _torch_model(arrays)
    out = {}
    with torch.no_grad():
        for scale in (1.0, 0.0):
            out[f"scale{scale:g}"] = model(torch.from_numpy(x), torch.from_numpy(t),
                                           lora_scale=scale).numpy()
    train, frozen = split_adapt_params(model)
    assert set(lora) <= set(train) and not set(lora) & set(frozen)
    assert sum(isinstance(m, (LoRAConv, LoRADense)) for m in model.modules()) == len(lora) // 2
    out["trainable"] = np.array(sorted(train))
    return out


def _sampler(arrays, gt, obs_noise):
    import torch

    TF, _, tsd, model, lora, trafo = _torch_model(arrays)
    _, obs, _ = TF.get_data_from_ground_truth(gt, trafo, 0.01, noise=torch.from_numpy(obs_noise))
    sampler = TF.get_standard_adapted_sampler(
        "dds", model, tsd, trafo, obs, num_steps=N_STEPS, num_optim_step=N_OPTIM,
        adapt_freq=ADAPT_FREQ, ground_truth=gt, **KW)
    sampler.lora = lora
    return sampler, model, lora


def inner_loss_grads(gt, obs_noise, x, t, **arrays):
    import torch

    sampler, model, lora = _sampler(arrays, gt, obs_noise)
    train = sampler.trainable
    with sampler.adapting():
        assert {n for n, p in model.named_parameters() if p.requires_grad} == set(train)
        loss = sampler.adaptation_loss(torch.from_numpy(x), torch.from_numpy(t))
        grads = torch.autograd.grad(loss, list(train.values()))
    return {"loss": loss.detach().numpy(), **{n: g.numpy() for n, g in zip(train, grads)}}


def _plain_sampler(impl, arrays, gt, obs_noise):
    """The same UNet without LoRA, for the `full` and `decoder` strategies."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    tc = _tiny(tget)
    tsd = TF.get_standard_sde(tc)
    model, _, _ = TF.get_standard_score(tc, tsd, load_model=False, device="cpu", adaptation=impl)
    model.load_state_dict(params_from_flax(child.unflatten(arrays, "params/")), strict=True)
    trafo = TF.get_standard_ray_trafo(tc, device="cpu")
    _, obs, _ = TF.get_data_from_ground_truth(gt, trafo, 0.01, noise=torch.from_numpy(obs_noise))
    kw = {k: v for k, v in KW.items() if k != "lora_rank"}
    sampler = TF.get_standard_adapted_sampler(
        "dds", model, tsd, trafo, obs, num_steps=N_STEPS, num_optim_step=N_OPTIM,
        adapt_freq=ADAPT_FREQ, ground_truth=gt, adaptation=impl, **kw)
    return sampler, model


def full_and_decoder_sets(gt, obs_noise, **arrays):
    """The trainable sets of `full` and `decoder` on a model without LoRA."""
    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import split_adapt_params

    out = {}
    for impl in ("full", "decoder"):
        sampler, model = _plain_sampler(impl, arrays, gt, obs_noise)
        train, frozen = split_adapt_params(model, impl)
        assert set(sampler.trainable) == set(train) and sampler.lora == {}
        out[impl] = np.array(sorted(train))
    return out


def plain_adapted_chain(impl, gt, obs_noise, noises, **arrays):
    import torch

    sampler, model = _plain_sampler(str(impl), arrays, gt, obs_noise)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x, trace = sampler.sample(noises=[torch.from_numpy(a) for a in noises], return_trace=True)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    return {"x": x.numpy(), "trace": trace.numpy()}


def adapted_chain(gt, obs_noise, noises, **arrays):
    import torch

    sampler, model, lora = _sampler(arrays, gt, obs_noise)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert sampler.num_draws == len(noises)
    x, trace = sampler.sample(noises=[torch.from_numpy(a) for a in noises], return_trace=True)
    # the model's parameters are as they were
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    return {"x": x.numpy(), "trace": trace.numpy()}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.models import unet as JU  # noqa: E402
from diffusion_models_dev_project_tpu.ops import diffusion as jd  # noqa: E402
from diffusion_models_dev_project_tpu.physics.simulation import simulate as j_simulate  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import adaptation as ja  # noqa: E402


@pytest.fixture(scope="module")
def lora_pair(tmp_path_factory):
    """The JAX tiny LoRA slice and its arrays for the port, with the three
    tests' children started at once, so that they run beside the JAX
    halves.  Parameters are drawn with numpy in the shapes of
    `UNetModel.init` (no compile): every kernel, bias and LoRA leaf
    N(0, 0.05), GroupNorm scales 1 + N(0, 0.05)."""
    jc = _tiny(jget)
    jsd = JF.get_standard_sde(jc)
    cfg = dataclasses.replace(JU.create_model_config(jc.model), lora_rank=RANK)
    jmodel = JU.UNetModel(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jmodel.init, {"params": key, "lora": key},
                            jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,)))
    rng = np.random.default_rng(21)

    def draw(tree):
        flat = traverse_util.flatten_dict(tree)
        return traverse_util.unflatten_dict({
            path: (float(path[-1] == "scale") + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
            for path, leaf in flat.items()})

    params, lora = draw(shapes["params"]), draw(shapes["lora"])
    gt = np.zeros((1, 32, 32, 1), np.float32)
    gt[0, 7:21, 9:23, 0] = 1.0
    gt[0, 23:29, 4:13, 0] = 0.5
    trafo = JF.get_standard_ray_trafo(jc)
    key = jax.random.PRNGKey(22)
    obs = j_simulate(key, jnp.asarray(gt), trafo, 0.01)
    obs_noise = np.array(jax.random.normal(key, obs.shape, obs.dtype))
    arrays = {**child.flatten(params, "params/"), **child.flatten(lora, "lora/")}
    rng = np.random.default_rng(23)
    unet_in = dict(x=rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
                   t=np.array([0.3, 0.7], np.float32))
    grad_in = dict(x=(gt + np.random.default_rng(24).normal(0, 2.0, gt.shape)).astype(np.float32),
                   t=np.array([0.45], np.float32))
    # the sampler's key use: one split for the prior, one per step for DDIM
    chain_key = jax.random.PRNGKey(25)
    k, init_key = jax.random.split(chain_key)
    noises = [np.asarray(jax.random.normal(init_key, gt.shape))]
    for _ in range(N_STEPS):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, gt.shape, jnp.float32)))
    tmp = tmp_path_factory.mktemp("adaptation")
    for impl in ("full", "decoder"):
        (tmp / impl).mkdir()
    plain = child.flatten(params, "params/")
    children = {
        "lora_unet": child.start(__file__, "lora_unet", tmp, **unet_in, **arrays),
        "full_and_decoder_sets": child.start(__file__, "full_and_decoder_sets", tmp, gt=gt,
                                             obs_noise=obs_noise, **plain),
        "inner_loss_grads": child.start(__file__, "inner_loss_grads", tmp, gt=gt,
                                        obs_noise=obs_noise, **grad_in, **arrays),
        "adapted_chain": child.start(__file__, "adapted_chain", tmp, gt=gt,
                                     obs_noise=obs_noise, noises=np.stack(noises), **arrays)}
    for impl in ("full", "decoder"):
        children[impl] = child.start(__file__, "plain_adapted_chain", tmp / impl, impl=impl, gt=gt,
                                     obs_noise=obs_noise, noises=np.stack(noises), **plain)
    yield dict(jmodel=jmodel, jsde=jsd, params=params, lora=lora, gt=gt, obs=obs, trafo=trafo,
               unet_in=unet_in, grad_in=grad_in, chain_key=chain_key, children=children)
    for pending in children.values():      # a test that failed early leaves no child behind
        pending.proc.kill()


def _jax_sampler(lp):
    s = ja.get_standard_adapted_sampler(
        "dds", lp["jmodel"], lp["params"], lp["jsde"], lp["trafo"], lp["obs"],
        num_steps=N_STEPS, num_optim_step=N_OPTIM, adapt_freq=ADAPT_FREQ,
        ground_truth=jnp.asarray(lp["gt"]), **KW)
    s.lora = lp["lora"]
    return s


def _port_name(path):
    return ".".join(path)


def test_lora_unet_and_trainable_set_match_jax(lora_pair):
    """The LoRA UNet at lora_scale 1 and 0 against `model.apply`, and the
    trainable set against `split_adapt_params` plus the `lora` collection,
    through the converters' name map."""
    lp = lora_pair
    x, t = (jnp.asarray(lp["unet_in"][n]) for n in ("x", "t"))
    apply = jax.jit(lambda s: lp["jmodel"].apply({"params": lp["params"], "lora": lp["lora"]},
                                                 x, t, lora_scale=s))
    refs = {scale: np.asarray(apply(scale)) for scale in (1.0, 0.0)}
    out = lp["children"]["lora_unet"].result()
    for scale, ref in refs.items():
        # fp32 on both sides; sums in another order through ~20 layers
        np.testing.assert_allclose(out[f"scale{scale:g}"], ref, rtol=1e-4,
                                   atol=2e-5 * np.abs(ref).max(), err_msg=str(scale))
    biases, _ = ja.split_adapt_params(lp["params"], "lora")
    lora_paths = traverse_util.flatten_dict(lp["lora"])
    want = sorted(_port_name(p) for p in list(biases) + list(lora_paths))
    assert out["trainable"].tolist() == want
    assert any(p[-2] == "norm1" for p in biases) and not any("emb" in p[:-1] for p in biases)


def test_inner_loss_gradients_match_jax(lora_pair):
    """The gradient of the adaptation loss (score -> Tweedie -> cg(1) ->
    mean((Ax - y)²) + 1e-6 TV) for every trainable leaf against `jax.grad`."""
    lp = lora_pair
    s = _jax_sampler(lp)
    biases, frozen = ja.split_adapt_params(lp["params"], "lora")
    jx, jt = (jnp.asarray(lp["grad_in"][n]) for n in ("x", "t"))

    def loss_fn(tr):
        xhat0 = jd.tweedy(s._score(frozen, tr, jx, jt, 1.0), jx, lp["jsde"], jt)
        xhat = s._data_consistency(s.ray_trafo, s.rhs, xhat0, "cg", 1)
        return s._lloss(s.ray_trafo, s.observation, xhat)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))({"bias": biases, "lora": lp["lora"]})
    out = lp["children"]["inner_loss_grads"].result()
    np.testing.assert_allclose(out["loss"], np.asarray(loss), rtol=1e-5)
    want = {_port_name(p): np.asarray(g) for p, g in grads["bias"].items()}
    for path, g in traverse_util.flatten_dict(grads["lora"]).items():
        g = np.asarray(g)       # the converters' layouts: 1x1 and dense leaves transposed
        if g.ndim == 4 and g.shape[:2] == (1, 1):
            g = g.reshape(g.shape[2:]).T
        elif g.ndim == 2:
            g = g.T
        want[_port_name(path)] = g
    assert sorted(want) == sorted(k for k in out if k != "loss")
    assert sum(np.abs(g).max() > 0 for g in want.values()) == len(want)   # none is vacuous
    for name, g in want.items():
        # fp32 on both sides through a UNet forward and backward, CG and the
        # operator: sums in another order
        assert np.abs(out[name] - g).max() <= 1e-4 * np.abs(g).max(), name


def test_adapted_chain_matches_jax(lora_pair):
    """3 outer steps, adaptation at steps 0 and 2 (`adapt_freq` 2) of 2 Adam
    steps each, add_cg with cg(1), and the PSNR trace, against
    `AdaptedSampler.sample` with its own draws injected."""
    lp = lora_pair
    jx, jtrace = _jax_sampler(lp).sample(lp["chain_key"], return_trace=True)
    out = lp["children"]["adapted_chain"].result()
    ref = np.asarray(jx)
    assert out["x"].shape == ref.shape and np.isfinite(out["x"]).all()
    assert np.abs(out["x"] - ref).max() <= TOL_CHAIN * np.abs(ref).max()
    np.testing.assert_allclose(out["trace"], np.asarray(jtrace), rtol=0, atol=TOL_TRACE_DB)


def _jax_param_name(path):
    *mods, leaf = path
    return ".".join([*mods, "weight" if leaf in ("kernel", "scale") else "bias"])


def _plain_jax_sampler(lp, impl):
    jc = _tiny(jget)
    jmodel = JU.UNetModel(JU.create_model_config(jc.model))       # no LoRA
    kw = {k: v for k, v in KW.items() if k != "lora_rank"}
    return ja.get_standard_adapted_sampler(
        "dds", jmodel, lp["params"], lp["jsde"], lp["trafo"], lp["obs"], num_steps=N_STEPS,
        num_optim_step=N_OPTIM, adapt_freq=ADAPT_FREQ, ground_truth=jnp.asarray(lp["gt"]),
        adaptation=impl, lora_rank=0, **kw)


def test_full_and_decoder_trainable_sets_match_jax(lora_pair):
    """`full` trains every parameter, `decoder` the output blocks and the
    final norm and conv but their `emb` projections: the port's sets
    against `split_adapt_params`, through the converters' name map."""
    out = lora_pair["children"]["full_and_decoder_sets"].result()
    for impl in ("full", "decoder"):
        train, frozen = ja.split_adapt_params(lora_pair["params"], impl)
        assert out[impl].tolist() == sorted(_jax_param_name(p) for p in train), impl
    assert len(out["decoder"]) < len(out["full"])
    assert any(".conv1.weight" in n for n in out["decoder"])


@pytest.mark.parametrize("impl", ["full", "decoder"])
def test_full_and_decoder_chains_match_jax(lora_pair, impl):
    """3 outer steps of 2 Adam steps each (`adapt_freq` 2) over the base
    weights, against `AdaptedSampler.sample` with its draws injected; the
    same bounds as the LoRA chain's (an Adam step moves each element by up
    to lr = 1e-3)."""
    lp = lora_pair
    jx, jtrace = _plain_jax_sampler(lp, impl).sample(lp["chain_key"], return_trace=True)
    out = lp["children"][impl].result()
    ref = np.asarray(jx)
    assert out["x"].shape == ref.shape and np.isfinite(out["x"]).all()
    assert np.abs(out["x"] - ref).max() <= TOL_CHAIN * np.abs(ref).max()
    np.testing.assert_allclose(out["trace"], np.asarray(jtrace), rtol=0, atol=TOL_TRACE_DB)
