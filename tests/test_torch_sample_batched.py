"""The port's `AdaptedSampler.sample_batched` against the JAX package's.

Two images of the tiny LoRA UNet of tests/test_torch_adaptation.py (32², one
level, the middle block's attention), each with its own observation, its
own LoRA state (`lora_stack`) and its own draws, recomputed from the JAX
keys of each image and injected into the port.  Under `lora` the port runs
both images as one chain on the batch axis with stacked leaves; under
`full` and `decoder` one after another.  Each is held to JAX's vmapped
`sample_batched` and, row by row, to the port's own serial `sample` of each
image.  Both sides compute in fp32.

Tolerances: against JAX, `TOL_CHAIN` of max|x| as for the serial chains
(tests/test_torch_adaptation.py: an Adam step moves each leaf by up to lr
whatever its gradient's size); batched against serial within rtol 1e-3,
atol 1e-5, the bounds of JAX's own test of its batched mode
(tests/test_adaptation.py); one Adam over stacked leaves against one Adam
per image, exactly (Adam's update is elementwise).

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

RANK = 2
N_IMAGES = 2
N_STEPS, N_OPTIM, ADAPT_FREQ = 3, 2, 2
KW = dict(add_cg=True, cg_iter=1, dc_type="cg", eta=0.85, gamma=0.01, tv_penalty=1e-6, lr=1e-3)
TOL_CHAIN = 1e-4
RTOL_SERIAL, ATOL_SERIAL = 1e-3, 1e-5
IMPLS = ("lora", "full", "decoder")


def _tiny(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 64
    c.model.channel_mult = "1"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


# ------------------------------------------------------------- torch halves
def batched_and_serial(impl, obs, noises, **arrays):
    """The port's `sample_batched` of the images, and each image's serial
    `sample`; the model's parameters must be as they were after each."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import lora_from_flax, params_from_flax

    impl = str(impl)
    c = _tiny(get_config)
    sde = TF.get_standard_sde(c)
    kw = dict(lora_rank=RANK) if impl == "lora" else dict(adaptation=impl)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu", **kw)
    model.load_state_dict(params_from_flax(child.unflatten(arrays, "params/")), strict=False)
    trafo = TF.get_standard_ray_trafo(c, device="cpu")
    obs, noises = torch.from_numpy(obs), torch.from_numpy(noises)
    loras = ([lora_from_flax(child.unflatten(arrays, f"lora{j}/")) for j in range(N_IMAGES)]
             if impl == "lora" else None)
    sampler = TF.get_standard_adapted_sampler(
        "dds", model, sde, trafo, obs[0], num_steps=N_STEPS, num_optim_step=N_OPTIM,
        adapt_freq=ADAPT_FREQ, adaptation=impl, lora_rank=RANK if impl == "lora" else 0, **KW)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stack = None if loras is None else {k: torch.stack([lo[k] for lo in loras]) for k in loras[0]}
    xb = sampler.sample_batched(obs, noises=noises, lora_stack=stack)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    serial = []
    for j in range(N_IMAGES):
        sampler.observation, sampler.rhs = obs[j], trafo.adjoint(obs[j])
        if loras is not None:
            sampler.lora = loras[j]
        serial.append(sampler.sample(noises=list(noises[j]))[0])
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    return {"batched": xb.numpy(), "serial": torch.stack(serial).numpy()}


def stacked_adam(leaves, grads):
    """Three Adam steps over stacked (2, ...) leaves, and three over each
    row with an Adam of its own, on the same gradients."""
    import torch

    stacked = torch.from_numpy(leaves).clone().requires_grad_(True)
    rows = [torch.from_numpy(leaves[j]).clone().requires_grad_(True) for j in range(2)]
    opt = torch.optim.Adam([stacked], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    opts = [torch.optim.Adam([r], lr=1e-3, betas=(0.9, 0.999), eps=1e-8) for r in rows]
    for g in torch.from_numpy(grads):
        stacked.grad = g.clone()
        opt.step()
        for j in range(2):
            rows[j].grad = g[j].clone()
            opts[j].step()
    return {"stacked": stacked.detach().numpy(),
            "separate": torch.stack([r.detach() for r in rows]).numpy()}


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
from diffusion_models_dev_project_tpu.physics.simulation import simulate as j_simulate  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import adaptation as ja  # noqa: E402


def _image_draws(key, shape):
    """The single-image program's draws from `key`: the prior's, then one
    per outer step."""
    k, init_key = jax.random.split(key)
    out = [np.asarray(jax.random.normal(init_key, shape))]
    for _ in range(N_STEPS):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    """The JAX tiny LoRA slice, two images with their observations, LoRA
    states and keys, and the port's children started at once (one per
    strategy) so that they run beside the JAX halves."""
    jc = _tiny(jget)
    jsd = JF.get_standard_sde(jc)
    cfg = dataclasses.replace(JU.create_model_config(jc.model), lora_rank=RANK)
    jmodel = JU.UNetModel(cfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jmodel.init, {"params": key, "lora": key},
                            jnp.zeros((1, 32, 32, 1)), jnp.zeros((1,)))
    rng = np.random.default_rng(31)

    def draw(tree):
        flat = traverse_util.flatten_dict(tree)
        return traverse_util.unflatten_dict({
            path: (float(path[-1] == "scale") + rng.normal(0, 0.05, leaf.shape)).astype(np.float32)
            for path, leaf in flat.items()})

    params = draw(shapes["params"])
    loras = [draw(shapes["lora"]) for _ in range(N_IMAGES)]
    gt = np.zeros((N_IMAGES, 1, 32, 32, 1), np.float32)
    gt[0, 0, 7:21, 9:23, 0] = 1.0
    gt[0, 0, 23:29, 4:13, 0] = 0.5
    gt[1, 0, 4:14, 12:28, 0] = 0.8
    gt[1, 0, 18:30, 3:11, 0] = 0.4
    trafo = JF.get_standard_ray_trafo(jc)
    obs = np.stack([np.asarray(j_simulate(jax.random.PRNGKey(32 + j), jnp.asarray(gt[j]), trafo,
                                          0.01)) for j in range(N_IMAGES)])
    keys = jnp.stack([jax.random.PRNGKey(40 + j) for j in range(N_IMAGES)])
    noises = np.stack([_image_draws(k, gt.shape[1:]) for k in keys])
    arrays = {**child.flatten(params, "params/"),
              **{k: v for j, lo in enumerate(loras) for k, v in child.flatten(lo, f"lora{j}/").items()}}
    tmp = tmp_path_factory.mktemp("sample_batched")
    children = {}
    for impl in IMPLS:
        (tmp / impl).mkdir()
        children[impl] = child.start(__file__, "batched_and_serial", tmp / impl, timeout=180,
                                     impl=impl, obs=obs, noises=noises,
                                     **(arrays if impl == "lora" else child.flatten(params, "params/")))
    yield dict(jc=jc, jsd=jsd, jmodel=jmodel, params=params, loras=loras, obs=obs, keys=keys,
               trafo=trafo, children=children)
    for pending in children.values():      # a test that failed early leaves no child behind
        pending.proc.kill()


def _jax_batched(b, impl):
    if impl == "lora":
        model = b["jmodel"]
        stack = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *b["loras"])
    else:
        model, stack = JU.UNetModel(JU.create_model_config(b["jc"].model)), None
    s = ja.get_standard_adapted_sampler(
        "dds", model, b["params"], b["jsd"], b["trafo"], jnp.asarray(b["obs"][0]),
        num_steps=N_STEPS, num_optim_step=N_OPTIM, adapt_freq=ADAPT_FREQ, adaptation=impl,
        lora_rank=RANK if impl == "lora" else 0, **KW)
    return np.asarray(s.sample_batched(b["keys"], jnp.asarray(b["obs"]), lora_stack=stack))


@pytest.mark.parametrize("impl", IMPLS)
def test_sample_batched_matches_jax(batched, impl):
    """Two images, each its own LoRA (`lora`) or base weights (`full`,
    `decoder`) and Adam state, against JAX's vmapped `sample_batched`."""
    ref = _jax_batched(batched, impl)
    out = batched["children"][impl].result()
    assert ref.shape == out["batched"].shape == (N_IMAGES, 1, 32, 32, 1)
    assert np.isfinite(out["batched"]).all()
    err = np.abs(out["batched"] - ref).max() / np.abs(ref).max()
    assert err <= TOL_CHAIN, f"{impl}: {err:.3e} of max|JAX|"
    # the images did not run one chain twice: their results differ
    assert np.abs(ref[0] - ref[1]).max() > 100 * TOL_CHAIN * np.abs(ref).max()


@pytest.mark.parametrize("impl", IMPLS)
def test_sample_batched_rows_match_serial(batched, impl):
    """Row j of the port's batched result against the port's serial
    `sample` of image j with its observation, LoRA state and draws."""
    out = batched["children"][impl].result()
    np.testing.assert_allclose(out["batched"], out["serial"], rtol=RTOL_SERIAL, atol=ATOL_SERIAL)


def test_one_adam_over_stacked_leaves_is_one_adam_per_image(tmp_path):
    rng = np.random.default_rng(33)
    leaves = rng.normal(size=(2, 3, 5)).astype(np.float32)
    grads = rng.normal(size=(3, 2, 3, 5)).astype(np.float32) * np.array([1e-6, 1.0],
                                                                        np.float32)[:, None, None]
    out = child.run(__file__, "stacked_adam", tmp_path, leaves=leaves, grads=grads)
    np.testing.assert_array_equal(out["stacked"], out["separate"])
    assert not np.array_equal(out["stacked"], leaves)
