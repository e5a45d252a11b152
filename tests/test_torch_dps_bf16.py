"""The gradient that ancestral DPS takes in x, in bf16, against the JAX
package's.

DPS differentiates ||y - A·Tweedie(score(x, t), x, t)|| in x through the
UNet, and in bf16 that gradient lies a few percent from its fp32 value in
both packages.  Bitwise agreement in bf16 is not expected (sums in another
order), so the port is held to JAX by distance from the fp32 gradient: in
fp32 the two agree to `TOL_FP32`, and the port's bf16 gradient lies no
farther from the fp32 one than `BF16_RATIO` times JAX's bf16 gradient does.
A port that rounded where JAX does not (Tweedie, the data fit, the stem's
input gradient) would fail the second check.

A tiny DDPM UNet at 64² (32 channels), random weights carried across,
weights stored in bf16 as the evaluation script's `--params_dtype bfloat16`
stores them, the data fit of a disk-ellipse phantom at 60 angles, at a
noisy and a nearly clean step.  The torch half runs in a child interpreter
(tests/_torch_child.py): no pytest process runs torch code.
"""
import numpy as np

import _torch_child as child

IM, STEPS = 64, (200, 950)
TOL_FP32 = 1e-4       # |port - JAX| / |JAX| in fp32: sums in another order
BF16_RATIO = 1.5      # measured: the port's distance 0.81x (t 200) and 0.92x (t 950) JAX's


def _tiny(get_config, dtype):
    c = get_config("ddpm")
    c.data.im_size = c.model.image_size = IM
    c.model.num_channels = 32
    c.model.channel_mult = "1,2,2"
    c.model.attention_resolutions = "16"
    c.model.num_head_channels = 16
    c.model.dtype = dtype
    return c


# ------------------------------------------------------------- torch halves
def gradients(x, t, obs, **arrays):
    """d||y - A·Tweedie(score(x, t))|| / dx of the port in fp32 and bf16."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.ops.diffusion import tweedy
    from diffusion_models_dev_project_tpu_torch.sampling.predictors import make_nloglik

    sde = TF.get_standard_sde(_tiny(get_config, "float32"))
    nll = make_nloglik(TF.get_standard_ray_trafo(_tiny(get_config, "float32"), device="cpu"),
                       torch.from_numpy(obs))
    out = {}
    for dtype in ("float32", "bfloat16"):
        model, _, _ = TF.get_standard_score(_tiny(get_config, dtype), sde, load_model=False,
                                            device="cpu")
        model.load_state_dict(params_from_flax(child.unflatten(arrays)))
        if dtype == "bfloat16":
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
        for i, step in enumerate(t):
            xx = torch.from_numpy(x[i]).requires_grad_(True)
            tt = torch.tensor([int(step)])
            (g,) = torch.autograd.grad(nll(tweedy(model(xx, tt), xx, sde, tt)), xx)
            out[f"{dtype}_{i}"] = g.double().numpy()
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.data.ellipses import get_disk_dist_ellipses_dataset  # noqa: E402
from diffusion_models_dev_project_tpu.ops.diffusion import tweedy as jtweedy  # noqa: E402
from diffusion_models_dev_project_tpu.sampling.predictors import make_nloglik as jnll  # noqa: E402


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_dps_gradient_in_x_lies_no_farther_from_fp32_than_jax(tmp_path):
    c32 = _tiny(jget, "float32")
    sde = JF.get_standard_sde(c32)
    _, params, _ = JF.get_standard_score(c32, sde, load_model=False)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    trafo = JF.get_standard_ray_trafo(c32)
    gt = np.asarray(next(iter(get_disk_dist_ellipses_dataset(
        fold="test", im_size=IM, length=1, diameter=0.4745, max_n_ellipse=140))))[None]
    _, obs, _ = JF.get_data_from_ground_truth(jnp.asarray(gt), trafo, 0.01,
                                              jax.random.PRNGKey(0))
    obs = np.asarray(obs)
    x = rng.normal(size=(len(STEPS), 1, IM, IM, 1)).astype(np.float32)
    t = np.array(STEPS, np.int32)
    pending = child.start(__file__, "gradients", tmp_path, x=x, t=t, obs=obs,
                          **child.flatten(params))
    nll = jnll(trafo, jnp.asarray(obs))
    ref = {}
    for dtype in ("float32", "bfloat16"):
        model, _, _ = JF.get_standard_score(_tiny(jget, dtype), sde, load_model=False)
        p = params if dtype == "float32" else jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)

        def loss(xx, tt, model=model, p=p):
            return nll(jtweedy(model.apply({"params": p}, xx, tt), xx, sde, tt))

        grad = jax.jit(jax.grad(loss))
        for i, step in enumerate(STEPS):
            ref[f"{dtype}_{i}"] = np.asarray(
                grad(jnp.asarray(x[i]), jnp.array([step], jnp.int32)), np.float64)
    out = pending.result()
    for i, step in enumerate(STEPS):
        j32, j16 = ref[f"float32_{i}"], ref[f"bfloat16_{i}"]
        t32, t16 = out[f"float32_{i}"], out[f"bfloat16_{i}"]
        assert np.isfinite(t16).all() and np.linalg.norm(j32) > 0
        assert _rel(t32, j32) <= TOL_FP32, step
        jax_bf16 = _rel(j16, j32)
        assert jax_bf16 > 0, step
        print(f"t = {step}: port bf16 {_rel(t16, j32):.3e}, JAX bf16 {jax_bf16:.3e} from fp32")
        assert _rel(t16, j32) <= BF16_RATIO * jax_bf16, (step, _rel(t16, j32), jax_bf16)
