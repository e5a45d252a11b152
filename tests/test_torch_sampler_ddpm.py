"""The port's DDS chain on the DDPM prior against the JAX engine.

Covers what tests/test_torch_sampler.py leaves out: the DDPM SDE with
integer t, time travel (`travel_length`, `travel_repeat`: steps that go
back up in t) and a chain started from the FBP at `pct_chain_elapsed` > 0.
Both factories get the same random weights at the tiny size, and every
draw the JAX engine makes from its PRNG keys is recomputed here and
injected into the port.  Both sides compute in fp32.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

# 4 steps with jumps of 2 repeated twice give 8 (t, t_prev) pairs, among
# them steps back up in t; 0.25 of the chain elapsed starts it at pair 1
NUM_STEPS, TRAVEL_LENGTH, TRAVEL_REPEAT, PCT_ELAPSED = 4, 2, 2, 0.25
STEP_PAIRS = ((500, 250), (250, 500), (0, -1))


def _tiny_ddpm(get_config):
    c = get_config("ddpm")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


# ------------------------------------------------------------- torch halves
def _torch_slice(params):
    """The tiny DDPM slice through the port's factories, with the JAX weights."""
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    tc = _tiny_ddpm(tget)
    tsd = TF.get_standard_sde(tc)
    tmodel, _, tscore = TF.get_standard_score(tc, tsd, load_model=False, device="cpu")
    tmodel.load_state_dict(params_from_flax(child.unflatten(params)))
    return TF, tsd, tscore, TF.get_standard_ray_trafo(tc, device="cpu")


def ddpm_steps(y, xs, noises, **params):
    import torch

    from diffusion_models_dev_project_tpu_torch.sampling import engine as te
    from diffusion_models_dev_project_tpu_torch.sampling import predictors as tp

    _, tsd, tscore, ttrafo = _torch_slice(params)
    kw = dict(method="dds", num_steps=NUM_STEPS, travel_length=TRAVEL_LENGTH,
              travel_repeat=TRAVEL_REPEAT, start_time_step=1)
    out = {f"grid{j}": np.asarray(a) for j, a in
           enumerate(te._time_arrays(tsd, te.SamplerSpec(**kw))[:3])}
    tg = ttrafo.with_gram()
    rhs = tg.adjoint(torch.from_numpy(y))
    for i, (t, tprev) in enumerate(STEP_PAIRS):
        with torch.no_grad():
            tnext, tmean = tp.dds_step(tscore, tsd, torch.from_numpy(xs[i]),
                                       torch.tensor([t]), torch.tensor([tprev]), rhs, tg,
                                       0.01, 0.85, 5, torch.from_numpy(noises[i]))
        out[f"next{i}"], out[f"mean{i}"] = tnext.numpy(), tmean.numpy()
    return out


def ddpm_chain(gt, obs_noise, noises, **params):
    import torch

    TF, tsd, tscore, ttrafo = _torch_slice(params)
    _, tobs, tfbp = TF.get_data_from_ground_truth(gt, ttrafo, 0.01,
                                                  noise=torch.from_numpy(obs_noise))
    ts = TF.get_standard_sampler("dds", tscore, tsd, ttrafo, tobs, filtbackproj=tfbp,
                                 num_steps=NUM_STEPS, im_shape=gt.shape[1:], eta=0.85,
                                 travel_length=TRAVEL_LENGTH, travel_repeat=TRAVEL_REPEAT,
                                 pct_chain_elapsed=PCT_ELAPSED)
    assert ts.num_draws == len(noises)
    tx, _ = ts.sample(noises=[torch.from_numpy(a) for a in noises])
    return {"fbp": tfbp.numpy(), "ts": np.asarray(ts._time_data[0]), "x": tx.numpy()}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import engine as je  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import predictors as jp  # noqa: E402


@pytest.fixture(scope="module")
def ddpm_pair():
    """The JAX half of the tiny DDPM slice, and its weights for the port's."""
    jc = _tiny_ddpm(jget)
    jsd = JF.get_standard_sde(jc)
    jmodel, params, _ = JF.get_standard_score(jc, jsd, load_model=False)
    rng = np.random.default_rng(14)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    japply = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))
    gt = np.zeros((1, 32, 32, 1), np.float32)
    gt[0, 6:18, 9:25, 0] = 1.0
    gt[0, 20:27, 4:14, 0] = 0.4
    return dict(jsde=jsd, japply=japply, params=params, flat=child.flatten(params),
                jtrafo=JF.get_standard_ray_trafo(jc), gt=gt)


def test_ddpm_step_with_integer_t_going_up_and_down_matches_jax(ddpm_pair, tmp_path):
    """One DDS step at an integer (t, t_prev) pair of each direction of the
    travel schedule, and the schedule itself."""
    sp = ddpm_pair
    kw = dict(method="dds", num_steps=NUM_STEPS, travel_length=TRAVEL_LENGTH,
              travel_repeat=TRAVEL_REPEAT, start_time_step=1)
    jt = je._time_arrays(sp["jsde"], je.SamplerSpec(**kw))

    rng = np.random.default_rng(15)
    y = rng.normal(size=(1, *sp["jtrafo"].obs_shape, 1)).astype(np.float32)
    jg = sp["jtrafo"].with_gram()
    xs, noises, refs = [], [], []
    for i, (t, tprev) in enumerate(STEP_PAIRS):
        x = rng.normal(size=(1, 32, 32, 1)).astype(np.float32)
        t, tprev = np.array([t], np.int32), np.array([tprev], np.int32)
        key = jax.random.PRNGKey(16 + i)
        refs.append(jp.dds_step(lambda a, b: sp["japply"](sp["params"], a, b), sp["jsde"],
                                jnp.asarray(x), key, jnp.asarray(t), jnp.asarray(tprev),
                                jg.adjoint(jnp.asarray(y)), jg, 0.01, 0.85, 5))
        xs.append(x)
        noises.append(np.asarray(jax.random.normal(key, x.shape, jnp.float32)))
    out = child.run(__file__, "ddpm_steps", tmp_path, y=y, xs=np.stack(xs),
                    noises=np.stack(noises), **sp["flat"])
    for j, a in enumerate(jt[:3]):
        np.testing.assert_array_equal(a, out[f"grid{j}"])
    assert (np.diff(out["grid0"]) > 0).any()       # the schedule travels back up in t
    for i, ((t, tprev), (jnext, jmean)) in enumerate(zip(STEP_PAIRS, refs)):
        for name, ref in ((f"next{i}", jnext), (f"mean{i}", jmean)):
            ref = np.asarray(ref)
            assert np.isfinite(out[name]).all()
            assert np.abs(out[name] - ref).max() <= 1e-4 * np.abs(ref).max(), (t, tprev)


def test_ddpm_time_travel_chain_from_fbp_matches_jax(ddpm_pair, tmp_path):
    """Data and FBP, then the DDS chain through both factories: DDPM, time
    travel, started from the FBP, with the JAX engine's own draws injected."""
    sp = ddpm_pair
    key = jax.random.PRNGKey(17)
    jgt, jobs, jfbp = JF.get_data_from_ground_truth(jnp.asarray(sp["gt"]), sp["jtrafo"], 0.01, key)
    noise = np.array(jax.random.normal(key, jobs.shape, jobs.dtype))

    shape = (1, 32, 32, 1)
    kw = dict(num_steps=NUM_STEPS, im_shape=shape[1:], eta=0.85, travel_length=TRAVEL_LENGTH,
              travel_repeat=TRAVEL_REPEAT, pct_chain_elapsed=PCT_ELAPSED)
    js = JF.get_standard_sampler("dds", None, sp["jsde"], sp["jtrafo"], jobs,
                                 filtbackproj=jfbp, score_apply=sp["japply"],
                                 score_params=sp["params"], cg_precision="highest", **kw)
    n = len(js._time_data[0])
    assert js.spec.start_time_step == 1 and n == 7
    skey = jax.random.PRNGKey(18)
    jx, _ = js.sample(skey)
    # the engine's key use: one split for the FBP start, one per step for DDIM
    k, init_key = jax.random.split(skey)
    noises = [np.asarray(jax.random.normal(init_key, shape))]
    for _ in range(n):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    out = child.run(__file__, "ddpm_chain", tmp_path, gt=sp["gt"], obs_noise=noise,
                    noises=np.stack(noises), **sp["flat"])
    assert np.abs(out["fbp"] - np.asarray(jfbp)).max() <= 2e-5 * np.abs(np.asarray(jfbp)).max()
    np.testing.assert_array_equal(out["ts"], js._time_data[0])
    ref = np.asarray(jx)
    assert out["x"].shape == ref.shape and np.isfinite(out["x"]).all()
    # fp32 through 7 UNet forwards and 42 Gram applies of a random-weight prior
    assert np.abs(out["x"] - ref).max() <= 1e-4 * np.abs(ref).max()
