"""The port's DDS chain on the DDPM prior against the JAX engine.

Covers what tests/test_torch_sampler.py leaves out: the DDPM SDE with
integer t, time travel (`travel_length`, `travel_repeat`: steps that go
back up in t) and a chain started from the FBP at `pct_chain_elapsed` > 0.
Both factories get the same random weights at the tiny size, and every
draw the JAX engine makes from its PRNG keys is recomputed here and
injected into the port.  Both sides compute in fp32.

torch and the port are imported inside the tests, never at collection
(see tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import diffusion_models_dev_project_tpu.factory as JF
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget
from diffusion_models_dev_project_tpu.sampling import engine as je
from diffusion_models_dev_project_tpu.sampling import predictors as jp

# 4 steps with jumps of 2 repeated twice give 8 (t, t_prev) pairs, among
# them steps back up in t; 0.25 of the chain elapsed starts it at pair 1
NUM_STEPS, TRAVEL_LENGTH, TRAVEL_REPEAT, PCT_ELAPSED = 4, 2, 2, 0.25


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _tiny_ddpm(get_config):
    c = get_config("ddpm")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


@pytest.fixture(scope="module")
def ddpm_pair():
    """The tiny DDPM slice built through both factories, with the same weights."""
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    jc, tc = _tiny_ddpm(jget), _tiny_ddpm(tget)
    jsd, tsd = JF.get_standard_sde(jc), TF.get_standard_sde(tc)
    jmodel, params, _ = JF.get_standard_score(jc, jsd, load_model=False)
    rng = np.random.default_rng(14)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    tmodel, _, tscore = TF.get_standard_score(tc, tsd, load_model=False, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    japply = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))
    gt = np.zeros((1, 32, 32, 1), np.float32)
    gt[0, 6:18, 9:25, 0] = 1.0
    gt[0, 20:27, 4:14, 0] = 0.4
    return dict(TF=TF, jsde=jsd, tsde=tsd, japply=japply, params=params, tscore=tscore,
                jtrafo=JF.get_standard_ray_trafo(jc),
                ttrafo=TF.get_standard_ray_trafo(tc, device="cpu"), gt=gt)


def test_ddpm_step_with_integer_t_going_up_and_down_matches_jax(ddpm_pair):
    """One DDS step at an integer (t, t_prev) pair of each direction of the
    travel schedule, and the schedule itself."""
    import torch

    from diffusion_models_dev_project_tpu_torch.sampling import engine as te
    from diffusion_models_dev_project_tpu_torch.sampling import predictors as tp

    sp = ddpm_pair
    kw = dict(method="dds", num_steps=NUM_STEPS, travel_length=TRAVEL_LENGTH,
              travel_repeat=TRAVEL_REPEAT, start_time_step=1)
    jt = je._time_arrays(sp["jsde"], je.SamplerSpec(**kw))
    tt = te._time_arrays(sp["tsde"], te.SamplerSpec(**kw))
    for a, b in zip(jt[:3], tt[:3]):
        np.testing.assert_array_equal(a, b)
    assert (np.diff(tt[0]) > 0).any()       # the schedule travels back up in t

    rng = np.random.default_rng(15)
    y = rng.normal(size=(1, *sp["ttrafo"].obs_shape, 1)).astype(np.float32)
    jg, tg = sp["jtrafo"].with_gram(), sp["ttrafo"].with_gram()
    for i, (t, tprev) in enumerate(((500, 250), (250, 500), (0, -1))):
        x = rng.normal(size=(1, 32, 32, 1)).astype(np.float32)
        t, tprev = np.array([t], np.int32), np.array([tprev], np.int32)
        key = jax.random.PRNGKey(16 + i)
        jnext, jmean = jp.dds_step(lambda a, b: sp["japply"](sp["params"], a, b), sp["jsde"],
                                   jnp.asarray(x), key, jnp.asarray(t), jnp.asarray(tprev),
                                   jg.adjoint(jnp.asarray(y)), jg, 0.01, 0.85, 5)
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        with torch.no_grad():
            tnext, tmean = tp.dds_step(sp["tscore"], sp["tsde"], _t(x), _t(t).long(),
                                       _t(tprev).long(), tg.adjoint(_t(y)), tg, 0.01, 0.85, 5,
                                       _t(noise))
        for out, ref in ((tnext, jnext), (tmean, jmean)):
            ref = np.asarray(ref)
            assert np.isfinite(out.numpy()).all()
            assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), (t, tprev)


def test_ddpm_time_travel_chain_from_fbp_matches_jax(ddpm_pair):
    """Data and FBP, then the DDS chain through both factories: DDPM, time
    travel, started from the FBP, with the JAX engine's own draws injected."""
    sp = ddpm_pair
    TF = sp["TF"]
    key = jax.random.PRNGKey(17)
    jgt, jobs, jfbp = JF.get_data_from_ground_truth(jnp.asarray(sp["gt"]), sp["jtrafo"], 0.01, key)
    noise = np.array(jax.random.normal(key, jobs.shape, jobs.dtype))
    tgt, tobs, tfbp = TF.get_data_from_ground_truth(sp["gt"], sp["ttrafo"], 0.01, noise=_t(noise))
    assert np.abs(tfbp.numpy() - np.asarray(jfbp)).max() <= 2e-5 * np.abs(np.asarray(jfbp)).max()

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
    ts = TF.get_standard_sampler("dds", sp["tscore"], sp["tsde"], sp["ttrafo"], tobs,
                                 filtbackproj=tfbp, **kw)
    assert ts.num_draws == len(noises)
    np.testing.assert_array_equal(ts._time_data[0], js._time_data[0])
    tx, _ = ts.sample(noises=[_t(a) for a in noises])
    ref = np.asarray(jx)
    assert tx.shape == ref.shape and np.isfinite(tx.numpy()).all()
    # fp32 through 7 UNet forwards and 42 Gram applies of a random-weight prior
    assert np.abs(tx.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
