"""The port's SDE algebra, CG, DDS step and the whole DDS slice against JAX.

Noise cannot be reproduced across frameworks from a seed, so every draw the
JAX package makes from its PRNG keys is recomputed with jax.random here and
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
from diffusion_models_dev_project_tpu.ops import diffusion as jd
from diffusion_models_dev_project_tpu.ops import sde as jsde
from diffusion_models_dev_project_tpu.ops import time_grids as jtg
from diffusion_models_dev_project_tpu.ops.cg import cg as jax_cg
from diffusion_models_dev_project_tpu.sampling import engine as je
from diffusion_models_dev_project_tpu.sampling import predictors as jp


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _times(kind, rng, b=3):
    if kind == "ddpm":
        t = rng.integers(1, 999, size=b).astype(np.int32)
        return t, (t - 7).astype(np.int32)
    t = rng.uniform(0.05, 1.0, size=b).astype(np.float32)
    return t, np.maximum(t - 0.01, 0).astype(np.float32)


def test_sde_diffusion_cg_and_time_grids_match_jax():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import diffusion as td
    from diffusion_models_dev_project_tpu_torch.ops import sde as tsde
    from diffusion_models_dev_project_tpu_torch.ops import time_grids as ttg
    from diffusion_models_dev_project_tpu_torch.ops.cg import cg as torch_cg
    from diffusion_models_dev_project_tpu_torch.sampling import engine as te

    sdes = {"vesde": (jsde.VESDE(0.01, 100.0), tsde.VESDE(0.01, 100.0)),
            "vpsde": (jsde.VPSDE(0.1, 10.0), tsde.VPSDE(0.1, 10.0)),
            "ddpm": (jsde.DDPM(), tsde.DDPM())}
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    for kind, (js, ts) in sdes.items():
        t, tprev = _times(kind, rng)
        for name in ("marginal_prob_std", "marginal_prob_mean"):
            np.testing.assert_allclose(getattr(ts, name)(_t(t)).numpy(),
                                       np.asarray(getattr(js, name)(jnp.asarray(t))),
                                       rtol=2e-6, err_msg=f"{kind} {name}")
        s, x, xhat = (rng.normal(size=(3, 8, 8, 1)).astype(np.float32) for _ in range(3))
        np.testing.assert_allclose(
            td.tweedy(_t(s), _t(x), ts, _t(t)).numpy(),
            np.asarray(jd.tweedy(jnp.asarray(s), jnp.asarray(x), js, jnp.asarray(t))),
            rtol=1e-5, atol=1e-5, err_msg=kind)
        noise = np.asarray(jax.random.normal(key, xhat.shape, jnp.float32))
        for simplified in (True, False):
            ref = jd.ddim(js, jnp.asarray(s), jnp.asarray(xhat), jnp.asarray(t),
                          jnp.asarray(tprev), 0.85, key, use_simplified_eqn=simplified)
            out = td.ddim(ts, _t(s), _t(xhat), _t(t), _t(tprev), 0.85, _t(noise),
                          use_simplified_eqn=simplified)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{kind} ddim simplified={simplified}")
        for n, start in ((10, 0), (50, 5)):
            jspec = je.SamplerSpec(method="dds", num_steps=n, start_time_step=start)
            tspec = te.SamplerSpec(method="dds", num_steps=n, start_time_step=start)
            for a, b in zip(je._time_arrays(js, jspec)[:3], te._time_arrays(ts, tspec)[:3]):
                np.testing.assert_array_equal(a, b)
    # the DDPM endpoint t_prev = -1 is guarded against NaN
    z = torch.ones(1, 4, 4, 1)
    assert torch.isfinite(td.ddim(tsde.DDPM(), z, z, _t(np.array([0])), _t(np.array([-1])),
                                  0.5, z)).all()
    np.testing.assert_array_equal(ttg.ddpm_time_pairs(1000, 20, 2, 3),
                                  jtg.ddpm_time_pairs(1000, 20, 2, 3))
    with pytest.raises(NotImplementedError):
        te.SamplerSpec(method="dps")

    # CG, with batch entry 2 starting converged (the 0/0 guard)
    a = rng.normal(size=(16, 16)).astype(np.float32)
    spd = a @ a.T / 16 + np.eye(16, dtype=np.float32)
    x0 = rng.normal(size=(3, 4, 4, 1)).astype(np.float32)
    rhs = rng.normal(size=(3, 4, 4, 1)).astype(np.float32)
    rhs[2] = (spd @ x0[2].reshape(16)).reshape(4, 4, 1)
    jop = lambda v: (v.reshape(v.shape[0], 16) @ spd.T).reshape(v.shape)  # noqa: E731
    top = lambda v: (v.reshape(v.shape[0], 16) @ torch.from_numpy(spd).T).reshape(v.shape)  # noqa: E731
    for n in (1, 5, 12):
        ref = np.asarray(jax_cg(jop, jnp.asarray(x0), jnp.asarray(rhs), n_iter=n))
        out = torch_cg(top, _t(x0), _t(rhs), n_iter=n).numpy()
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5, err_msg=f"cg {n}")


def _tiny(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


@pytest.fixture(scope="module")
def slice_pair():
    """The tiny slice built through both factories, with the same weights."""
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    jc, tc = _tiny(jget), _tiny(tget)
    jsd, tsd = JF.get_standard_sde(jc), TF.get_standard_sde(tc)
    jmodel, params, _ = JF.get_standard_score(jc, jsd, load_model=False)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    tmodel, _, tscore = TF.get_standard_score(tc, tsd, load_model=False, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    japply = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))
    gt = np.zeros((1, 32, 32, 1), np.float32)
    gt[0, 8:20, 10:24, 0] = 1.0
    gt[0, 22:28, 5:12, 0] = 0.5
    return dict(TF=TF, jsde=jsd, tsde=tsd, japply=japply, params=params, tscore=tscore,
                jtrafo=JF.get_standard_ray_trafo(jc),
                ttrafo=TF.get_standard_ray_trafo(tc, device="cpu"), gt=gt)


def test_dds_step_matches_jax(slice_pair):
    import torch

    from diffusion_models_dev_project_tpu_torch.sampling import predictors as tp

    sp = slice_pair
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(1, 32, 32, 1)) * 20).astype(np.float32)
    y = rng.normal(size=(1, *sp["ttrafo"].obs_shape, 1)).astype(np.float32)
    t, tprev = np.array([0.6], np.float32), np.array([0.59], np.float32)
    key = jax.random.PRNGKey(6)
    jg, tg = sp["jtrafo"].with_gram(), sp["ttrafo"].with_gram()
    jnext, jmean = jp.dds_step(lambda a, b: sp["japply"](sp["params"], a, b), sp["jsde"],
                               jnp.asarray(x), key, jnp.asarray(t), jnp.asarray(tprev),
                               jg.adjoint(jnp.asarray(y)), jg, 0.01, 0.85, 5)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    with torch.no_grad():
        tnext, tmean = tp.dds_step(sp["tscore"], sp["tsde"], _t(x), _t(t), _t(tprev),
                                   tg.adjoint(_t(y)), tg, 0.01, 0.85, 5, _t(noise))
    for out, ref in ((tnext, jnext), (tmean, jmean)):
        ref = np.asarray(ref)
        assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_dds_slice_through_the_factories_matches_jax(slice_pair):
    """Data simulation and FBP, then a 4-step DDS chain at 32², with the JAX
    sampler's own noise injected."""
    sp = slice_pair
    TF = sp["TF"]
    key = jax.random.PRNGKey(7)
    jgt, jobs, jfbp = JF.get_data_from_ground_truth(jnp.asarray(sp["gt"]), sp["jtrafo"], 0.01, key)
    noise = np.array(jax.random.normal(key, jobs.shape, jobs.dtype))
    tgt, tobs, tfbp = TF.get_data_from_ground_truth(sp["gt"], sp["ttrafo"], 0.01, noise=_t(noise))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jgt))
    for out, ref in ((tobs, jobs), (tfbp, jfbp)):
        ref = np.asarray(ref)
        assert np.abs(out.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()

    n, shape = 4, (1, 32, 32, 1)
    js = JF.get_standard_sampler("dds", None, sp["jsde"], sp["jtrafo"], jobs, num_steps=n,
                                 im_shape=shape[1:], eta=0.85, score_apply=sp["japply"],
                                 score_params=sp["params"], cg_precision="highest")
    skey = jax.random.PRNGKey(8)
    jx, _ = js.sample(skey)
    # the engine's key use: one split for the prior, one per step for DDIM
    k, init_key = jax.random.split(skey)
    noises = [np.asarray(jax.random.normal(init_key, shape))]
    for _ in range(n):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    ts = TF.get_standard_sampler("dds", sp["tscore"], sp["tsde"], sp["ttrafo"], tobs,
                                 num_steps=n, im_shape=shape[1:], eta=0.85)
    assert ts.num_draws == len(noises)
    tx, _ = ts.sample(noises=[_t(a) for a in noises])
    ref = np.asarray(jx)
    assert tx.shape == ref.shape and np.isfinite(tx.numpy()).all()
    # fp32 through 4 UNet forwards and 24 Gram applies of a random-weight prior
    assert np.abs(tx.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    with pytest.raises(ValueError):
        ts.sample(noises=noises[:-1])
