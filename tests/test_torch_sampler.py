"""The port's SDE algebra, CG, DDS step and the whole DDS slice against JAX.

Noise cannot be reproduced across frameworks from a seed, so every draw the
JAX package makes from its PRNG keys is recomputed with jax.random here and
injected into the port.  Both sides compute in fp32.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

KINDS = ("vesde", "vpsde", "ddpm")
GRIDS = ((10, 0), (50, 5))          # (num_steps, start_time_step)
CG_ITERS = (1, 5, 12)


def _times(kind, rng, b=3):
    if kind == "ddpm":
        t = rng.integers(1, 999, size=b).astype(np.int32)
        return t, (t - 7).astype(np.int32)
    t = rng.uniform(0.05, 1.0, size=b).astype(np.float32)
    return t, np.maximum(t - 0.01, 0).astype(np.float32)


def _tiny(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


# ------------------------------------------------------------- torch halves
def _torch_slice(params):
    """The tiny slice through the port's factories, with the JAX weights."""
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    tc = _tiny(tget)
    tsd = TF.get_standard_sde(tc)
    tmodel, _, tscore = TF.get_standard_score(tc, tsd, load_model=False, device="cpu")
    tmodel.load_state_dict(params_from_flax(child.unflatten(params)))
    return TF, tsd, tscore, TF.get_standard_ray_trafo(tc, device="cpu")


def algebra(**a):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import diffusion as td
    from diffusion_models_dev_project_tpu_torch.ops import sde as tsde
    from diffusion_models_dev_project_tpu_torch.ops import time_grids as ttg
    from diffusion_models_dev_project_tpu_torch.ops.cg import cg as torch_cg
    from diffusion_models_dev_project_tpu_torch.sampling import engine as te

    T = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    sdes = {"vesde": tsde.VESDE(0.01, 100.0), "vpsde": tsde.VPSDE(0.1, 10.0), "ddpm": tsde.DDPM()}
    out = {}
    for kind, ts in sdes.items():
        t, tprev = T[f"{kind}_t"], T[f"{kind}_tprev"]
        for name in ("marginal_prob_std", "marginal_prob_mean"):
            out[f"{kind}_{name}"] = getattr(ts, name)(t).numpy()
        s, x, xhat = T[f"{kind}_s"], T[f"{kind}_x"], T[f"{kind}_xhat"]
        out[f"{kind}_tweedy"] = td.tweedy(s, x, ts, t).numpy()
        for simplified in (True, False):
            out[f"{kind}_ddim_{simplified}"] = td.ddim(
                ts, s, xhat, t, tprev, 0.85, T[f"{kind}_noise"],
                use_simplified_eqn=simplified).numpy()
        for n, start in GRIDS:
            tspec = te.SamplerSpec(method="dds", num_steps=n, start_time_step=start)
            for j, arr in enumerate(te._time_arrays(ts, tspec)[:3]):
                out[f"{kind}_grid{n}_{j}"] = np.asarray(arr)
    # the DDPM endpoint t_prev = -1 is guarded against NaN
    z = torch.ones(1, 4, 4, 1)
    assert torch.isfinite(td.ddim(tsde.DDPM(), z, z, torch.tensor([0]), torch.tensor([-1]),
                                  0.5, z)).all()
    out["ddpm_pairs"] = np.asarray(ttg.ddpm_time_pairs(1000, 20, 2, 3))
    # every method of the JAX engine but its adapted one is ported, and both
    # data consistencies; an unknown method or data consistency raises
    for method in ("naive", "dps", "dds", "uncond"):
        te.SamplerSpec(method=method)
    with pytest.raises(NotImplementedError):
        te.SamplerSpec(method="adapted_dds")
    assert te.SamplerSpec(method="dds", dc_mode="woodbury").dc_mode == "woodbury"
    with pytest.raises(ValueError, match="dc_mode"):
        te.SamplerSpec(method="dds", dc_mode="lsqr")
    spd = T["spd"]
    top = lambda v: (v.reshape(v.shape[0], 16) @ spd.T).reshape(v.shape)  # noqa: E731
    for n in CG_ITERS:
        out[f"cg{n}"] = torch_cg(top, T["x0"], T["rhs"], n_iter=n).numpy()
    return out


def dds_step(x, y, t, tprev, noise, **params):
    import torch

    from diffusion_models_dev_project_tpu_torch.sampling import predictors as tp

    _, tsd, tscore, ttrafo = _torch_slice(params)
    tg = ttrafo.with_gram()
    T = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    with torch.no_grad():
        tnext, tmean = tp.dds_step(tscore, tsd, T(x), T(t), T(tprev), tg.adjoint(T(y)), tg,
                                   0.01, 0.85, 5, T(noise))
    return {"next": tnext.numpy(), "mean": tmean.numpy()}


def dds_slice(gt, obs_noise, noises, **params):
    import torch

    TF, tsd, tscore, ttrafo = _torch_slice(params)
    tgt, tobs, tfbp = TF.get_data_from_ground_truth(gt, ttrafo, 0.01,
                                                    noise=torch.from_numpy(obs_noise))
    n = noises.shape[0] - 1
    ts = TF.get_standard_sampler("dds", tscore, tsd, ttrafo, tobs, num_steps=n,
                                 im_shape=gt.shape[1:], eta=0.85)
    assert ts.num_draws == len(noises)
    draws = [torch.from_numpy(a) for a in noises]
    tx, _ = ts.sample(noises=draws)
    with pytest.raises(ValueError):
        ts.sample(noises=draws[:-1])
    return {"gt": tgt.numpy(), "obs": tobs.numpy(), "fbp": tfbp.numpy(), "x": tx.numpy()}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.ops import diffusion as jd  # noqa: E402
from diffusion_models_dev_project_tpu.ops import sde as jsde  # noqa: E402
from diffusion_models_dev_project_tpu.ops import time_grids as jtg  # noqa: E402
from diffusion_models_dev_project_tpu.ops.cg import cg as jax_cg  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import engine as je  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import predictors as jp  # noqa: E402


def test_sde_diffusion_cg_and_time_grids_match_jax(tmp_path):
    sdes = {"vesde": jsde.VESDE(0.01, 100.0), "vpsde": jsde.VPSDE(0.1, 10.0), "ddpm": jsde.DDPM()}
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    inputs, refs = {}, {}
    for kind, js in sdes.items():
        t, tprev = _times(kind, rng)
        s, x, xhat = (rng.normal(size=(3, 8, 8, 1)).astype(np.float32) for _ in range(3))
        noise = np.asarray(jax.random.normal(key, xhat.shape, jnp.float32))
        inputs.update({f"{kind}_{n}": v for n, v in
                       dict(t=t, tprev=tprev, s=s, x=x, xhat=xhat, noise=noise).items()})
        for name in ("marginal_prob_std", "marginal_prob_mean"):
            refs[f"{kind}_{name}"] = (np.asarray(getattr(js, name)(jnp.asarray(t))), 2e-6, 0)
        refs[f"{kind}_tweedy"] = (np.asarray(jd.tweedy(jnp.asarray(s), jnp.asarray(x), js,
                                                       jnp.asarray(t))), 1e-5, 1e-5)
        for simplified in (True, False):
            ref = jd.ddim(js, jnp.asarray(s), jnp.asarray(xhat), jnp.asarray(t),
                          jnp.asarray(tprev), 0.85, key, use_simplified_eqn=simplified)
            refs[f"{kind}_ddim_{simplified}"] = (np.asarray(ref), 1e-5, 1e-5)
        for n, start in GRIDS:
            jspec = je.SamplerSpec(method="dds", num_steps=n, start_time_step=start)
            for j, arr in enumerate(je._time_arrays(js, jspec)[:3]):
                refs[f"{kind}_grid{n}_{j}"] = (np.asarray(arr), None, None)
    refs["ddpm_pairs"] = (jtg.ddpm_time_pairs(1000, 20, 2, 3), None, None)

    # CG, with batch entry 2 starting converged (the 0/0 guard)
    a = rng.normal(size=(16, 16)).astype(np.float32)
    spd = a @ a.T / 16 + np.eye(16, dtype=np.float32)
    x0 = rng.normal(size=(3, 4, 4, 1)).astype(np.float32)
    rhs = rng.normal(size=(3, 4, 4, 1)).astype(np.float32)
    rhs[2] = (spd @ x0[2].reshape(16)).reshape(4, 4, 1)
    jop = lambda v: (v.reshape(v.shape[0], 16) @ spd.T).reshape(v.shape)  # noqa: E731
    for n in CG_ITERS:
        refs[f"cg{n}"] = (np.asarray(jax_cg(jop, jnp.asarray(x0), jnp.asarray(rhs), n_iter=n)),
                          1e-4, 1e-5)
    out = child.run(__file__, "algebra", tmp_path, spd=spd, x0=x0, rhs=rhs, **inputs)
    for name, (ref, rtol, atol) in refs.items():
        if rtol is None:                         # time grids: exactly equal
            np.testing.assert_array_equal(out[name], ref, err_msg=name)
            continue
        assert np.isfinite(out[name]).all(), name
        np.testing.assert_allclose(out[name], ref, rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def slice_pair():
    """The JAX half of the tiny slice, and its weights for the port's."""
    jc = _tiny(jget)
    jsd = JF.get_standard_sde(jc)
    jmodel, params, _ = JF.get_standard_score(jc, jsd, load_model=False)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    japply = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))
    gt = np.zeros((1, 32, 32, 1), np.float32)
    gt[0, 8:20, 10:24, 0] = 1.0
    gt[0, 22:28, 5:12, 0] = 0.5
    return dict(jsde=jsd, japply=japply, params=params, flat=child.flatten(params),
                jtrafo=JF.get_standard_ray_trafo(jc), gt=gt)


def test_dds_step_matches_jax(slice_pair, tmp_path):
    sp = slice_pair
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(1, 32, 32, 1)) * 20).astype(np.float32)
    y = rng.normal(size=(1, *sp["jtrafo"].obs_shape, 1)).astype(np.float32)
    t, tprev = np.array([0.6], np.float32), np.array([0.59], np.float32)
    key = jax.random.PRNGKey(6)
    jg = sp["jtrafo"].with_gram()
    jnext, jmean = jp.dds_step(lambda a, b: sp["japply"](sp["params"], a, b), sp["jsde"],
                               jnp.asarray(x), key, jnp.asarray(t), jnp.asarray(tprev),
                               jg.adjoint(jnp.asarray(y)), jg, 0.01, 0.85, 5)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    out = child.run(__file__, "dds_step", tmp_path, x=x, y=y, t=t, tprev=tprev, noise=noise,
                    **sp["flat"])
    for name, ref in (("next", jnext), ("mean", jmean)):
        ref = np.asarray(ref)
        assert np.abs(out[name] - ref).max() <= 1e-4 * np.abs(ref).max()


def test_dds_slice_through_the_factories_matches_jax(slice_pair, tmp_path):
    """Data simulation and FBP, then a 4-step DDS chain at 32², with the JAX
    sampler's own noise injected."""
    sp = slice_pair
    key = jax.random.PRNGKey(7)
    jgt, jobs, jfbp = JF.get_data_from_ground_truth(jnp.asarray(sp["gt"]), sp["jtrafo"], 0.01, key)
    noise = np.array(jax.random.normal(key, jobs.shape, jobs.dtype))

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
    out = child.run(__file__, "dds_slice", tmp_path, gt=sp["gt"], obs_noise=noise,
                    noises=np.stack(noises), **sp["flat"])
    np.testing.assert_array_equal(out["gt"], np.asarray(jgt))
    for name, ref in (("obs", jobs), ("fbp", jfbp)):
        ref = np.asarray(ref)
        assert np.abs(out[name] - ref).max() <= 2e-5 * np.abs(ref).max()
    ref = np.asarray(jx)
    assert out["x"].shape == ref.shape and np.isfinite(out["x"]).all()
    # fp32 through 4 UNet forwards and 24 Gram applies of a random-weight prior
    assert np.abs(out["x"] - ref).max() <= 1e-4 * np.abs(ref).max()
