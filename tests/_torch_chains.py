"""Shared halves of the chain-parity tests of the port's sampling methods
(tests/test_torch_sampler_methods.py, tests/test_torch_sampler_uncond.py).

A case is (method, sde, keywords of `get_standard_sampler`; `dense: True`
runs it on the parallel-beam operator stored as a dense matrix,
`DenseRayTransform`, which the Woodbury solve takes).
Both sides run each case's chain through their factory, with the same
weights at the tiny size of tests/test_torch_sampler.py and the same
observation, or with `batch` 2 the same two observations stacked on the
sampler's batch axis (tests/test_torch_sampler_batch.py); every
draw the JAX engine makes from its split keys (the prior, one per step, one
per corrector step) is recomputed with jax.random and injected into the
port.  Both sides compute in fp32.  The returned chain must lie within
`TOL` of max|JAX|, as for the DDS and DDPM chains; the per-step PSNR trace
within `TOL_TRACE_DB` of JAX's.  This module imports numpy only: `chains`
runs in the test's child interpreter, `jax_half` in the pytest process.
"""
import numpy as np

import _torch_child as child

TOL = 1e-4                  # max|port - JAX| / max|JAX| of the returned x_mean
TOL_TRACE_DB = 2e-3         # |port - JAX| of each step's PSNR, in dB
N_STEPS, PENALTY = 6, 2.0


def tiny(get_config, sde):
    c = get_config(sde)
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


def _num_steps(kw):
    """Steps given to the factory: the FBP start skips the first half."""
    return 2 * N_STEPS if kw.get("pct_chain_elapsed") else N_STEPS


def chains(cases, gt, obs, fbp, arrays):
    """The torch half: every case's chain through the port's factory, with
    the JAX weights and draws; x_mean and the PSNR trace per case."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.physics.ray_trafo import DenseRayTransform

    weights = params_from_flax(child.unflatten(arrays, "params/"))
    T = torch.from_numpy
    out = {}
    for case, (method, kind, kw) in cases.items():
        kw = dict(kw)
        dense = kw.pop("dense", False)
        c = tiny(get_config, kind)
        sde = TF.get_standard_sde(c)
        model, _, score = TF.get_standard_score(c, sde, load_model=False, device="cpu")
        model.load_state_dict(weights)
        trafo = TF.get_standard_ray_trafo(c, device="cpu")
        if dense:
            trafo = DenseRayTransform(matrix=T(arrays["dense_matrix"]), im_shape=trafo.im_shape,
                                      obs_shape=tuple(trafo.obs_shape))
        cond = method != "uncond"
        sampler = TF.get_standard_sampler(
            method, score, sde, trafo if cond else None, T(obs) if cond else None,
            num_steps=_num_steps(kw), batch_size=gt.shape[0], im_shape=gt.shape[1:],
            penalty=PENALTY, ground_truth=T(gt) if cond else None, filtbackproj=T(fbp),
            device="cpu", **kw)
        noises = arrays[f"noises_{case}"]
        assert sampler.num_draws == len(noises), (case, sampler.num_draws, len(noises))
        x, trace = sampler.sample(noises=list(T(noises)), return_trace=True)
        out[f"x_{case}"], out[f"trace_{case}"] = x.numpy(), trace.numpy()
    return out


def _engine_draws(key, n_steps, corrector_steps, shape):
    """The standard-normal draws of the JAX engine's `sample(key)`: the prior's,
    then per step the predictor's and each corrector step's."""
    import jax
    import jax.numpy as jnp

    key, init_key = jax.random.split(key)
    draws = [jax.random.normal(init_key, shape)]
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws.append(jax.random.normal(sub, shape, jnp.float32))
        if corrector_steps:
            key, csub = jax.random.split(key)
            for _ in range(corrector_steps):
                csub, sub = jax.random.split(csub)
                draws.append(jax.random.normal(sub, shape, jnp.float32))
    return np.stack([np.asarray(d) for d in draws])


def jax_half(test_file, cases, tmp_path, seed, batch=1):
    """(JAX x_mean and trace, port's) of every case: the JAX engine's chains,
    with the port's in a child started first, on the same inputs; `batch`
    2 stacks a second phantom's observation on the batch axis."""
    import jax
    import jax.numpy as jnp

    import diffusion_models_dev_project_tpu.factory as JF
    from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget
    from diffusion_models_dev_project_tpu.physics.ray_trafo import DenseRayTransform

    jc = tiny(jget, "vesde")
    _, params, _ = JF.get_standard_score(jc, JF.get_standard_sde(jc), load_model=False)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    trafo = JF.get_standard_ray_trafo(jc)
    gt = np.zeros((batch, 32, 32, 1), np.float32)
    gt[0, 7:21, 8:22, 0] = 1.0
    gt[0, 23:28, 6:15, 0] = 0.6
    if batch > 1:
        gt[1, 4:16, 12:28, 0] = 0.8
        gt[1, 18:30, 3:11, 0] = 0.4
    _, obs, fbp = JF.get_data_from_ground_truth(jnp.asarray(gt), trafo, 0.01,
                                                jax.random.PRNGKey(seed + 1))
    samplers, inputs, models = {}, {}, {}
    if any(kw.get("dense") for _, _, kw in cases.values()):
        # the operator's matrix, column by column from the images of the pixel basis
        n = gt.shape[1] * gt.shape[2]
        cols = trafo.apply(jnp.eye(n, dtype=jnp.float32).reshape(n, *gt.shape[1:]))
        inputs["dense_matrix"] = np.asarray(cols).reshape(n, -1).T.copy()
        dense_op = DenseRayTransform(matrix=jnp.asarray(inputs["dense_matrix"]),
                                     im_shape=tuple(trafo.im_shape),
                                     obs_shape=tuple(trafo.obs_shape))
    for i, (case, (method, kind, kw)) in enumerate(cases.items()):
        kw = dict(kw)
        dense = kw.pop("dense", False)
        c = tiny(jget, kind)
        sde = JF.get_standard_sde(c)
        if kind not in models:
            models[kind] = JF.get_standard_score(c, sde, load_model=False)[0]
        cond = method != "uncond"
        op = dense_op if dense else trafo
        sampler = JF.get_standard_sampler(
            method, None, sde, op if cond else None, obs if cond else None,
            num_steps=_num_steps(kw), batch_size=batch, im_shape=gt.shape[1:], penalty=PENALTY,
            ground_truth=jnp.asarray(gt) if cond else None, filtbackproj=fbp,
            score_apply=lambda p, x, t, m=models[kind]: m.apply({"params": p}, x, t),
            score_params=params, cg_precision="highest", **kw)
        key = jax.random.PRNGKey(seed + 10 + i)
        samplers[case] = (sampler, key)
        corrector = sampler.spec.corrector_steps if sde.prediction_type == "score" else 0
        inputs[f"noises_{case}"] = _engine_draws(key, N_STEPS, corrector, gt.shape)
    pending = child.start(test_file, "chains", tmp_path, gt=gt, obs=np.asarray(obs),
                          fbp=np.asarray(fbp), **inputs, **child.flatten({"params": params}))
    refs = {}
    for case, (sampler, key) in samplers.items():
        x, trace = sampler.sample(key, return_trace=True)
        refs[f"x_{case}"], refs[f"trace_{case}"] = np.asarray(x), np.asarray(trace)
    return refs, pending.result()


def check_chain(pair, case):
    refs, out = pair
    ref, got = refs[f"x_{case}"], out[f"x_{case}"]
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, f"{case}: {err:.3e} of max|JAX| (tol {TOL})"


def check_trace(pair, case):
    refs, out = pair
    ref, got = refs[f"trace_{case}"], out[f"trace_{case}"]
    assert got.shape == ref.shape == (N_STEPS,) and np.isfinite(ref).all()
    assert np.abs(got - ref).max() <= TOL_TRACE_DB, (case, got, ref)
