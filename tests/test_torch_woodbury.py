"""The port's Woodbury data consistency against the JAX package's.

- `build_woodbury_sinv` and `woodbury_dc` on a small dense operator (a
  random (96, 32²) matrix, `DenseRayTransform`), gamma = 0.01: within 1e-4
  of max|JAX|; the port's x solves (I + gamma AᵀA) x = xhat0 + gamma Aᵀy to
  1e-4 relative.
- One DDS step with `dc_mode="woodbury"` (the engine's S⁻¹, `dds_step` with
  `dc_sinv` and `observation`) on the tiny UNet of
  tests/test_torch_sampler.py with the JAX weights, the JAX step's DDIM draw
  injected: within 1e-4 of max|JAX|, the DDS step test's tolerance.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

GAMMA = 0.01
N_OBS, IM = 96, (32, 32)
TOL = 1e-4


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _matrix(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.random((N_OBS, IM[0] * IM[1])) * (rng.random((N_OBS, IM[0] * IM[1])) < 0.1)
            ).astype(np.float32)


def _tiny(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    return c


# ------------------------------------------------------------- torch halves
def _dense(matrix):
    import torch

    from diffusion_models_dev_project_tpu_torch.physics.ray_trafo import DenseRayTransform

    return DenseRayTransform(matrix=torch.from_numpy(matrix), im_shape=IM, obs_shape=(1, N_OBS))


def solve(matrix, xhat0, y):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops.woodbury import build_woodbury_sinv, woodbury_dc

    tr = _dense(matrix)
    sinv = build_woodbury_sinv(tr, GAMMA)
    x = woodbury_dc(tr, sinv, torch.from_numpy(xhat0), torch.from_numpy(y))
    lhs = x + GAMMA * tr.adjoint(tr.apply(x))
    rhs = torch.from_numpy(xhat0) + GAMMA * tr.adjoint(torch.from_numpy(y))
    resid = float(torch.linalg.vector_norm(lhs - rhs) / torch.linalg.vector_norm(rhs))
    assert resid <= 1e-4, resid
    return {"sinv": sinv.numpy(), "x": x.numpy()}


def dds_step(matrix, x, y, t, tprev, noise, **params):
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    tc = _tiny(get_config)
    tsd = TF.get_standard_sde(tc)
    tmodel, _, tscore = TF.get_standard_score(tc, tsd, load_model=False, device="cpu")
    tmodel.load_state_dict(params_from_flax(child.unflatten(params)))
    tr = _dense(matrix)
    T = torch.from_numpy
    sampler = TF.get_standard_sampler("dds", tscore, tsd, tr, T(y), num_steps=10, gamma=GAMMA,
                                      eta=0.85, dc_mode="woodbury")
    assert sampler.dc_sinv is not None
    with torch.no_grad():
        nxt, mean = sampler._step(T(x), T(t), T(tprev), 1.0, T(noise), None)
    # the exact solve needs a matrix-backed operator
    fft = TF.get_standard_ray_trafo(tc, device="cpu")
    with pytest.raises(ValueError, match="matrix-backed"):
        TF.get_standard_sampler("dds", tscore, tsd, fft, T(np.zeros((1, *fft.obs_shape, 1),
                                                                    np.float32)),
                                dc_mode="woodbury")
    return {"next": nxt.numpy(), "mean": mean.numpy()}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.ops.woodbury import build_woodbury_sinv, woodbury_dc  # noqa: E402
from diffusion_models_dev_project_tpu.physics.ray_trafo import DenseRayTransform  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import predictors as jp  # noqa: E402


def _jdense(matrix):
    return DenseRayTransform(matrix=jnp.asarray(matrix), im_shape=IM, obs_shape=(1, N_OBS))


def test_sinv_and_woodbury_dc_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    matrix = _matrix()
    xhat0 = rng.normal(size=(2, *IM, 1)).astype(np.float32)
    y = rng.normal(size=(2, 1, N_OBS, 1)).astype(np.float32)
    jt = _jdense(matrix)
    sinv = build_woodbury_sinv(jt, GAMMA)
    x = woodbury_dc(jt, sinv, jnp.asarray(xhat0), jnp.asarray(y))
    out = child.run(__file__, "solve", tmp_path, matrix=matrix, xhat0=xhat0, y=y)
    assert _rel(out["sinv"], sinv) <= TOL
    assert _rel(out["x"], x) <= TOL


def test_woodbury_dds_step_matches_jax(tmp_path):
    jc = _tiny(jget)
    jsd = JF.get_standard_sde(jc)
    jmodel, params, _ = JF.get_standard_score(jc, jsd, load_model=False)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    matrix = _matrix()
    jt = _jdense(matrix)
    x = (rng.normal(size=(1, *IM, 1)) * 20).astype(np.float32)
    y = rng.normal(size=(1, 1, N_OBS, 1)).astype(np.float32)
    t, tprev = np.array([0.6], np.float32), np.array([0.59], np.float32)
    key = jax.random.PRNGKey(6)
    sinv = build_woodbury_sinv(jt, GAMMA)
    jnext, jmean = jp.dds_step(lambda a, b: jmodel.apply({"params": params}, a, b), jsd,
                               jnp.asarray(x), key, jnp.asarray(t), jnp.asarray(tprev),
                               jt.adjoint(jnp.asarray(y)), jt, GAMMA, 0.85, 5,
                               observation=jnp.asarray(y), dc_sinv=sinv)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    out = child.run(__file__, "dds_step", tmp_path, matrix=matrix, x=x, y=y, t=t, tprev=tprev,
                    noise=noise, **child.flatten(params))
    for name, ref in (("next", jnext), ("mean", jmean)):
        assert _rel(out[name], ref) <= TOL, (name, _rel(out[name], ref))
