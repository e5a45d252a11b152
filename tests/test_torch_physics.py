"""The port's FFT-shear parallel-beam operator against the JAX package's.

Both operators are built from the same geometry; the port builds its
tables in float64 numpy (the JAX package builds the shear phases in
float32), so outputs agree to a few fp32 ulps of their magnitude.

torch and the port are imported inside the tests, never at collection
(see tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np

from diffusion_models_dev_project_tpu.ops.fbp import ramp_filter_sinogram as j_ramp
from diffusion_models_dev_project_tpu.physics.fft_radon import make_fft_parallel_trafo as j_make
from diffusion_models_dev_project_tpu.physics.geometry import parallel_beam_geometry as j_geom
from diffusion_models_dev_project_tpu.physics.simulation import simulate as j_simulate

# max |port - JAX| / max |JAX|: table round-off and sums in another order
REL = 5e-5
GEOMS = [(64, 30), (256, 60)]


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / np.abs(ref).max()


def _inputs(trafo, seed):
    rng = np.random.default_rng(seed)
    n = trafo.im_shape[0]
    x = rng.normal(size=(2, n, n, 1)).astype(np.float32)
    y = rng.normal(size=(2, *trafo.obs_shape, 1)).astype(np.float32)
    return x, y


def test_operator_matches_jax():
    """Geometry, tables, apply, adjoint, fused gram, fbp and simulate, at
    64² with 30 angles and 256² with 60 angles."""
    import torch

    from diffusion_models_dev_project_tpu_torch.physics.fft_radon import make_fft_parallel_trafo
    from diffusion_models_dev_project_tpu_torch.physics.geometry import parallel_beam_geometry
    from diffusion_models_dev_project_tpu_torch.physics.simulation import simulate

    for n, angles in GEOMS:
        jt, tt = j_make((n, n), angles), make_fft_parallel_trafo((n, n), angles, device="cpu")
        jg, tg = jt.with_gram(), tt.with_gram()
        g1, g2 = j_geom((n, n), angles), parallel_beam_geometry((n, n), angles)
        assert (g1.det_count, g1.det_spacing, g1.obs_shape) == (g2.det_count, g2.det_spacing, g2.obs_shape)
        np.testing.assert_array_equal(g1.angles, g2.angles)
        assert tt.canvas == jt.canvas and tt.k90s == jt.k90s
        assert tuple(tt.inv_perm.tolist()) == jt.inv_perm
        np.testing.assert_array_equal(tt.det_matrix.numpy(), np.asarray(jt.det_matrix))
        np.testing.assert_allclose(tt.fbp_scale, jt.fbp_scale, rtol=1e-5)

        x, y = _inputs(tt, seed=n)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        checks = {"apply": (tt.apply(tx), jt.apply(jx)),
                  "adjoint": (tt.adjoint(ty), jt.adjoint(jy)),
                  "gram": (tg.gram(tx), jg.gram(jx)),
                  "fbp": (tt.fbp(ty), jt.fbp(jy))}
        key = jax.random.PRNGKey(0)
        ref = j_simulate(key, jx, jt, 0.01)
        noise = np.array(jax.random.normal(key, ref.shape, ref.dtype))
        checks["simulate"] = (simulate(tx, tt, 0.01, noise=torch.from_numpy(noise)), ref)
        for name, (out, want) in checks.items():
            assert _rel(out, want) < REL, (n, name)


def test_adjoint_and_gram_are_exact():
    """The written-out adjoint passes the dot test, and the fused Gram equals
    adjoint∘apply (the un-fused `gram` is exactly that)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.physics.fft_radon import make_fft_parallel_trafo

    for n, angles in GEOMS:
        tt = make_fft_parallel_trafo((n, n), angles, device="cpu")
        x, y = (torch.from_numpy(a) for a in _inputs(tt, seed=n + 1))
        lhs = float((tt.apply(x).double() * y.double()).sum())
        rhs = float((x.double() * tt.adjoint(y).double()).sum())
        np.testing.assert_allclose(lhs, rhs, rtol=1e-4)
        ref = tt.adjoint(tt.apply(x))
        assert _rel(tt.with_gram().gram(x), ref) < 1e-5
        assert _rel(tt.gram(x), ref) == 0.0


def test_ramp_filters_match_jax():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops.fbp import ramp_filter_sinogram

    s = np.random.default_rng(5).normal(size=(2, 30, 91, 1)).astype(np.float32)
    for name in ("ramp", "shepp-logan", "cosine", "hann"):
        np.testing.assert_allclose(ramp_filter_sinogram(torch.from_numpy(s), name).numpy(),
                                   np.asarray(j_ramp(jnp.asarray(s), name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
