"""The port's FFT-shear parallel-beam operator against the JAX package's.

Both operators are built from the same geometry; the port builds its
tables in float64 numpy (the JAX package builds the shear phases in
float32), so outputs agree to a few fp32 ulps of their magnitude.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np

import _torch_child as child

# max |port - JAX| / max |JAX|: table round-off and sums in another order
REL = 5e-5
GEOMS = [(64, 30), (256, 60)]
FILTERS = ("ramp", "shepp-logan", "cosine", "hann")


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / np.abs(ref).max()


def _inputs(obs_shape, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n, n, 1)).astype(np.float32)
    y = rng.normal(size=(2, *obs_shape, 1)).astype(np.float32)
    return x, y


# ------------------------------------------------------------- torch halves
def operator(**arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.physics.fft_radon import make_fft_parallel_trafo
    from diffusion_models_dev_project_tpu_torch.physics.geometry import parallel_beam_geometry
    from diffusion_models_dev_project_tpu_torch.physics.simulation import simulate

    out = {}
    for n, angles in GEOMS:
        tt = make_fft_parallel_trafo((n, n), angles, device="cpu")
        tg = tt.with_gram()
        g = parallel_beam_geometry((n, n), angles)
        tx, ty = torch.from_numpy(arrays[f"{n}_x"]), torch.from_numpy(arrays[f"{n}_y"])
        out.update({
            f"{n}_geom": np.array([g.det_count, g.det_spacing, *g.obs_shape], np.float64),
            f"{n}_angles": np.asarray(g.angles), f"{n}_canvas": np.asarray(tt.canvas),
            f"{n}_k90s": np.asarray(tt.k90s), f"{n}_inv_perm": tt.inv_perm.numpy(),
            f"{n}_det_matrix": tt.det_matrix.numpy(), f"{n}_fbp_scale": np.asarray(tt.fbp_scale),
            f"{n}_apply": tt.apply(tx).numpy(), f"{n}_adjoint": tt.adjoint(ty).numpy(),
            f"{n}_gram": tg.gram(tx).numpy(), f"{n}_fbp": tt.fbp(ty).numpy(),
            f"{n}_simulate": simulate(tx, tt, 0.01,
                                      noise=torch.from_numpy(arrays[f"{n}_noise"])).numpy()})
    return out


def adjoint_and_gram():
    import torch

    from diffusion_models_dev_project_tpu_torch.physics.fft_radon import make_fft_parallel_trafo

    for n, angles in GEOMS:
        tt = make_fft_parallel_trafo((n, n), angles, device="cpu")
        x, y = (torch.from_numpy(a) for a in _inputs(tt.obs_shape, n, seed=n + 1))
        lhs = float((tt.apply(x).double() * y.double()).sum())
        rhs = float((x.double() * tt.adjoint(y).double()).sum())
        np.testing.assert_allclose(lhs, rhs, rtol=1e-4)
        ref = tt.adjoint(tt.apply(x))
        assert _rel(tt.with_gram().gram(x), ref) < 1e-5
        assert _rel(tt.gram(x), ref) == 0.0


def ramp_filters(s):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops.fbp import ramp_filter_sinogram

    return {name: ramp_filter_sinogram(torch.from_numpy(s), name).numpy() for name in FILTERS}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.ops.fbp import ramp_filter_sinogram as j_ramp  # noqa: E402
from diffusion_models_dev_project_tpu.physics.fft_radon import make_fft_parallel_trafo as j_make  # noqa: E402
from diffusion_models_dev_project_tpu.physics.geometry import parallel_beam_geometry as j_geom  # noqa: E402
from diffusion_models_dev_project_tpu.physics.simulation import simulate as j_simulate  # noqa: E402


def test_operator_matches_jax(tmp_path):
    """Geometry, tables, apply, adjoint, fused gram, fbp and simulate, at
    64² with 30 angles and 256² with 60 angles."""
    inputs, refs = {}, {}
    key = jax.random.PRNGKey(0)
    for n, angles in GEOMS:
        jt = j_make((n, n), angles)
        x, y = _inputs(jt.obs_shape, n, seed=n)
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        ref = j_simulate(key, jx, jt, 0.01)
        noise = np.array(jax.random.normal(key, ref.shape, ref.dtype))
        inputs.update({f"{n}_x": x, f"{n}_y": y, f"{n}_noise": noise})
        refs[n] = (jt, {"apply": jt.apply(jx), "adjoint": jt.adjoint(jy),
                        "gram": jt.with_gram().gram(jx), "fbp": jt.fbp(jy), "simulate": ref})
    out = child.run(__file__, "operator", tmp_path, **inputs)
    for n, angles in GEOMS:
        jt, checks = refs[n]
        g1 = j_geom((n, n), angles)
        np.testing.assert_array_equal(out[f"{n}_geom"],
                                      np.array([g1.det_count, g1.det_spacing, *g1.obs_shape]))
        np.testing.assert_array_equal(g1.angles, out[f"{n}_angles"])
        assert out[f"{n}_canvas"].tolist() == jt.canvas
        assert tuple(out[f"{n}_k90s"].tolist()) == jt.k90s
        assert tuple(out[f"{n}_inv_perm"].tolist()) == jt.inv_perm
        np.testing.assert_array_equal(out[f"{n}_det_matrix"], np.asarray(jt.det_matrix))
        np.testing.assert_allclose(out[f"{n}_fbp_scale"], jt.fbp_scale, rtol=1e-5)
        for name, want in checks.items():
            assert _rel(out[f"{n}_{name}"], want) < REL, (n, name)


def test_adjoint_and_gram_are_exact(tmp_path):
    """The written-out adjoint passes the dot test, and the fused Gram equals
    adjoint∘apply (the un-fused `gram` is exactly that)."""
    child.run(__file__, "adjoint_and_gram", tmp_path)


def test_ramp_filters_match_jax(tmp_path):
    s = np.random.default_rng(5).normal(size=(2, 30, 91, 1)).astype(np.float32)
    out = child.run(__file__, "ramp_filters", tmp_path, s=s)
    for name in FILTERS:
        np.testing.assert_allclose(out[name], np.asarray(j_ramp(jnp.asarray(s), name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
