"""The port's matrix operators (ELL and dense) and their assembly against JAX.

- The Joseph parallel-beam matrix: the port's native assembler (built from
  `native/projector.cpp` into `build/native/`) against the JAX package's
  numpy body (its library stays unbuilt), at 48² x 14 angles, entry by
  entry: rtol 1e-5, atol 1e-6.  The port's numpy twin gives the JAX
  triplets exactly.
- `ell_from_coo` of the same triplets: tables equal.
- `RayTransform` (`make_parallel_beam_trafo(impl="matrix")`, and
  `make_matmul_trafo` of a random sparse matrix with a 45² -> 32² resize,
  uncalibrated as the walnut's):
  apply, adjoint, fbp and `fbp_scale` within 1e-5 of max|JAX|, and the
  gradients of <A x, y> in x and of <Aᵀ y, x> in y (the ELL autograd
  Function) within 1e-5 of `jax.grad`'s.
- `densify_model_grid` at 45² -> 32²: within 1e-6 of max|JAX|.
- The nearest resize: its indices equal `jax.image.resize`'s at 501 -> 256
  and 256 -> 501.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np

import _torch_child as child

REL = 1e-5                 # max|port - JAX| / max|JAX|, fp32 sums in another order
REL_DENSE = 1e-6
GEOM = ((48, 48), 14)
NATIVE, MODEL, N_OBS = (45, 45), (32, 32), 60


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _random_matrix(seed=3):
    """A sparse (N_OBS, 45²) matrix, scipy CSR, about 40 entries a row."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = NATIVE[0] * NATIVE[1]
    dense = np.where(rng.random((N_OBS, n)) < 0.02, rng.random((N_OBS, n)), 0.0)
    return sp.csr_matrix(dense.astype(np.float32))


# ------------------------------------------------------------- torch halves
def assemble():
    from diffusion_models_dev_project_tpu_torch.physics import geometry as G

    geom = G.parallel_beam_geometry(*GEOM)
    out = {}
    for name, fn in (("native", G.joseph_system_matrix), ("plain", G.joseph_system_matrix_plain)):
        rows, cols, vals = fn(geom)
        out.update({f"{name}_rows": rows, f"{name}_cols": cols, f"{name}_vals": vals})
    return out


def ell_tables(rows, cols, vals, n_rows, n_cols):
    from diffusion_models_dev_project_tpu_torch.physics.geometry import ell_from_coo

    t = ell_from_coo(rows, cols, vals, int(n_rows), int(n_cols))
    return {"idx": t.idx, "w": t.w}


def operators(x, y, xm, ym):
    import torch

    from diffusion_models_dev_project_tpu_torch.physics import ray_trafo as RT

    T = torch.from_numpy
    out = {}
    pb = RT.make_parallel_beam_trafo(GEOM[0], GEOM[1], impl="matrix", device="cpu")
    mm = RT.make_matmul_trafo(_random_matrix(), NATIVE, (1, N_OBS), resize_shape=MODEL,
                              calibrate_fbp=False, device="cpu")
    for name, tr, xx, yy in (("pb", pb, x, y), ("mm", mm, xm, ym)):
        tx, ty = T(xx).requires_grad_(True), T(yy).requires_grad_(True)
        ax, aty = tr.apply(tx), tr.adjoint(ty)
        gx, = torch.autograd.grad((ax * T(yy)).sum(), tx)
        gy, = torch.autograd.grad((aty * T(xx)).sum(), ty)
        out.update({f"{name}_apply": ax.detach().numpy(), f"{name}_adjoint": aty.detach().numpy(),
                    f"{name}_grad_x": gx.numpy(), f"{name}_grad_y": gy.numpy(),
                    f"{name}_fbp_scale": np.asarray(tr.fbp_scale)})
        if name == "pb":
            out["pb_fbp"] = tr.fbp(T(yy)).numpy()
    return out


def densify():
    from diffusion_models_dev_project_tpu_torch.physics.ray_trafo import densify_model_grid

    return {"dense": densify_model_grid(_random_matrix(), NATIVE, MODEL, device="cpu").numpy()}


def resize_indices():
    import torch

    from diffusion_models_dev_project_tpu_torch.physics.ray_trafo import nearest_resize

    out = {}
    for n_in, n_out in ((501, 256), (256, 501)):
        x = torch.arange(n_in, dtype=torch.float32)[None, :, None, None].expand(1, n_in, n_in, 1)
        r = nearest_resize(x.contiguous(), (n_out, n_out))
        out[f"{n_in}_{n_out}_rows"] = r[0, :, 0, 0].long().numpy()
        out[f"{n_in}_{n_out}_cols"] = nearest_resize(x.transpose(1, 2).contiguous(),
                                                     (n_out, n_out))[0, 0, :, 0].long().numpy()
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from diffusion_models_dev_project_tpu.physics import geometry as JG  # noqa: E402
from diffusion_models_dev_project_tpu.physics import native as jnative  # noqa: E402
from diffusion_models_dev_project_tpu.physics import ray_trafo as JRT  # noqa: E402


def _dense_coo(rows, cols, vals, shape):
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).toarray()


def test_joseph_native_and_plain_match_the_jax_numpy_body(tmp_path):
    assert not jnative.available(), "the JAX package's native library must stay unbuilt"
    geom = JG.parallel_beam_geometry(*GEOM)
    rows, cols, vals = JG.joseph_system_matrix(geom)
    shape = (int(np.prod(geom.obs_shape)), GEOM[0][0] * GEOM[0][1])
    ref = _dense_coo(rows, cols, vals, shape)
    out = child.run(__file__, "assemble", tmp_path)
    got = _dense_coo(out["native_rows"], out["native_cols"], out["native_vals"], shape)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for name, a in (("rows", rows), ("cols", cols), ("vals", vals)):
        np.testing.assert_array_equal(out[f"plain_{name}"], a)
    # the JAX package reads native/libprojector.so: the port never writes it
    assert not jnative.available()


def test_ell_tables_equal(tmp_path):
    geom = JG.parallel_beam_geometry(*GEOM)
    rows, cols, vals = JG.joseph_system_matrix(geom)
    n_rows, n_cols = int(np.prod(geom.obs_shape)), GEOM[0][0] * GEOM[0][1]
    for r, c, nr, nc in ((rows, cols, n_rows, n_cols), (cols, rows, n_cols, n_rows)):
        ref = JG.ell_from_coo(r, c, vals, nr, nc)
        out = child.run(__file__, "ell_tables", tmp_path, rows=r, cols=c, vals=vals, n_rows=nr,
                        n_cols=nc)
        np.testing.assert_array_equal(out["idx"], ref.idx)
        np.testing.assert_array_equal(out["w"], ref.w)


def test_ray_transforms_and_their_gradients_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    pb = JRT.make_parallel_beam_trafo(GEOM[0], GEOM[1], cache=False, impl="matrix")
    mm = JRT.make_matmul_trafo(_random_matrix(), NATIVE, (1, N_OBS), resize_shape=MODEL,
                               calibrate_fbp=False)
    x = rng.normal(size=(2, *GEOM[0], 1)).astype(np.float32)
    y = rng.normal(size=(2, *pb.obs_shape, 1)).astype(np.float32)
    xm = rng.normal(size=(2, *MODEL, 1)).astype(np.float32)
    ym = rng.normal(size=(2, 1, N_OBS, 1)).astype(np.float32)
    out = child.run(__file__, "operators", tmp_path, x=x, y=y, xm=xm, ym=ym)
    for name, tr, xx, yy in (("pb", pb, x, y), ("mm", mm, xm, ym)):
        jx, jy = jnp.asarray(xx), jnp.asarray(yy)
        refs = {
            "apply": tr.apply(jx), "adjoint": tr.adjoint(jy),
            "grad_x": jax.grad(lambda v: jnp.sum(tr.apply(v) * jy))(jx),
            "grad_y": jax.grad(lambda v: jnp.sum(tr.adjoint(v) * jx))(jy)}
        if name == "pb":
            refs["fbp"] = tr.fbp(jy)
        for key, ref in refs.items():
            assert _rel(out[f"{name}_{key}"], ref) <= REL, (name, key, _rel(out[f"{name}_{key}"], ref))
        assert abs(float(out[f"{name}_fbp_scale"]) - tr.fbp_scale) <= REL * abs(tr.fbp_scale)


def test_densify_model_grid_matches_jax(tmp_path):
    ref = JRT.densify_model_grid(_random_matrix(), NATIVE, MODEL)
    out = child.run(__file__, "densify", tmp_path)
    assert _rel(out["dense"], ref) <= REL_DENSE


def test_nearest_resize_takes_jaxs_indices(tmp_path):
    out = child.run(__file__, "resize_indices", tmp_path)
    for n_in, n_out in ((501, 256), (256, 501)):
        src = jnp.arange(n_in, dtype=jnp.float32)
        want = np.asarray(jax.image.resize(src, (n_out,), method="nearest")).astype(np.int64)
        np.testing.assert_array_equal(out[f"{n_in}_{n_out}_rows"], want)
        np.testing.assert_array_equal(out[f"{n_in}_{n_out}_cols"], want)
