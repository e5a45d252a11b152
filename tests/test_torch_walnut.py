"""The port's walnut workload against the JAX package's, on a miniature dataset.

The JAX half writes the miniature CWI-format dataset of tests/test_walnut.py
(`_write_mini_dataset`: a `.geom` orbit, TIFF projections of a disk through
the JAX projector, dark and flat fields, a ground-truth slice) and a copy
without matrices for the port, so that each package assembles and saves
its own `.mat` (the port with its native assembler, the JAX package with
its numpy body).  The operators take the slice one above the slab's centre
(`slice_offset` 1): at the centre the rows above and below the slice tie
in the mask probe, and last-bit differences between the two projectors
pick either (tests/test_torch_cone_beam.py checks those ties):

- `get_walnut_2d_ray_trafo`, `impl="ell"` (with its 33² -> 16² resize) and
  `impl="dense"`: apply, adjoint, the FDK fbp and `fbp_scale` within 1e-5 of
  max|JAX|;
- the flat masked observation and the ground truth read from the TIFFs
  equal the JAX package's within 1e-6 of their max;
- a `.mat` saved by either package loads in the other bit-equal to what the
  saving package loads, and the dense cache lies beside it.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import os
import shutil

import numpy as np

import _torch_child as child

REL = 1e-5
SPEC = dict(projs_rows=32, projs_cols=48, max_num_angles=24, vol_sz=(33, 33, 33), vox_sz=1.0)
SLICE_CFG = dict(num_slices=5, slice_offset=0, num_proj_rows=5, first_proj_row=13)
OFF_CFG = dict(SLICE_CFG, slice_offset=1)
KW = dict(walnut_id=1, orbit_id=2, angular_sub_sampling=2, proj_col_sub_sampling=2,
          new_shape=(16, 16), single_slice_config=OFF_CFG)
MAT = "single_slice_ray_trafo_matrix_walnut1_orbit2_ass2_css2.mat"


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / np.abs(ref).max()


# ------------------------------------------------------------- torch halves
def walnut(root, jax_root, x, y):
    import torch

    from diffusion_models_dev_project_tpu_torch.data import walnut as data
    from diffusion_models_dev_project_tpu_torch.physics import walnut as W

    root, jax_root = str(root), str(jax_root)
    spec = W.WalnutDatasetSpec(**SPEC)
    out = {}
    for impl in ("ell", "dense"):
        rt = W.get_walnut_2d_ray_trafo(root, **KW, spec=spec, impl=impl, device="cpu")
        assert rt.model_im_shape == (16, 16) and rt.im_shape == (33, 33)
        out[f"{impl}_apply"] = rt.apply(torch.from_numpy(x)).numpy()
        out[f"{impl}_adjoint"] = rt.adjoint(torch.from_numpy(y)).numpy()
        out[f"{impl}_fbp"] = rt.fbp(torch.from_numpy(y)).numpy()
        out[f"{impl}_fbp_scale"] = np.asarray(rt.fbp_scale)
    assert os.path.exists(os.path.join(root, MAT.replace(".mat", "_dense_16x16.npy")))
    out["obs"] = data.get_walnut_2d_observation(
        root, 1, 2, angular_sub_sampling=2, proj_col_sub_sampling=2, spec=spec,
        single_slice_config=OFF_CFG, device="cpu")
    out["gt"] = data.get_walnut_2d_ground_truth(root, 1, 2, spec=spec,
                                                single_slice_config=SLICE_CFG)
    out["own_mat"] = W.load_masked_ray_trafo_matrix(os.path.join(root, MAT)).toarray()
    out["jax_mat"] = W.load_masked_ray_trafo_matrix(os.path.join(jax_root, MAT)).toarray()
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.data import walnut as jdata  # noqa: E402
from diffusion_models_dev_project_tpu.physics import walnut as JW  # noqa: E402
from test_walnut import MINI_SPEC, _write_mini_dataset  # noqa: E402


def test_walnut_operators_data_and_mat_files_match_jax(tmp_path):
    assert MINI_SPEC == JW.WalnutDatasetSpec(**SPEC)
    jax_root, root = tmp_path / "jax", tmp_path / "torch"
    _write_mini_dataset(str(jax_root))
    shutil.copytree(jax_root, root)
    rng = np.random.default_rng(0)
    x = rng.random((2, 16, 16, 1)).astype(np.float32)
    pending = None
    refs = {}
    for impl in ("ell", "dense"):
        rt = JW.get_walnut_2d_ray_trafo(str(jax_root), **KW, spec=MINI_SPEC, impl=impl)
        if pending is None:            # the JAX .mat exists now: start the port's half
            y = rng.normal(size=(2, *rt.obs_shape, 1)).astype(np.float32)
            pending = child.start(__file__, "walnut", tmp_path, timeout=180, root=str(root),
                                  jax_root=str(jax_root), x=x, y=y)
        refs.update({f"{impl}_apply": rt.apply(jnp.asarray(x)),
                     f"{impl}_adjoint": rt.adjoint(jnp.asarray(y)),
                     f"{impl}_fbp": rt.fbp(jnp.asarray(y)), f"{impl}_fbp_scale": rt.fbp_scale})
    obs = jdata.get_walnut_2d_observation(str(jax_root), 1, 2, angular_sub_sampling=2,
                                          proj_col_sub_sampling=2, spec=MINI_SPEC,
                                          single_slice_config=OFF_CFG)
    gt = jdata.get_walnut_2d_ground_truth(str(jax_root), 1, 2, spec=MINI_SPEC,
                                          single_slice_config=SLICE_CFG)
    out = pending.result()
    for key, ref in refs.items():
        if key.endswith("fbp_scale"):
            assert abs(float(out[key]) - ref) <= REL * abs(ref), (key, float(out[key]), ref)
        else:
            assert _rel(out[key], ref) <= REL, (key, _rel(out[key], ref))
    for key, ref in (("obs", obs), ("gt", gt)):
        assert _rel(out[key], ref) <= 1e-6, key
    # each package loads the other's .mat exactly as the saving package does
    np.testing.assert_array_equal(out["jax_mat"],
                                  JW.load_masked_ray_trafo_matrix(str(jax_root / MAT)).toarray())
    np.testing.assert_array_equal(JW.load_masked_ray_trafo_matrix(str(root / MAT)).toarray(),
                                  out["own_mat"])
