"""The port's cone-beam projector and slice-matrix assembly against JAX.

On the miniature walnut geometry of tests/test_walnut.py (`MINI_SPEC`, 12
angles of a circular orbit, a 5 x 33 x 33 slab, 5 x 48 detector pixels):

- `fp3d`, all angles at once and 5 at a time, and `bp3d` against the JAX
  package's: within 1e-5 of max|JAX|;
- `bp3d` is the adjoint of `fp3d`: <A x, y> = <x, Aᵀ y> to 1e-5 relative;
- the probe mask of `MaskedWalnutRayTrafo` equals the JAX one for a slice
  off the slab's centre; at the centre the rows above and below the slice
  tie in exact arithmetic and last-bit differences pick either, so there
  each row the port picks holds, by the JAX probe, the largest share of
  its (angle, column) to 1e-5;
- `masked_slice_matrix` (the native assembler) and
  `masked_slice_matrix_plain` against the JAX package's numpy assembly
  (its library unbuilt): rtol 1e-5 (atol 1e-6 where entries vanish).

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np

import _torch_child as child

REL = 1e-5
# tests/test_walnut.py's miniature dataset format and slab
SPEC = dict(projs_rows=32, projs_cols=48, max_num_angles=24, vol_sz=(33, 33, 33), vox_sz=1.0)
SLICE_CFG = dict(num_slices=5, slice_offset=0, num_proj_rows=5, first_proj_row=13)
VOL_MASK_SLICE = 3


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _geom(cb, walnut):
    vecs = cb.circular_cone_vecs(SPEC["max_num_angles"], src_radius=60.0, det_radius=30.0,
                                 det_spacing=(0.9, 0.9))
    return walnut.build_proj_geometry(
        vecs, angular_sub_sampling=2, first_proj_row=SLICE_CFG["first_proj_row"],
        num_proj_rows=SLICE_CFG["num_proj_rows"], num_slices=SLICE_CFG["num_slices"],
        spec=walnut.WalnutDatasetSpec(**SPEC))


# ------------------------------------------------------------- torch halves
def project(vol, projs):
    import torch

    from diffusion_models_dev_project_tpu_torch.physics import cone_beam as cb
    from diffusion_models_dev_project_tpu_torch.physics import walnut

    geom = _geom(cb, walnut)
    fp = cb.fp3d(torch.from_numpy(vol), geom)
    fp5 = cb.make_fp3d(geom, angle_chunk=5, device="cpu")(torch.from_numpy(vol))
    bp = cb.bp3d(torch.from_numpy(projs), geom)
    lhs = float((fp.double() * torch.from_numpy(projs).double()).sum())
    rhs = float((torch.from_numpy(vol).double() * bp.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)
    return {"fp": fp.numpy(), "fp5": fp5.numpy(), "bp": bp.numpy()}


def mask_and_matrix():
    from diffusion_models_dev_project_tpu_torch.physics import cone_beam as cb
    from diffusion_models_dev_project_tpu_torch.physics import walnut

    geom = _geom(cb, walnut)
    trafo = walnut.MaskedWalnutRayTrafo(geom=geom, vol_mask_slice=VOL_MASK_SLICE, device="cpu")
    return {"mask": trafo.proj_mask, "native": trafo.assemble_matrix().toarray(),
            "plain": cb.masked_slice_matrix_plain(geom, trafo.proj_mask).toarray()}


def centre_mask():
    from diffusion_models_dev_project_tpu_torch.physics import cone_beam as cb
    from diffusion_models_dev_project_tpu_torch.physics import walnut

    geom = _geom(cb, walnut)
    centre = (geom.vol_shape[0] - 1) // 2
    return {"mask": walnut.MaskedWalnutRayTrafo(geom=geom, vol_mask_slice=centre,
                                                device="cpu").proj_mask}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
from diffusion_models_dev_project_tpu.physics import cone_beam as jcb  # noqa: E402
from diffusion_models_dev_project_tpu.physics import native as jnative  # noqa: E402
from diffusion_models_dev_project_tpu.physics import walnut as jwalnut  # noqa: E402


def test_fp3d_and_bp3d_match_jax(tmp_path):
    geom = _geom(jcb, jwalnut)
    rng = np.random.default_rng(0)
    vol = rng.random(geom.vol_shape).astype(np.float32)
    projs = rng.normal(size=geom.proj_shape).astype(np.float32)
    fp, bp = np.asarray(jcb.fp3d(vol, geom)), np.asarray(jcb.bp3d(projs, geom))
    out = child.run(__file__, "project", tmp_path, vol=vol, projs=projs)
    for name, ref in (("fp", fp), ("fp5", fp), ("bp", bp)):
        assert _rel(out[name], ref) <= REL, (name, _rel(out[name], ref))


def test_probe_mask_and_slice_matrix_match_jax(tmp_path):
    assert not jnative.available(), "the JAX package's native library must stay unbuilt"
    geom = _geom(jcb, jwalnut)
    trafo = jwalnut.MaskedWalnutRayTrafo(geom=geom, vol_mask_slice=VOL_MASK_SLICE)
    ref = trafo.assemble_matrix().toarray()
    out = child.run(__file__, "mask_and_matrix", tmp_path)
    np.testing.assert_array_equal(out["mask"], trafo.proj_mask)
    for name in ("native", "plain"):
        np.testing.assert_allclose(out[name], ref, rtol=1e-5, atol=1e-6, err_msg=name)


def test_centre_slice_mask_ties(tmp_path):
    geom = _geom(jcb, jwalnut)
    centre = (geom.vol_shape[0] - 1) // 2
    vol = np.zeros(geom.vol_shape, np.float32)
    vol[centre] = 1.0
    projs = np.asarray(jcb.fp3d(vol, geom))
    total = np.asarray(jcb.fp3d(np.ones(geom.vol_shape, np.float32), geom))
    share = np.where(total > 0, projs / np.where(total > 0, total, 1.0), 0.0)
    mask = child.run(__file__, "centre_mask", tmp_path)["mask"]
    assert (mask.sum(axis=0) == 1).all()
    picked = (share * mask).sum(axis=0)
    np.testing.assert_allclose(picked, share.max(axis=0), rtol=1e-5)
