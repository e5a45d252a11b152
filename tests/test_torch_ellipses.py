"""The port's generated ellipse data against the JAX package's.

The ellipse tables come from numpy on both sides, with the same per-fold
`np.random.RandomState` seeding, so they must be equal bit for bit; the
rasterised phantoms (torch here, a jitted JAX scan there) within `TOL` at
32² and 64² for the train, validation and test folds, of both the plain and
the disk-distributed datasets; and the port's `get_standard_dataset` for
the disk-ellipse config's part "test" at 32² (no shipped set at that size:
the generated test fold) within `TOL` of the JAX package's.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

TOL = 1e-6                  # max|port - JAX| per pixel; the images lie in [0, 1]
N_IMAGES, LENGTH = 3, 10
SIZES, FOLDS = (32, 64), ("train", "validation", "test")
DATASETS = ("plain", "disk")


def _dataset(mod, kind, fold, size, **kw):
    if kind == "plain":
        return mod.get_ellipses_dataset(fold=fold, im_size=size, length=LENGTH, **kw)
    return mod.get_disk_dist_ellipses_dataset(fold=fold, im_size=size, length=LENGTH,
                                              max_n_ellipse=140, **kw)


# ------------------------------------------------------------- torch half
def generate():
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.data import ellipses as te

    out = {}
    for kind in DATASETS:
        for fold in FOLDS:
            for size in SIZES:
                ds = _dataset(te, kind, fold, size, device="cpu")
                imgs = [ds[i] for i in range(N_IMAGES)]
                out[f"{kind}_{fold}_{size}"] = np.stack(imgs)
                out[f"{kind}_{fold}_{size}_params"] = ds.params_batch(0, N_IMAGES)
    config = get_config("vesde")
    config.data.im_size = 32
    assert config.data.part == "test"
    out["standard"] = np.stack(list(TF.get_standard_dataset(config, device="cpu")))
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX half
import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.data import ellipses as je  # noqa: E402


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX's, port's) tables, images and standard dataset, by name."""
    pending = child.start(__file__, "generate", tmp_path_factory.mktemp("ellipses"))
    refs = {}
    for kind in DATASETS:
        for fold in FOLDS:
            for size in SIZES:
                ds = _dataset(je, kind, fold, size)
                refs[f"{kind}_{fold}_{size}"] = np.stack([ds[i] for i in range(N_IMAGES)])
                refs[f"{kind}_{fold}_{size}_params"] = ds.params_batch(0, N_IMAGES)
    config = jget("vesde")
    config.data.im_size = 32
    refs["standard"] = np.stack(list(JF.get_standard_dataset(config)))
    assert refs["standard"].shape == (config.data.val_length, 32, 32, 1)
    return refs, pending.result()


def _check_images(ref, got, name):
    assert got.shape == ref.shape and got.dtype == np.float32, name
    assert ref.max() == 1.0 and ref.min() >= 0.0, name
    assert np.abs(got - ref).max() <= TOL, (name, np.abs(got - ref).max())


def test_ellipse_tables_match_jax_bit_for_bit(pair):
    refs, out = pair
    for name in (n for n in refs if n.endswith("_params")):
        np.testing.assert_array_equal(out[name], refs[name], err_msg=name)


def test_rasterised_phantoms_match_jax(pair):
    refs, out = pair
    for name in (n for n in refs if not n.endswith("_params") and n != "standard"):
        _check_images(refs[name], out[name], name)


def test_standard_dataset_part_test_is_generated_as_in_jax(pair):
    refs, out = pair
    _check_images(refs["standard"], out["standard"], "standard")
