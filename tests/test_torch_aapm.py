"""The port's AAPM dataset and the conditional CLI on it, against the JAX package.

- `AAPMDataset` on 100 slices written by numpy (`5.npy` to `104.npy`, 64²,
  so that the numeric order is not the names' lexical one): the
  test, val and train folds list the same slices in the same order as the
  JAX package's, their items are equal, and the first four training
  batches (numpy's generator seeded 1234: order and flips) are equal;
  `batches` with no device wants CUDA and raises without it.
- The conditional CLI with `--dataset aapm` (`AAPM_DATA_PATH` at those
  slices; `--im_size 64 --num_channels 64 --num_steps 3 --num_images 1`,
  random weights), with the disk-ellipse prior and with the AAPM config's
  UNet (`--model_learned_on aapm`: learn_sigma, scale-shift norm, resblock
  up/down): each writes the JAX CLI's output path, a finite reconstruction,
  and reconstructs the JAX CLI's image, test-fold slice 0 (equal).

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import os
import re

import numpy as np

import _torch_child as child

N_SLICES, SIZE = 100, 64
PARTS = ("test", "val", "train")
BATCHES, BATCH_SIZE = 4, 3
ARGV = ["--device", "cpu", "--dataset", "aapm", "--method", "dds", "--im_size", "64",
        "--num_channels", "64", "--num_steps", "3", "--num_images", "1"]
PRIORS = ("ellipses", "aapm")


def _write_slices(root):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for k in range(N_SLICES):
        np.save(os.path.join(root, f"{5 + k}.npy"),
                rng.random((SIZE, SIZE)).astype(np.float32))


# ------------------------------------------------------------- torch halves
def folds(root):
    from diffusion_models_dev_project_tpu_torch.data.aapm import AAPMDataset

    out = {}
    for part in PARTS:
        ds = AAPMDataset(part, str(root))
        out[f"{part}_slices"] = np.array(ds.slices)
        out[f"{part}_items"] = np.stack(list(ds))
    it = AAPMDataset("train", str(root)).batches(BATCH_SIZE, device="cpu")
    out["batches"] = np.stack([next(it).numpy() for _ in range(BATCHES)])
    try:                                    # no device named: CUDA, which is absent here
        AAPMDataset("train", str(root)).batches(BATCH_SIZE)
        out["default_raises"] = np.array(False)
    except RuntimeError as e:
        out["default_raises"] = np.array("pass device='cpu'" in str(e))
    return out


def run_cli(root, workdir):
    from diffusion_models_dev_project_tpu_torch import run_conditional_sampling as cli

    os.environ["AAPM_DATA_PATH"] = str(root)
    os.chdir(str(workdir))
    out = {}
    for prior in PRIORS:
        r = cli.coordinator(cli.parser.parse_args(ARGV + ["--model_learned_on", prior]))
        assert re.search(r"^PSNR: ", (r / "report.yaml").read_text(), re.M)
        with np.load(r / "recon_0_info.npz") as info:
            out[f"{prior}_recon"], out[f"{prior}_gt"] = info["recon"], info["ground_truth"]
        out[f"{prior}_path"] = np.array(str(r.parent))
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import sys  # noqa: E402

sys.path.insert(0, child.REPO)              # the JAX CLI is a module at the repo's root
import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
import run_conditional_sampling as jcli  # noqa: E402
from diffusion_models_dev_project_tpu.data.aapm import AAPMDataset  # noqa: E402


def test_aapm_folds_items_and_batches_match_jax(tmp_path):
    root = tmp_path / "slices"
    _write_slices(root)
    out = child.run(__file__, "folds", tmp_path, root=str(root))
    for part in PARTS:
        ds = AAPMDataset(part, str(root))
        assert out[f"{part}_slices"].tolist() == ds.slices
        np.testing.assert_array_equal(out[f"{part}_items"], np.stack(list(ds)))
    it = AAPMDataset("train", str(root)).batches(BATCH_SIZE)
    np.testing.assert_array_equal(out["batches"],
                                  np.stack([np.asarray(next(it)) for _ in range(BATCHES)]))
    assert out["default_raises"], "batches() with no device must want CUDA, not fall back to the CPU"


def test_conditional_cli_on_aapm_reconstructs_the_jax_clis_image(tmp_path, monkeypatch):
    root, work = tmp_path / "slices", tmp_path / "work"
    _write_slices(root)
    work.mkdir()
    monkeypatch.setenv("AAPM_DATA_PATH", str(root))
    pending = child.start(__file__, "run_cli", tmp_path, timeout=300, root=str(root),
                          workdir=str(work))
    wants = {}
    for prior in PRIORS:
        args = jcli.parser.parse_args(ARGV[2:] + ["--model_learned_on", prior])
        _, dataconfig = JF.get_standard_configs(args)
        wants[prior] = JF.get_standard_path(args, run_type="dds",
                                            data_part=dataconfig.data.part).parent
        gt = np.asarray(next(iter(JF.get_standard_dataset(dataconfig))))[..., 0]
        wants[prior, "gt"] = gt
    out = pending.result()
    for prior in PRIORS:
        recon = out[f"{prior}_recon"]
        assert recon.shape == (SIZE, SIZE) and np.isfinite(recon).all() and recon.min() >= 0
        assert os.path.normpath(str(out[f"{prior}_path"])) == os.path.normpath(str(wants[prior]))
        np.testing.assert_array_equal(out[f"{prior}_gt"], wants[prior, "gt"])
