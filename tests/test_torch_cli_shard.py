"""`--shard_images` of the port's conditional and adapted CLIs on the CPU.

Both CLIs with `--shard_images 2 --num_images 3` at 64² with random weights
(as tests/test_cli.py runs the JAX CLI's): two chunks, the second padded
with its last image, whose extra row is dropped.  Every image is reported
(`recon_<i>.png` and `recon_<i>_info.npz` for i < 3, none for 3), each
reconstruction is finite, `report.yaml` says `sampling_mode: "sharded(2)"`,
and each image's ground truth is the JAX package's test-fold phantom i at
that size (within 1e-6).  The conditional CLI runs DDS; the adapted CLI
runs `lora` (one chain of two images, each with its own LoRA) and `full`
(one image after another).

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import os
import re

import numpy as np
import pytest

import _torch_child as child

SMALL = ["--device", "cpu", "--im_size", "64", "--num_channels", "64", "--num_images", "3",
         "--shard_images", "2"]
RUNS = {
    "conditional_dds": ("run_conditional_sampling", ["--num_steps", "3", "--method", "dds"]),
    "adapted_lora": ("run_adapted_sampling", ["--num_steps", "2", "--num_optim_step", "1",
                                              "--add_cg"]),
    "adapted_full": ("run_adapted_sampling", ["--num_steps", "2", "--num_optim_step", "1",
                                              "--adaptation", "full"]),
}
N_IMAGES = 3
TOL_GT = 1e-6


# ------------------------------------------------------------- torch halves
def run_clis(workdir):
    import importlib

    os.chdir(str(workdir))
    out = {}
    for name, (module, argv) in RUNS.items():
        cli = importlib.import_module(f"diffusion_models_dev_project_tpu_torch.{module}")
        root = cli.coordinator(cli.parser.parse_args(SMALL + argv))
        out[f"{name}_report"] = np.array((root / "report.yaml").read_text())
        out[f"{name}_files"] = np.array(sorted(os.listdir(root)))
        for i in range(N_IMAGES):
            with np.load(root / f"recon_{i}_info.npz") as info:
                out[f"{name}_recon_{i}"], out[f"{name}_gt_{i}"] = info["recon"], info["ground_truth"]
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX half
import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("shard")
    return child.run(__file__, "run_clis", work, timeout=300, workdir=str(work))


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_cli_reports_every_image(runs, name):
    files = set(runs[f"{name}_files"].tolist())
    assert {f"recon_{i}{ext}" for i in range(N_IMAGES) for ext in (".png", "_info.npz")} <= files
    assert "recon_3.png" not in files and "recon_3_info.npz" not in files
    report = str(runs[f"{name}_report"])
    assert re.search(r'^sampling_mode: "?sharded\(2\)"?$', report, re.M), report
    assert re.search(r"^PSNR: -?\d", report, re.M)
    for i in range(N_IMAGES):
        recon = runs[f"{name}_recon_{i}"]
        assert recon.shape == (64, 64) and np.isfinite(recon).all() and recon.min() >= 0


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_cli_reconstructs_the_jax_clis_images(runs, name):
    dataconfig = jget("vesde")
    dataconfig.data.im_size = 64
    dataconfig.data.part = "test"
    images = iter(JF.get_standard_dataset(dataconfig))
    for i in range(N_IMAGES):
        gt = np.asarray(next(images))[..., 0]
        assert np.abs(runs[f"{name}_gt_{i}"] - gt).max() <= TOL_GT, (name, i)
