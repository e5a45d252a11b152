"""The port's conditional-sampling CLI, end to end at a small size on the CPU.

`run_conditional_sampling.coordinator` of the port with `--device cpu
--im_size 64 --num_channels 64 --num_steps 3 --num_images 1` (random
weights; 64² is the smallest size the disk-ellipse config's UNet takes, as
for the JAX CLI's own test in tests/test_cli.py), for `dds`, `dps` and
`naive`: each run writes `report.yaml`, `recon_0.png` and
`recon_0_info.npz` into the JAX CLI's output path, and reconstructs the JAX
CLI's image: its ground truth equals, within 1e-6, the first test-fold
phantom of the JAX package's `get_standard_dataset` at that size
(`--shard_images`: tests/test_torch_cli_shard.py).  Without the CWI data in
the repository the walnut data raise
FileNotFoundError naming them, and the Woodbury data consistency
(`dc_mode="woodbury"`) raises for an operator without a dense matrix.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import os
import re

import numpy as np
import pytest

import _torch_child as child

METHODS = ("dds", "dps", "naive")
ARGV = ["--device", "cpu", "--im_size", "64", "--num_channels", "64", "--num_steps", "3",
        "--num_images", "1"]
TOL_GT = 1e-6


# ------------------------------------------------------------- torch halves
def run_cli(workdir):
    from diffusion_models_dev_project_tpu_torch import run_conditional_sampling as cli

    os.chdir(str(workdir))
    out = {}
    for method in METHODS:
        root = cli.coordinator(cli.parser.parse_args(ARGV + ["--method", method]))
        report = (root / "report.yaml").read_text()
        assert re.search(r"^PSNR: ", report, re.M) and re.search(r"^SSIM: ", report, re.M)
        assert re.search(rf'^method: "?{method}"?$', report, re.M), report
        assert (root / "recon_0.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        with np.load(root / "recon_0_info.npz") as info:
            out[f"{method}_recon"], out[f"{method}_gt"] = info["recon"], info["ground_truth"]
        out[f"{method}_path"] = np.array(str(root.parent))
    return out


def unported_raise(workdir):
    from pathlib import Path

    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch import run_conditional_sampling as cli

    workdir = Path(str(workdir))
    os.chdir(str(workdir))

    os.environ["WALNUT_DATA_PATH"] = str(workdir / "Walnuts")
    with pytest.raises(FileNotFoundError, match="walnut"):
        cli.coordinator(cli.parser.parse_args(ARGV + ["--dataset", "walnut"]))
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config

    config = get_config("vesde")
    config.data.im_size, config.forward_op.num_angles = 32, 6
    fft = TF.get_standard_ray_trafo(config, device="cpu")
    obs = fft.apply(fft.adjoint(fft.apply(torch.zeros(1, 32, 32, 1))))
    with pytest.raises(ValueError, match="matrix-backed"):
        TF.get_standard_sampler("dds", None, TF.get_standard_sde(config), fft, obs,
                                dc_mode="woodbury")


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX half
import sys  # noqa: E402

sys.path.insert(0, child.REPO)              # the JAX CLI is a module at the repo's root
import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
import run_conditional_sampling as jcli  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("cli")
    return work, child.run(__file__, "run_cli", work, timeout=240, workdir=str(work))


@pytest.mark.parametrize("method", METHODS)
def test_cli_writes_the_jax_clis_outputs_for_its_image(runs, method):
    _, out = runs
    recon = out[f"{method}_recon"]
    assert recon.shape == (64, 64) and np.isfinite(recon).all() and recon.min() >= 0
    # the JAX CLI's output path (less its time stamp) and its image
    args = jcli.parser.parse_args(ARGV[2:] + ["--method", method])
    config, dataconfig = JF.get_standard_configs(args)
    dataconfig.data.im_size = 64
    want = JF.get_standard_path(args, run_type=method, data_part=dataconfig.data.part).parent
    assert os.path.normpath(str(out[f"{method}_path"])) == os.path.normpath(str(want))
    gt = np.asarray(next(iter(JF.get_standard_dataset(dataconfig))))[..., 0]
    assert np.abs(out[f"{method}_gt"] - gt).max() <= TOL_GT


def test_unported_options_raise_naming_their_roadmap_items(tmp_path):
    child.run(__file__, "unported_raise", tmp_path, workdir=str(tmp_path))
