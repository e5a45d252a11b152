"""The port stands alone: no JAX, nothing of the JAX package, CUDA by default.

The evaluation entry points (`scripts/eval_flagship_256.py`,
`eval_adapted_256.py`, `smoke_512.py`) and the walnut protocol's
(`scripts/_walnut_common.py`, `walnut_full_scale.py`, `walnut_adapted.py`)
are among the modules checked.

The card's machine has torch, numpy and scipy but no jax, flax, msgpack,
ml_collections, yaml or PIL, so the port, chip_smoke.py, adapted_spread.py,
conditional_probe.py, wgrad_probe.py, walnut_probe.py, tf32x3_probe.py and
batched_grad_probe.py import none of them.  Entry points run on CUDA unless asked for the CPU, and raise here,
where there is no CUDA device.  The paths of ROADMAP.md queue 1 item 9
(matrix and walnut operators, AAPM and walnut data) resolve; the walnut
data, which the repository does not hold, raise FileNotFoundError naming
them.  Reference `.pt` checkpoints are read (a missing one raises
FileNotFoundError).  The multi-card paths (`parallel/launch.py`, one
process per rank) import no JAX either; outside a process group a mesh
over more than one device raises, and `rank_devices` gives one CPU rank
when asked for the CPU.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import _torch_child as child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_NAME = "diffusion_models_dev_project_tpu_torch"
PKG = os.path.join(REPO, PKG_NAME)
ABSENT = ["jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "ml_collections", "yaml",
          "PIL", "skimage", "diffusion_models_dev_project_tpu"]


def _port_modules():
    names = []
    for root, _, files in os.walk(PKG):
        rel = os.path.relpath(root, REPO).replace(os.sep, ".")
        for f in sorted(files):
            if f.endswith(".py"):
                names.append(rel if f == "__init__.py" else f"{rel}.{f[:-3]}")
    return sorted(names)


def test_port_and_chip_smoke_import_without_jax_or_the_jax_package():
    modules = _port_modules()
    assert len(modules) >= 20
    # among them the conditional-sampling slice's and the training slice's
    assert {f"{PKG_NAME}.{m}" for m in (
        "run_conditional_sampling", "data.ellipses", "configs.aapm_configs",
        "configs.walnut_configs", "sampling.predictors", "sampling.engine",
        "run_score_based_models_train", "training.losses", "training.ema", "training.trainer",
        "utils.checkpoint", "parallel.mesh", "parallel.launch", "utils.kvlogger",
        "utils.profiling", "utils.flops", "models.torch_convert", "physics.simulation",
        "scripts.eval_flagship_256", "scripts.eval_adapted_256",
        "scripts.smoke_512", "scripts._walnut_common", "scripts.walnut_full_scale",
        "scripts.walnut_adapted")} <= set(modules)
    code = "\n".join([
        "import importlib, sys",
        f"for name in {ABSENT!r}:",
        "    sys.modules[name] = None      # any import of these now fails",
        f"sys.path.insert(0, {REPO!r})",
        f"for name in {modules!r} + ['chip_smoke', 'adapted_spread', 'conditional_probe',"
        " 'wgrad_probe', 'walnut_probe', 'tf32x3_probe', 'batched_grad_probe']:",
        "    importlib.import_module(name)",
        "print('ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"
    # and no source names them in an import statement
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|diffusion_models_dev_project_tpu)\b(?!_torch)",
                     re.M)
    files = [os.path.join(root, f) for root, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files += [os.path.join(REPO, name)
              for name in ("chip_smoke.py", "adapted_spread.py", "conditional_probe.py",
                           "wgrad_probe.py", "walnut_probe.py", "tf32x3_probe.py",
                           "batched_grad_probe.py")]
    assert not [f for f in files if pat.search(open(f, encoding="utf-8").read())]
    # collecting the port's test files imports no torch (xdist workers
    # collect every file, and the JAX tests run in those processes)
    tests = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    code = "\n".join([
        "import importlib, sys",
        f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tests')!r}]",
        f"for name in {tests!r}:",
        "    importlib.import_module(name)",
        "print('torch' in sys.modules)",
    ])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=180, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "False"


# ------------------------------------------------------------- torch halves
def entry_points_want_cuda():
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        return {"cuda": np.array(True)}
    config = get_config("vesde")
    config.data.im_size = 32
    config.forward_op.num_angles = 6
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.get_standard_ray_trafo(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.get_standard_score(config, TF.get_standard_sde(config), load_model=False)
    # the evaluation entry points too, unless given --device cpu
    from diffusion_models_dev_project_tpu_torch.scripts import (eval_adapted_256, eval_flagship_256,
                                                                smoke_512)

    for script in (eval_flagship_256, eval_adapted_256):
        with pytest.raises(RuntimeError, match="CUDA"):
            script.main(["--ckpt", "checkpoints/flagship_vesde_256_ema.msgpack.npz"])
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke_512.main(["--num_steps", "1"])
    # and the walnut protocol's, unless given --device cpu (or --platform cpu)
    from diffusion_models_dev_project_tpu_torch.scripts import walnut_adapted, walnut_full_scale

    with pytest.raises(RuntimeError, match="CUDA"):
        walnut_full_scale.main(["--workdir", "unused"])
    with pytest.raises(RuntimeError, match="CUDA"):
        walnut_adapted.main(["--ckpt", "unused", "--workdir", "unused"])
    assert not os.path.exists("unused")
    trafo = TF.get_standard_ray_trafo(config, device="cpu")
    assert trafo.device.type == "cpu" and trafo.obs_shape == (6, 47)
    assert resolve_device("cpu") == torch.device("cpu")


def _write_aapm_slices(root, n=24, size=64):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for k in range(n):
        np.save(os.path.join(root, f"{100 + k}.npy"), rng.random((size, size)).astype(np.float32))


def unported_paths_raise(workdir):
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs import aapm_configs, walnut_configs
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config

    workdir = str(workdir)
    # the walnut operator and data resolve; without the CWI data in the
    # repository they raise FileNotFoundError naming it
    wconfig = walnut_configs.get_config()
    wconfig.data.data_path = os.path.join(workdir, "Walnuts")
    with pytest.raises(FileNotFoundError, match="walnut"):
        TF.get_standard_ray_trafo(wconfig, device="cpu")
    small = get_config("vesde")
    small.data.im_size, small.forward_op.num_angles = 32, 6
    with pytest.raises(FileNotFoundError, match="walnut"):
        TF.get_standard_dataset(wconfig, TF.get_standard_ray_trafo(small, device="cpu"))
    config = get_config("vesde")
    # reference torch checkpoints are read through models/torch_convert.py
    with pytest.raises(FileNotFoundError, match="model.pt"):
        TF.get_standard_score(config, TF.get_standard_sde(config), ckpt_path="model.pt",
                              device="cpu")
    # adaptation: the full and decoder strategies train base conv weights
    # through the conv3x3 weight gradient (queue 1 item 8, done); an unknown
    # strategy raises
    from diffusion_models_dev_project_tpu_torch.sampling import adaptation as TA

    for impl in ("full", "decoder"):
        assert TA.AdaptSpec(impl=impl).impl == impl
    assert TA.is_adapt_param("in_1_0.conv1.weight", "full")
    assert not TA.is_adapt_param("in_1_0.conv1.weight", "decoder")
    assert TA.is_adapt_param("out_1_0.conv1.weight", "decoder")
    assert not TA.is_adapt_param("out_1_0.emb.weight", "decoder")
    assert TA.is_adapt_param("final_conv.weight", "decoder")
    with pytest.raises(NotImplementedError, match="strategy"):
        TF.get_standard_adapted_sampler("dds", None, None, None, None, adaptation="dif-fit")
    with pytest.raises(NotImplementedError, match="strategy"):
        TA.AdaptSpec(impl="dif-fit")
    # several devices take one process each: outside a process group a mesh
    # over two raises, and the CPU gives one rank
    from diffusion_models_dev_project_tpu_torch.parallel.launch import launch, rank_devices
    from diffusion_models_dev_project_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(2, device="cpu")
    assert rank_devices("cpu") == ["cpu"]
    with pytest.raises(ValueError, match="NCCL takes one rank per card"):
        launch(print, ["cuda:0", "cuda:0"], "nccl")
    # part "test" has no shipped set: the port generates the test-fold
    # phantoms, as the JAX package does (tests/test_torch_ellipses.py holds
    # them to its)
    config.data.part = "test"
    dataset = TF.get_standard_dataset(config, device="cpu")
    image = dataset[0]
    assert len(dataset) == config.data.val_length and image.shape == (256, 256, 1)
    assert image.dtype == np.float32 and image.min() >= 0 and image.max() == 1
    # the AAPM data resolve: the slices of the config's part (the test fold)
    aapm = os.path.join(workdir, "aapm")
    _write_aapm_slices(aapm)
    aconfig = aapm_configs.get_config()
    aconfig.data.base_path = aapm
    dataset = TF.get_standard_dataset(aconfig, device="cpu")
    assert len(dataset) == 3 and dataset[0].shape == (64, 64, 1)
    assert np.array_equal(dataset[0][..., 0], np.load(os.path.join(aapm, "100.npy")))
    aconfig.training.batch_size = 2
    _, batches = TF.get_standard_train_dataset(aconfig, device="cpu")
    assert tuple(next(batches).shape) == (2, 64, 64, 1)
    # the adapted CLI: the walnut data raise as above
    from diffusion_models_dev_project_tpu_torch import run_adapted_sampling as cli

    os.environ["WALNUT_DATA_PATH"] = os.path.join(workdir, "Walnuts")
    os.chdir(workdir)
    with pytest.raises(FileNotFoundError, match="walnut"):
        cli.coordinator(cli.parser.parse_args(["--dataset", "walnut", "--device", "cpu"]))


def aapm_clis(workdir):
    """The adapted CLI on the AAPM data with the AAPM config's UNet (random
    weights, 64², two outer steps), and one training step of the AAPM model
    through the train CLI."""
    from diffusion_models_dev_project_tpu_torch import run_adapted_sampling as acli
    from diffusion_models_dev_project_tpu_torch import run_score_based_models_train as tcli

    workdir = str(workdir)
    aapm = os.path.join(workdir, "aapm")
    _write_aapm_slices(aapm)
    os.environ["AAPM_DATA_PATH"] = aapm
    os.chdir(workdir)
    small = ["--device", "cpu", "--im_size", "64", "--num_channels", "64"]
    root = acli.coordinator(acli.parser.parse_args(
        small + ["--dataset", "aapm", "--model_learned_on", "aapm", "--num_steps", "2",
                 "--num_optim_step", "1", "--num_images", "1"]))
    with np.load(root / "recon_0_info.npz") as info:
        recon, gt = info["recon"], info["ground_truth"]
    state = tcli.coordinator(tcli.parser.parse_args(
        small + ["--train_model_on", "aapm", "--batch_size", "2", "--epochs", "1",
                 "--steps_per_epoch", "1", "--base_path", os.path.join(workdir, "runs")]))
    run = os.path.join(workdir, "runs", "AAPM", "vesde", "version_01")
    return {"recon": recon, "gt": gt, "path": np.array(str(root)), "step": np.array(state.step),
            "run": np.array(os.path.isdir(run))}


if __name__ == "__main__":
    child.main(globals())


def test_entry_points_want_cuda_unless_asked_for_the_cpu(tmp_path):
    if "cuda" in child.run(__file__, "entry_points_want_cuda", tmp_path):
        pytest.skip("this machine has a CUDA device")


def test_unported_paths_raise(tmp_path):
    child.run(__file__, "unported_paths_raise", tmp_path, workdir=str(tmp_path))


def test_aapm_through_the_adapted_and_train_clis(tmp_path):
    out = child.run(__file__, "aapm_clis", tmp_path, timeout=240, workdir=str(tmp_path))
    assert out["recon"].shape == (64, 64) and np.isfinite(out["recon"]).all()
    assert np.array_equal(out["gt"], np.load(tmp_path / "aapm" / "100.npy"))
    assert "aapm_aapm" in str(out["path"]) and int(out["step"]) == 1 and bool(out["run"])
