"""The port stands alone: no JAX, nothing of the JAX package, CUDA by default.

The card's machine has torch, numpy and scipy but no jax, flax, msgpack,
ml_collections, yaml or PIL, so the port, chip_smoke.py, adapted_spread.py,
conditional_probe.py and wgrad_probe.py import none of them.  Entry points
run on CUDA unless asked for the CPU, and raise here, where there is no CUDA
device.

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
        "utils.checkpoint")} <= set(modules)
    code = "\n".join([
        "import importlib, sys",
        f"for name in {ABSENT!r}:",
        "    sys.modules[name] = None      # any import of these now fails",
        f"sys.path.insert(0, {REPO!r})",
        f"for name in {modules!r} + ['chip_smoke', 'adapted_spread', 'conditional_probe',"
        " 'wgrad_probe']:",
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
                           "wgrad_probe.py")]
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
    trafo = TF.get_standard_ray_trafo(config, device="cpu")
    assert trafo.device.type == "cpu" and trafo.obs_shape == (6, 47)
    assert resolve_device("cpu") == torch.device("cpu")


def unported_paths_raise():
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config

    config = get_config("vesde")
    config.forward_op.trafo_name = "walnut_trafo"
    with pytest.raises(NotImplementedError):
        TF.get_standard_ray_trafo(config, device="cpu")
    config = get_config("vesde")
    # reference torch checkpoints wait for their converter (queue 1 item 11)
    with pytest.raises(NotImplementedError, match="item 11"):
        TF.get_standard_score(config, TF.get_standard_sde(config), ckpt_path="model.pt",
                              device="cpu")
    # adaptation: the full and decoder strategies train base conv weights
    # through the conv3x3 weight gradient (queue 1 item 8, done); an unknown
    # strategy raises; several images per call is item 10
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
    # training: one device; a mesh (data parallelism) is item 10
    from diffusion_models_dev_project_tpu_torch.training.trainer import train_score_model

    with pytest.raises(NotImplementedError, match="item 10"):
        train_score_model(None, None, None, [], epochs=1, steps_per_epoch=1, mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        TA.AdaptedSampler.sample_batched(None)
    # part "test" has no shipped set: the port generates the test-fold
    # phantoms, as the JAX package does (tests/test_torch_ellipses.py holds
    # them to its); the AAPM and walnut data are item 9
    config.data.part = "test"
    dataset = TF.get_standard_dataset(config, device="cpu")
    image = dataset[0]
    assert len(dataset) == config.data.val_length and image.shape == (256, 256, 1)
    assert image.dtype == np.float32 and image.min() >= 0 and image.max() == 1
    from diffusion_models_dev_project_tpu_torch.configs import aapm_configs, walnut_configs

    for data_config in (aapm_configs.get_config(), walnut_configs.get_config()):
        with pytest.raises(NotImplementedError, match="item 9"):
            TF.get_standard_dataset(data_config, device="cpu")
    # the adapted CLI: full and decoder pass its check; what the port does
    # not have raises, naming its item
    from diffusion_models_dev_project_tpu_torch import run_adapted_sampling as cli

    for impl in ("full", "decoder"):
        cli._check_ported(cli.parser.parse_args(["--adaptation", impl, "--device", "cpu"]))
    for argv, item in ((["--shard_images", "2"], "item 10"), (["--dataset", "walnut"], "item"),
                       (["--model_learned_on", "aapm"], "item")):
        with pytest.raises(NotImplementedError, match=item):
            cli.coordinator(cli.parser.parse_args(argv + ["--device", "cpu"]))
    # the train CLI: the AAPM data is item 9
    from diffusion_models_dev_project_tpu_torch import run_score_based_models_train as train_cli

    with pytest.raises(NotImplementedError, match="item 9"):
        train_cli.coordinator(train_cli.parser.parse_args(["--train_model_on", "aapm",
                                                           "--device", "cpu"]))


if __name__ == "__main__":
    child.main(globals())


def test_entry_points_want_cuda_unless_asked_for_the_cpu(tmp_path):
    if "cuda" in child.run(__file__, "entry_points_want_cuda", tmp_path):
        pytest.skip("this machine has a CUDA device")


def test_unported_paths_raise(tmp_path):
    child.run(__file__, "unported_paths_raise", tmp_path)
