"""The port stands alone: no JAX, nothing of the JAX package, CUDA by default.

The card's machine has torch, numpy and scipy but no jax, flax, msgpack,
ml_collections, yaml or PIL, so the port and chip_smoke.py import none of
them.  Entry points run on CUDA unless asked for the CPU, and raise here,
where there is no CUDA device.

torch and the port are imported inside the tests, never at collection
(see tests/test_torch_kernels.py).
"""
import os
import re
import subprocess
import sys

import pytest

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
    code = "\n".join([
        "import importlib, sys",
        f"for name in {ABSENT!r}:",
        "    sys.modules[name] = None      # any import of these now fails",
        f"sys.path.insert(0, {REPO!r})",
        f"for name in {modules!r} + ['chip_smoke']:",
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
    files.append(os.path.join(REPO, "chip_smoke.py"))
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


def test_entry_points_want_cuda_unless_asked_for_the_cpu():
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
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


def test_unported_paths_raise():
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config

    config = get_config("vesde")
    config.forward_op.trafo_name = "walnut_trafo"
    with pytest.raises(NotImplementedError):
        TF.get_standard_ray_trafo(config, device="cpu")
    config = get_config("vesde")
    with pytest.raises(ValueError, match="format"):
        TF.get_standard_score(config, TF.get_standard_sde(config), ckpt_path="model.pt",
                              device="cpu")
