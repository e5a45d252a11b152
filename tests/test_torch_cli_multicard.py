"""The port's three CLIs sharded over two ranks on the CPU.

Each CLI runs with `--device cpu` at the small sizes of
tests/test_torch_cli_shard.py and tests/test_torch_cli_train.py (64², 64
channels: with one channel per GroupNorm group a conv bias right before
the norm has a gradient of exactly 0, which Adam turns into steps of up to
lr on any two correct runs), once with `parallel/launch.py::rank_devices`
giving two CPU ranks (the CLI then spawns two gloo ranks itself) and once
in one process:

- conditional DDS and adapted `lora` at `--shard_images 2 --num_images 2`:
  each image's PSNR equals the one-process `--shard_images` run's within
  `TOL_PSNR_DB` = 1e-4 dB, and `report.yaml` says `sharded(2) over 2 ranks`;
- training at a global batch of 4 (2 rows a rank) for 3 steps, warm-started
  (`--init_ckpt`) from weights drawn nonzero with numpy: the saved
  checkpoint's parameters and EMA shadow equal the one-process run's, each
  leaf within `TOL_CHECKPOINT` = 1e-6 of its 2-norm, and its Adam moments
  (averages of the gradients, whose fp32 sums over the batch's 4 x 64²
  pixels run in another order) within `TOL_MOMENTS` = 1e-5.  (From the fresh init, whose zero-initialised convs first see
  gradients near Adam's epsilon, Adam's m/√v turns their rounding into
  steps that differ by 4e-5 of the leaf; and Adam's first update, lr
  times the sign of each gradient, flips for gradients within rounding of
  0: `--lr_warmup 1` runs the first step at lr 0.)  The key third of each attention
  `qkv` bias has a gradient of exactly 0; Adam turns its rounding noise
  into steps of up to lr on any two correct runs, so those elements are
  held to 2 lr k only;
- only rank 0 writes: each run leaves one output directory, holding what
  the one-process run's holds.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import json
import os
import re

import numpy as np
import pytest

import _torch_child as child

SMALL = ["--device", "cpu", "--im_size", "64", "--num_channels", "64"]
SAMPLING = {
    "conditional_dds": ("run_conditional_sampling", ["--num_steps", "3", "--method", "dds"]),
    "adapted_lora": ("run_adapted_sampling", ["--num_steps", "2", "--num_optim_step", "1",
                                              "--add_cg"]),
}
SHARD = ["--num_images", "2", "--shard_images", "2"]
N_IMAGES = 2
TRAIN_STEPS, LR, HEAD_CHANNELS = 3, 1e-4, 64         # the config's lr and head width
TRAIN = ["--batch_size", "4", "--epochs", "1", "--steps_per_epoch", str(TRAIN_STEPS),
         "--lr_warmup", "1", "--save_every_n_epoch", "1"]
TOL_PSNR_DB = 1e-4
TOL_CHECKPOINT = 1e-6
TOL_MOMENTS = 1e-5


# ------------------------------------------------------------- torch halves
def _warm_start(path):
    """A checkpoint directory of the train CLI's format holding the small
    UNet's parameters, each leaf drawn nonzero with numpy."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.utils.checkpoint import Checkpointer

    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 64
    c.model.num_channels = 64
    model, _, _ = TF.get_standard_score(c, TF.get_standard_sde(c), load_model=False,
                                        device="cpu")
    rng = np.random.default_rng(5)
    params = {}
    for n, v in model.state_dict().items():
        scale = n.endswith(".weight") and "norm" in n.split(".")[-2]      # a GroupNorm's
        params[n] = torch.from_numpy(
            (float(scale) + rng.normal(0, 0.05, tuple(v.shape))).astype(np.float32))
    Checkpointer(path).save({"params": params}, step=0)
    return path


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def run_clis(workdir):
    import importlib

    import torch

    from diffusion_models_dev_project_tpu_torch.parallel import launch as L
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR

    one_rank = L.rank_devices
    out = {}
    init = _warm_start(os.path.join(str(workdir), "init"))
    for ranks in (2, 1):
        L.rank_devices = (lambda device=None: ["cpu", "cpu"]) if ranks == 2 else one_rank
        for name, (module, argv) in SAMPLING.items():
            work = os.path.join(str(workdir), f"{name}_{ranks}")
            os.makedirs(work)
            os.chdir(work)
            cli = importlib.import_module(f"diffusion_models_dev_project_tpu_torch.{module}")
            root = cli.coordinator(cli.parser.parse_args(SMALL + SHARD + argv))
            out[f"{name}_{ranks}_report"] = np.array((root / "report.yaml").read_text())
            out[f"{name}_{ranks}_files"] = np.array(_listing(work))
            psnr = []
            for i in range(N_IMAGES):
                with np.load(root / f"recon_{i}_info.npz") as info:
                    psnr.append(PSNR(info["recon"], info["ground_truth"]))
            out[f"{name}_{ranks}_psnr"] = np.array(psnr)
        cli = importlib.import_module(
            "diffusion_models_dev_project_tpu_torch.run_score_based_models_train")
        base = os.path.join(str(workdir), f"train_{ranks}")
        cli.coordinator(cli.parser.parse_args(SMALL + TRAIN + ["--base_path", base,
                                                               "--init_ckpt", init]))
        out[f"train_{ranks}_files"] = np.array(_listing(base))
        run = os.path.join(base, "DiskEllipses", "vesde", "version_01")
        state = torch.load(os.path.join(run, "ckpts", str(TRAIN_STEPS), "state.pt"),
                           weights_only=False)
        for n, v in state["params"].items():
            out[f"train_{ranks}/p/{n}"] = v.numpy()
            out[f"train_{ranks}/ema/{n}"] = state["ema"]["shadow"][n].numpy()
        adam = state["opt_state"]["adam"]["state"]
        for i, n in enumerate(state["params"]):
            out[f"train_{ranks}/mu/{n}"] = adam[i]["exp_avg"].numpy()
            out[f"train_{ranks}/nu/{n}"] = adam[i]["exp_avg_sq"].numpy()
        log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
        out[f"train_{ranks}_losses"] = np.array([e["value"] for e in log
                                                 if e["name"].startswith("train/")])
    return out


if __name__ == "__main__":
    child.main(globals())

RUN_DIR = re.compile(r"\d\d-\d\d-\d{4}-\d\d-\d\d-\d\d|version_\d\d")


def _normalised(files):
    """The files with the run directory (a time stamp, or version_NN) named alike."""
    return [RUN_DIR.sub("<run>", f) for f in files]


def _run_dirs(files):
    return {m for f in files for m in RUN_DIR.findall(f)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multicard")
    return child.run(__file__, "run_clis", work, timeout=300, workdir=str(work))


@pytest.mark.parametrize("name", list(SAMPLING))
def test_sharded_cli_reports_the_one_process_psnr(runs, name):
    two, one = runs[f"{name}_2_psnr"], runs[f"{name}_1_psnr"]
    assert two.shape == (N_IMAGES,) and np.isfinite(two).all()
    np.testing.assert_allclose(two, one, rtol=0, atol=TOL_PSNR_DB)
    assert 'sampling_mode: "sharded(2) over 2 ranks"' in str(runs[f"{name}_2_report"]).replace(
        "'", '"')
    assert "over" not in [line for line in str(runs[f"{name}_1_report"]).splitlines()
                          if line.startswith("sampling_mode")][0]


@pytest.mark.parametrize("name", list(SAMPLING) + ["train"])
def test_only_rank_0_writes(runs, name):
    """One output directory (one time stamp, one version) holding the
    one-process run's files: rank 1 wrote nothing."""
    two, one = runs[f"{name}_2_files"].tolist(), runs[f"{name}_1_files"].tolist()
    assert two and len(_run_dirs(two)) == 1 == len(_run_dirs(one))
    assert sorted(_normalised(two)) == sorted(_normalised(one)), (two, one)


def _zero_gradient(name, shape):
    """The key third of an attention `qkv` bias ([head][q|k|v][ch] order)."""
    mask = np.zeros(shape, bool)
    if name.endswith(".qkv.bias"):
        mask.reshape(-1, 3, HEAD_CHANNELS)[:, 1] = True
    return mask


def test_data_parallel_train_cli_saves_the_one_process_checkpoint(runs):
    np.testing.assert_allclose(runs["train_2_losses"], runs["train_1_losses"], rtol=1e-6)
    names = [k[len("train_1/p/"):] for k in runs if k.startswith("train_1/p/")]
    assert len(names) > 100
    for tag in ("p", "ema"):
        for n in names:
            got, ref = runs[f"train_2/{tag}/{n}"], runs[f"train_1/{tag}/{n}"]
            mask = _zero_gradient(n, ref.shape)
            assert np.abs(got - ref)[mask].max(initial=0) <= 2 * LR * TRAIN_STEPS, (tag, n)
            d = np.where(mask, 0.0, got - ref)
            assert np.linalg.norm(d) <= TOL_CHECKPOINT * np.linalg.norm(ref), (tag, n)
    for tag in ("mu", "nu"):                 # the Adam moments, of the gradients alone
        for n in names:
            got, ref = runs[f"train_2/{tag}/{n}"], runs[f"train_1/{tag}/{n}"]
            keep = ~_zero_gradient(n, ref.shape)
            assert np.abs(ref[keep]).max() > 0, (tag, n)       # every leaf took a gradient
            err = np.linalg.norm((got - ref)[keep]) / np.linalg.norm(ref[keep])
            assert err <= TOL_MOMENTS, (tag, n, err)
