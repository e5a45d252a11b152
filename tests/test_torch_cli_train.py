"""The port's training CLI on the CPU at a tiny size.

`run_score_based_models_train` with the JAX CLI's flags writes a versioned
run directory (`report.yaml`, `train_log.jsonl`, checkpoints, the tail
average, the keep-best export with `best_ema.json`, the sample grids), and
`--run_dir` resumes that directory from its latest checkpoint.  A warm
start from a reference `.pt` file that is not there raises
FileNotFoundError naming it, and so do missing AAPM slices.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import json
import os

import numpy as np

import _torch_child as child

TINY = ["--device", "cpu", "--im_size", "64", "--num_channels", "64", "--batch_size", "2",
        "--steps_per_epoch", "2", "--save_every_n_epoch", "1", "--lr_warmup", "2",
        "--grad_clip", "1.0", "--loss_sigma_alpha", "0.5", "--avg_tail", "2",
        "--keep_best_probe", "tweedie", "--sample_freq", "1", "--val_num_steps", "2"]


# ------------------------------------------------------------- torch halves
def train_and_resume(base):
    import pytest

    from diffusion_models_dev_project_tpu_torch import run_score_based_models_train as cli

    base = str(base)
    state = cli.coordinator(cli.parser.parse_args(TINY + ["--epochs", "2", "--base_path", base]))
    run = os.path.join(base, "DiskEllipses", "vesde", "version_01")
    assert os.path.isdir(run) and state.step == 4
    files = sorted(os.listdir(run))
    resumed = cli.coordinator(cli.parser.parse_args(TINY + ["--epochs", "3", "--run_dir", run]))
    assert resumed.step == 6
    steps = sorted(int(s) for s in os.listdir(os.path.join(run, "ckpts")))
    with pytest.raises(FileNotFoundError, match="model.pt"):
        cli.coordinator(cli.parser.parse_args(TINY + ["--init_ckpt", "model.pt",
                                                      "--base_path", base]))
    # the AAPM model trains on the slices under AAPM_DATA_PATH (absent here;
    # tests/test_torch_imports.py trains it on written slices)
    os.environ["AAPM_DATA_PATH"] = os.path.join(base, "no_aapm_slices")
    with pytest.raises(FileNotFoundError, match="no_aapm_slices"):
        cli.coordinator(cli.parser.parse_args(TINY + ["--train_model_on", "aapm",
                                                      "--base_path", base]))
    log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
    return {"files": np.array(files), "steps": np.array(steps),
            "samples": np.array(sorted(os.listdir(os.path.join(run, "samples")))),
            "report": np.array(open(os.path.join(run, "report.yaml")).read()),
            "losses": np.array([e["value"] for e in log if e["name"] == "train/loss"]),
            "best": np.array(open(os.path.join(run, "best_ema.json")).read())}


if __name__ == "__main__":
    child.main(globals())


def test_train_cli_writes_the_run_directory_and_resumes(tmp_path):
    out = child.run(__file__, "train_and_resume", tmp_path, timeout=180, base=str(tmp_path))
    assert set(out["files"]) == {"avg_ema_tail.msgpack.npz", "best_ema.json",
                                 "best_ema.msgpack.npz", "ckpts", "report.yaml", "samples",
                                 "train_log.jsonl"}
    assert out["steps"].tolist() == [2, 4, 6]
    assert out["samples"].tolist() == ["epoch_0000.png", "epoch_0001.png", "epoch_0002.png"]
    report = str(out["report"])
    assert "im_size: 64" in report and "num_channels: 64" in report
    # a loss logged at the first step of each epoch, finite
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert json.loads(str(out["best"]))["source"] in ("ema", "avg_tail2")
