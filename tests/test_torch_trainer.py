"""The port's training loop: exact resume, the tail average, the keep-best
export, and exports that the JAX package reads.

The loop's bookkeeping is the JAX trainer's (`training/trainer.py`): resume
at `step // steps_per_epoch` with the data iterator restarted, a save at
`epoch % save_every == 0` and at the last epoch, the EMA's warm start, the
rolling tail average and the keep-best probe with `best_ema.json`.  The
first three tests train a one-parameter model, as the JAX package's
`tests/test_utils.py` does; the last trains a small UNet on the CPU and
loads its fp16 export with flax and with the JAX package's `_load_params`.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import json
import os

import numpy as np

import _torch_child as child


# ------------------------------------------------------------- torch halves
def _toy():
    """x * w with one parameter, named as a flax tree leaf (`w/bias`)."""
    import torch

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Module()
            self.w.bias = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x, t):
            return x * self.w.bias.reshape(1, 1, 1, 1)

    return Toy()


def _batches():
    while True:
        yield np.full((2, 8, 8, 1), 0.5, np.float32)


def _train(run_dir, epochs, **kw):
    from diffusion_models_dev_project_tpu_torch.ops.sde import VESDE
    from diffusion_models_dev_project_tpu_torch.training.trainer import train_score_model
    from diffusion_models_dev_project_tpu_torch.utils.checkpoint import Checkpointer

    args = dict(epochs=epochs, steps_per_epoch=3, lr=1e-2, log_dir=os.path.join(run_dir, "l"),
                seed=1, save_model_every_n_epoch=1, ema_warm_start_steps=2,
                checkpointer=Checkpointer(os.path.join(run_dir, "ck")))
    args.update(kw)
    return train_score_model(_toy(), None, VESDE(sigma_min=0.01, sigma_max=5.0), _batches(),
                             **args)


def _snapshot(state):
    m, v = state.opt.moments()["w.bias"]
    return np.concatenate([state.params["w.bias"].detach().numpy(),
                           state.ema.shadow["w.bias"].numpy(), m.numpy(), v.numpy(),
                           [state.step, state.ema.num_updates, state.opt.count]])


def resume(work):
    """Two epochs at once against one epoch, then a resumed second: equal
    bit for bit; a resume of a finished run runs nothing; more epochs go on
    from the checkpoint."""
    from diffusion_models_dev_project_tpu_torch.utils.checkpoint import Checkpointer

    work = str(work)
    whole = _train(os.path.join(work, "whole"), 2)
    part = os.path.join(work, "part")
    first = _train(part, 1)
    assert first.step == 3
    resumed = _train(part, 2)
    assert whole.step == resumed.step == 6
    again = _train(part, 2)
    assert again.step == 6
    more = _train(part, 3)
    assert more.step == 9
    ck = Checkpointer(os.path.join(part, "ck"))
    assert ck.steps() == [3, 6, 9] and ck.latest_step() == 9
    assert Checkpointer(os.path.join(work, "empty")).restore() is None
    return {"whole": _snapshot(whole), "resumed": _snapshot(resumed), "again": _snapshot(again)}


def tail_and_best(work):
    """avg_tail 2 and a probe whose scores are best at the second save,
    then a resume with a worse score that must not replace the export."""
    from diffusion_models_dev_project_tpu_torch.utils.checkpoint import Checkpointer

    import torch

    work = str(work)
    # per save the EMA, then from the second save on the tail average
    scores = iter([3.0, 1.0, 9.0, 9.0, 9.0])
    seen = []

    def probe(weights):
        assert all(v.dtype == torch.bfloat16 for v in weights.values())
        seen.append(float(weights["w.bias"][0]))
        return next(scores)

    _train(work, 3, steps_per_epoch=2, avg_tail=2, probe_hook=probe)
    ck = Checkpointer(os.path.join(work, "ck"))
    shadows = np.array([float(ck.restore(step=s)["ema"]["shadow"]["w.bias"][0]) for s in (2, 4, 6)])
    best = json.load(open(os.path.join(work, "l", "best_ema.json")))
    # resume one epoch further with a probe that scores worse than the best
    _train(work, 4, steps_per_epoch=2, avg_tail=2, probe_hook=lambda w: 5.0)
    after = json.load(open(os.path.join(work, "l", "best_ema.json")))
    return {"shadows": shadows, "seen": np.array(seen), "best_step": np.array(best["step"]),
            "best_source": np.array(best["source"]), "best_after": np.array(after["step"]),
            "avg": np.fromfile(os.path.join(work, "l", "avg_ema_tail.msgpack.npz"), np.uint8),
            "best": np.fromfile(os.path.join(work, "l", "best_ema.msgpack.npz"), np.uint8)}


def unet_export(work, x, t):
    """A small UNet trained 2 steps, its EMA exported by the keep-best path;
    the port's model output from that export."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.training.trainer import train_score_model
    from diffusion_models_dev_project_tpu_torch.utils.checkpoint import Checkpointer

    work = str(work)
    c = _unet_config(get_config)
    sde = TF.get_standard_sde(c)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu", train=True)
    _, batches = TF.get_standard_train_dataset(c, device="cpu")
    train_score_model(model, None, sde, batches, epochs=1, steps_per_epoch=2, lr=1e-3,
                      ema_warm_start_steps=1, log_dir=work, probe_hook=lambda w: 0.0,
                      checkpointer=Checkpointer(os.path.join(work, "ck")))
    path = os.path.join(work, "best_ema.msgpack.npz")
    c.ckpt_path = path
    loaded, _, _ = TF.get_standard_score(c, sde, device="cpu")
    with torch.no_grad():
        out = loaded(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return {"out": out, "path": np.array(path)}


def warm_start_rounding(work):
    """A small UNet's random weights exported as fp16 msgpack, then loaded
    as the trainer's masters under bf16 and under fp32 compute, and as
    `full` adaptation's under bf16, in the flax layout."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import (flax_from_params,
                                                                       save_flax_msgpack)

    c = _unet_config(get_config)
    sde = TF.get_standard_sde(c)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu")
    g = torch.Generator().manual_seed(0)
    weights = {n: torch.randn(p.shape, generator=g) * 0.05 for n, p in model.named_parameters()}
    path = save_flax_msgpack(flax_from_params(weights, np.float16),
                             os.path.join(str(work), "w.msgpack.npz"))
    out = {"path": np.array(path)}
    for dt in ("bfloat16", "float32"):
        c.model.dtype = dt
        m, _, _ = TF.get_standard_score(c, sde, ckpt_path=path, train=True, device="cpu")
        assert all(p.dtype == torch.float32 and p.requires_grad for p in m.parameters())
        out.update(child.flatten(flax_from_params(dict(m.named_parameters())), f"{dt}/"))
    c.model.dtype = "bfloat16"
    m, _, _ = TF.get_standard_score(c, sde, ckpt_path=path, adaptation="full", device="cpu")
    assert all(p.dtype == torch.float32 for p in m.parameters())
    out.update(child.flatten(flax_from_params(dict(m.named_parameters())), "full/"))
    return out


def _unet_config(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.data.length = 8
    c.training.batch_size = 2
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "16"
    c.model.num_head_channels = 32
    return c


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import flax.serialization  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.models import unet as JU  # noqa: E402


def test_trainer_resumes_exactly(tmp_path):
    out = child.run(__file__, "resume", tmp_path, work=str(tmp_path))
    np.testing.assert_array_equal(out["resumed"], out["whole"])
    np.testing.assert_array_equal(out["again"], out["whole"])
    assert out["whole"][0] != 0                     # the parameter moved


def test_tail_average_and_keep_best_export(tmp_path):
    out = child.run(__file__, "tail_and_best", tmp_path, work=str(tmp_path))
    avg = flax.serialization.msgpack_restore(out["avg"].tobytes())
    assert avg["w"]["bias"].dtype == np.float16
    # the average of the last two saved EMA shadows (steps 4 and 6)
    np.testing.assert_allclose(avg["w"]["bias"][0], out["shadows"][1:].mean(), rtol=1e-2)
    # probed: ema at each save, the tail average from the second on; the
    # best (1.0) is the second save's EMA, and a worse resumed run keeps it
    assert len(out["seen"]) == 5
    # each save's EMA probed as the JAX trainer casts it: fp32 straight to bf16
    np.testing.assert_array_equal(
        out["seen"][[0, 1, 3]], np.asarray(jnp.asarray(out["shadows"], jnp.bfloat16), np.float32))
    assert int(out["best_step"]) == 4 and str(out["best_source"]) == "ema"
    assert int(out["best_after"]) == 4
    best = flax.serialization.msgpack_restore(out["best"].tobytes())
    np.testing.assert_allclose(best["w"]["bias"][0], out["shadows"][1], rtol=1e-3)


def test_export_loads_in_the_jax_package(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([0.2, 0.9], np.float32)
    out = child.run(__file__, "unet_export", tmp_path, work=str(tmp_path), x=x, t=t)
    path = str(out["path"])
    tree = flax.serialization.msgpack_restore(open(path, "rb").read())
    assert all(v.dtype == np.float16 for v in child.flatten(tree).values())
    jc = _unet_config(jget)
    cfg = JU.create_model_config(jc.model)
    params = JF._load_params(path, cfg, use_ema=False)
    ref = np.asarray(JU.UNetModel(cfg).apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    assert np.abs(ref).max() > 0                   # trained: no longer the zero init's output
    # the same fp16 weights, fp32 compute on both sides
    np.testing.assert_allclose(out["out"], ref, rtol=1e-4, atol=2e-5 * np.abs(ref).max())


def test_warm_start_masters_start_on_the_bf16_grid(tmp_path):
    """Under bf16 compute a trainer's masters are the checkpoint's values
    cast to bf16 as JAX casts them (to nearest, ties to even), so that the
    first updates do not tip the fp16 values that lie halfway between two
    bf16 values all the update's way; under fp32 compute, and for `full`
    adaptation (lr 1e-3), they are the stored values, as the JAX package's
    `_load_params` widens them."""
    out = child.run(__file__, "warm_start_rounding", tmp_path, work=str(tmp_path))
    stored = child.flatten(flax.serialization.msgpack_restore(open(str(out["path"]), "rb").read()))
    ties = changed = total = 0
    for name, a in stored.items():
        assert a.dtype == np.float16
        want = np.asarray(jnp.asarray(a.astype(np.float32), jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(out[f"bfloat16/{name}"], want, err_msg=name)
        np.testing.assert_array_equal(out[f"float32/{name}"], a.astype(np.float32), err_msg=name)
        np.testing.assert_array_equal(out[f"full/{name}"], a.astype(np.float32), err_msg=name)
        ties += int(np.count_nonzero((a.view(np.uint16) & 0b111) == 0b100))
        changed += int(np.count_nonzero(want != a.astype(np.float32)))
        total += a.size
    # about an eighth of fp16 values lie halfway between two bf16 values
    assert 0.1 < ties / total < 0.15 and changed > ties
