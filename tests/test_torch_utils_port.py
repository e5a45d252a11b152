"""The port's mesh, kvlogger, profiling, FLOP counter and `.pt` converter.

- `utils/kvlogger.py`: the same calls on both sides write the same files
  (`progress.csv` equal; `progress.jsonl` equal but for the wall-clock
  stamps and the `time/*` values, which measure time);
- `utils/profiling.py`: `timed_value` returns the result and a time,
  `Throughput` a rate from its second tick on, `device_trace` a trace file,
  `device_busy_us` the union of a trace's device intervals (no CPU
  event, no user annotation; none in a CPU run's trace);
- `utils/flops.py`: `fn_flops` of the tiny UNet's forward equals JAX
  `fn_flops` of the same model (matmuls and convs, 2 FLOPs per
  multiply-add; on the CPU the port's conv3x3 and attention run their plain
  versions, whose matmuls the torch counter sees, and the JAX UNet its XLA
  conv and einsum attention, with no Pallas grid);
- `models/torch_convert.py`: a synthetic reference state_dict, raw and as
  an EMA state, converted by the port equals the JAX package's
  `convert_torch_state_dict` result mapped through the port's
  `params_from_flax`, exactly; `factory.get_standard_score` reads the same
  weights from a `.pt` file;
- `physics/simulation.py::SimulatedDataset`: without noise the triplets of
  the JAX package's, with noise the same triplet on every read of an
  index, another per index, of std rel · mean|Ax|; `models/unet.py::
  count_params` of the tiny UNet equals JAX `count_params` of its tree;
- `parallel/mesh.py`: outside a process group, a mesh over the one device,
  and ValueError for more (a mesh over several devices takes one process
  per device: tests/test_torch_parallel.py); `train_score_model` refuses
  a mesh on another device than the model's.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import json
import os

import numpy as np
import pytest

import _torch_child as child


def _log_calls(kv, log_dir):
    """The same sequence of kvlogger calls for either package's module."""
    kv.configure(log_dir, formats=("jsonl", "csv"))
    kv.logkv("loss", 1.5)
    kv.logkv_mean("psnr", 30.0)
    kv.logkv_mean("psnr", 31.0)
    with kv.profile_kv("step"):
        pass
    first = kv.dumpkvs()

    @kv.profile
    def work():
        return 3

    assert work() == 3
    kv.logkv("loss", 1.25)
    second = kv.dumpkvs()
    return [first, second]


def _tiny(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    return c


# ------------------------------------------------------------- torch halves
def utils_half(workdir, x, t, jax_tree, **arrays):
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import torch_convert as TC
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.parallel import mesh as M
    from diffusion_models_dev_project_tpu_torch.training.trainer import train_score_model
    from diffusion_models_dev_project_tpu_torch.utils import kvlogger, profiling
    from diffusion_models_dev_project_tpu_torch.utils.flops import fn_flops

    workdir = str(workdir)
    out = {}
    dumps = _log_calls(kvlogger, os.path.join(workdir, "torch_log"))
    out["dumps"] = np.array(json.dumps(dumps))
    # profiling
    val, secs = profiling.timed_value(lambda a: (a * 2, None), torch.ones(3))
    out["timed"] = np.array([float(val[0].sum()), secs])
    tp = profiling.Throughput(window=4)
    out["first_tick_none"] = np.array(tp.tick() is None)
    out["rates"] = np.array([tp.tick(2) for _ in range(3)], dtype=np.float64)
    with profiling.device_trace(os.path.join(workdir, "trace")):
        torch.ones(8) @ torch.ones(8)
    out["trace_bytes"] = np.array(os.path.getsize(os.path.join(workdir, "trace", "trace.json")))
    # kernels at 10-20 and 15-30 overlap (20 us together), a copy at 40-50
    # holds a kernel at 42-45; the CPU op and the annotation over 0-100 are
    # not device work
    spans = [("cpu_op", 0, 100), ("kernel", 15, 15), ("gpu_memcpy", 40, 10), ("kernel", 10, 10),
             ("gpu_user_annotation", 0, 100), ("kernel", 42, 3)]
    synthetic = os.path.join(workdir, "synthetic_trace.json")
    with open(synthetic, "w") as f:
        json.dump({"traceEvents": [{"ph": "X", "cat": c, "name": "k", "ts": ts, "dur": d}
                                   for c, ts, d in spans]}, f)
    out["busy_us"] = np.array([profiling.device_busy_us(synthetic),
                               profiling.device_busy_us(os.path.join(workdir, "trace",
                                                                     "trace.json"))])
    # FLOPs of the tiny UNet's forward
    c = _tiny(get_config)
    model, _, _ = TF.get_standard_score(c, TF.get_standard_sde(c), load_model=False, device="cpu")
    with torch.no_grad():
        out["flops"] = np.array(fn_flops(model, torch.from_numpy(x), torch.from_numpy(t)))
    # .pt conversion: raw and EMA, against the JAX converter's tree
    sd = {k[len("sd/"):]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("sd/")}
    want = params_from_flax(child.unflatten(arrays, "jax_tree/"))
    keys = [k for k, _, _ in TC.torch_key_map(model.cfg)]
    assert list(sd) == keys
    raw = TC.convert_torch_state_dict(sd, model.cfg)
    ema = TC.convert_ema_state({"shadow_params": [sd[k] for k in keys], "decay": 0.999},
                               model.cfg)
    for form, got in (("raw", raw), ("ema", ema)):
        out[f"pt_{form}_equal"] = np.array(sorted(got) == sorted(want) == sorted(model.state_dict())
                                           and all(torch.equal(got[n], want[n]) for n in want))
    with pytest.raises(KeyError, match="missing"):
        TC.convert_torch_state_dict({k: v for k, v in sd.items() if k != "out.2.bias"}, model.cfg)
    for name, obj in (("model.pt", sd), ("ema_model.pt", {"shadow_params": [sd[k] for k in keys]})):
        path = os.path.join(workdir, name)
        torch.save(obj, path)
        loaded, _, _ = TF.get_standard_score(c, TF.get_standard_sde(c), ckpt_path=path,
                                             device="cpu")
        out[f"pt_file_{name}"] = np.array(all(torch.equal(p.float(), want[n])
                                              for n, p in loaded.state_dict().items()))
    # the mesh outside a process group: one device, and no more
    mesh = M.make_mesh(device="cpu")
    batch = M.shard_batch(mesh, {"x": np.ones((2, 3), np.float32), "y": [torch.zeros(2)]})
    out["mesh_one_device"] = np.array(
        mesh.devices == (torch.device("cpu"),) and mesh.shape == {"data": 1}
        and batch["x"].device.type == "cpu" and tuple(batch["x"].shape) == (2, 3)
        and isinstance(batch["y"], list) and M.replicate(mesh, torch.ones(2)).device.type == "cpu")
    with pytest.raises(ValueError, match="one process per device"):
        M.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh()
    elsewhere = M.Mesh((torch.device("meta"),))
    with pytest.raises(ValueError, match="is not the model's"):
        train_score_model(model, None, None, [], epochs=1, steps_per_epoch=1, mesh=elsewhere)
    return out


def simulation_and_count(images, **_):
    """`SimulatedDataset` triplets without and with noise, and the tiny
    UNet's parameter count (module and state_dict)."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.unet import count_params
    from diffusion_models_dev_project_tpu_torch.physics.simulation import SimulatedDataset

    c = _tiny(get_config)
    c.forward_op.num_angles = 20
    trafo = TF.get_standard_ray_trafo(c, device="cpu")
    out = {}
    clean = SimulatedDataset(list(images), trafo, white_noise_rel_stddev=0.0, seed=3)
    assert len(clean) == len(images)
    for i, (y, x, fbp) in enumerate(clean):
        out[f"clean{i}_y"], out[f"clean{i}_x"], out[f"clean{i}_fbp"] = (
            a.numpy() for a in (y, x, fbp))
    noisy = SimulatedDataset(list(images), trafo, white_noise_rel_stddev=0.05, seed=3)
    y0, y0b, y1 = noisy[0][0], noisy[0][0], noisy[1][0]
    assert torch.equal(y0, y0b) and not torch.equal(y1, clean[1][0])
    for i, y in enumerate((y0, y1)):
        clean_y = clean[i][0]
        out[f"noise{i}"] = (y - clean_y).numpy()
        out[f"level{i}"] = np.array(0.05 * clean_y.abs().mean().item())
    assert not torch.equal(noisy[0][0], SimulatedDataset(list(images), trafo, 0.05, seed=4)[0][0])
    model, state, _ = TF.get_standard_score(c, TF.get_standard_sde(c), load_model=False,
                                            device="cpu")
    out["count"] = np.array([count_params(model), count_params(state),
                             count_params(list(state.values()))])
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX half
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.models.torch_convert import (  # noqa: E402
    convert_torch_state_dict, torch_key_map)
from diffusion_models_dev_project_tpu.utils import kvlogger as jkv  # noqa: E402
from diffusion_models_dev_project_tpu.utils.flops import fn_flops as jfn_flops  # noqa: E402


def _torch_layout(flax_shape, key):
    """The shape a reference torch checkpoint stores for a flax leaf."""
    if len(flax_shape) == 4:                          # conv (kh, kw, I, O) -> (O, I, kh, kw)
        return (flax_shape[3], flax_shape[2], flax_shape[0], flax_shape[1])
    if len(flax_shape) == 2:                          # dense (I, O) -> (O, I), conv1d (O, I, 1)
        o_i = (flax_shape[1], flax_shape[0])
        return o_i + (1,) if key.endswith(("qkv.weight", "proj_out.weight")) else o_i
    return flax_shape


@pytest.fixture(scope="module")
def utils_pair(tmp_path_factory):
    work = tmp_path_factory.mktemp("utils_port")
    jc = _tiny(jget)
    jmodel, params, _ = JF.get_standard_score(jc, JF.get_standard_sde(jc), load_model=False)
    flat = traverse_util.flatten_dict(params)
    rng = np.random.default_rng(91)
    sd = {}
    for tkey, fpath, _ in torch_key_map(jmodel.cfg):
        sd[tkey] = rng.normal(size=_torch_layout(flat[fpath].shape, tkey)).astype(np.float32)
    jax_tree = convert_torch_state_dict(sd, jmodel.cfg)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([0.3, 0.6], np.float32)
    pending = child.start(__file__, "utils_half", work, timeout=180, workdir=str(work), x=x, t=t,
                          jax_tree=np.array(0), **{f"sd/{k}": v for k, v in sd.items()},
                          **child.flatten(jax_tree, "jax_tree/"))
    jdumps = _log_calls(jkv, os.path.join(str(work), "jax_log"))
    jflops = jfn_flops(lambda p, a, b: jmodel.apply({"params": p}, a, b), params,
                       jnp.asarray(x), jnp.asarray(t))
    return dict(work=work, jdumps=jdumps, jflops=jflops, out=pending.result())


def _untimed(row):
    return {k: v for k, v in row.items() if not k.startswith(("time/", "_time"))}


def test_kvlogger_writes_what_the_jax_module_writes(utils_pair):
    work, out = utils_pair["work"], utils_pair["out"]
    dumps = json.loads(str(out["dumps"]))
    assert [_untimed(d) for d in dumps] == [_untimed(d) for d in utils_pair["jdumps"]]
    assert [sorted(d) for d in dumps] == [sorted(d) for d in utils_pair["jdumps"]]
    files = {}
    for side in ("torch", "jax"):
        d = work / f"{side}_log"
        lines = (d / "progress.jsonl").read_text().splitlines()
        csv = (d / "progress.csv").read_text().splitlines()
        files[side] = ([_untimed(json.loads(line)) for line in lines],
                       [sorted(json.loads(line)) for line in lines], csv[0], csv[2])
    assert files["torch"] == files["jax"]


def test_unet_flops_match_jax(utils_pair):
    assert float(utils_pair["out"]["flops"]) == utils_pair["jflops"] > 0


def test_profiling_helpers(utils_pair):
    out = utils_pair["out"]
    assert out["timed"][0] == 6.0 and out["timed"][1] > 0
    assert bool(out["first_tick_none"]) and (out["rates"] > 0).all()
    assert int(out["trace_bytes"]) > 0


def test_device_busy_counts_each_interval_once(utils_pair):
    assert utils_pair["out"]["busy_us"].tolist() == [30.0, 0.0]


@pytest.mark.parametrize("form", ["pt_raw_equal", "pt_ema_equal", "pt_file_model.pt",
                                  "pt_file_ema_model.pt"])
def test_pt_checkpoint_converts_as_the_jax_converter(utils_pair, form):
    assert bool(utils_pair["out"][form])


def test_mesh_holds_one_device_and_refuses_more(utils_pair):
    assert bool(utils_pair["out"]["mesh_one_device"])


def test_simulated_dataset_and_count_params_match_jax(tmp_path):
    from diffusion_models_dev_project_tpu.models.unet import count_params as jcount
    from diffusion_models_dev_project_tpu.physics.simulation import SimulatedDataset as JDS

    rng = np.random.default_rng(92)
    images = np.zeros((2, 32, 32, 1), np.float32)
    images[0, 6:20, 8:24] = 1.0
    images[1, 10:28, 4:16] = rng.uniform(0.2, 1.0)
    pending = child.start(__file__, "simulation_and_count", tmp_path, images=images)
    jc = _tiny(jget)
    jc.forward_op.num_angles = 20
    _, params, _ = JF.get_standard_score(jc, JF.get_standard_sde(jc), load_model=False)
    clean = JDS(list(images), JF.get_standard_ray_trafo(jc), white_noise_rel_stddev=0.0, seed=3)
    out = pending.result()
    for i, (y, x, fbp) in enumerate(clean):
        np.testing.assert_array_equal(out[f"clean{i}_x"], np.asarray(x))
        for name, ref in (("y", y), ("fbp", fbp)):
            ref = np.asarray(ref)
            # fp32 operators on both sides, sums in another order
            assert np.abs(out[f"clean{i}_{name}"] - ref).max() <= 2e-5 * np.abs(ref).max()
    for i in range(2):
        # white noise of the stated level: the sample std of ~940 draws lies
        # within 10% of it, its mean within 0.15 of it
        noise, level = out[f"noise{i}"], float(out[f"level{i}"])
        assert abs(noise.std() / level - 1) < 0.1 and abs(noise.mean()) < 0.15 * level
    assert np.abs(out["noise0"] - out["noise1"]).max() > 0
    assert out["count"].tolist() == [jcount(params)] * 3
