"""The port's flagship evaluation entry point (`scripts/eval_flagship_256.py`)
against the JAX package.

The JAX script parses its command line when imported, so its per-image
protocol is composed here from the JAX factory's calls, as the script
makes them: image i's data from `fold_in(PRNGKey(seed), i)`, one sampler
built on image 0 and re-pointed at each image's observation, Aᵀy and FBP,
the chain sampled from `fold_in(key, 1)`, the clamped reconstruction's
PSNR and SSIM, and with `trace` a first, traced sample of image 0.  The
port runs its own `evaluate` on the same images with the same weights
(64², a narrow UNet, random weights carried across from JAX's params) and
every draw the JAX side makes injected: VESDE DDS (traced), DPS and naive,
DDPM DDS, DDS with time travel and ancestral DPS, 2 images each.  Both
sides compute in fp32.

Then the module's `main` runs on the CPU on a tiny 256² checkpoint written
by the port's msgpack writer: its printed lines in the JAX script's format,
`--save_npz` and the trace file, and its weights under `--params_dtype`
against the JAX script's cast of the same checkpoint.

The torch half runs in child interpreters (tests/_torch_child.py): no
pytest process runs torch code.
"""
import re

import numpy as np
import pytest

import _torch_child as child

IM, N_STEPS, N_IMAGES, SEED, STDDEV = 64, 3, 2, 1, 0.01
# case: (sde, method, keywords of the sampler factory, trace)
CASES = {
    "vesde_dds": ("vesde", "dds", {"eta": 0.15}, True),
    "vesde_dps": ("vesde", "dps", {"penalty": 2.0}, False),
    "vesde_naive": ("vesde", "naive", {"penalty": 2.0}, False),
    "ddpm_dds": ("ddpm", "dds", {"eta": 0.15}, False),
    "ddpm_dds_travel": ("ddpm", "dds", {"eta": 0.15, "travel_length": 2, "travel_repeat": 2},
                        False),
    "ddpm_dps": ("ddpm", "dps", {"penalty": 2.0}, False),
}
# max|port - JAX| / max|JAX| of each image's chain output before the clamp
# (fp32 through a few UNet forwards, Gram applies and, for DPS, a backward:
# sums in another order; a random-weight prior leaves it far outside
# [0, 1]), the clamped reconstructions within as much of max|JAX|, and the
# metrics of the two within these
TOL = 1e-4
TOL_PSNR_DB = 1e-2
TOL_SSIM = 1e-4
TOL_TRACE_DB = 2e-3
# the JAX script's printed lines
LINE = re.compile(r"^image (\d+): dds +(-?\d+\.\d{2}) dB / (-?\d\.\d{4}) SSIM \| "
                  r"FBP +(-?\d+\.\d{2}) dB \| (\d+\.\d)s$")
MEAN = re.compile(r"^MEAN over (\d+): dds (-?\d+\.\d{2}) dB / (-?\d\.\d{4}) SSIM \| "
                  r"FBP (-?\d+\.\d{2}) dB$")
TRACE = re.compile(r"^trace PSNR @ \{0,25,50,75,90,95,100\}% of steps:( -?\d+\.\d){7}$")


def _tiny(get_config, sde):
    c = get_config(sde)
    c.data.im_size = c.model.image_size = IM
    c.model.num_channels = 32
    c.model.channel_mult = "1,2,2"
    c.model.attention_resolutions = "16"
    c.model.num_head_channels = 16
    return c


def _args(method, kw, trace):
    import argparse

    a = dict(method=method, num_steps=N_STEPS, num_images=N_IMAGES, eta=0.15, gamma=0.01,
             penalty=1.0, cg_iter=5, travel_length=1, travel_repeat=1, early_stopping_pct=None,
             cg_precision="high", trace=trace)
    a.update(kw)
    return argparse.Namespace(**a)


# ------------------------------------------------------------- torch halves
def cases(images, **arrays):
    """Every case through the port's `evaluate`, with the JAX weights and draws."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.sampling import engine
    from diffusion_models_dev_project_tpu_torch.scripts import eval_flagship_256 as EF

    os.chdir(tempfile.mkdtemp())            # --trace writes outputs/trace_psnr.npy
    # each chain's output before the clamp, as the sampler returns it
    raw, sample = [], engine.DiffusionSampler.sample

    def recorded(self, *a, **kw):
        res = sample(self, *a, **kw)
        raw.append(res[0][0, ..., 0].numpy().copy())
        return res

    engine.DiffusionSampler.sample = recorded
    out = {}
    for case, (sde_name, method, kw, trace) in CASES.items():
        c = _tiny(get_config, sde_name)
        sde = TF.get_standard_sde(c)
        model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu")
        model.load_state_dict(params_from_flax(child.unflatten(arrays, f"params_{sde_name}/")))
        trafo = TF.get_standard_ray_trafo(c, device="cpu")

        def draws(i, case=case):
            n = arrays[f"chain_{case}_{i}"]
            return torch.from_numpy(arrays[f"obs_noise_{sde_name}"][i]), list(torch.from_numpy(n))

        printed = io.StringIO()
        raw.clear()
        with contextlib.redirect_stdout(printed):
            res = EF.evaluate(_args(method, kw, trace), sde, model, trafo, list(images), c.seed,
                              c.data.stddev, torch.device("cpu"), draws=draws)
        lines = printed.getvalue().splitlines()
        assert len(lines) == N_IMAGES + trace, lines
        out[f"{case}_recon"] = np.stack(res["recon"])
        out[f"{case}_raw"] = np.stack(raw[trace:])          # the traced run's is image 0's again
        for k in ("psnr", "ssim", "fbp"):
            out[f"{case}_{k}"] = np.array(res[k])
        if trace:
            out[f"{case}_trace"] = res["trace"]
            assert np.array_equal(np.load("outputs/trace_psnr.npy"), res["trace"])
    return out


def main_cpu(workdir, **_):
    """`main` on the CPU on a tiny 256² checkpoint (32 channels, random
    weights, fp16 storage, written by the port's msgpack writer): the
    printed lines, the saved stacks, and the weights as `load_model` stores
    them under each `--params_dtype` (bf16 compute)."""
    import contextlib
    import io
    import os

    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import (flax_from_params,
                                                                       save_flax_msgpack)
    from diffusion_models_dev_project_tpu_torch.scripts import eval_flagship_256 as EF

    workdir = str(workdir)
    os.chdir(workdir)
    c = get_config("vesde")
    c.model.num_channels = 32
    sde = TF.get_standard_sde(c)
    model, state, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu")
    rng = np.random.default_rng(31)
    state = {k: v + torch.from_numpy(rng.normal(0, 0.02, v.shape).astype(np.float32))
             for k, v in state.items()}
    ckpt = save_flax_msgpack(flax_from_params(state, dtype=np.float16),
                             os.path.join(workdir, "tiny.msgpack.npz"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        EF.main(["--ckpt", ckpt, "--num_channels", "32", "--num_steps", "2", "--num_images",
                 str(N_IMAGES), "--device", "cpu", "--trace", "--save_npz", "saved.npz"])
    out = {"printed": np.array(printed.getvalue()), "ckpt": np.array(ckpt)}
    with np.load("saved.npz") as f:
        out.update({f"saved_{k}": f[k] for k in f.files})
    c.model.dtype = "bfloat16"
    for params_dtype in ("bfloat16", "float32"):
        m = EF.load_model(c, sde, ckpt, params_dtype, torch.device("cpu"))
        dtypes = {n: str(p.dtype) for n, p in m.named_parameters()}
        tree = child.flatten(flax_from_params(m.state_dict()), f"{params_dtype}/")
        out.update(tree)
        out.update({f"dtype_{params_dtype}/{k[len(params_dtype) + 1:]}": np.array(
            dtypes[_port_name(k[len(params_dtype) + 1:])]) for k in tree})
    return out


def _port_name(flax_key):
    *mods, leaf = flax_key.split("/")
    return ".".join([*mods, "bias" if leaf == "bias" else "weight"])


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.utils.metrics import PSNR as JPSNR  # noqa: E402
from diffusion_models_dev_project_tpu.utils.metrics import SSIM as JSSIM  # noqa: E402


def _engine_draws(key, n_steps, shape):
    """The draws of the JAX engine's `sample(key)` without a corrector: the
    prior's (or the FBP start's), then one per step."""
    key, init_key = jax.random.split(key)
    draws = [jax.random.normal(init_key, shape)]
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws.append(jax.random.normal(sub, shape, jnp.float32))
    return np.stack([np.asarray(d) for d in draws])


def _images():
    images = np.zeros((N_IMAGES, IM, IM, 1), np.float32)
    images[0, 14:42, 16:44] = 1.0
    images[0, 46:56, 12:30] = 0.6
    images[1, 8:32, 24:56] = 0.8
    images[1, 36:60, 6:22] = 0.4
    return images


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """The JAX script's protocol composed per case, and the port's `evaluate`
    on the same inputs in a child started first."""
    images = _images()
    inputs, params, models, trafos = {}, {}, {}, {}
    for sde_name in ("vesde", "ddpm"):
        jc = _tiny(jget, sde_name)
        models[sde_name], p, _ = JF.get_standard_score(jc, JF.get_standard_sde(jc),
                                                       load_model=False)
        rng = np.random.default_rng(33)
        params[sde_name] = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), p)
        inputs.update(child.flatten(params[sde_name], f"params_{sde_name}/"))
        trafos[sde_name] = JF.get_standard_ray_trafo(jc)
    data = {}
    for sde_name in ("vesde", "ddpm"):
        rows = []
        for i in range(N_IMAGES):
            key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
            gt, obs, fbp = JF.get_data_from_ground_truth(jnp.asarray(images[i])[None],
                                                         trafos[sde_name], STDDEV, key)
            rows.append((key, gt, obs, fbp))
            inputs.setdefault(f"obs_noise_{sde_name}", []).append(
                np.asarray(jax.random.normal(key, obs.shape, obs.dtype)))
        inputs[f"obs_noise_{sde_name}"] = np.stack(inputs[f"obs_noise_{sde_name}"])
        data[sde_name] = rows
    samplers = {}
    for case, (sde_name, method, kw, trace) in CASES.items():
        jc = _tiny(jget, sde_name)
        _, gt, obs, fbp = data[sde_name][0]
        model = models[sde_name]
        s = JF.get_standard_sampler(
            method, None, JF.get_standard_sde(jc), trafos[sde_name], obs, num_steps=N_STEPS,
            im_shape=(IM, IM, 1), filtbackproj=fbp, ground_truth=gt if trace else None,
            score_apply=lambda p, x, t, m=model: m.apply({"params": p}, x, t),
            score_params=params[sde_name], cg_precision="highest",
            **{k: v for k, v in _args(method, kw, trace).__dict__.items()
               if k in ("gamma", "eta", "cg_iter", "penalty", "travel_length", "travel_repeat",
                        "early_stopping_pct")})
        n = len(s._time_data[0])
        for i, (key, *_rest) in enumerate(data[sde_name]):
            inputs[f"chain_{case}_{i}"] = _engine_draws(jax.random.fold_in(key, 1), n,
                                                        (1, IM, IM, 1))
        samplers[case] = s
    pending = child.start(__file__, "cases", tmp_path_factory.mktemp("eval_flagship"),
                          timeout=240, images=images, **inputs)
    refs = {}
    for case, s in samplers.items():
        sde_name, method, kw, trace = CASES[case]
        recons, raws, psnrs, ssims, fbps = [], [], [], [], []
        for i, (key, gt, obs, fbp) in enumerate(data[sde_name]):
            if i == 0 and trace:
                _, tr = s.sample(jax.random.fold_in(key, 1), return_trace=True)
                refs[f"{case}_trace"] = np.asarray(tr)
            if i > 0:
                s.observation = obs
                s.rhs = trafos[sde_name].adjoint(obs)
                s.filtbackproj = fbp
            x, _ = s.sample(jax.random.fold_in(key, 1))
            raws.append(np.asarray(x[0, ..., 0]))
            x = np.clip(raws[-1], 0, 1)
            g = np.asarray(gt[0, ..., 0])
            recons.append(x)
            psnrs.append(JPSNR(x, g))
            ssims.append(JSSIM(x, g))
            fbps.append(JPSNR(np.asarray(fbp[0, ..., 0]), g))
        refs[f"{case}_recon"], refs[f"{case}_raw"] = np.stack(recons), np.stack(raws)
        refs.update({f"{case}_psnr": np.array(psnrs), f"{case}_ssim": np.array(ssims),
                     f"{case}_fbp": np.array(fbps)})
    return refs, pending.result()


@pytest.mark.parametrize("case", list(CASES))
def test_per_image_reconstruction_and_metrics_match_jax(eval_pair, case):
    refs, out = eval_pair
    ref, got = refs[f"{case}_raw"], out[f"{case}_raw"]
    assert got.shape == ref.shape == (N_IMAGES, IM, IM) and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale, case
    assert np.abs(out[f"{case}_recon"] - refs[f"{case}_recon"]).max() <= TOL * scale, case
    np.testing.assert_allclose(out[f"{case}_psnr"], refs[f"{case}_psnr"], rtol=0, atol=TOL_PSNR_DB)
    np.testing.assert_allclose(out[f"{case}_ssim"], refs[f"{case}_ssim"], rtol=0, atol=TOL_SSIM)
    # the FBP of the same observation
    np.testing.assert_allclose(out[f"{case}_fbp"], refs[f"{case}_fbp"], rtol=0, atol=TOL_PSNR_DB)
    if f"{case}_trace" in refs:
        np.testing.assert_allclose(out[f"{case}_trace"], refs[f"{case}_trace"], rtol=0,
                                   atol=TOL_TRACE_DB)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("eval_flagship_main")
    return work, child.run(__file__, "main_cpu", work, timeout=300, workdir=str(work))


def test_main_on_the_cpu_prints_the_jax_scripts_lines(main_run):
    work, out = main_run
    lines = str(out["printed"]).splitlines()
    assert len(lines) == N_IMAGES + 2, lines
    assert TRACE.match(lines[0]), lines[0]
    rows = [LINE.match(line) for line in lines[1:-1]]
    assert all(rows) and [int(m.group(1)) for m in rows] == list(range(N_IMAGES)), lines
    mean = MEAN.match(lines[-1])
    assert mean and int(mean.group(1)) == N_IMAGES, lines[-1]
    # the means of the rounded per-image numbers, to their printed digits
    for col in (2, 3, 4):
        assert abs(float(mean.group(col)) - np.mean([float(m.group(col)) for m in rows])) <= (
            0.01 if col != 3 else 1e-4)
    assert out["saved_recon"].shape == out["saved_gt"].shape == (N_IMAGES, 256, 256)
    np.testing.assert_allclose(out["saved_psnr"], [float(m.group(2)) for m in rows], atol=0.006)
    assert out["saved_ssim"].shape == (N_IMAGES,)
    assert (work / "outputs" / "trace_psnr.npy").exists()


@pytest.mark.parametrize("params_dtype", ["bfloat16", "float32"])
def test_params_dtype_stores_the_jax_scripts_weights(main_run, params_dtype):
    """`bfloat16`: every leaf bf16, bitwise the JAX script's cast of its fp32
    tree (GroupNorm and final conv included); `float32`: the fp32 values
    wherever the layer computes in fp32, bf16 where it casts to bf16."""
    _, out = main_run
    tree = JF._load_params(str(out["ckpt"]), None, use_ema=True)
    flat = child.flatten(jax.tree_util.tree_map(np.asarray, tree))
    assert sorted(f"{params_dtype}/{k}" for k in flat) == sorted(
        k for k in out if k.startswith(f"{params_dtype}/"))
    for key, ref in flat.items():
        got, dtype = out[f"{params_dtype}/{key}"], str(out[f"dtype_{params_dtype}/{key}"])
        fp32_layer = key.split("/")[-2].startswith(("norm", "final_norm")) or key.startswith(
            "final_conv/")
        if params_dtype == "bfloat16" or not fp32_layer:
            want = np.asarray(jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32))
            assert dtype == "torch.bfloat16", key
        else:
            want = ref.astype(np.float32)
            assert dtype == "torch.float32", key
        np.testing.assert_array_equal(got, want, err_msg=key)
