"""The port's adapted evaluation entry point (`scripts/eval_adapted_256.py`)
against the JAX package's script.

- `ood_bars` and `ood_grid` equal the JAX script's bit for bit (the script
  parses its command line on import: it is imported with `sys.argv` set),
  and `cases` lists the JAX script's cases in its order, with its indices;
- `sampling/adaptation.py::init_lora` draws JAX `init_lora`'s values for the
  same seed (its leaves in the JAX tree's sorted path order, each `down` in
  the flax layout), at the tiny size and on the flagship 256² structure;
- one OOD case (the bars phantom at 64², a narrow LoRA UNet, random weights
  carried across from JAX's params) through the port's `evaluate` at 2
  outer x 2 inner steps and 2 DDS steps, against the JAX script's calls
  composed here: its data from `fold_in(PRNGKey(seed), idx)`, plain DDS on
  the model without LoRA, the adapted chain with a fresh LoRA drawn from
  `lora_seed = idx`, both chains from `fold_in(key, 1)`, whose draws are
  injected into the port.  Both sides compute in fp32.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

import _torch_child as child

IM, RANK, N_STEPS, N_OPTIM, DDS_STEPS, SEED, IDX = 64, 4, 2, 2, 2, 1, 100
# max|port - JAX| / max|JAX| of each chain's output before the clamp: fp32
# through a UNet, CG and, for the adapted chain, Adam on the LoRA leaves
# (as tests/test_torch_adaptation.py holds the chain)
TOL = 1e-4
TOL_PSNR_DB = 1e-2


def _tiny(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = IM
    c.model.num_channels = 32
    c.model.channel_mult = "1,2,2"
    c.model.attention_resolutions = "16"
    c.model.num_head_channels = 16
    return c


# ------------------------------------------------------------- torch halves
def ood_case(gt, obs_noise, dds_noises, ad_noises, **arrays):
    """The bars case through the port's `evaluate`, with the JAX weights and
    draws; the outputs before and after the clamp, and the row's PSNRs."""
    import argparse
    import contextlib
    import io

    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.sampling import adaptation, engine
    from diffusion_models_dev_project_tpu_torch.scripts import eval_adapted_256 as EA

    raw = {}
    for name, cls in (("dds", engine.DiffusionSampler), ("adapted", adaptation.AdaptedSampler)):
        def recorded(self, *a, _sample=cls.sample, _name=name, **kw):
            res = _sample(self, *a, **kw)
            raw[_name] = res[0][0, ..., 0].numpy().copy()
            return res
        cls.sample = recorded
    c = _tiny(get_config)
    sde = TF.get_standard_sde(c)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, lora_rank=RANK, device="cpu")
    missing, unexpected = model.load_state_dict(params_from_flax(child.unflatten(arrays)),
                                                strict=False)
    assert not unexpected and all("_lora." in k for k in missing)
    trafo = TF.get_standard_ray_trafo(c, device="cpu")
    args = argparse.Namespace(adaptation="lora", num_steps=N_STEPS, num_optim_step=N_OPTIM,
                              lora_rank=RANK, lr=1e-3, tv_penalty=1e-6, eta=0.85,
                              dds_steps=DDS_STEPS, dds_eta=0.85)

    def draws(idx):
        assert idx == IDX
        return (torch.from_numpy(obs_noise), list(torch.from_numpy(dds_noises)),
                list(torch.from_numpy(ad_noises)))

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rows = EA.evaluate(args, sde, model, trafo, [("OOD bars", gt, IDX)], c.seed,
                           c.data.stddev, torch.device("cpu"), draws=draws)
    line = printed.getvalue().strip()
    assert line.startswith("[OOD bars] FBP ") and f"DDS({DDS_STEPS}, eta=0.85)" in line, line
    assert "adapted(lora)" in line and len(rows) == 1
    row = rows[0]
    return {"raw_dds": raw["dds"], "raw_adapted": raw["adapted"], "x_dds": row["x_dds"],
            "x_adapted": row["x_adapted"],
            "psnr": np.array([row["fbp"], row["dds"], row["adapted"]])}


def lora_draws(seed, **_):
    """`init_lora` of the tiny LoRA UNet and of the flagship structure at 32
    channels, under the port's names."""
    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import init_lora

    out = {}
    for size, c in (("tiny", _tiny(get_config)), ("flagship", get_config("vesde"))):
        c.model.num_channels = 32
        model, _, _ = TF.get_standard_score(c, TF.get_standard_sde(c), load_model=False,
                                            lora_rank=RANK, device="cpu")
        out.update({f"{size}/{k}": v.numpy() for k, v in init_lora(model, int(seed)).items()})
    return out


def case_list(images):
    """The port's `cases` at 256² over a stand-in val set."""
    from diffusion_models_dev_project_tpu_torch.scripts import eval_adapted_256 as EA

    got = EA.cases(list(images), 2, 3)
    out = {"names": np.array([n for n, _, _ in got]), "idx": np.array([i for _, _, i in got])}
    out.update({f"gt{k}": g for k, (_, g, _) in enumerate(got)})
    out.update({f"bars{im}": EA.ood_bars(im) for im in (64, 256, 100)})
    out.update({f"grid{im}_{s}": EA.ood_grid(im, s) for im in (64, 256) for s in (17, 18, 5)})
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.utils.metrics import PSNR as JPSNR  # noqa: E402


@pytest.fixture(scope="module")
def jax_script():
    """The JAX package's `scripts/eval_adapted_256.py` as a module."""
    path = os.path.join(child.REPO, "scripts", "eval_adapted_256.py")
    spec = importlib.util.spec_from_file_location("jax_eval_adapted_256", path)
    module = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = ["x", "--ckpt", "x"]
    try:
        spec.loader.exec_module(module)
    finally:
        sys.argv = argv
    return module


def test_phantoms_and_cases_equal_the_jax_scripts(jax_script, tmp_path):
    images = np.random.default_rng(41).random((3, 256, 256, 1)).astype(np.float32)
    out = child.run(__file__, "case_list", tmp_path, images=images)
    for im in (64, 256, 100):
        np.testing.assert_array_equal(out[f"bars{im}"], jax_script.ood_bars(im))
    for im in (64, 256):
        for s in (17, 18, 5):
            np.testing.assert_array_equal(out[f"grid{im}_{s}"], jax_script.ood_grid(im, s))
    # the JAX script's cases for --num_in_dist 2 --num_ood 3
    want = ([(f"in-dist val[{i}]", images[i], i) for i in range(2)]
            + [("OOD bars", jax_script.ood_bars(256)[..., None], 100)]
            + [(f"OOD blocks[{k}]", jax_script.ood_grid(256, 17 + k)[..., None], 101 + k)
               for k in range(2)])
    assert out["names"].tolist() == [n for n, _, _ in want]
    assert out["idx"].tolist() == [i for _, _, i in want]
    for k, (_, g, _) in enumerate(want):
        np.testing.assert_array_equal(out[f"gt{k}"], g)


def test_init_lora_draws_the_jax_values(tmp_path):
    from flax import traverse_util

    from diffusion_models_dev_project_tpu.models import unet as JU
    from diffusion_models_dev_project_tpu.sampling.adaptation import init_lora as jinit

    pending = child.start(__file__, "lora_draws", tmp_path, seed=IDX)
    want = {}
    for size, c in (("tiny", _tiny(jget)), ("flagship", jget("vesde"))):
        c.model.num_channels = 32
        cfg = dataclasses.replace(JU.create_model_config(c.model), lora_rank=RANK)
        for path, leaf in traverse_util.flatten_dict(jinit(JU.UNetModel(cfg), cfg,
                                                           seed=IDX)).items():
            a = np.asarray(leaf)        # the converters' layouts: 1x1 and dense leaves transposed
            if a.ndim == 4 and a.shape[:2] == (1, 1):
                a = a.reshape(a.shape[2:]).T
            elif a.ndim == 2:
                a = a.T
            want[f"{size}/" + ".".join(path)] = a
    out = pending.result()
    assert sorted(out) == sorted(want)
    assert sum(k.startswith("flagship/in_10_0.") for k in want)      # past in_9: sorted as text
    for k, a in want.items():
        np.testing.assert_array_equal(out[k], a, err_msg=k)


def test_adapted_ood_case_matches_the_jax_scripts_calls(jax_script, tmp_path):
    """The bars case at 2 x 2 (DDS 2 steps), LoRA from lora_seed = idx."""
    jc = _tiny(jget)
    sde = JF.get_standard_sde(jc)
    model, params, _ = JF.get_standard_score(jc, sde, load_model=False, lora_rank=RANK)
    rng = np.random.default_rng(43)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    plain = type(model)(dataclasses.replace(model.cfg, lora_rank=0))
    trafo = JF.get_standard_ray_trafo(jc)
    gt = jax_script.ood_bars(IM)[..., None]
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), IDX)
    jgt, obs, fbp = JF.get_data_from_ground_truth(jnp.asarray(gt)[None], trafo, 0.01, key)
    chain_key = jax.random.fold_in(key, 1)

    def engine_draws(n):
        k, init_key = jax.random.split(chain_key)
        d = [jax.random.normal(init_key, (1, IM, IM, 1))]
        for _ in range(n):
            k, sub = jax.random.split(k)
            d.append(jax.random.normal(sub, (1, IM, IM, 1), jnp.float32))
        return np.stack([np.asarray(a) for a in d])

    pending = child.start(__file__, "ood_case", tmp_path, gt=gt,
                          obs_noise=np.asarray(jax.random.normal(key, obs.shape, obs.dtype)),
                          dds_noises=engine_draws(DDS_STEPS), ad_noises=engine_draws(N_STEPS),
                          **child.flatten(params))
    dds = JF.get_standard_sampler(
        "dds", None, sde, trafo, obs, num_steps=DDS_STEPS, im_shape=(IM, IM, 1), gamma=0.01,
        eta=0.85, cg_iter=5, score_apply=lambda p, x, t: plain.apply({"params": p}, x, t),
        score_params=params, cg_precision="highest")
    x_dds, _ = dds.sample(chain_key)
    ad = JF.get_standard_adapted_sampler(
        "dds", model, params, sde, trafo, obs, num_steps=N_STEPS, im_shape=(IM, IM, 1),
        num_optim_step=N_OPTIM, adapt_freq=1, lr=1e-3, tv_penalty=1e-6, eta=0.85, gamma=0.01,
        dc_type="cg", cg_iter=1, add_cg=True, adaptation="lora", lora_seed=IDX)
    x_ad, _ = ad.sample(chain_key)
    out = pending.result()
    g = np.asarray(jgt[0, ..., 0])
    for name, ref in (("dds", x_dds), ("adapted", x_ad)):
        ref = np.asarray(ref[0, ..., 0])
        got = out[f"raw_{name}"]
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), name
        assert np.abs(out[f"x_{name}"] - np.clip(ref, 0, 1)).max() <= TOL * np.abs(ref).max()
    want = [JPSNR(np.asarray(fbp[0, ..., 0]), g)] + [
        JPSNR(np.clip(np.asarray(x[0, ..., 0]), 0, 1), g) for x in (x_dds, x_ad)]
    np.testing.assert_allclose(out["psnr"], want, rtol=0, atol=TOL_PSNR_DB)
