"""The port's walnut protocol entry points (`scripts/_walnut_common.py`,
`walnut_full_scale.py`, `walnut_adapted.py`) against the JAX package.

The JAX scripts parse their command line when imported, so their calls are
composed here from the JAX package's functions, as the scripts make them;
`scripts/_walnut_common.py` imports numpy alone at its top and is loaded
from its file.

- the port's constants, `walnut_phantom` at n = 501 and 33 and the
  synthetic orbit equal the JAX module's bit for bit;
- at the miniature CWI spec of tests/test_torch_walnut.py (33³ volume, 24
  angles, sub-sampled 2x in angle and columns, a 64² model grid) with an
  off-centre slice (`slice_offset` 1: at the centre the rows above and
  below the slice tie in the mask probe), `build_walnut_trafo`'s ELL and
  dense operators (apply, adjoint, FDK), the observation of the phantom
  with JAX's noise injected, its FDK, PSNR, SSIM and SNR, within 1e-5 of
  max|JAX|;
- the DDS stage (`walnut_full_scale.dds_sweep`) on the dense operator:
  VESDE, and DDPM with time travel (2, 2), 3 steps, a narrow random UNet
  carried across from JAX's params, JAX's draws injected, within 1e-4 of
  max|JAX|;
- `walnut_adapted`'s sampler (DDPM, LoRA rank 4, `add_cg` off, CG(5) in the
  loss) at 2 x 2 against JAX's `get_standard_adapted_sampler` with the
  same `init_lora` draws (`lora_seed` 0), within 1e-4 as
  tests/test_torch_eval_adapted.py holds the adapted chain;
- each script's `main` on the CPU at that spec on tiny checkpoints written
  by the port's msgpack writer, printing the JAX script's lines.

Both sides compute in fp32.  The torch half runs in child interpreters
(tests/_torch_child.py): no pytest process runs torch code.
"""
import importlib.util
import os
import re

import numpy as np
import pytest

import _torch_child as child

SPEC = dict(projs_rows=32, projs_cols=48, max_num_angles=24, vol_sz=(33, 33, 33), vox_sz=1.0)
OFF_CFG = dict(num_slices=5, slice_offset=1, num_proj_rows=5, first_proj_row=13)
ORBIT = dict(sod=60.0, sdd=90.0, pix=0.9)          # tests/test_walnut.py::_mini_vecs
ASS = CSS = 2
IM, N_STEPS, RANK, N_OUTER, N_OPTIM = 64, 3, 4, 2, 2
# case: (sde, eta, travel_length, travel_repeat) of the DDS stage
DDS_CASES = {"vesde": ("vesde", 0.85, 1, 1), "ddpm_travel": ("ddpm", 0.15, 2, 2)}
REL = 1e-5       # operators, observation and FDK: max|port - JAX| / max|JAX|
# the chains' outputs before the clamp: fp32 through a UNet, CG and, for the
# adapted chain, Adam on the LoRA leaves (as tests/test_torch_eval_adapted.py)
TOL = 1e-4
TOL_PSNR_DB = 1e-2
TOL_SSIM = 1e-4


def _tiny(get_config, sde):
    c = get_config(sde)
    c.data.im_size = c.model.image_size = IM
    c.model.num_channels = 32
    c.model.channel_mult = "1,2,2"
    c.model.attention_resolutions = "16"
    c.model.num_head_channels = 16
    return c


def _rel(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return np.abs(out - ref).max() / np.abs(ref).max()


# ------------------------------------------------------------- torch halves
def _protocol():
    from diffusion_models_dev_project_tpu_torch.physics.walnut import WalnutDatasetSpec
    from diffusion_models_dev_project_tpu_torch.scripts._walnut_common import WalnutProtocol

    return WalnutProtocol(**ORBIT, ass=ASS, css=CSS, slice_cfg=OFF_CFG,
                          spec=WalnutDatasetSpec(**SPEC))


def constants(**_):
    from diffusion_models_dev_project_tpu_torch.scripts import _walnut_common as C

    out = {k: np.asarray(getattr(C, k)) for k in ("SOD", "SDD", "PIX", "ASS", "CSS")}
    out.update({f"slice_{k}": np.asarray(v) for k, v in C.SLICE_CFG.items()})
    out.update({f"phantom{n}": C.walnut_phantom(n) for n in (501, 33)})
    out["vecs_cwi"], out["vecs_mini"] = C.walnut_vecs(), C.walnut_vecs(_protocol())
    return out


def stages(root, x, y, noise, obs, **arrays):
    """The operator stage, the DDS stage and the adapted sampler on JAX's
    weights, observation and draws."""
    import contextlib
    import io

    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.sampling import engine
    from diffusion_models_dev_project_tpu_torch.scripts import walnut_adapted as WA
    from diffusion_models_dev_project_tpu_torch.scripts import walnut_full_scale as WF
    from diffusion_models_dev_project_tpu_torch.scripts._walnut_common import build_walnut_trafo
    from diffusion_models_dev_project_tpu_torch.utils.metrics import PSNR, SSIM

    cpu, protocol, out = torch.device("cpu"), _protocol(), {}
    os.makedirs(str(root), exist_ok=True)
    x_model = WF.model_ground_truth(protocol, IM, cpu)
    out["gt"] = x_model.numpy()
    rts = {}
    with torch.no_grad():
        for impl in ("ell", "dense"):
            rt = rts[impl] = build_walnut_trafo(str(root), impl=impl, new_shape=(IM, IM),
                                                device="cpu", protocol=protocol)
            out[f"{impl}_apply"] = rt.apply(torch.from_numpy(x)).numpy()
            out[f"{impl}_adjoint"] = rt.adjoint(torch.from_numpy(y)).numpy()
            out[f"{impl}_fbp_y"] = rt.fbp(torch.from_numpy(y)).numpy()
            o = WF.observe(x_model, rt, cpu, noise=torch.from_numpy(noise))
            fdk = rt.fbp(o)
            f = fdk[0, :, :, 0].numpy()
            y0 = rt.apply(x_model)
            out[f"{impl}_obs"], out[f"{impl}_fdk"] = o.numpy(), fdk.numpy()
            out[f"{impl}_metrics"] = np.array([PSNR(f, out["gt"][0, ..., 0]),
                                               SSIM(f, out["gt"][0, ..., 0]),
                                               float(y0.norm() / (o - y0).norm())])

    # the DDS stage, each chain's output before the clamp recorded
    raw, sample = [], engine.DiffusionSampler.sample

    def recorded(self, *a, **kw):
        res = sample(self, *a, **kw)
        raw.append(res[0][0, ..., 0].numpy().copy())
        return res

    engine.DiffusionSampler.sample = recorded
    obs = torch.from_numpy(obs)
    for case, (sde_name, eta, tl, tr) in DDS_CASES.items():
        c = _tiny(get_config, sde_name)
        sde = TF.get_standard_sde(c)
        model, _, _ = TF.get_standard_score(c, sde, load_model=False, device="cpu")
        model.load_state_dict(params_from_flax(child.unflatten(arrays, f"params_{sde_name}/")))
        args = WF.parser.parse_args(["--workdir", str(root), "--num_steps", str(N_STEPS),
                                     "--eta", str(eta), "--travel_length", str(tl),
                                     "--travel_repeat", str(tr)])
        printed = io.StringIO()
        raw.clear()
        with contextlib.redirect_stdout(printed):
            res = WF.dds_sweep(args, model, sde, rts["dense"], obs, out["gt"][0, ..., 0], 8.0,
                               cpu, noises=list(torch.from_numpy(arrays[f"chain_{case}"])))
        lines = printed.getvalue().splitlines()
        assert len(lines) == 2 and lines[0].startswith(f"[dds eta={eta} gamma=0.01 cg=5] ")
        assert lines[1].startswith("[sweep best] ")
        assert os.path.exists(os.path.join(str(root), "dds_recon_best.npz"))
        (run,) = res["runs"]
        out[f"{case}_raw"], out[f"{case}_recon"] = raw[0], run["recon"]
        out[f"{case}_metrics"] = np.array([run["psnr"], run["ssim"]])

    # walnut_adapted's sampler, its chain's output before the clamp
    c = _tiny(get_config, "ddpm")
    sde = TF.get_standard_sde(c)
    model, _, _ = TF.get_standard_score(c, sde, load_model=False, lora_rank=RANK, device="cpu")
    missing, unexpected = model.load_state_dict(
        params_from_flax(child.unflatten(arrays, "params_lora/")), strict=False)
    assert not unexpected and all("_lora." in k for k in missing)
    args = WA.parser.parse_args(["--ckpt", "unused", "--num_steps", str(N_OUTER),
                                 "--num_optim_step", str(N_OPTIM)])
    sampler = WA.adapted_sampler(args, model, sde, rts["dense"], obs, x_model)
    assert not sampler.adapt.add_cg and sampler.adapt.cg_iter == 5
    x, _ = sampler.sample(noises=list(torch.from_numpy(arrays["chain_adapted"])))
    out["adapted_raw"] = x[0, ..., 0].numpy()
    return out


def mains(workdir, **_):
    """Each script's `main` on the CPU at the miniature spec, on tiny 64²
    checkpoints (64 channels, random weights, fp16 storage) of a VESDE and
    a DDPM prior: the printed lines and the saved files."""
    import contextlib
    import io

    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import (flax_from_params,
                                                                       save_flax_msgpack)
    from diffusion_models_dev_project_tpu_torch.scripts import walnut_adapted as WA
    from diffusion_models_dev_project_tpu_torch.scripts import walnut_full_scale as WF

    workdir = str(workdir)
    rng = np.random.default_rng(31)
    ckpts = {}
    for sde_name in ("vesde", "ddpm"):
        c = get_config(sde_name)
        c.data.im_size = c.model.image_size = IM
        c.model.num_channels = 64
        _, state, _ = TF.get_standard_score(c, TF.get_standard_sde(c), load_model=False,
                                            device="cpu")
        state = {k: v + torch.from_numpy(rng.normal(0, 0.02, v.shape).astype(np.float32))
                 for k, v in state.items()}
        ckpts[sde_name] = save_flax_msgpack(flax_from_params(state, dtype=np.float16),
                                            os.path.join(workdir, f"{sde_name}.msgpack.npz"))
    work = os.path.join(workdir, "walnut_full")
    out = {}
    for name, fn, argv in (
            ("full_no_ckpt", WF.main, ["--workdir", work, "--platform", "cpu"]),
            ("full", WF.main, ["--workdir", work, "--device", "cpu", "--ckpt", ckpts["vesde"],
                               "--num_channels", "64", "--num_steps", "2", "--eta", "0.85,0.15"]),
            ("adapted", WA.main, ["--workdir", work, "--device", "cpu", "--ckpt", ckpts["ddpm"],
                                  "--num_channels", "64", "--num_steps", "2",
                                  "--num_optim_step", "1"])):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = fn(argv, protocol=_protocol(), size=IM)
        out[f"{name}_printed"] = np.array(printed.getvalue())
        if name != "adapted":
            out[f"{name}_fdk_psnr"] = np.array(res["dense_run"]["fdk_psnr"])
    for f in ("dds_recon_best.npz", "adapted_recon_eta0.85.npz"):
        with np.load(os.path.join(work, f)) as z:
            out.update({f"{f}/{k}": z[k] for k in z.files})
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.physics import walnut as JW  # noqa: E402
from diffusion_models_dev_project_tpu.physics.cone_beam import circular_cone_vecs  # noqa: E402
from diffusion_models_dev_project_tpu.physics.simulation import simulate  # noqa: E402
from diffusion_models_dev_project_tpu.utils.metrics import PSNR as JPSNR  # noqa: E402
from diffusion_models_dev_project_tpu.utils.metrics import SSIM as JSSIM  # noqa: E402

MINI_SPEC = JW.WalnutDatasetSpec(**SPEC)


@pytest.fixture(scope="module")
def jax_common():
    """The repository's `scripts/_walnut_common.py` as a module."""
    path = os.path.join(child.REPO, "scripts", "_walnut_common.py")
    spec = importlib.util.spec_from_file_location("jax_walnut_common", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _engine_draws(key, n_steps, shape):
    """The draws of a JAX chain's `sample(key)`: the prior's, then one per step."""
    key, init_key = jax.random.split(key)
    draws = [jax.random.normal(init_key, shape)]
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws.append(jax.random.normal(sub, shape, jnp.float32))
    return np.stack([np.asarray(d) for d in draws])


def _params(model_params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), model_params)


@pytest.fixture(scope="module")
def walnut_pair(tmp_path_factory, jax_common):
    """The JAX scripts' calls at the miniature spec, and the port's stages on
    the same inputs in a child started as soon as those exist."""
    root = tmp_path_factory.mktemp("walnut_scripts")
    (root / "jax").mkdir()
    vecs = circular_cone_vecs(SPEC["max_num_angles"], src_radius=ORBIT["sod"],
                              det_radius=ORBIT["sdd"] - ORBIT["sod"],
                              det_spacing=(ORBIT["pix"], ORBIT["pix"]))
    rts = {impl: JW.get_walnut_2d_ray_trafo(
        str(root / "jax"), walnut_id=1, orbit_id=2, angular_sub_sampling=ASS,
        proj_col_sub_sampling=CSS, new_shape=(IM, IM), vecs_all=vecs, impl=impl,
        single_slice_config=OFF_CFG, spec=MINI_SPEC) for impl in ("ell", "dense")}
    gt = jax_common.walnut_phantom(SPEC["vol_sz"][1])
    x_model = jax.image.resize(jnp.asarray(gt)[None, :, :, None], (1, IM, IM, 1),
                               method="nearest")
    key = jax.random.PRNGKey(3)
    obs = {impl: simulate(key, x_model, rt, 0.05) for impl, rt in rts.items()}
    rng = np.random.default_rng(0)
    inputs = dict(x=rng.random((2, IM, IM, 1)).astype(np.float32),
                  y=rng.normal(size=(2, *rts["dense"].obs_shape, 1)).astype(np.float32),
                  noise=np.asarray(jax.random.normal(key, obs["dense"].shape, obs["dense"].dtype)),
                  obs=np.asarray(obs["dense"]))
    # the DDS stage: one sampler per case, as the script builds it
    samplers, models, params = {}, {}, {}
    for sde_name in ("vesde", "ddpm"):
        jc = _tiny(jget, sde_name)
        models[sde_name], p, _ = JF.get_standard_score(jc, JF.get_standard_sde(jc),
                                                       load_model=False)
        params[sde_name] = _params(p, 33)
        inputs.update(child.flatten(params[sde_name], f"params_{sde_name}/"))
    for case, (sde_name, eta, tl, tr) in DDS_CASES.items():
        jc = _tiny(jget, sde_name)
        s = JF.get_standard_sampler(
            "dds", None, JF.get_standard_sde(jc), rts["dense"], obs["dense"], num_steps=N_STEPS,
            im_shape=(IM, IM, 1), gamma=0.01, eta=eta, cg_iter=5, travel_length=tl,
            travel_repeat=tr, cg_precision="highest",
            score_apply=lambda p, x, t, m=models[sde_name]: m.apply({"params": p}, x, t),
            score_params=params[sde_name])
        inputs[f"chain_{case}"] = _engine_draws(jax.random.PRNGKey(7), len(s._time_data[0]),
                                                (1, IM, IM, 1))
        samplers[case] = s
    # walnut_adapted's sampler: DDPM, LoRA from lora_seed 0, add_cg off
    jc = _tiny(jget, "ddpm")
    sde = JF.get_standard_sde(jc)
    lmodel, p, _ = JF.get_standard_score(jc, sde, load_model=False, lora_rank=RANK)
    lparams = _params(p, 43)
    inputs.update(child.flatten(lparams, "params_lora/"))
    ad = JF.get_standard_adapted_sampler(
        "dds", lmodel, lparams, sde, rts["dense"], obs["dense"], num_steps=N_OUTER, eta=0.85,
        gamma=0.01, tv_penalty=1e-6, lr=1e-3, num_optim_step=N_OPTIM, lora_rank=RANK,
        dc_type="cg", cg_iter=5, ground_truth=x_model, lora_seed=0)
    inputs["chain_adapted"] = _engine_draws(jax.random.PRNGKey(7), N_OUTER, (1, IM, IM, 1))
    pending = child.start(__file__, "stages", root, timeout=240, root=str(root / "torch"),
                          **inputs)
    refs = {"gt": np.asarray(x_model), "vecs": vecs}
    for impl, rt in rts.items():
        refs[f"{impl}_apply"] = np.asarray(rt.apply(jnp.asarray(inputs["x"])))
        refs[f"{impl}_adjoint"] = np.asarray(rt.adjoint(jnp.asarray(inputs["y"])))
        refs[f"{impl}_fbp_y"] = np.asarray(rt.fbp(jnp.asarray(inputs["y"])))
        fdk = rt.fbp(obs[impl])
        f, g = np.asarray(fdk[0, :, :, 0]), np.asarray(x_model[0, :, :, 0])
        y0 = rt.apply(x_model)
        refs[f"{impl}_obs"], refs[f"{impl}_fdk"] = np.asarray(obs[impl]), np.asarray(fdk)
        refs[f"{impl}_metrics"] = np.array([
            JPSNR(f, g), JSSIM(f, g),
            float(jnp.linalg.norm(y0) / jnp.linalg.norm(obs[impl] - y0))])
    g = np.asarray(x_model[0, :, :, 0])
    for case, s in samplers.items():
        x, _ = s.sample(jax.random.PRNGKey(7))
        refs[f"{case}_raw"] = np.asarray(x[0, ..., 0])
        recon = np.clip(refs[f"{case}_raw"], 0, 1)
        refs[f"{case}_recon"] = recon
        refs[f"{case}_metrics"] = np.array([JPSNR(recon, g), JSSIM(recon, g)])
    x, _ = ad.sample(jax.random.PRNGKey(7))
    refs["adapted_raw"] = np.asarray(x[0, ..., 0])
    return refs, pending.result()


def test_constants_phantom_and_orbit_equal_the_jax_scripts(jax_common, tmp_path):
    out = child.run(__file__, "constants", tmp_path)
    for k in ("SOD", "SDD", "PIX", "ASS", "CSS"):
        assert out[k] == getattr(jax_common, k), k
    assert {k: int(out[f"slice_{k}"]) for k in jax_common.SLICE_CFG} == jax_common.SLICE_CFG
    for n in (501, 33):
        np.testing.assert_array_equal(out[f"phantom{n}"], jax_common.walnut_phantom(n))
    np.testing.assert_array_equal(out["vecs_cwi"], circular_cone_vecs(
        1200, src_radius=jax_common.SOD, det_radius=jax_common.SDD - jax_common.SOD,
        det_spacing=(jax_common.PIX, jax_common.PIX)))
    np.testing.assert_array_equal(out["vecs_mini"], circular_cone_vecs(
        24, src_radius=60.0, det_radius=30.0, det_spacing=(0.9, 0.9)))


def test_operators_observation_and_fdk_match_jax(walnut_pair):
    refs, out = walnut_pair
    np.testing.assert_array_equal(out["gt"], refs["gt"])
    for impl in ("ell", "dense"):
        for k in ("apply", "adjoint", "fbp_y", "obs", "fdk"):
            assert _rel(out[f"{impl}_{k}"], refs[f"{impl}_{k}"]) <= REL, (impl, k)
        np.testing.assert_allclose(out[f"{impl}_metrics"], refs[f"{impl}_metrics"], rtol=REL,
                                   atol=0, err_msg=impl)


@pytest.mark.parametrize("case", list(DDS_CASES))
def test_dds_stage_matches_jax(walnut_pair, case):
    refs, out = walnut_pair
    ref, got = refs[f"{case}_raw"], out[f"{case}_raw"]
    assert got.shape == ref.shape == (IM, IM) and np.isfinite(got).all()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale, case
    assert np.abs(out[f"{case}_recon"] - refs[f"{case}_recon"]).max() <= TOL * scale, case
    (p, s), (p_ref, s_ref) = out[f"{case}_metrics"], refs[f"{case}_metrics"]
    assert abs(p - p_ref) <= TOL_PSNR_DB and abs(s - s_ref) <= TOL_SSIM, case


def test_adapted_sampler_matches_jax(walnut_pair):
    refs, out = walnut_pair
    ref, got = refs["adapted_raw"], out["adapted_raw"]
    assert got.shape == ref.shape == (IM, IM) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


# the JAX scripts' lines, in their order
FULL_LINES = [
    r"native C\+\+ assembly available: True",
    r"\[ell\] operator built in \d+\.\ds \(mask probe \+ single-pass assembly \+ \.mat save\)",
    r"      im_shape=\(33, 33\) obs_shape=\(1, 288\) model grid=\(64, 64\)",
    r"      matrix \(288, 1089\), nnz=\d+ \(\d+/row\), \.mat size \d+ MB",
    r"\[dense\] model-grid densify in \d+\.\ds \(\(288, 4096\), \d\.\d\d GB fp32\)",
    r"\[ell\] FDK: -?\d+\.\d\d dB / -?\d\.\d{4} SSIM   obs SNR \d+\.\d",
    r"\[dense\] FDK: -?\d+\.\d\d dB / -?\d\.\d{4} SSIM   obs SNR \d+\.\d",
    r"ell vs dense forward rel-diff: \d\.\d\de[-+]\d\d",
    r"\[ell\] apply \d+\.\d\d ms, adjoint \d+\.\d\d ms \(batch 1, wall time, mean of 20 calls\)",
    r"\[dense\] apply \d+\.\d\d ms, adjoint \d+\.\d\d ms \(batch 1, wall time, mean of 20 calls\)",
]
DDS_LINE = (r"\[dds eta={} gamma=0\.01 cg=5\] -?\d+\.\d\d dB / -?\d\.\d{{4}} SSIM in \d+\.\ds "
            r"\(2 steps\)  vs FDK -?\d+\.\d\d dB")
BEST = re.compile(r"^\[sweep best\] (-?\d+\.\d\d) dB at eta/gamma/cg = \((0\.\d+), 0\.01, 5\)$")
ADAPTED_LINES = [
    r"\[dense\] walnut operator ready in \d+\.\ds \(\(288, 4096\)\)",
    r"FDK baseline: -?\d+\.\d\d dB",
    r"\[adapted dds eta=0\.85\] walnut steered reconstruction: -?\d+\.\d\d dB / -?\d\.\d{4} SSIM "
    r"in \d+\.\ds \(2 steps x 1 optim, LoRA r=4\)  vs FDK -?\d+\.\d\d dB",
]


def _match(lines, patterns):
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        assert re.fullmatch(pat, line), (line, pat)


def test_mains_on_the_cpu_print_the_jax_scripts_lines(tmp_path):
    out = child.run(__file__, "mains", tmp_path, timeout=240, workdir=str(tmp_path))
    # without --ckpt: the operator stages alone, the .mat then loaded by the next run
    _match(str(out["full_no_ckpt_printed"]).splitlines(), FULL_LINES)
    lines = str(out["full_printed"]).splitlines()
    _match(lines[:10], FULL_LINES[:1] + [FULL_LINES[1].replace(
        r"mask probe \+ single-pass assembly \+ \.mat save", r"\.mat load")] + FULL_LINES[2:])
    _match(lines[10:12], [DDS_LINE.format(r"0\.85"), DDS_LINE.format(r"0\.15")])
    best = BEST.match(lines[12])
    assert best and len(lines) == 13, lines
    psnrs = [float(re.search(r"\] (-?\d+\.\d\d) dB", line).group(1)) for line in lines[10:12]]
    # the best run's PSNR, to the printed digits
    assert psnrs[(0.85, 0.15).index(float(best.group(2)))] == float(best.group(1)) == max(psnrs)
    assert float(out["full_fdk_psnr"]) == float(out["full_no_ckpt_fdk_psnr"])
    saved = {k.split("/", 1)[1]: v for k, v in out.items() if k.startswith("dds_recon_best")}
    assert sorted(saved) == ["cg_iter", "eta", "gamma", "gt", "psnr", "recon", "ssim"]
    assert saved["recon"].shape == saved["gt"].shape == (IM, IM)
    assert abs(float(saved["psnr"]) - float(best.group(1))) <= 0.005
    _match(str(out["adapted_printed"]).splitlines(), ADAPTED_LINES)
    saved = {k.split("/", 1)[1]: v for k, v in out.items() if k.startswith("adapted_recon")}
    assert sorted(saved) == ["eta", "gt", "lora_rank", "num_optim_step", "num_steps", "psnr",
                             "recon", "ssim"]
    assert saved["recon"].shape == (IM, IM) and np.isfinite(saved["recon"]).all()
    assert int(saved["num_steps"]) == 2 and int(saved["lora_rank"]) == RANK
