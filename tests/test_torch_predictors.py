"""The port's predictor steps, one step each, against the JAX package's.

Euler-Maruyama (unconditional, naive and DPS, on VESDE and VPSDE), the
ancestral DDPM step (with and without the data fit), the Langevin corrector
(with and without it), the unconditional DDIM step and `make_nloglik`, on
the same inputs with the same weights at the tiny size of
tests/test_torch_sampler.py.  Every draw the JAX step makes from its key is
recomputed with jax.random and injected into the port.  Both sides compute
in fp32; each output must lie within 1e-4 of max|JAX| (`TOL`), DPS's too,
whose gradient in x runs back through the UNet.

The torch half runs in one child interpreter for all cases
(tests/_torch_child.py): no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

TOL = 1e-4                  # max|port - JAX| / max|JAX|
STEP_SIZE, DATAFITSCALE, PENALTY, SNR, CORRECTOR_STEPS = 1e-3, 0.4, 3.0, 0.16, 2
T_SCORE, T_DDPM, T_DDPM_PREV = 0.45, 420, 380
CASES = ([f"em_{mode}_{kind}" for kind in ("vesde", "vpsde") for mode in ("none", "naive", "dps")]
         + ["ancestral_none", "ancestral_dps", "langevin_none", "langevin_naive",
            "ddim_vesde", "ddim_ddpm", "nloglik"])


def _tiny(get_config, sde):
    c = get_config(sde)
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.forward_op.num_angles = 20
    return c


def _times(kind):
    if kind == "ddpm":
        return np.array([T_DDPM], np.int32), np.array([T_DDPM_PREV], np.int32)
    return np.array([T_SCORE], np.float32), np.array([T_SCORE - STEP_SIZE], np.float32)


# ------------------------------------------------------------- torch half
def steps(x, y, **arrays):
    """Every case's step on the port, with the JAX weights and draws."""
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax
    from diffusion_models_dev_project_tpu_torch.sampling import predictors as tp

    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    weights = params_from_flax(child.unflatten(arrays, "params/"))
    parts = {}
    for kind in ("vesde", "vpsde", "ddpm"):
        c = _tiny(get_config, kind)
        sde = TF.get_standard_sde(c)
        model, _, score = TF.get_standard_score(c, sde, load_model=False, device="cpu")
        model.load_state_dict(weights)
        assert not any(p.requires_grad for p in model.parameters())
        trafo = TF.get_standard_ray_trafo(c, device="cpu")
        t, tp_ = (T(a) for a in _times(kind))
        parts[kind] = (sde, score, tp.make_nloglik(trafo, T(y)), t, tp_)
    x = T(x)
    out = {}
    with torch.no_grad():                 # as the engine calls them
        for kind in ("vesde", "vpsde"):
            sde, score, nll, t, _ = parts[kind]
            for mode in ("none", "naive", "dps"):
                out[f"em_{mode}_{kind}"] = torch.cat(tp.euler_maruyama_step(
                    score, sde, x, t, STEP_SIZE, T(arrays[f"noise_em_{mode}_{kind}"]),
                    nloglik=None if mode == "none" else nll, datafitscale=DATAFITSCALE,
                    penalty=PENALTY, aTweedy=mode == "dps"))
        sde, score, nll, t, t_prev = parts["ddpm"]
        for mode in ("none", "dps"):
            out[f"ancestral_{mode}"] = torch.cat(tp.ancestral_step(
                score, sde, x, t, T(arrays[f"noise_ancestral_{mode}"]),
                nloglik=None if mode == "none" else nll, penalty=PENALTY))
        out["ddim_ddpm"] = torch.cat(tp.wrapper_ddim_step(score, sde, x, t, t_prev,
                                                          T(arrays["noise_ddim_ddpm"])))
        sde, score, nll, t, t_prev = parts["vesde"]
        for mode in ("none", "naive"):
            out[f"langevin_{mode}"] = tp.langevin_corrector(
                score, sde, x, t, list(T(arrays[f"noise_langevin_{mode}"])),
                nloglik=None if mode == "none" else nll, datafitscale=DATAFITSCALE,
                penalty=PENALTY, snr=SNR)
        out["ddim_vesde"] = torch.cat(tp.wrapper_ddim_step(score, sde, x, t, t_prev,
                                                           T(arrays["noise_ddim_vesde"])))
    # the data fit and its gradient in x, outside any no_grad region
    xx = x.clone().requires_grad_(True)
    value = parts["vesde"][2](xx)
    (grad,) = torch.autograd.grad(value, xx)
    out["nloglik"] = torch.cat([value.detach().reshape(1), grad.reshape(-1)])
    return {k: v.numpy() for k, v in out.items()}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX half
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.sampling import predictors as jp  # noqa: E402


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX outputs, port outputs) of every case, on the same inputs."""
    jc = _tiny(jget, "vesde")
    jmodel, params, _ = JF.get_standard_score(jc, JF.get_standard_sde(jc), load_model=False)
    rng = np.random.default_rng(21)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    japply = jax.jit(lambda p, a, b: jmodel.apply({"params": p}, a, b))
    score = lambda a, b: japply(params, a, b)  # noqa: E731
    x = rng.normal(size=(1, 32, 32, 1)).astype(np.float32)
    trafo = JF.get_standard_ray_trafo(jc)
    y = rng.normal(size=(1, *trafo.obs_shape, 1)).astype(np.float32)
    nll = jp.make_nloglik(trafo, jnp.asarray(y))
    sdes = {kind: JF.get_standard_sde(_tiny(jget, kind)) for kind in ("vesde", "vpsde", "ddpm")}
    jx = jnp.asarray(x)
    noises, refs = {}, {}

    def key_of(case):
        key = jax.random.PRNGKey(CASES.index(case) + 30)
        noises[case] = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        return key

    for kind in ("vesde", "vpsde"):
        t = jnp.asarray(_times(kind)[0])
        for mode in ("none", "naive", "dps"):
            case = f"em_{mode}_{kind}"
            refs[case] = jnp.concatenate(jp.euler_maruyama_step(
                score, sdes[kind], jx, key_of(case), t, STEP_SIZE,
                nloglik=None if mode == "none" else nll,
                datafitscale=jnp.float32(DATAFITSCALE), penalty=PENALTY, aTweedy=mode == "dps"))
    t, t_prev = (jnp.asarray(a) for a in _times("ddpm"))
    for mode in ("none", "dps"):
        case = f"ancestral_{mode}"
        refs[case] = jnp.concatenate(jp.ancestral_step(
            score, sdes["ddpm"], jx, key_of(case), t,
            nloglik=None if mode == "none" else nll, penalty=PENALTY))
    refs["ddim_ddpm"] = jnp.concatenate(jp.wrapper_ddim_step(
        score, sdes["ddpm"], jx, key_of("ddim_ddpm"), t, t_prev))
    t, t_prev = (jnp.asarray(a) for a in _times("vesde"))
    refs["ddim_vesde"] = jnp.concatenate(jp.wrapper_ddim_step(
        score, sdes["vesde"], jx, key_of("ddim_vesde"), t, t_prev))
    for mode in ("none", "naive"):
        case = f"langevin_{mode}"
        key = jax.random.PRNGKey(CASES.index(case) + 30)
        refs[case] = jp.langevin_corrector(
            score, sdes["vesde"], jx, key, t, nloglik=None if mode == "none" else nll,
            datafitscale=jnp.float32(DATAFITSCALE), penalty=PENALTY,
            corrector_steps=CORRECTOR_STEPS, snr=SNR)
        draws = []                       # the corrector's own key splits
        for _ in range(CORRECTOR_STEPS):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(sub, x.shape, jnp.float32)))
        noises[case] = np.stack(draws)
    value, grad = jax.value_and_grad(nll)(jx)
    refs["nloglik"] = jnp.concatenate([value.reshape(1), grad.reshape(-1)])
    out = child.run(__file__, "steps", tmp_path_factory.mktemp("predictors"), x=x, y=y,
                    **{f"noise_{k}": v for k, v in noises.items()},
                    **child.flatten({"params": params}))
    return {k: np.asarray(v) for k, v in refs.items()}, out


@pytest.mark.parametrize("case", CASES)
def test_predictor_step_matches_jax(pair, case):
    refs, out = pair
    ref, got = refs[case], out[case]
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, f"{case}: {err:.3e} of max|JAX| (tol {TOL})"
