"""The port's UNet in the 512² configuration against the JAX UNet with its
Pallas flash attention.

The 512² config (`scripts/smoke_512.py`: `image_size` 512, channel_mult
(0.5, 1, 1, 2, 2, 4, 4) from the table of both packages) at 64 channels,
one res block per level, every leaf drawn with numpy in the shapes of
`UNetModel.init` and carried across, one image.  The JAX UNet runs with
`attention_impl="flash"`, so that each of its attention blocks calls the
Pallas kernel, in interpret mode as the JAX package's own tests run it
(`interpret=True`, tests/test_attention.py); the calls are counted.  Its
attention runs at the 16² level (`attention_resolutions` "16" names the
map size: 256 tokens, 4 heads of 64 at this width) and at the 8² middle.
Both sides compute in fp32.

The port's smoke entry point (`scripts/smoke_512.py`) also runs its CPU
recipe here, `--num_channels 64 --num_steps 2 --device cpu`: the bf16 UNet
at 512² through a 2-step DDS, its printed lines and `recon_512.npz`.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

IM, CHANNELS = 512, 64
# max|port - JAX| / max|JAX|: fp32 through 72 convs and 4 attention blocks,
# sums in another order
TOL = 1e-4


def _config(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = IM
    c.model.num_channels = CHANNELS
    c.model.attention_impl = "flash"
    return c


# ------------------------------------------------------------- torch halves
def unet_512(x, t, **arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    cfg = U.create_model_config(_config(get_config).model)
    assert cfg.channel_mult == (0.5, 1, 1, 2, 2, 4, 4) and cfg.num_res_blocks == 1
    model = U.UNetModel(cfg)
    model.load_state_dict(params_from_flax(child.unflatten(arrays)))
    seen = []
    attention = U.attention

    def counted(q, k, v, use_kernel=True):
        seen.append(tuple(q.shape))
        return attention(q, k, v, use_kernel=use_kernel)

    U.attention = counted
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t))
    return {"out": out.numpy(), "attn": np.array(seen),
            "count": np.array(U.count_params(model))}


def smoke_cpu(workdir, **_):
    """The smoke entry point's CPU recipe: what it prints and saves."""
    import contextlib
    import io
    import os

    from diffusion_models_dev_project_tpu_torch.scripts import smoke_512

    workdir = str(workdir)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ret = smoke_512.main(["--num_channels", "64", "--num_steps", "2", "--device", "cpu",
                              "--workdir", workdir])
    out = {"printed": np.array(printed.getvalue()), "ret_psnr": np.array(ret["psnr"])}
    with np.load(os.path.join(workdir, "recon_512.npz")) as f:
        out.update({f"saved_{k}": f[k] for k in f.files})
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402
from diffusion_models_dev_project_tpu.models import unet as JU  # noqa: E402
from diffusion_models_dev_project_tpu.ops import attention as JA  # noqa: E402


def test_unet_512_matches_jax_with_its_pallas_flash_attention(tmp_path, monkeypatch):
    cfg = JU.create_model_config(_config(jget).model)
    assert cfg.attention_impl == "flash"
    model = JU.UNetModel(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, IM, IM, 1)),
                            jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(51)

    def draw(path, leaf):
        if path[-1] == "kernel":        # variance 1/fan_in, as lecun_normal
            return rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape)
        return float(path[-1] == "scale") + rng.normal(0, 0.05, leaf.shape)

    params = traverse_util.unflatten_dict({
        p: draw(p, leaf).astype(np.float32)
        for p, leaf in traverse_util.flatten_dict(shapes).items()})
    x = rng.normal(size=(1, IM, IM, 1)).astype(np.float32)
    t = np.array([0.5], np.float32)
    pending = child.start(__file__, "unet_512", tmp_path, x=x, t=t, **child.flatten(params))
    calls = []
    flash = JA.flash_attention

    def counted(q, k, v):
        calls.append(tuple(q.shape))
        return flash(q, k, v, interpret=True)

    monkeypatch.setattr(JA, "flash_attention", counted)
    ref = np.asarray(jax.jit(lambda p, a, b: model.apply({"params": p}, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)))
    out = pending.result()
    # every attention block ran the Pallas kernel: 16² (3 blocks) and the 8² middle
    assert sorted(calls) == [(4, 64, 64)] + [(4, 256, 64)] * 3
    assert sorted(map(tuple, out["attn"])) == sorted(calls)
    assert int(out["count"]) == JU.count_params(params)
    assert out["out"].shape == ref.shape == (1, IM, IM, 1) and np.isfinite(out["out"]).all()
    assert np.abs(ref).max() > 0
    assert np.abs(out["out"] - ref).max() <= TOL * np.abs(ref).max()


def test_smoke_512_cpu_recipe_prints_and_saves_its_record(tmp_path):
    # two steps of bf16 512² UNets on two CPU threads: about 90 s alone
    out = child.run(__file__, "smoke_cpu", tmp_path, timeout=400, workdir=str(tmp_path))
    lines = str(out["printed"]).splitlines()
    assert lines[0].startswith("model channel_mult (0.5, 1, 1, 2, 2, 4, 4) x 64, bfloat16;")
    fbp = float(lines[1].split(":")[1].split()[0])
    assert lines[2].startswith("[512² dds untrained-prior gamma=10.0] ") and "(2 steps)" in lines[2]
    recon, gt = out["saved_recon"], out["saved_gt"]
    assert recon.shape == gt.shape == (IM, IM) and np.isfinite(recon).all()
    assert recon.min() >= 0 and recon.max() <= 1
    assert int(out["saved_num_steps"]) == 2
    assert float(out["saved_psnr"]) == float(out["ret_psnr"])
    # the FBP of test-fold phantom 0 at 60 angles and noise 0.01 (25.77 dB on the card)
    assert abs(float(out["saved_fbp_psnr"]) - fbp) < 0.01 and fbp > 20
