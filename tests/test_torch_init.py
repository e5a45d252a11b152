"""A fresh port UNet is initialised by the JAX package's rule.

The JAX UNet zero-initialises every ResBlock's `conv2`, the attention
`proj` and the `final_conv` (kernel and bias), so a fresh model outputs
exactly zero; every other conv and dense kernel draws flax's truncated
`lecun_normal` (variance 1/fan_in), every bias is zero.  The values differ
between the two packages (weights cross over through `models/convert.py`);
the rule must match.  Both fresh models come from `get_standard_score(
load_model=False)` at a small two-level config with attention and 1x1
skips.

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

# a kernel's empirical std against sqrt(1 / fan_in): the smallest kernel
# here (the stem, 9 x 32 values) has a sampling spread of about 3.4% for a
# normal truncated at 2 sigma, so 10% is about three of its spreads; a wrong
# scale (a plain normal's 1/0.88, or 1/fan_out) misses by 14% or more
TOL_STD = 0.10


def _small(get_config):
    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 32
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "16"      # downsample rate 2: the second level
    c.model.num_head_channels = 32
    return c


def _fan_in(shape):
    """fan_in of a kernel in the JAX layout: 3x3 (3, 3, I, O) -> 9 I, a 1x1
    conv (1, 1, I, O) -> I, a dense (I, O) -> I."""
    return int(np.prod(shape[:-1]))


# ------------------------------------------------------------- torch halves
def fresh_port_model(x, t):
    import torch

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models.convert import flax_from_params

    c = _small(get_config)
    model, _, _ = TF.get_standard_score(c, TF.get_standard_sde(c), load_model=False, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    # the parameters in the JAX layout and names, for a like-for-like check
    tree = flax_from_params(dict(model.named_parameters()))
    return {"out": out, **child.flatten(tree, "params/")}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

import diffusion_models_dev_project_tpu.factory as JF  # noqa: E402
from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget  # noqa: E402


@pytest.fixture(scope="module")
def fresh_pair(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    pending = child.start(__file__, "fresh_port_model", tmp_path_factory.mktemp("init"), x=x, t=t)
    jc = _small(jget)
    jmodel, params, _ = JF.get_standard_score(jc, JF.get_standard_sde(jc), load_model=False)
    jout = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    out = pending.result()
    port = {k[len("params/"):]: v for k, v in out.items() if k.startswith("params/")}
    jax_leaves = {"/".join(p): np.asarray(v) for p, v in traverse_util.flatten_dict(params).items()}
    return dict(jout=jout, out=out["out"], port=port, jax=jax_leaves)


def test_fresh_models_output_exactly_zero(fresh_pair):
    fp = fresh_pair
    assert fp["jout"].shape == fp["out"].shape == (2, 32, 32, 1)
    assert not np.any(fp["jout"]) and not np.any(fp["out"])


def test_the_same_parameters_start_at_zero(fresh_pair):
    fp = fresh_pair
    assert sorted(fp["port"]) == sorted(fp["jax"])
    for name in fp["jax"]:
        assert fp["port"][name].shape == fp["jax"][name].shape, name
    zero = {side: sorted(n for n, v in fp[side].items() if not np.any(v)) for side in ("port", "jax")}
    assert zero["port"] == zero["jax"]
    # the zero set is every bias and the three zero-initialised kernels
    kernels = [n for n in zero["jax"] if n.endswith("/kernel")]
    assert kernels and all(n.split("/")[-2] in ("conv2", "proj", "final_conv") for n in kernels)
    assert all(n in zero["jax"] for n in fp["jax"] if n.endswith("/bias"))


def test_nonzero_kernels_are_lecun_normal(fresh_pair):
    fp = fresh_pair
    checked = 0
    for side in ("port", "jax"):
        for name, v in fp[side].items():
            if not name.endswith("/kernel") or not np.any(v):
                continue
            want = np.sqrt(1.0 / _fan_in(v.shape))
            assert abs(v.std() / want - 1) <= TOL_STD, (side, name, v.std(), want)
            # truncated at two standard deviations of the untruncated normal
            assert np.abs(v).max() <= 2 * want / 0.87962566103423978 + 1e-6, (side, name)
            checked += 1
    assert checked >= 20
