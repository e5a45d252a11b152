"""conv3x3 with a bias per image, on the port's plain path.

The batched adapted sampler gives every image its own conv biases: a bias
of shape (B, Cout), row b added to image b's outputs.  On the CPU the port's
`conv3x3` runs `conv3x3_reference`, and its tiled twin emulates the `tc`
kernel's split of K; both are held to `jax.vmap` of the JAX package's
Pallas kernel `conv3x3_same` over (image, bias row), run in interpret mode
as tests/test_conv3x3.py runs it, within that file's rtol and atol of 2e-5.
The bias gradient (the autograd Function's per-image (H, W) sum) is held to
`jax.grad` of the vmapped XLA conv, the one the JAX package differentiates
(a Pallas call in interpret mode has no gradient), within 1e-5.  Last, the tiny UNet with
LoRA under `torch.func.functional_call` with every trainable leaf stacked
per image (the sampler's `sample_batched`) equals, row by row, each image's
forward with its own leaves, within 1e-5 of max|out| (fp32: a grouped conv
and batched einsums against plain convs and matmuls sum in another order).

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

SHAPES = [(3, 16, 16, 8, 16), (2, 8, 24, 16, 8)]
RTOL = ATOL = 2e-5
TOL_GRAD = 1e-5
TOL_UNET = 1e-5
N_IMAGES = 3


# ------------------------------------------------------------- torch halves
def conv_bias(x, w, bias, g):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    x, w, g = (torch.from_numpy(a) for a in (x, w, g))
    b = torch.from_numpy(bias).requires_grad_(True)
    out = C.conv3x3(x, w, b)
    (gb,) = torch.autograd.grad(out, (b,), g)
    return {"out": out.detach().numpy(), "grad_bias": gb.numpy()}


def tiled_bias(x, w, bias):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    bsz, h, wd, cin = x.shape
    p = C.plan(bsz, h, wd, cin, w.shape[-1], torch.bfloat16, splits=2)
    assert p.variant == "tc" and p.splits == 2
    return {"out": C.conv3x3_tiled_reference(*(torch.from_numpy(a) for a in (x, w, bias)),
                                             p).numpy()}


def stacked_unet(x, t):
    """Per image its own LoRA state and biases: the stacked forward and the
    single-image forwards."""
    import torch
    from torch.func import functional_call

    import diffusion_models_dev_project_tpu_torch.factory as TF
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U
    from diffusion_models_dev_project_tpu_torch.sampling.adaptation import split_adapt_params

    c = get_config("vesde")
    c.data.im_size = c.model.image_size = 32
    c.model.num_channels = 64
    c.model.channel_mult = "1,2"
    c.model.attention_resolutions = "8"
    c.model.num_head_channels = 8
    c.model.resblock_updown = False          # standalone down and up convs too
    model, _, _ = TF.get_standard_score(c, TF.get_standard_sde(c), load_model=False,
                                        lora_rank=2, device="cpu")
    assert any(isinstance(m, U.Sample) for m in model.modules())
    train, _ = split_adapt_params(model)
    gen = torch.Generator().manual_seed(5)
    stacked = {n: 0.05 * torch.randn((N_IMAGES, *p.shape), generator=gen)
               for n, p in train.items()}
    kinds = {n.split(".")[-1] for n in stacked}
    assert {"down", "up", "bias"} <= kinds
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        out = functional_call(model, stacked, (x, t))
        rows = [functional_call(model, {n: v[j] for n, v in stacked.items()},
                                (x[j:j + 1], t[j:j + 1]))[0] for j in range(N_IMAGES)]
    return {"stacked": out.numpy(), "rows": torch.stack(rows).numpy()}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from diffusion_models_dev_project_tpu.ops.conv3x3 import conv3x3_same  # noqa: E402


def _inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(b, cout)).astype(np.float32)
    g = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    return x, k, bias, g


def _vmapped(k):
    """The JAX kernel over (image, bias row)."""
    return jax.vmap(lambda xi, bi: conv3x3_same(xi[None], k, bi, tile_h=8)[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_per_image_bias_matches_vmapped_jax_kernel(tmp_path, shape):
    x, k, bias, g = _inputs(shape, 81)
    pending = child.start(__file__, "conv_bias", tmp_path, x=x, w=k, bias=bias, g=g)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_vmapped(jnp.asarray(k))(jnp.asarray(x), jnp.asarray(bias)))
    out = pending.result()
    assert out["out"].shape == ref.shape
    np.testing.assert_allclose(out["out"], ref, rtol=RTOL, atol=ATOL)
    # rows differ: each image took its own bias
    assert not np.allclose(out["out"][0] - out["out"][1], 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_per_image_bias_gradient_matches_jax(tmp_path, shape):
    x, k, bias, g = _inputs(shape, 82)
    pending = child.start(__file__, "conv_bias", tmp_path, x=x, w=k, bias=bias, g=g)

    def conv(xi, bi):
        return jax.lax.conv_general_dilated(xi[None], jnp.asarray(k), (1, 1), [(1, 1), (1, 1)],
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))[0] + bi

    def loss(b):
        return jnp.sum(jax.vmap(conv)(jnp.asarray(x), b) * jnp.asarray(g))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(bias)))
    out = pending.result()
    assert out["grad_bias"].shape == bias.shape == ref.shape
    assert np.abs(out["grad_bias"] - ref).max() <= TOL_GRAD * np.abs(ref).max()


def test_tiled_reference_with_per_image_bias_matches_jax(tmp_path):
    x, k, bias, _ = _inputs((2, 8, 8, 64, 64), 83)
    pending = child.start(__file__, "tiled_bias", tmp_path, x=x, w=k, bias=bias)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_vmapped(jnp.asarray(k))(jnp.asarray(x), jnp.asarray(bias)))
    np.testing.assert_allclose(pending.result()["out"], ref, rtol=RTOL, atol=ATOL)


def test_unet_with_stacked_leaves_equals_single_image_forwards(tmp_path):
    rng = np.random.default_rng(84)
    out = child.run(__file__, "stacked_unet", tmp_path,
                    x=rng.normal(size=(N_IMAGES, 32, 32, 1)).astype(np.float32),
                    t=np.array([0.2, 0.5, 0.8], np.float32))
    assert out["stacked"].shape == (N_IMAGES, 32, 32, 1) and np.isfinite(out["stacked"]).all()
    scale = np.abs(out["rows"]).max()
    assert np.abs(out["stacked"] - out["rows"]).max() <= TOL_UNET * scale
