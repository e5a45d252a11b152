"""The conv3x3 weight gradient of the port against `jax.vjp` of XLA's conv.

dW of a 3x3 stride-1 zero-pad-1 NHWC x HWIO conv is a GEMM of M = 9 Cin,
N = Cout, K = B H W pixels (`ops/conv3x3.py`).  On the CPU the port runs
`conv3x3_weight_grad_reference`; on the card `csrc/conv3x3_wgrad.cu`, whose
split of K and summation order `conv3x3_wgrad_tiled_reference` emulates.
Both are held to `jax.vjp` of `lax.conv_general_dilated` in the kernel
argument, at the stem (Cin 1), final (Cout 1), small-map and large-K
shapes, for each split a plan can take.  `wgrad_plan` itself is checked at
every conv of a flagship training step.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

# (x shape, Cout): the stem, the final conv, a small map with ragged
# 64-channel tiles (Cin 48, Cout 80), a large K (3 x 64 x 64 pixels)
SHAPES = [((2, 16, 16, 1), 32), ((2, 16, 16, 32), 1), ((2, 4, 6, 48), 80),
          ((3, 64, 64, 16), 16)]
# fp32 on both sides, the sums over K taken in another order: relative to
# max|dW| (K up to 12288 terms of magnitude ~1)
TOL = 2e-5


# ------------------------------------------------------------- torch halves
def weight_grads(x, g):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    out = {"reference": C.conv3x3_weight_grad_reference(xt, gt).numpy()}
    # through the autograd Function on the CPU
    wt = torch.zeros((3, 3, cin, cout), requires_grad=True)
    bias = torch.zeros((cout,), requires_grad=True)
    C.conv3x3(xt, wt, bias).backward(gt)
    out["autograd"] = wt.grad.numpy()
    # every variant that takes the shape, at one split, the default one and
    # the most the K steps allow (capped to keep the emulation quick)
    for variant in ("mma", "simt"):
        try:
            default = C.wgrad_plan(b, h, w, cin, cout, torch.bfloat16, variant)
        except ValueError:
            assert variant == "mma" and (cin % 16 or cout % 16)
            continue
        for s in sorted({1, default.splits, min(default.k_steps, 64)}):
            p = C.wgrad_plan(b, h, w, cin, cout, torch.bfloat16, variant, s)
            out[f"{variant}_{p.splits}"] = C.conv3x3_wgrad_tiled_reference(xt, gt, p).numpy()
    assert C.wgrad_launches == 0           # the CPU path launches nothing
    return out


def plans_on_the_flagship_training_step():
    """Every conv of a batch-3 and a batch-1 flagship forward: mma at the
    60 bf16 convs, simt at the stem and the final conv; each plan covers K
    exactly and sizes its workspace for its splits."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    shapes = []
    for b in (3, 1):
        for h, cin, cout, dt, n in _flagship_convs():
            shapes += [((b, h, h, cin), cout, dt)] * n
    counts = {}
    for (b, h, w, cin), cout, dt in shapes:
        p = C.wgrad_plan(b, h, w, cin, cout, dt)
        counts[b, p.variant] = counts.get((b, p.variant), 0) + 1
        k = b * h * w
        assert (p.k_steps - 1) * p.bk < k <= p.k_steps * p.bk
        assert (p.splits - 1) * p.steps_per_split < p.k_steps <= p.splits * p.steps_per_split
        assert p.workspace_bytes == (4 * p.splits * 9 * cin * cout if p.splits > 1 else 0)
        assert p.splits == 1 or p.tiles * (p.splits - 1) < C.WGRAD_BLOCKS
        assert p.splits == 1 or p.steps_per_split >= C.WGRAD_MIN_STEPS
    assert counts == {(3, "mma"): 60, (3, "simt"): 2, (1, "mma"): 60, (1, "simt"): 2}
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 8, 8, 48, 40, torch.bfloat16, "mma")     # Cout not a multiple of 16
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 8, 8, 64, 64, torch.float32, "mma")
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 2, 2, 64, 64, torch.bfloat16, "mma", splits=2)   # 1 K step
    return {}


def _flagship_convs():
    """(H, Cin, Cout, dtype, count) of the flagship UNet's 62 convs, traced
    on the meta device with the kernels' wrappers stubbed out."""
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    config = get_config("vesde")
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    seen = {}

    def conv(x, w, b, use_kernel=True):
        key = (x.shape[1], x.shape[-1], w.shape[-1], w.dtype)
        seen[key] = seen.get(key, 0) + 1
        return x.new_empty(x.shape[:3] + (w.shape[-1],))

    # the child process ends after the case, so the stubs need no undoing
    U.conv3x3 = conv
    U.attention = lambda q, k, v, use_kernel=True: torch.empty_like(q)
    cfg = U.create_model_config(config.model)
    with torch.device("meta"):
        model = U.UNetModel(cfg).to(cfg.torch_dtype)
        model(torch.empty(1, 256, 256, 1), torch.empty(1))
    assert sum(seen.values()) == 62
    return [(*key, n) for key, n in seen.items()]


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402


def _jax_weight_grad(x, g):
    cin, cout = x.shape[-1], g.shape[-1]

    def conv(k):
        return lax.conv_general_dilated(jnp.asarray(x), k, (1, 1), ((1, 1), (1, 1)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        precision=lax.Precision.HIGHEST)

    _, vjp = jax.vjp(conv, jnp.zeros((3, 3, cin, cout), jnp.float32))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("shape", SHAPES, ids=["stem", "final", "small_map", "large_k"])
def test_weight_grad_and_its_tiled_emulation_match_jax_vjp(tmp_path, shape):
    xshape, cout = shape
    rng = np.random.default_rng(sum(xshape) + cout)
    x = rng.normal(size=xshape).astype(np.float32)
    g = rng.normal(size=xshape[:3] + (cout,)).astype(np.float32)
    pending = child.start(__file__, "weight_grads", tmp_path, x=x, g=g)
    ref = _jax_weight_grad(x, g)
    out = pending.result()
    assert {"reference", "autograd"} < set(out) and any(k.startswith("simt_") for k in out)
    assert any(k.startswith("mma_") for k in out) == (xshape[-1] % 16 == 0 and cout % 16 == 0)
    scale = np.abs(ref).max()
    for name, dw in out.items():
        assert dw.shape == ref.shape, name
        assert np.abs(dw - ref).max() <= TOL * scale, (name, np.abs(dw - ref).max() / scale)


def test_wgrad_plan_on_the_flagship_training_step(tmp_path):
    child.run(__file__, "plans_on_the_flagship_training_step", tmp_path)
