"""The conv3x3 weight gradient of the port against `jax.vjp` of XLA's conv.

dW of a 3x3 stride-1 zero-pad-1 NHWC x HWIO conv is a GEMM of M = 9 Cin,
N = Cout, K = B H W pixels (`ops/conv3x3.py`).  On the CPU the port runs
`conv3x3_weight_grad_reference`; on the card `csrc/conv3x3_wgrad_tc.cu`
(`tc`) and `csrc/conv3x3_wgrad.cu` (`mma`, `narrow_out`, `narrow_in`,
`simt`), whose split of K and summation order `conv3x3_wgrad_tiled_reference`
emulates.  Both are held to `jax.vjp` of `lax.conv_general_dilated` in the
kernel argument, at the stem (Cin 1), final (Cout 1), small-map, large-K,
`tc` column-tile (Cin 64 and 128), ragged-box and largest-split shapes, for
each split a plan can take.  `wgrad_plan` itself is checked at every conv
of a flagship training step, for one wave of the given SM count.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

# (x shape, Cout): the stem, the final conv, a small map with ragged
# 64-channel tiles (Cin 48, Cout 80), a large K (3 x 64 x 64 pixels), `tc`
# column tiles at Cin 64 and 128, W and H ragged against `tc`'s 16 x 8 box
# (12 x 20), a map whose 16 boxes `tc` can split one each, and a stem-like
# shape of more splits than the second kernel adds one after another
SHAPES = [((2, 16, 16, 1), 32), ((2, 16, 16, 32), 1), ((2, 4, 6, 48), 80),
          ((3, 64, 64, 16), 16), ((1, 16, 16, 64), 64), ((2, 16, 16, 128), 128),
          ((1, 12, 20, 64), 64), ((2, 32, 32, 64), 64), ((2, 256, 64, 1), 8)]
IDS = ["stem", "final", "small_map", "large_k", "tc_cin64", "tc_cin128", "ragged_box",
       "largest_split", "many_splits"]
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
    # every variant that takes the shape in bf16, at one split, the default
    # one and the most the K steps allow (capped to keep the emulation
    # quick); `tc` also without clusters; the narrow variants split one way
    # only
    for variant in C.WGRAD_VARIANTS:
        try:
            default = C.wgrad_plan(b, h, w, cin, cout, torch.bfloat16, variant)
        except ValueError:
            assert variant != "simt"
            continue
        if variant.startswith("narrow"):
            plans = [default]
        else:
            plans = [C.wgrad_plan(b, h, w, cin, cout, torch.bfloat16, variant, s)
                     for s in sorted({1, default.splits, min(default.k_steps, 64)})]
        if variant == "tc" and default.splits % 2 == 0:
            plans.append(C.wgrad_plan(b, h, w, cin, cout, torch.bfloat16, variant, default.splits,
                                      cluster=1))
        for p in plans:
            out[f"{variant}_{p.splits}_{p.cluster}"] = C.conv3x3_wgrad_tiled_reference(xt, gt, p).numpy()
    assert C.wgrad_launches == 0           # the CPU path launches nothing
    return out


def plans_on_the_flagship_training_step():
    """Every conv of a batch-3 and a batch-1 flagship forward: tc at the 60
    bf16 convs, narrow_in at the stem, narrow_out at the final conv; each
    plan covers K exactly, sizes its workspace for its partial sums, and a
    tc grid fits one wave of the SM count it was given."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    shapes = []
    for b in (3, 1):
        for h, cin, cout, dt, n in _flagship_convs():
            shapes += [((b, h, h, cin), cout, dt)] * n
    for sms in (C.SMS, 114, 78):
        counts = {}
        for (b, h, w, cin), cout, dt in shapes:
            p = C.wgrad_plan(b, h, w, cin, cout, dt, sms=sms)
            counts[b, p.variant] = counts.get((b, p.variant), 0) + 1
            ht, wt = p.box
            # the boxes tile the map, and the splits the boxes
            assert (-(-h // ht) - 1) * ht < h <= -(-h // ht) * ht
            assert (-(-w // wt) - 1) * wt < w <= -(-w // wt) * wt
            assert p.k_steps == b * -(-h // ht) * -(-w // wt) and p.bk == ht * wt
            assert 1 <= p.splits <= p.k_steps and p.splits % p.cluster == 0
            groups = p.splits // p.cluster
            assert p.workspace_bytes == (4 * groups * 9 * cin * cout if groups > 1 else 0)
            if p.variant == "tc":
                assert p.steps_per_split == -(-p.k_steps // p.splits)
                assert p.tiles == 3 * -(-cin // 128) * -(-cout // 128)
                assert p.tiles * p.splits <= max(sms, p.tiles)       # one wave, a block per SM
                assert p.cluster in (1, C.WGRAD_TC_CLUSTER)
            else:
                assert p.splits == p.k_steps and p.steps_per_split == 1 and p.cluster == 1
                assert p.tiles * p.splits <= C.NARROW_WGRAD_BLOCKS_PER_SM * sms or p.box[0] == 16
        assert counts == {(3, "tc"): 60, (3, "narrow_in"): 1, (3, "narrow_out"): 1,
                          (1, "tc"): 60, (1, "narrow_in"): 1, (1, "narrow_out"): 1}, (sms, counts)
    # the largest conv fills the card's one wave
    p = C.wgrad_plan(3, 256, 256, 128, 128, torch.bfloat16)
    assert p.tiles * p.splits > C.SMS * 7 // 8
    # the other variants by dtype and shape; mma's and simt's plans as before
    assert C.wgrad_plan(1, 8, 8, 48, 80, torch.bfloat16).variant == "mma"
    assert C.wgrad_plan(1, 8, 8, 64, 64, torch.float32).variant == "tf32x3"
    assert C.wgrad_plan(1, 8, 8, 48, 80, torch.float32).variant == "simt"
    assert C.wgrad_plan(1, 8, 8, 64, 3, torch.float32).variant == "narrow_out"
    assert C.wgrad_plan(1, 8, 8, 3, 64, torch.float32).variant == "narrow_in"
    p = C.wgrad_plan(3, 64, 64, 16, 16, torch.bfloat16)
    assert (p.variant, p.splits, p.steps_per_split) == ("mma", 24, 16)
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 8, 8, 48, 40, torch.bfloat16, "mma")     # Cout not a multiple of 16
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 8, 8, 64, 64, torch.float32, "mma")
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 8, 8, 48, 64, torch.bfloat16, "tc")      # Cin not a multiple of 64
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 2, 2, 64, 64, torch.bfloat16, "mma", splits=2)   # 1 K step
    with pytest.raises(ValueError):
        C.wgrad_plan(1, 8, 8, 64, 64, torch.bfloat16, "tc", splits=2)    # 1 K step (one box)
    with pytest.raises(ValueError):
        C.wgrad_plan(2, 16, 16, 64, 64, torch.bfloat16, "tc", splits=3, cluster=2)
    with pytest.raises(ValueError):
        C.wgrad_plan(2, 32, 32, 64, 64, torch.bfloat16, "tc", splits=4, cluster=4)
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


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
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
    assert any(k.startswith("tc_") for k in out) == (xshape[-1] % 64 == 0 and cout % 64 == 0)
    assert any(k.startswith("narrow_out_") for k in out) == (cout <= 16)
    assert any(k.startswith("narrow_in_") for k in out) == (xshape[-1] <= 16)
    scale = np.abs(ref).max()
    for name, dw in out.items():
        assert dw.shape == ref.shape, name
        assert np.abs(dw - ref).max() <= TOL * scale, (name, np.abs(dw - ref).max() / scale)


def test_wgrad_plan_on_the_flagship_training_step(tmp_path):
    child.run(__file__, "plans_on_the_flagship_training_step", tmp_path)
