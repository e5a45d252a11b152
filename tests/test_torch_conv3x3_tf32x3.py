"""The port's fp32 conv3x3 on the tensor cores (`tf32x3`): its routes and
its arithmetic.

- `plan` and `wgrad_plan` on every conv of the flagship UNet in fp32 (its
  default compute dtype): the 60 convs with Cin and Cout multiples of 64
  take `tf32x3` forward, in the input gradient and in the weight gradient;
  the stem (Cin 1) `simt` forward, `narrow` in its input gradient and
  `narrow_in` in its weight gradient; the final conv (Cout 1) `narrow`,
  `simt` and `narrow_out`.  A forced `tf32x3` on a shape or dtype it does
  not take raises.
- The kernels' CPU emulations, `conv3x3_tf32x3_reference` (forward; the
  input gradient is the same conv on the swapped weight) and
  `conv3x3_wgrad_tf32x3_reference`, which split each fp32 operand into TF32
  hi + lo and add hi*hi, hi*lo, lo*hi per 8-wide slice of K as the kernels
  do, against the JAX package's Pallas `conv3x3_same` in interpret mode at
  fp32 and `jax.vjp` of the XLA conv at `Precision.HIGHEST`: within 1e-5 of
  the largest value (max|diff| / max|JAX|) at ragged maps, batch 2, one
  split of K and several.  A single TF32 product (the lo terms dropped)
  misses that bound at the same shapes: the split is what keeps fp32.
- On the CPU the wrappers take the plain version whatever is forced, launch
  nothing and cache no split operand.

The torch half of each test runs in a child interpreter (tests/_torch_child.py).
"""
import numpy as np
import pytest

import _torch_child as child

# (B, H, W, Cin, Cout, forced splits of the forward and weight gradient,
# Pallas tile_h): batch 2 with the default (many) splits, a ragged H != W map
# with Cout 192 in one split, an uneven split of 5, a ragged map at batch 2
SHAPES = [(2, 8, 8, 64, 64, None, 8), (1, 12, 20, 128, 192, 1, 4),
          (1, 16, 8, 64, 128, 5, 8), (2, 6, 10, 64, 64, 3, 2)]
IDS = [f"{b}x{h}x{w}x{cin}-{cout}-s{s}" for b, h, w, cin, cout, s, _ in SHAPES]
TOL = 1e-5       # max|diff| / max|reference|: fp32 accuracy


# ------------------------------------------------------------- torch halves
def _fp32_flagship_convs():
    """(x shape, Cout) of each conv3x3 call of one forward of the flagship
    UNet in fp32 (the config's default compute dtype), traced on the meta
    device with the kernels' wrappers stubbed out."""
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    config = get_config("vesde")
    config.model.num_channels = 128
    assert config.model.dtype == "float32"
    seen = []

    def conv(x, w, b, use_kernel=True):
        assert x.dtype == w.dtype == torch.float32
        seen.append((tuple(x.shape), w.shape[-1]))
        return x.new_empty(x.shape[:3] + (w.shape[-1],))

    # the child process ends after the case, so the stubs need no undoing
    U.conv3x3 = conv
    U.attention = lambda q, k, v, use_kernel=True: torch.empty_like(q)
    cfg = U.create_model_config(config.model)
    with torch.device("meta"):
        model = U.UNetModel(cfg).to(cfg.torch_dtype)
        model(torch.empty(1, 256, 256, 1), torch.empty(1))
    return seen


def routes_on_the_flagship_fp32():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    fp32 = torch.float32
    shapes = _fp32_flagship_convs()
    assert len(shapes) == 62
    fwd, igrad, wgrad = {}, {}, {}
    for (b, h, w, cin), cout in shapes:
        p = C.plan(b, h, w, cin, cout, fp32)
        q = C.plan(b, h, w, cout, cin, fp32)          # the input gradient's swapped conv
        fwd[p.variant] = fwd.get(p.variant, 0) + 1
        igrad[q.variant] = igrad.get(q.variant, 0) + 1
        for batch in (3, 1):
            r = C.wgrad_plan(batch, h, w, cin, cout, fp32)
            wgrad[batch, r.variant] = wgrad.get((batch, r.variant), 0) + 1
            if r.variant == "tf32x3":
                assert (r.bm, r.bn, r.bk) == C.WGRAD_TF32X3_TILE
                assert r.tiles == 9 * -(-cin // 128) * -(-cout // 128)
                assert r.k_steps == -(-batch * h * w // 32)
                assert (r.splits - 1) * r.steps_per_split < r.k_steps <= r.splits * r.steps_per_split
                assert r.workspace_bytes == (4 * r.splits * 9 * cin * cout if r.splits > 1 else 0)
        for pl in (p, q):
            if pl.variant != "tf32x3":
                continue
            ht, wt = pl.box
            assert ht * wt == pl.bm and pl.bm in (64, 128) and h % ht == 0 and w % wt == 0
            assert pl.k_steps == 9 * (cin if pl is p else cout) // C.TF32_BK
            assert (pl.splits - 1) * pl.steps_per_split < pl.k_steps <= pl.splits * pl.steps_per_split
            n_out = cout if pl is p else cin
            assert pl.workspace_bytes == (4 * pl.splits * b * h * w * n_out if pl.splits > 1 else 0)
    assert fwd == {"tf32x3": 60, "narrow": 1, "simt": 1}, fwd
    assert igrad == {"tf32x3": 60, "narrow": 1, "simt": 1}, igrad     # stem narrow, final conv simt
    assert wgrad == {(3, "tf32x3"): 60, (3, "narrow_in"): 1, (3, "narrow_out"): 1,
                     (1, "tf32x3"): 60, (1, "narrow_in"): 1, (1, "narrow_out"): 1}, wgrad
    assert [xs[-1] for xs, cout in shapes if C.plan(*xs, cout, fp32).variant == "simt"] == [1]
    # bf16 keeps its routes; the largest fp32 weight gradient fills whole waves
    assert C.plan(1, 256, 256, 128, 128, torch.bfloat16).variant == "tc"
    assert C.wgrad_plan(3, 256, 256, 128, 128, torch.bfloat16).variant == "tc"
    r = C.wgrad_plan(3, 256, 256, 128, 128, fp32)
    slots = C.WGRAD_TF32X3_BLOCKS_PER_SM * C.SMS
    blocks = r.tiles * r.splits
    assert blocks > 0.9 * slots * -(-blocks // slots), r         # the last wave nine tenths full


def forced_tf32x3_raises():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    fp32, bf16 = torch.float32, torch.bfloat16
    for args in ((1, 8, 8, 48, 64, fp32), (1, 8, 8, 64, 80, fp32), (1, 8, 8, 64, 64, bf16),
                 (1, 8, 8, 1, 128, fp32), (1, 8, 8, 128, 1, fp32)):
        with pytest.raises(ValueError, match="tf32x3"):
            C.plan(*args, variant="tf32x3")
        with pytest.raises(ValueError, match="tf32x3"):
            C.wgrad_plan(*args, variant="tf32x3")
    with pytest.raises(ValueError):
        C.plan(1, 8, 8, 512, 512, fp32, variant="tf32x3", splits=200)    # 144 steps: empty splits
    with pytest.raises(ValueError):
        C.conv3x3_tf32x3_reference(torch.zeros(1, 8, 8, 64), torch.zeros(3, 3, 64, 64),
                                   torch.zeros(64), C.plan(1, 8, 8, 64, 64, fp32, "simt"))
    with pytest.raises(ValueError):
        C.conv3x3_wgrad_tf32x3_reference(torch.zeros(1, 8, 8, 64), torch.zeros(1, 8, 8, 64),
                                         C.wgrad_plan(1, 8, 8, 64, 64, fp32, "simt"))
    # the measurement override still takes simt at the tf32x3 shapes
    assert C.plan(1, 8, 8, 512, 512, fp32, variant="simt").variant == "simt"
    assert C.wgrad_plan(1, 8, 8, 512, 512, fp32, variant="simt").variant == "simt"
    return {}


def emulations(**arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    (b, h, w, cin, cout, splits, _), = [s for s in SHAPES if s[:5] == tuple(arrays["shape"])]
    x, k, bias, g = (torch.from_numpy(arrays[n]) for n in ("x", "k", "bias", "g"))
    fp32 = torch.float32
    out = {}
    # forward: the default plan, one split and the forced one
    for s in (None, 1, splits or 2):
        p = C.plan(b, h, w, cin, cout, fp32, splits=s)
        assert p.variant == "tf32x3"
        out[f"fwd_{p.splits}"] = C.conv3x3_tf32x3_reference(x, k, bias, p).numpy()
    # the input gradient: the same kernel's arithmetic on the swapped weight
    q = C.plan(b, h, w, cout, cin, fp32)
    out[f"igrad_{q.splits}"] = C.conv3x3_tf32x3_reference(
        g, C.swapped_weight(k), torch.zeros(cin), q).numpy()
    # the weight gradient: the default plan, one split and several
    for s in (None, 1, 3):
        r = C.wgrad_plan(b, h, w, cin, cout, fp32, splits=s)
        assert r.variant == "tf32x3"
        out[f"wgrad_{r.splits}"] = C.conv3x3_wgrad_tf32x3_reference(x, g, r).numpy()
    assert C.conv3x3_wgrad_tf32x3_reference(x, g).shape == (3, 3, cin, cout)
    # one TF32 product, the lo terms dropped
    hi = [C.tf32_split(t)[0] for t in (x, k, g)]
    out["one_fwd"] = C.conv3x3_reference(hi[0], hi[1], bias).numpy()
    out["one_wgrad"] = C.conv3x3_weight_grad_reference(hi[0], hi[2]).numpy()
    # the split itself: hi and lo TF32 values (low 13 bits 0), summing to x
    # within the bits cut from lo, each of them no larger than x
    xh, xl = C.tf32_split(x)
    for t in (xh, xl):
        assert not (t.view(torch.int32) & 0x1FFF).any()
        assert (t.abs() <= x.abs()).all()
    assert ((xh + xl - x).abs() <= 2.0 ** -20 * x.abs()).all()
    return out


def wrapper_on_cpu():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, 3, 64, 64)).astype(np.float32) * 0.1)
    g = torch.from_numpy(rng.normal(size=(1, 8, 8, 64)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    C.launches = C.backward_launches = C.wgrad_launches = 0
    C.launches_by_variant = dict.fromkeys(C.VARIANTS, 0)
    C.backward_launches_by_variant = dict.fromkeys(C.VARIANTS, 0)
    C.wgrad_launches_by_variant = dict.fromkeys(C.WGRAD_VARIANTS, 0)
    assert C.plan(1, 8, 8, 64, 64, torch.float32).variant == "tf32x3"
    for force in ({}, {"variant": "tf32x3", "splits": 3}, {"variant": "simt"}):
        out = C.conv3x3(x, k, bias, **force)
        torch.testing.assert_close(out, C.conv3x3_reference(x, k, bias), rtol=0, atol=0)
    torch.testing.assert_close(C.conv3x3_input_grad(g, k),
                               C.conv3x3_reference(g, C.swapped_weight(k), torch.zeros(64)),
                               rtol=0, atol=0)
    torch.testing.assert_close(C.conv3x3_weight_grad(x, g), C.conv3x3_weight_grad_reference(x, g),
                               rtol=0, atol=0)
    # through the autograd Function: every gradient on the plain path
    xr, kr, br = (t.clone().requires_grad_() for t in (x, k, bias))
    C.conv3x3(xr, kr, br).backward(g)
    assert C.launches == C.backward_launches == C.wgrad_launches == 0
    assert not any(v for d in (C.launches_by_variant, C.backward_launches_by_variant,
                               C.wgrad_launches_by_variant) for v in d.values())
    assert not any(hasattr(t, a) for t in (k, kr) for a in ("_conv3x3_tf32x3", "_conv3x3_tf32x3_flip"))
    return {}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from diffusion_models_dev_project_tpu.ops.conv3x3 import conv3x3_same  # noqa: E402


def _inputs(shape):
    b, h, w, cin, cout, _, _ = shape
    rng = np.random.default_rng(b * 1000 + h * 100 + w + cin + cout)
    return dict(x=rng.normal(size=(b, h, w, cin)).astype(np.float32),
                k=(rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32),
                bias=rng.normal(size=(cout,)).astype(np.float32),
                g=rng.normal(size=(b, h, w, cout)).astype(np.float32),
                shape=np.array(shape[:5]))


def _jax_results(shape, arrays):
    """The Pallas forward in interpret mode at fp32, and the input and
    weight gradients by `jax.vjp` of the XLA conv at HIGHEST."""
    tile_h = shape[6]
    x, k, bias, g = (jnp.asarray(arrays[n]) for n in ("x", "k", "bias", "g"))
    with pltpu.force_tpu_interpret_mode():
        fwd = np.asarray(conv3x3_same(x, k, bias, tile_h=tile_h))

    def conv(xx, kk):
        return lax.conv_general_dilated(xx, kk, (1, 1), ((1, 1), (1, 1)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        precision=lax.Precision.HIGHEST)

    _, vjp = jax.vjp(conv, x, k)
    gx, gk = vjp(g)
    return {"fwd": fwd, "igrad": np.asarray(gx), "wgrad": np.asarray(gk)}


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_plans_route_the_fp32_flagship_to_tf32x3(tmp_path):
    child.run(__file__, "routes_on_the_flagship_fp32", tmp_path)


def test_forced_tf32x3_on_a_shape_it_does_not_take_raises(tmp_path):
    child.run(__file__, "forced_tf32x3_raises", tmp_path)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_tf32x3_emulations_match_pallas_and_jax_vjp(tmp_path, shape):
    arrays = _inputs(shape)
    pending = child.start(__file__, "emulations", tmp_path, **arrays)
    ref = _jax_results(shape, arrays)
    out = pending.result()
    kinds = {name.split("_")[0] for name in out if not name.startswith("one")}
    assert kinds == {"fwd", "igrad", "wgrad"}
    for name, val in out.items():
        if name.startswith("one"):
            continue
        kind = name.split("_")[0]
        assert val.shape == ref[kind].shape, name
        assert _rel(val, ref[kind]) <= TOL, (name, _rel(val, ref[kind]))
    # several splits of K were emulated for each GEMM with more than one step
    assert len([n for n in out if n.startswith("fwd")]) >= 2
    assert len([n for n in out if n.startswith("wgrad")]) >= 2


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_a_single_tf32_product_misses_fp32_accuracy(tmp_path, shape):
    arrays = _inputs(shape)
    pending = child.start(__file__, "emulations", tmp_path, **arrays)
    ref = _jax_results(shape, arrays)
    out = pending.result()
    # the lo terms carry what fp32 keeps beyond TF32's 10 mantissa bits
    assert _rel(out["one_fwd"], ref["fwd"]) > TOL, _rel(out["one_fwd"], ref["fwd"])
    assert _rel(out["one_wgrad"], ref["wgrad"]) > TOL, _rel(out["one_wgrad"], ref["wgrad"])


def test_wrapper_on_cpu_takes_the_plain_version_and_caches_nothing(tmp_path):
    child.run(__file__, "wrapper_on_cpu", tmp_path)
