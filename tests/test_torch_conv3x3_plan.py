"""The port's conv3x3 plan (variant, tiling, split of K) and its CPU emulation.

`plan` is what the wrapper hands the CUDA kernels, so it is checked here on
every conv shape of the flagship UNet, and of the 512² configuration's
(channel_mult (0.5, 1, 1, 2, 2, 4, 4)) at 128 and at 64 channels.  `conv3x3_tiled_reference` carries
out a `tc` plan step by step in PyTorch (zero-filled boxes, fp32 partials
per split, then the reduction); it is held against the port's plain version
and the JAX package's Pallas kernel, run as the JAX package's own tests run
it (`force_tpu_interpret_mode`), on inputs from numpy with a fixed seed.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

# (B, H, W, Cin, Cout, forced splits, Pallas tile_h): batch 2 with the
# largest split, H != W with ragged boxes and Cout = 192 (half a channel
# tile over), an uneven split, Cin = 64 and 128; every image's boxes run off
# all four sides at the border taps
EMULATED = [(2, 8, 8, 64, 64, None, 8), (1, 12, 20, 128, 192, None, 4),
            (1, 16, 8, 64, 128, 3, 8), (1, 8, 24, 128, 64, 1, 8)]


# ------------------------------------------------------------- torch halves
def _flagship_conv_shapes(image_size=256, channels=128):
    """(x shape, Cout, dtype) of each conv3x3 call of one forward of the
    flagship's bf16 UNet (or the config's at another size and width), traced
    on the meta device with the kernels' wrappers stubbed out."""
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    config = get_config("vesde")
    config.model.image_size = image_size
    config.model.num_channels = channels
    config.model.dtype = "bfloat16"
    seen = []

    def conv(x, w, b, use_kernel=True):
        seen.append((tuple(x.shape), w.shape[-1], w.dtype))
        return x.new_empty(x.shape[:3] + (w.shape[-1],))

    # the child process ends after the case, so the stubs need no undoing
    U.conv3x3 = conv
    U.attention = lambda q, k, v, use_kernel=True: torch.empty_like(q)
    cfg = U.create_model_config(config.model)
    with torch.device("meta"):
        model = U.UNetModel(cfg).to(cfg.torch_dtype)
        model(torch.empty(1, image_size, image_size, 1), torch.empty(1))
    return seen


def _check_tc_plans(shapes, plans):
    """The `tc` tiling invariants of each `tc` plan of `shapes`."""
    for ((b, h, w, cin), cout, dt), p in zip(shapes, plans):
        if p.variant != "tc":
            continue
        ht, wt = p.box
        assert ht * wt == p.bm and p.bm in (64, 128) and wt <= 256 and ht <= 256
        assert h % ht == 0 and w % wt == 0            # the boxes tile the image exactly
        assert p.tiles == b * (h // ht) * (w // wt) * (-(-cout // p.bn))
        assert p.k_steps == 9 * cin // 64
        # every split has at least one K step, and together they take them all
        assert (p.splits - 1) * p.steps_per_split < p.k_steps <= p.splits * p.steps_per_split
        assert p.tiles * p.splits >= 100 or p.splits == p.k_steps, (h, cin, cout, p)
        assert p.workspace_bytes == (4 * p.splits * b * h * w * cout if p.splits > 1 else 0)


def plan_on_every_flagship_conv():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    shapes = _flagship_conv_shapes()
    assert len(shapes) == 62
    plans = [C.plan(*xs, cout, dt) for xs, cout, dt in shapes]
    by_variant = {v: sum(p.variant == v for p in plans) for v in C.VARIANTS}
    assert by_variant == {"tc": 60, "narrow": 1, "simt": 1}
    assert [xs[-1] for (xs, _, _), p in zip(shapes, plans) if p.variant == "simt"] == [1]
    _check_tc_plans(shapes, plans)
    # forced choices that cannot run raise; the measurement override takes simt anywhere
    with pytest.raises(ValueError):
        C.plan(1, 8, 8, 512, 512, torch.float32, variant="tc")
    with pytest.raises(ValueError):
        C.plan(1, 8, 8, 512, 512, torch.bfloat16, splits=100)   # 72 steps: an empty split
    with pytest.raises(ValueError):
        C.plan(1, 8, 8, 512, 512, torch.bfloat16, variant="narrow")
    assert C.plan(1, 8, 8, 512, 512, torch.bfloat16, variant="simt").variant == "simt"
    assert C.plan(1, 8, 8, 1024, 512, torch.bfloat16, splits=144).steps_per_split == 1


def plan_on_every_512_conv():
    """The 512² configuration: at 128 channels a 64-channel 512² level, on
    `tc` like every conv but the stem (Cin 1: `simt`) and the final conv
    (Cout 1: `narrow`); at 64 channels its 32-channel convs go to `simt`."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    for channels in (128, 64):
        shapes = _flagship_conv_shapes(512, channels)
        plans = [C.plan(*xs, cout, dt) for xs, cout, dt in shapes]
        by_variant = {v: sum(p.variant == v for p in plans) for v in C.VARIANTS}
        off_tc = [(xs[-1], cout) for (xs, cout, _), p in zip(shapes, plans) if p.variant != "tc"]
        assert len(shapes) == 72 and by_variant["narrow"] == 1
        assert all(dt == torch.bfloat16 for _, _, dt in shapes[:-1])
        assert shapes[-1][1:] == (1, torch.float32)                  # the final conv
        assert {xs[1] for xs, _, _ in shapes} == {512, 256, 128, 64, 32, 16, 8}
        # off tc exactly where Cin or Cout is no multiple of 64
        assert off_tc == [(xs[-1], cout) for xs, cout, _ in shapes
                          if xs[-1] % 64 or cout % 64]
        if channels == 128:
            assert by_variant == {"tc": 70, "narrow": 1, "simt": 1}
            assert off_tc == [(1, 64), (64, 1)]
        else:
            assert by_variant == {"tc": 60, "narrow": 1, "simt": 11}
        _check_tc_plans(shapes, plans)
        # the 512² map at 64 channels: full 128-pixel tiles, one split
        p = C.plan(1, 512, 512, 64, 64, torch.bfloat16)
        assert p.variant == "tc" and p.bm == 128 and p.splits == 1 and p.tiles == 2048


def tiled_emulation(**arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    out = {}
    for i, (b, h, w, cin, cout, splits, _) in enumerate(EMULATED):
        xt, kt, bt = (torch.from_numpy(arrays[f"{i}_{n}"]) for n in ("x", "k", "bias"))
        p = C.plan(b, h, w, cin, cout, torch.bfloat16, splits=splits)
        assert p.variant == "tc" and (splits is not None or p.splits > 1), p
        out[f"{i}_tiled"] = C.conv3x3_tiled_reference(xt, kt, bt, p).numpy()
        out[f"{i}_ref"] = C.conv3x3_reference(xt, kt, bt).numpy()
        out[f"{i}_plan"] = np.array(str(p))
    with pytest.raises(ValueError):
        C.conv3x3_tiled_reference(xt, kt, bt, C.plan(1, 8, 24, 128, 64, torch.float32))
    return out


def wrapper_on_cpu():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    rng = np.random.default_rng(1)
    x, k = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
            for s in ((1, 8, 8, 64), (3, 3, 64, 64)))
    bias = torch.zeros(64)
    C.launches = 0
    C.launches_by_variant = dict.fromkeys(C.VARIANTS, 0)
    for force in ({}, {"variant": "tc", "splits": 3}, {"variant": "simt"}):
        out = C.conv3x3(x, k, bias, **force)
        torch.testing.assert_close(out, C.conv3x3_reference(x, k, bias), rtol=0, atol=0)
    assert C.launches == 0 and set(C.launches_by_variant.values()) == {0}
    # the bf16 emulation rounds once, as the kernel does: within one bf16 ulp
    # (2^-8 relative), or the fp32 reordering error of 576 products of size
    # ~1 where an output lies near 0
    emu = C.conv3x3_tiled_reference(x, k, bias, C.plan(1, 8, 8, 64, 64, torch.bfloat16))
    assert emu.dtype == torch.bfloat16
    torch.testing.assert_close(emu.float(), C.conv3x3_reference(x, k, bias).float(),
                               rtol=2 ** -7, atol=1e-4)


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from diffusion_models_dev_project_tpu.ops.conv3x3 import conv3x3_same  # noqa: E402


def test_plan_on_every_flagship_conv(tmp_path):
    child.run(__file__, "plan_on_every_flagship_conv", tmp_path)


def test_plan_on_every_512_conv(tmp_path):
    child.run(__file__, "plan_on_every_512_conv", tmp_path)


def test_tiled_emulation_matches_reference_and_pallas(tmp_path):
    rng = np.random.default_rng(0)
    inputs, pallas = {}, {}
    for i, (b, h, w, cin, cout, splits, tile_h) in enumerate(EMULATED):
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
        bias = rng.normal(size=(cout,)).astype(np.float32)
        inputs.update({f"{i}_x": x, f"{i}_k": k, f"{i}_bias": bias})
        with pltpu.force_tpu_interpret_mode():
            pallas[i] = np.asarray(conv3x3_same(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                                tile_h=tile_h))
    out = child.run(__file__, "tiled_emulation", tmp_path, **inputs)
    for i in range(len(EMULATED)):
        # fp32 on all sides; sums of up to 9*128 products of size ~0.1 in
        # another order (per 64-channel step, per split) differ by ~1e-6; a
        # lost or doubled K step would be off by ~0.1
        for other in (out[f"{i}_ref"], pallas[i]):
            np.testing.assert_allclose(out[f"{i}_tiled"], other, rtol=1e-5, atol=1e-4,
                                       err_msg=str(out[f"{i}_plan"]))


def test_wrapper_on_cpu_takes_the_plain_version_whatever_is_forced(tmp_path):
    child.run(__file__, "wrapper_on_cpu", tmp_path)
