"""The port's attention plan (variant, blocking, key splits), its CPU
emulation of the `mma` kernel, and head widths up to 256 and past it (the
chunked tensor-core plans; tests/test_torch_attention_wide.py holds wide
heads to the JAX kernel).

`plan` is what the wrapper hands the CUDA kernels, so it is checked on the
flagship UNet's attention calls, on the 512² configuration's (its attention
runs at the 16² and 8² maps, `attention_resolutions` "16" naming the map
size: the flagship's shapes), and at (4, 1024, 64), the regime in which the
JAX UNet would pick its Pallas flash kernel (1024 tokens or more).
`attention_tiled_reference` carries out a `mma` plan step by step in
PyTorch (bf16 operands, S from unscaled q and k, exp2 with the folded
scale, P rounded to bf16, key splits merged in order);
it is held against the port's plain version and the JAX package's Pallas
kernel (`interpret=True`, as the JAX package's own tests run it) on inputs
from numpy with a fixed seed.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

# the path's (T, d) at 16² and 8², ragged T, d = 20 and 40 (padded to 32, 48)
EMULATED = [(256, 64), (64, 64), (300, 64), (100, 20), (257, 40)]
# (T, d) of the head-width test: d = 20, 160 and 256
WIDE = [(300, 20), (130, 160), (70, 256)]


def _bf16(a):
    """fp32 -> the nearest bf16 value (round to nearest even), kept in fp32."""
    bits = a.astype(np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.view(np.float32)


# ------------------------------------------------------------- torch halves
def _flagship_attention_shapes(image_size=256):
    """(B·heads, T, d, dtype) of each attention call of one forward of the
    flagship's bf16 UNet (or the config's at another size), traced on the
    meta device with the kernels' wrappers stubbed out."""
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    config = get_config("vesde")
    config.model.image_size = image_size
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    seen = []

    def attention(q, k, v, use_kernel=True):
        seen.append((*q.shape, q.dtype))
        return torch.empty_like(q)

    # the child process ends after the case, so the stubs need no undoing
    U.conv3x3 = lambda x, w, b, use_kernel=True: x.new_empty(x.shape[:3] + (w.shape[-1],))
    U.attention = attention
    cfg = U.create_model_config(config.model)
    with torch.device("meta"):
        model = U.UNetModel(cfg).to(cfg.torch_dtype)
        model(torch.empty(1, image_size, image_size, 1), torch.empty(1))
    return seen


def plan_on_the_flagship_calls():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    shapes = _flagship_attention_shapes()
    assert sorted(shapes, key=lambda s: -s[1]) == [(8, 256, 64, torch.bfloat16)] * 3 + [
        (8, 64, 64, torch.bfloat16)]
    for bh, t, d, dt in shapes:
        p = A.plan(bh, t, d, dt)
        tiles = -(-t // p.key_tile)
        rows = A.MMA_ROWS * p.warps // p.key_splits
        assert p.variant == "mma" and p.warps == 4 and p.key_tile == 64 and p.d_pad == 64
        assert 1 <= p.key_splits <= tiles
        assert p.grid == (-(-t // rows), bh)
    p = A.plan(8, 256, 64, torch.bfloat16)
    # 128 blocks, one key tile a warp; an H100 SXM has 132 SMs
    assert p.grid[0] * p.grid[1] >= 64 and p.key_splits == 4
    assert A.plan(8, 64, 64, torch.bfloat16).key_splits == 1           # one tile: no split
    assert A.plan(8, 1024, 64, torch.bfloat16).key_splits == 4         # 4 rounds of 4 tiles
    assert A.plan(1, 150, 64, torch.bfloat16).key_splits == 2          # 3 tiles
    assert A.plan(3, 300, 128, torch.bfloat16).key_splits == 2         # d > 64: two rounds must fit
    assert A.plan(2, 37, 20, torch.bfloat16).d_pad == 32
    # fp32 goes to tf32x3 (tests/test_torch_attention_tf32x3.py), and a forced
    # simt still takes it; d > 128 stays on the tensor cores in column chunks
    # (tests/test_torch_attention_wide.py): 4 key splits (the head streams
    # through in slices, so any split fits), one ring stage past one wave of
    # the card; the forced simt takes d <= 256 in one pass and wider heads
    # in column chunks of 256; no head is narrower than 1
    assert A.plan(8, 256, 64, torch.float32).variant == "tf32x3"
    for args in ((8, 256, 64, torch.float32, "simt"), (8, 256, 160, torch.bfloat16, "simt"),
                 (2, 64, 256, torch.bfloat16, "simt"), (2, 64, 256, torch.float32, "simt")):
        assert A.plan(*args).variant == "simt" and A.plan(*args).chunks == 1
    assert A.plan(8, 256, 160, torch.bfloat16) == A.Plan("mma", 4, 4, 64, 160, (16, 8), 2, 1,
                                                         128)
    assert A.plan(2, 64, 256, torch.bfloat16) == A.Plan("mma", 4, 1, 64, 256, (1, 2), 2, 2, 128)
    assert A.plan(2, 64, 256, torch.float32) == A.Plan("tf32x3", 4, 2, 32, 256, (2, 2), 2, 2,
                                                       128)
    assert A.plan(2, 64, 256, torch.float32, "simt").key_tile == 16
    assert A.plan(8, 256, 64, torch.bfloat16, "simt").grid == (4, 8)
    assert A.plan(2, 64, 257, torch.bfloat16, "simt") == A.Plan("simt", 8, 1, 16, 512, (1, 2), 2)
    with pytest.raises(ValueError, match="head width"):
        A.plan(2, 64, 0, torch.bfloat16)
    # a forced variant that cannot take the dtype raises
    for args in ((8, 256, 64, torch.float32, "mma"), (8, 256, 160, torch.float32, "mma"),
                 (8, 256, 64, torch.bfloat16, "wgmma")):
        with pytest.raises(ValueError):
            A.plan(*args)


def plan_on_the_512_calls(**arrays):
    """The 512² configuration's four attention calls are the flagship's;
    at (4, 1024, 64) `mma` takes 4 key splits of 4 rounds of tiles, 16 query
    rows a block, grid (64, 4); and the plan's emulation at that shape."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    assert _flagship_attention_shapes(512) == _flagship_attention_shapes(256)
    p = A.plan(4, 1024, 64, torch.bfloat16)
    assert p == A.Plan("mma", 4, 4, 64, 64, (64, 4))
    assert -(-1024 // p.key_tile) // p.key_splits == 4          # key tiles a warp
    q, k, v = (torch.from_numpy(arrays[n]) for n in "qkv")
    return {"tiled": A.attention_tiled_reference(q, k, v, p).float().numpy(),
            "ref": A.attention_reference(q, k, v).numpy()}


def mma_emulation(**arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    out = {}
    for i, (t, d) in enumerate(EMULATED):
        q, k, v = (torch.from_numpy(arrays[f"{i}_{n}"]) for n in "qkv")
        out[f"{i}_ref"] = A.attention_reference(q, k, v).numpy()
        chosen = A.plan(3, t, d, torch.bfloat16)
        most = min(-(-t // A.MMA_KEY_TILE), 4 if d <= 64 else 2)
        # the plan's own split and every other split the kernel takes here
        for splits in (s for s in (1, 2, 4) if s <= most):
            p = chosen._replace(key_splits=splits,
                                grid=(-(-t // (A.MMA_ROWS * chosen.warps // splits)), 3))
            emu = A.attention_tiled_reference(q, k, v, p)
            assert emu.dtype == torch.bfloat16 and emu.shape == (3, t, d)
            out[f"{i}_split{splits}"] = emu.float().numpy()
    with pytest.raises(ValueError):
        A.attention_tiled_reference(q, k, v, A.plan(3, t, d, torch.float32))
    return out


def head_widths(**arrays):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    A.launches = 0
    A.launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    out = {}
    for i in range(len(WIDE)):
        out[str(i)] = A.attention(*(torch.from_numpy(arrays[f"{i}_{n}"]) for n in "qkv")).numpy()
    assert A.launches == 0 and set(A.launches_by_variant.values()) == {0}   # no kernel ran
    # past 128 the CPU runs the plain version too; no head is narrower than 1
    wide = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 4, 257)).astype(np.float32))
    for kw in ({}, {"use_kernel": False}):
        assert torch.equal(A.attention(wide, wide, wide, **kw),
                           A.attention_reference(wide, wide, wide))
        with pytest.raises(ValueError, match="head width"):
            A.attention(wide[..., :0], wide[..., :0], wide[..., :0], **kw)
    assert A.launches == 0
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.ops.attention import flash_attention  # noqa: E402


def test_plan_on_the_flagship_attention_calls_and_its_limits(tmp_path):
    child.run(__file__, "plan_on_the_flagship_calls", tmp_path)


def test_plan_at_512_and_at_1024_tokens_and_its_emulation_match_pallas(tmp_path):
    """The 512² configuration's calls, and at (4, 1024, 64) the plan and its
    emulation against the port's plain attention and the Pallas flash kernel
    in interpret mode."""
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng.normal(size=(4, 1024, 64)).astype(np.float32)) for _ in range(3))
    pending = child.start(__file__, "plan_on_the_512_calls", tmp_path, q=q, k=k, v=v)
    pallas = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    out = pending.result()
    # as in the test below: bf16 inputs, the emulation rounds P and its output to bf16
    for other in (out["ref"], pallas):
        assert np.abs(out["tiled"] - other).max() <= 1e-2 * np.abs(other).max()
    # fp32 on both sides, sums of 1024 products in another order
    np.testing.assert_allclose(out["ref"], pallas, rtol=2e-4, atol=2e-5)


def test_mma_emulation_matches_reference_and_pallas(tmp_path):
    rng = np.random.default_rng(3)
    inputs, pallas = {}, {}
    for i, (t, d) in enumerate(EMULATED):
        # bf16-representable fp32 inputs (the bf16 rounding done with numpy)
        q, k, v = (_bf16(rng.normal(size=(3, t, d)).astype(np.float32)) for _ in range(3))
        inputs.update({f"{i}_q": q, f"{i}_k": k, f"{i}_v": v})
        pallas[i] = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    out = child.run(__file__, "mma_emulation", tmp_path, **inputs)
    for i, (t, d) in enumerate(EMULATED):
        splits = [key for key in out if key.startswith(f"{i}_split")]
        assert splits
        for key in splits:
            # bf16 inputs on all sides; the emulation rounds P and its output
            # to bf16 (2^-9 relative each), the fp32 sides do not
            for other in (out[f"{i}_ref"], pallas[i]):
                assert np.abs(out[key] - other).max() <= 1e-2 * np.abs(other).max(), (t, d, key)


def test_head_widths_up_to_256_match_pallas_and_wider_raise(tmp_path):
    rng = np.random.default_rng(4)
    inputs, pallas = {}, {}
    for i, (t, d) in enumerate(WIDE):
        q, k, v = (rng.normal(size=(2, t, d)).astype(np.float32) for _ in range(3))
        inputs.update({f"{i}_q": q, f"{i}_k": k, f"{i}_v": v})
        pallas[i] = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    out = child.run(__file__, "head_widths", tmp_path, **inputs)
    for i, shape in enumerate(WIDE):
        # fp32 on both sides, sums of up to 256 products in another order
        np.testing.assert_allclose(out[str(i)], pallas[i], rtol=2e-4, atol=2e-5, err_msg=str(shape))
