"""The port's attention plan (variant, blocking, key splits), its CPU
emulation of the `mma` kernel, and head widths up to the port's limit.

`plan` is what the wrapper hands the CUDA kernels, so it is checked on the
flagship UNet's attention calls.  `attention_tiled_reference` carries out a
`mma` plan step by step in PyTorch (bf16 operands, S from unscaled q and k,
exp2 with the folded scale, P rounded to bf16, key splits merged in order);
it is held against the port's plain version and the JAX package's Pallas
kernel (`interpret=True`, as the JAX package's own tests run it) on inputs
from numpy with a fixed seed.

torch and the port are imported inside the tests, never at collection
(see tests/test_torch_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_models_dev_project_tpu.ops.attention import flash_attention

# the path's (T, d) at 16² and 8², ragged T, d = 20 and 40 (padded to 32, 48)
EMULATED = [(256, 64), (64, 64), (300, 64), (100, 20), (257, 40)]


def _flagship_attention_shapes(monkeypatch):
    """(B·heads, T, d, dtype) of each attention call of one flagship 256²
    forward, traced on the meta device with the kernels' wrappers stubbed out."""
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    config = get_config("vesde")
    config.model.num_channels = 128
    config.model.dtype = "bfloat16"
    seen = []

    def attention(q, k, v, use_kernel=True):
        seen.append((*q.shape, q.dtype))
        return torch.empty_like(q)

    monkeypatch.setattr(U, "conv3x3", lambda x, w, b, use_kernel=True:
                        x.new_empty(x.shape[:3] + (w.shape[-1],)))
    monkeypatch.setattr(U, "attention", attention)
    cfg = U.create_model_config(config.model)
    with torch.device("meta"):
        model = U.UNetModel(cfg).to(cfg.torch_dtype)
        model(torch.empty(1, 256, 256, 1), torch.empty(1))
    return seen


def test_plan_on_the_flagship_attention_calls_and_its_limits(monkeypatch):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    shapes = _flagship_attention_shapes(monkeypatch)
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
    # fp32 and d > 128 go to simt; past 256 nothing takes the head
    for args in ((8, 256, 64, torch.float32), (8, 256, 160, torch.bfloat16),
                 (2, 64, 256, torch.bfloat16), (2, 64, 256, torch.float32)):
        assert A.plan(*args).variant == "simt"
    assert A.plan(2, 64, 256, torch.float32).key_tile == 16
    assert A.plan(8, 256, 64, torch.bfloat16, "simt").grid == (4, 8)
    with pytest.raises(ValueError, match="256"):
        A.plan(2, 64, 257, torch.bfloat16)
    # a forced variant that cannot take the shape raises
    for args in ((8, 256, 64, torch.float32, "mma"), (8, 256, 160, torch.bfloat16, "mma"),
                 (8, 256, 64, torch.bfloat16, "wgmma")):
        with pytest.raises(ValueError):
            A.plan(*args)


def test_mma_emulation_matches_reference_and_pallas():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    rng = np.random.default_rng(3)
    for t, d in EMULATED:
        q, k, v = (torch.from_numpy(rng.normal(size=(3, t, d)).astype(np.float32)).bfloat16().float()
                   for _ in range(3))
        pallas = np.asarray(flash_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                                            interpret=True))
        ref = A.attention_reference(q, k, v).numpy()
        chosen = A.plan(3, t, d, torch.bfloat16)
        most = min(-(-t // A.MMA_KEY_TILE), 4 if d <= 64 else 2)
        # the plan's own split and every other split the kernel takes here
        for splits in (s for s in (1, 2, 4) if s <= most):
            p = chosen._replace(key_splits=splits,
                                grid=(-(-t // (A.MMA_ROWS * chosen.warps // splits)), 3))
            out = A.attention_tiled_reference(q, k, v, p)
            assert out.dtype == torch.bfloat16 and out.shape == (3, t, d)
            out = out.float().numpy()
            # bf16 inputs on all sides; the emulation rounds P and its output
            # to bf16 (2^-9 relative each), the fp32 sides do not
            for other in (ref, pallas):
                assert np.abs(out - other).max() <= 1e-2 * np.abs(other).max(), (t, d, splits)
    with pytest.raises(ValueError):
        A.attention_tiled_reference(q, k, v, A.plan(3, t, d, torch.float32))


def test_head_widths_up_to_256_match_pallas_and_wider_raise():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    rng = np.random.default_rng(4)
    A.launches = 0
    A.launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    for t, d in ((300, 20), (130, 160), (70, 256)):
        q, k, v = (rng.normal(size=(2, t, d)).astype(np.float32) for _ in range(3))
        pallas = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
        out = A.attention(*(torch.from_numpy(a) for a in (q, k, v)))
        # fp32 on both sides, sums of up to 256 products in another order
        np.testing.assert_allclose(out.numpy(), pallas, rtol=2e-4, atol=2e-5, err_msg=str((t, d)))
    assert A.launches == 0 and set(A.launches_by_variant.values()) == {0}   # no kernel ran
    wide = torch.zeros(1, 4, 257)
    for kw in ({}, {"use_kernel": False}):
        with pytest.raises(ValueError, match="256"):
            A.attention(wide, wide, wide, **kw)
