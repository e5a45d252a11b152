"""The port's UNet and checkpoint loader against the JAX package.

Parameters come from the JAX `UNetModel.init`, perturbed with numpy noise
so that the zero-initialised layers matter, and reach the port through
`params_from_flax`; both models compute in fp32 on the same inputs.

torch and the port are imported inside the tests, never at collection
(see tests/test_torch_kernels.py).
"""
import dataclasses
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_models_dev_project_tpu.models import unet as JU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VESDE = os.path.join(REPO, "checkpoints", "flagship_vesde_256_ema.msgpack.npz")

# the TINY config of tests/test_unet.py, then its learn_sigma variant, then
# standalone Sample layers with additive embedding
TINY = dict(image_size=32, in_channels=1, out_channels=1, model_channels=32,
            num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
            num_heads=4, num_head_channels=8, use_scale_shift_norm=True,
            resblock_updown=True)
VARIANTS = [{}, {"out_channels": 2}, {"resblock_updown": False, "use_scale_shift_norm": False}]


def test_tiny_unets_match_jax():
    import torch

    from diffusion_models_dev_project_tpu_torch.models import unet as TU
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([0.2, 0.8], np.float32)
    for overrides in VARIANTS:
        cfg = {**TINY, **overrides}
        jmodel = JU.UNetModel(JU.UNetConfig(**cfg))
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
        ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
        tmodel = TU.UNetModel(TU.UNetConfig(**cfg))
        tmodel.load_state_dict(params_from_flax(params), strict=True)
        with torch.no_grad():
            out = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        assert out.shape == ref.shape == (2, 32, 32, 1)
        # fp32 on both sides; sums in another order through ~20 layers
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=str(overrides))


def test_unet_pieces_and_structure_match_jax():
    import torch

    from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget
    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models import unet as TU

    t = np.array([0.0, 1.0, 7.3, 500.0], np.float32)
    np.testing.assert_allclose(TU.timestep_embedding(torch.from_numpy(t), 33).numpy(),
                               np.asarray(JU.timestep_embedding(jnp.asarray(t), 33)),
                               rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 7, 64)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=(2, 64)).astype(np.float32)
    ref = np.asarray(JU._group_norm32(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    out = TU.group_norm32(*(torch.from_numpy(a) for a in (x, scale, bias))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    flagship = {**TINY, "model_channels": 128, "image_size": 256,
                "channel_mult": (1, 1, 2, 2, 4, 4), "attention_resolutions": (16,),
                "num_head_channels": 64}
    assert repr(TU.build_arch_spec(TU.UNetConfig(**flagship))) == \
        repr(JU.build_arch_spec(JU.UNetConfig(**flagship)))
    jc, tc = JU.create_model_config(jget("vesde").model), TU.create_model_config(tget("vesde").model)
    for f in dataclasses.fields(tc):           # the JAX config also has LoRA fields
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name

    model = TU.UNetModel(TU.UNetConfig(**flagship))
    convs = [m for m in model.modules() if isinstance(m, TU.Conv3x3)]
    attns = [m for m in model.modules() if isinstance(m, TU.AttentionBlock)]
    assert len(convs) == 62 and len(attns) == 4
    assert {a.spec.num_heads for a in attns} == {8}
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6 - 93.6) < 0.1


def test_msgpack_loader_matches_flax():
    import torch

    from diffusion_models_dev_project_tpu_torch.models import unet as TU
    from diffusion_models_dev_project_tpu_torch.models.convert import (load_flax_msgpack,
                                                                       params_from_flax,
                                                                       unpack_msgpack)

    def same_trees(ours, ref):
        ours_leaves = jax.tree_util.tree_leaves_with_path(ours)
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        assert [p for p, _ in ours_leaves] == [p for p, _ in ref_leaves]
        for (_, a), (_, b) in zip(ours_leaves, ref_leaves):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return len(ref_leaves)

    # a small tree of every type flax writes
    rng = np.random.default_rng(4)
    tree = {"a": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float16),
                  "bias": np.zeros(4, np.float32)},
            "n": 7, "neg": -3, "big": 2 ** 40, "f": 1.5, "s": "text", "flag": True,
            "none": None, "i8": np.arange(5, dtype=np.int8), "scalar": np.float64(2.5),
            "many": {str(i): np.full((i + 1,), i, np.int32) for i in range(20)}}
    buf = flax.serialization.msgpack_serialize(tree)
    same_trees(unpack_msgpack(buf), flax.serialization.msgpack_restore(buf))
    # bfloat16 leaves widen to fp32; truncated input is refused
    bf = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) * 0.5
    buf = flax.serialization.msgpack_serialize({"w": np.asarray(bf)})
    np.testing.assert_array_equal(unpack_msgpack(buf)["w"], np.asarray(bf, np.float32))
    with pytest.raises(ValueError):
        unpack_msgpack(buf[:-3])

    # the shipped VESDE prior: 362 fp16 leaves, equal to flax's reading
    with open(VESDE, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    ours = load_flax_msgpack(VESDE)
    assert same_trees(ours, ref) == 362
    model = TU.UNetModel(TU.UNetConfig(model_channels=128, num_head_channels=64))
    model.load_state_dict(params_from_flax(ours), strict=True)
    w = model.in_1_0.emb.weight.detach()
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), ref["in_1_0"]["emb"]["kernel"].astype(np.float32).T)
