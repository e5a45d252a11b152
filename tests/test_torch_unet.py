"""The port's UNet and checkpoint loader against the JAX package.

Parameters come from the JAX `UNetModel.init`, perturbed with numpy noise
so that the zero-initialised layers matter, and reach the port through
`params_from_flax`; both models compute in fp32 on the same inputs.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import dataclasses
import hashlib
import json
import os
import pickle

import numpy as np
import pytest

import _torch_child as child

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VESDE = os.path.join(REPO, "checkpoints", "flagship_vesde_256_ema.msgpack.npz")

# the TINY config of tests/test_unet.py, then its learn_sigma variant, then
# standalone Sample layers with additive embedding
TINY = dict(image_size=32, in_channels=1, out_channels=1, model_channels=32,
            num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
            num_heads=4, num_head_channels=8, use_scale_shift_norm=True,
            resblock_updown=True)
VARIANTS = [{}, {"out_channels": 2}, {"resblock_updown": False, "use_scale_shift_norm": False}]
FLAGSHIP = {**TINY, "model_channels": 128, "image_size": 256,
            "channel_mult": (1, 1, 2, 2, 4, 4), "attention_resolutions": (16,),
            "num_head_channels": 64}


def _leaf_digests(tree):
    """(path, dtype, shape, sha1) of every array leaf of a nested dict."""
    return [(k, str(v.dtype), v.shape, hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest())
            for k, v in sorted(child.flatten(tree).items())]


# ------------------------------------------------------------- torch halves
def tiny_unets(x, t, **params):
    import torch

    from diffusion_models_dev_project_tpu_torch.models import unet as TU
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    out = {}
    for i, overrides in enumerate(VARIANTS):
        tmodel = TU.UNetModel(TU.UNetConfig(**{**TINY, **overrides}))
        tmodel.load_state_dict(params_from_flax(child.unflatten(params, f"v{i}/")), strict=True)
        with torch.no_grad():
            out[str(i)] = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    return out


def unet_pieces(t, x, scale, bias):
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config as tget
    from diffusion_models_dev_project_tpu_torch.models import unet as TU

    tc = TU.create_model_config(tget("vesde").model)
    model = TU.UNetModel(TU.UNetConfig(**FLAGSHIP))
    convs = [m for m in model.modules() if isinstance(m, TU.Conv3x3)]
    attns = [m for m in model.modules() if isinstance(m, TU.AttentionBlock)]
    assert len(convs) == 62 and len(attns) == 4
    assert {a.spec.num_heads for a in attns} == {8}
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6 - 93.6) < 0.1
    return {"emb": TU.timestep_embedding(torch.from_numpy(t), 33).numpy(),
            "gn": TU.group_norm32(*(torch.from_numpy(a) for a in (x, scale, bias))).numpy(),
            "arch": np.array(repr(TU.build_arch_spec(TU.UNetConfig(**FLAGSHIP)))),
            "cfg": np.array(json.dumps({f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}))}


def msgpack_reader(small, bf):
    from diffusion_models_dev_project_tpu_torch.models import unet as TU
    from diffusion_models_dev_project_tpu_torch.models.convert import (load_flax_msgpack,
                                                                       params_from_flax,
                                                                       unpack_msgpack)

    ours_small = unpack_msgpack(small.tobytes())
    ours_bf = unpack_msgpack(bf.tobytes())
    with pytest.raises(ValueError):        # truncated input is refused
        unpack_msgpack(bf.tobytes()[:-3])
    ours = load_flax_msgpack(VESDE)
    model = TU.UNetModel(TU.UNetConfig(model_channels=128, num_head_channels=64))
    model.load_state_dict(params_from_flax(ours), strict=True)
    w = model.in_1_0.emb.weight.detach()
    assert str(w.dtype) == "torch.float32"
    return {"small": np.frombuffer(pickle.dumps(ours_small), np.uint8),
            "bf": ours_bf["w"], "emb_weight": w.numpy(),
            "vesde": np.array(json.dumps(_leaf_digests(ours)))}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.models import unet as JU  # noqa: E402


def test_tiny_unets_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    t = np.array([0.2, 0.8], np.float32)
    inputs, refs = {}, []
    for i, overrides in enumerate(VARIANTS):
        jmodel = JU.UNetModel(JU.UNetConfig(**{**TINY, **overrides}))
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
        refs.append(np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                                      jnp.asarray(t))))
        inputs.update(child.flatten(params, f"v{i}/"))
    out = child.run(__file__, "tiny_unets", tmp_path, x=x, t=t, **inputs)
    for i, (overrides, ref) in enumerate(zip(VARIANTS, refs)):
        assert out[str(i)].shape == ref.shape == (2, 32, 32, 1)
        # fp32 on both sides; sums in another order through ~20 layers
        np.testing.assert_allclose(out[str(i)], ref, rtol=1e-4, atol=2e-5 * np.abs(ref).max(),
                                   err_msg=str(overrides))


def test_unet_pieces_and_structure_match_jax(tmp_path):
    from diffusion_models_dev_project_tpu.configs.disk_ellipses_configs import get_config as jget

    t = np.array([0.0, 1.0, 7.3, 500.0], np.float32)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 7, 64)) * 3 + 1).astype(np.float32)
    scale, bias = rng.normal(size=(2, 64)).astype(np.float32)
    out = child.run(__file__, "unet_pieces", tmp_path, t=t, x=x, scale=scale, bias=bias)
    np.testing.assert_allclose(out["emb"], np.asarray(JU.timestep_embedding(jnp.asarray(t), 33)),
                               rtol=1e-6, atol=1e-6)
    ref = np.asarray(JU._group_norm32(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    np.testing.assert_allclose(out["gn"], ref, rtol=1e-5, atol=1e-5)
    assert str(out["arch"]) == repr(JU.build_arch_spec(JU.UNetConfig(**FLAGSHIP)))
    jc = JU.create_model_config(jget("vesde").model)
    for name, value in json.loads(str(out["cfg"])).items():   # the JAX config also has LoRA fields
        assert value == json.loads(json.dumps(getattr(jc, name))), name


def test_msgpack_loader_matches_flax(tmp_path):
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
    small = flax.serialization.msgpack_serialize(tree)
    # bfloat16 leaves widen to fp32; truncated input is refused (in the child)
    bf = jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) * 0.5
    bf_buf = flax.serialization.msgpack_serialize({"w": np.asarray(bf)})
    out = child.run(__file__, "msgpack_reader", tmp_path,
                    small=np.frombuffer(small, np.uint8), bf=np.frombuffer(bf_buf, np.uint8))
    same_trees(pickle.loads(out["small"].tobytes()), flax.serialization.msgpack_restore(small))
    np.testing.assert_array_equal(out["bf"], np.asarray(bf, np.float32))

    # the shipped VESDE prior: 362 fp16 leaves, equal to flax's reading
    with open(VESDE, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    ref_digests = json.loads(json.dumps(_leaf_digests(ref)))
    assert json.loads(str(out["vesde"])) == ref_digests and len(ref_digests) == 362
    np.testing.assert_array_equal(out["emb_weight"],
                                  ref["in_1_0"]["emb"]["kernel"].astype(np.float32).T)
