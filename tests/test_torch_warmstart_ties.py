"""The bf16 ties of a warm start, in the JAX package and in the port.

A shipped checkpoint stores fp16 values.  Both packages widen them to fp32
masters (the JAX package in `factory._load_params`, the port in
`factory.load_params`) and, under bf16 compute, cast every parameter to
bf16 in the forward (the JAX package's layers through
`flax.linen.dtypes.promote_dtype`).  An eighth of fp16 values lie exactly
halfway between two bf16 values, where the cast rounds to even; a first
update far below bf16's resolution then tips half of them to the odd
neighbour.  Here both packages start from the same fp16-valued masters of
the tiny flagship UNet, take the same update of 1e-6 (a random sign per
value), and count the bf16 casts that change: the counts agree, so the
JAX package's warm start tips as the port's did.  The port's trainer
rounds its masters to bf16 first (`factory.round_to_compute_dtype_`); then
a cast changes only where 1e-6 reaches half a bf16 ulp (|value| below
about 2^9 x 1e-6).

The torch half runs in a child interpreter (tests/_torch_child.py): no
pytest process runs torch code.
"""
import dataclasses

import numpy as np

import _torch_child as child

STEP = 1e-6


def _flips(masters, update, cast):
    """(casts that change, values, values where STEP can reach half a bf16
    ulp on either side: 2^(e - 9) for |value| in [2^e, 2^(e+1)), the lower
    binade's, since a value at 2^e moves into it) over every leaf of the
    flat dicts `masters` and `update`."""
    changed = small = total = 0
    for k, p in masters.items():
        a, b = cast(p), cast(p + update[k])
        changed += int(np.count_nonzero(a != b))
        mag = np.abs(p.astype(np.float64))
        half_ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 9)
        small += int(np.count_nonzero((mag == 0) | (half_ulp <= STEP)))
        total += p.size
    return changed, total, small


# ------------------------------------------------------------- torch half
def port_warm_start(ckpt, **update):
    import torch

    from diffusion_models_dev_project_tpu_torch import factory
    from diffusion_models_dev_project_tpu_torch.models import unet as TU
    from diffusion_models_dev_project_tpu_torch.models.convert import params_from_flax

    state = factory.load_params(str(ckpt))
    step = params_from_flax(child.unflatten(update))
    model = TU.UNetModel(TU.UNetConfig(**TINY, dtype="bfloat16"))
    model.load_state_dict(state, strict=True)

    def cast(v):
        return torch.from_numpy(v).to(torch.bfloat16).float().numpy()

    out = {}
    for name in ("loaded", "rounded"):
        if name == "rounded":
            factory.round_to_compute_dtype_(model)
        masters = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
        assert all(v.dtype == np.float32 for v in masters.values())
        out[name] = np.array(_flips(masters, {n: step[n].numpy() for n in masters}, cast))
    return out


# the tiny flagship UNet (__graft_entry__._flagship(tiny=True)'s config)
TINY = dict(image_size=32, in_channels=1, out_channels=1, model_channels=32,
            num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
            num_heads=4, num_head_channels=8, use_scale_shift_norm=True,
            resblock_updown=True)

if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX half
import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from diffusion_models_dev_project_tpu import factory as jax_factory  # noqa: E402


def test_a_warm_start_tips_the_same_bf16_ties_in_both_packages(tmp_path):
    model, cfg = __graft_entry__._flagship(tiny=True)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name in TINY} == TINY
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    x = jnp.zeros((1, cfg.image_size, cfg.image_size, cfg.in_channels))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x, jnp.zeros((1,)))["params"]
    # the shipped checkpoints' storage: fp16 leaves in a flax msgpack tree
    rng = np.random.default_rng(0)
    fp16 = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.02, size=a.shape)).astype(np.float16), params)
    ckpt = tmp_path / "warm.msgpack.npz"
    ckpt.write_bytes(flax.serialization.msgpack_serialize(fp16))
    update = {k: (STEP * rng.choice([-1.0, 1.0], size=v.shape)).astype(np.float32)
              for k, v in child.flatten(fp16).items()}
    pending = child.start(__file__, "port_warm_start", tmp_path, ckpt=np.array(str(ckpt)), **update)

    masters = {k: np.asarray(v) for k, v in
               child.flatten(jax_factory._load_params(str(ckpt), cfg, use_ema=False)).items()}
    assert all(v.dtype == np.float32 for v in masters.values())

    def cast(v):        # the cast of the JAX UNet's layers under bf16 compute (models/unet.py)
        return np.asarray(flax.linen.dtypes.promote_dtype(jnp.asarray(v), dtype=jnp.bfloat16)[0],
                          np.float32)

    jax_changed, total, small = _flips(masters, update, cast)
    port = pending.result()
    # the same values and the same update tip the same casts in both packages:
    # about half of the eighth that lie on ties, the others' move is too small
    assert tuple(port["loaded"]) == (jax_changed, total, small)
    assert total / 20 < jax_changed - small and jax_changed < total / 12
    # the port's rounded masters change a cast only where the step reaches
    # half a bf16 ulp
    changed, _, _ = port["rounded"]
    print(f"bf16 casts changed by the step: JAX {jax_changed}, port {port['loaded'][0]} of "
          f"{total} values; port from rounded masters {changed} (values the step can tip: {small})")
    assert changed <= small
