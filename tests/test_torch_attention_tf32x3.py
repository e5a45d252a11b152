"""The port's fp32 attention on the tensor cores (`tf32x3`): its routes and
its arithmetic.

- `plan` and `backward_plan` on the flagship UNet's fp32 attention calls
  (fp32 is its default compute dtype): three at (8·B, 256, 64) and one at
  (8·B, 64, 64) per forward, at batch 1, 3 (training) and 4 (the batched
  path), all on `tf32x3`; bf16 keeps `mma`, d > 128 stays on both (in
  column chunks), a forced `simt` takes `simt`, and a forced `tf32x3` on
  bf16 raises.
- The kernels' CPU emulations, `attention_tf32x3_tiled_reference` (forward
  and its lse2) and `attention_backward_tf32x3_tiled_reference`, which split
  each fp32 operand into TF32 hi + lo and add hi·hi, hi·lo, lo·hi per
  8-wide slice as the kernels do, key splits and chunks merged in the
  kernels' order, against the JAX package's fp32 attention: the Pallas
  `flash_attention` in interpret mode and the einsum `attention_reference`
  for the forward, `jax.vjp` of `attention_reference` for the backward,
  within 1e-5 of the largest value (max|diff| / max|JAX|; lse2 within 1e-5
  absolute, in log2 units) at T = 1, 64, 100 (ragged), 256 and 1024 and
  d = 8, 40, 64 and 128.  A single TF32 product (the lo terms dropped)
  misses that bound at the flagship's shapes: the split is what keeps fp32.
- On the CPU `attention`, `attention_with_lse` and the gradient take the
  plain versions and count no launch.

Inputs come from numpy with a fixed seed.  The torch half of each test runs
in a child interpreter (tests/_torch_child.py): no pytest process runs
torch code.
"""
import math

import numpy as np
import pytest

import _torch_child as child

# (B·heads, T, d) of the emulation tests: T = 1, 64, 100 (ragged over 4
# splits), 256 (the flagship's 16² map), 1024 (several rounds of tiles and
# chunks), d = 8, 40 (a ragged slice count), 64 and 128 (2 key splits)
EMULATED = [(2, 1, 8), (3, 64, 64), (2, 100, 40), (2, 100, 128), (8, 256, 64), (2, 256, 128),
            (2, 1024, 64), (3, 64, 8)]
IDS = [f"{bh}x{t}x{d}" for bh, t, d in EMULATED]
# the flagship's two shapes per image
FLAGSHIP = [(8, 256, 64), (8, 64, 64)]
TOL = 1e-5          # of max|JAX|: fp32 accuracy
TOL_LSE = 1e-5      # absolute, on lse2 in log2 units (values of about 5 to 10)
LOG2E = 1.4426950408889634


# ------------------------------------------------------------- torch halves
def _flagship_attention_shapes(batch):
    """(B·heads, T, d) of each attention call of one forward of the
    flagship's fp32 UNet at `batch`, traced on the meta device with the
    kernels' wrappers stubbed out."""
    import torch

    from diffusion_models_dev_project_tpu_torch.configs.disk_ellipses_configs import get_config
    from diffusion_models_dev_project_tpu_torch.models import unet as U

    config = get_config("vesde")
    config.model.num_channels = 128
    assert config.model.dtype == "float32"
    seen = []

    def attention(q, k, v, use_kernel=True):
        assert q.dtype == torch.float32
        seen.append(tuple(q.shape))
        return torch.empty_like(q)

    # the child process ends after the case, so the stubs need no undoing
    U.conv3x3 = lambda x, w, b, use_kernel=True: x.new_empty(x.shape[:3] + (w.shape[-1],))
    U.attention = attention
    cfg = U.create_model_config(config.model)
    with torch.device("meta"):
        model = U.UNetModel(cfg).to(cfg.torch_dtype)
        model(torch.empty(batch, 256, 256, 1), torch.empty(batch))
    return seen


def routes():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    fp32, bf16 = torch.float32, torch.bfloat16
    for batch in (1, 3, 4):
        shapes = _flagship_attention_shapes(batch)
        assert sorted(shapes, key=lambda s: -s[1]) == [(8 * batch, 256, 64)] * 3 + [
            (8 * batch, 64, 64)], shapes
        for bh, t, d in shapes:
            p, bp = A.plan(bh, t, d, fp32), A.backward_plan(bh, t, d, fp32)
            assert p.variant == bp.variant == "tf32x3", (p, bp)
            # bf16 at the same shapes keeps mma
            assert A.plan(bh, t, d, bf16).variant == "mma"
            assert A.backward_plan(bh, t, d, bf16).variant == "mma"
    # 4 key splits of 2 tiles of 32 keys at T = 256: 128 blocks at batch 1,
    # in two stages a split; past one block per SM, one stage; T = 64 is 2
    # tiles, so 2 splits of 2 row groups
    assert A.plan(8, 256, 64, fp32) == A.Plan("tf32x3", 4, 4, 32, 64, (16, 8), stages=2)
    assert A.plan(24, 256, 64, fp32) == A.Plan("tf32x3", 4, 4, 32, 64, (16, 24), stages=1)
    assert A.plan(8, 64, 64, fp32) == A.Plan("tf32x3", 4, 2, 32, 64, (2, 8))
    assert A.plan(2, 1024, 128, fp32).key_splits == 2               # d > 64: at most 2
    assert A.plan(2, 100, 40, fp32).d_pad == 40                     # 8-wide slices
    assert A.plan(1, 1, 8, fp32).key_splits == 1
    # the backward: the narrowest chunk that leaves a warp one, up to what two
    # stages a warp take, 32 rows (d <= 64) or 16 (d > 64): 2 chunks a warp
    # in two stages at T = 256; past one block per SM, chunks of 16 in one
    # stage (the batch-3 pass)
    assert A.backward_plan(8, 256, 64, fp32) == A.BackwardPlan("tf32x3", 64, 32, 16, 4, 0, (16, 8))
    assert A.backward_plan(24, 256, 64, fp32) == A.BackwardPlan("tf32x3", 64, 16, 16, 4, 0,
                                                                (16, 24), stages=1)
    assert A.backward_plan(8, 64, 64, fp32) == A.BackwardPlan("tf32x3", 64, 16, 16, 4, 0, (4, 8))
    assert A.backward_plan(24, 64, 64, fp32).stages == 2                # 96 blocks
    assert A.backward_plan(2, 1024, 64, fp32).tile == 32
    assert A.backward_plan(3, 100, 128, fp32).tile == 16
    assert A.backward_plan(3, 100, 128, fp32, tile=32).tile == 32       # one chunk a warp
    assert A.backward_plan(3, 300, 128, fp32).tile == 16
    assert A.backward_plan(2, 1024, 64, fp32, tile=16).tile == 16
    for args, kw in (((2, 1024, 64, fp32), {"tile": 64}), ((3, 300, 128, fp32), {"tile": 32}),
                     ((2, 100, 128, fp32), {"tile": 64}), ((8, 256, 64, fp32), {"tile": 48})):
        with pytest.raises(ValueError, match="chunk"):
            A.backward_plan(*args, **kw)
    # d > 128 stays on the tensor cores, in column chunks of 128
    # (tests/test_torch_attention_wide.py); only the forced simt takes simt;
    # a forced tf32x3 on bf16 (or mma on fp32) raises
    for dt, own in ((fp32, "tf32x3"), (bf16, "mma")):
        assert A.plan(8, 256, 160, dt).variant == A.backward_plan(8, 256, 160, dt).variant == own
        assert A.plan(8, 256, 160, dt).chunks == A.backward_plan(8, 256, 160, dt).chunks == 2
    assert A.plan(8, 256, 64, fp32, "simt").variant == "simt"
    assert A.backward_plan(8, 256, 64, fp32, "simt").variant == "simt"
    for args in ((8, 256, 64, bf16, "tf32x3"), (8, 256, 160, bf16, "tf32x3"),
                 (8, 256, 64, fp32, "mma")):
        with pytest.raises(ValueError, match=args[-1]):
            A.plan(*args)
        with pytest.raises(ValueError, match=args[-1]):
            A.backward_plan(*args)
    # off the CPU, tf32x3 needs the forward's lse2: on the meta device the
    # wrapper raises for it before it looks for CUDA
    m = torch.zeros(2, 37, 20, device="meta")
    with pytest.raises(ValueError, match="tf32x3 needs the forward's lse2"):
        A.attention_backward(m, m, m, m, m)
    with pytest.raises(ValueError, match="not on CUDA"):
        A.attention_backward(m, m, m, m, m, torch.zeros(2, 37, device="meta"))
    # the emulations take their own plans only
    q = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="emulates tf32x3"):
        A.attention_tf32x3_tiled_reference(q, q, q, A.plan(1, 8, 8, bf16))
    with pytest.raises(ValueError, match="emulates tf32x3"):
        A.attention_backward_tf32x3_tiled_reference(q, q, q, q, q, q[..., 0],
                                                    A.backward_plan(1, 8, 8, fp32, "simt"))
    with pytest.raises(ValueError, match="emulates mma"):
        A.attention_tiled_reference(q, q, q, A.plan(1, 8, 8, fp32))
    return {}


def emulations(**a):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    q, k, v, g = (torch.from_numpy(a[n]) for n in "qkvg")
    bh, t, d = q.shape
    p = A.plan(bh, t, d, torch.float32)
    bp = A.backward_plan(bh, t, d, torch.float32)
    assert p.variant == bp.variant == "tf32x3"
    out, lse = A.attention_tf32x3_tiled_reference(q, k, v, p, with_lse=True)
    assert out.dtype == lse.dtype == torch.float32 and out.shape == (bh, t, d)
    assert lse.shape == (bh, t)
    # the backward from the emulated forward's output and lse2, as the
    # kernels take them
    grads = A.attention_backward_tf32x3_tiled_reference(q, k, v, out, g, lse, bp)
    res = {"out": out.numpy(), "lse": lse.numpy()}
    res.update({f"d{n}": x.numpy() for n, x in zip("qkv", grads)})
    # every other key split and chunk the kernels take here, forced
    for splits in (1, 2, 4):
        if splits != p.key_splits and splits <= min(-(-t // p.key_tile), 4 if d <= 64 else 2):
            other = p._replace(key_splits=splits, grid=(-(-t // (A.MMA_ROWS * 4 // splits)), bh))
            res[f"out_split{splits}"] = A.attention_tf32x3_tiled_reference(q, k, v, other).numpy()
    for tile in (16, 32, 64):
        if tile != bp.tile:
            try:
                other = A.backward_plan(bh, t, d, torch.float32, tile=tile)
            except ValueError:
                continue
            for n, x in zip("qkv", A.attention_backward_tf32x3_tiled_reference(q, k, v, out, g,
                                                                               lse, other)):
                res[f"d{n}_chunk{tile}"] = x.numpy()
    return res


def single_tf32(**a):
    """The emulations with the lo terms dropped: every operand, P and dS
    included, rounded to one TF32 value and multiplied once."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    split = A.tf32_split
    # the child process ends after the case, so the patch needs no undoing
    A.tf32_split = lambda x: (split(x)[0], torch.zeros_like(x))
    q, k, v, g = (torch.from_numpy(a[n]) for n in "qkvg")
    bh, t, d = q.shape
    out, lse = A.attention_tf32x3_tiled_reference(q, k, v, A.plan(bh, t, d, torch.float32),
                                                  with_lse=True)
    grads = A.attention_backward_tf32x3_tiled_reference(
        q, k, v, out, g, lse, A.backward_plan(bh, t, d, torch.float32))
    return {"out": out.numpy(), **{f"d{n}": x.numpy() for n, x in zip("qkv", grads)}}


def wrapper_on_cpu(**a):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    A.launches = A.backward_launches = 0
    A.launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    A.backward_launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    assert A.VARIANTS == ("mma", "tf32x3", "simt")
    for i in range(2):
        q, k, v, g = (torch.from_numpy(a[f"{i}_{n}"]) for n in "qkvg")
        assert A.plan(*q.shape, torch.float32).variant == "tf32x3"
        for force in ({}, {"variant": "tf32x3"}, {"variant": "simt"}):
            assert torch.equal(A.attention(q, k, v, **force), A.attention_reference(q, k, v))
        o, lse = A.attention_with_lse(q, k, v)
        assert torch.equal(o, A.attention_reference(q, k, v))
        assert torch.equal(lse, A.attention_lse_reference(q, k))
        assert all(torch.equal(x, y) for x, y in zip(
            A.attention_backward(q, k, v, o, g, lse),
            A.attention_backward_reference(q, k, v, o, g)))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        y = A.attention(*leaves)
        assert type(y.grad_fn).__name__ == "_AttentionBackward"
        grads = torch.autograd.grad(y, leaves, g)
        want = A.attention_backward_reference(q, k, v, A.attention_reference(q, k, v), g)
        assert all(torch.equal(x, y) for x, y in zip(grads, want))
    assert A.launches == A.backward_launches == 0
    assert not any(A.launches_by_variant.values())
    assert not any(A.backward_launches_by_variant.values())
    return {}


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.ops.attention import (  # noqa: E402
    attention_reference, flash_attention)


def _inputs(shape):
    bh, t, d = shape
    rng = np.random.default_rng(bh * 10000 + t * 10 + d)
    return {n: rng.normal(size=shape).astype(np.float32) for n in "qkvg"}


def _jax(a):
    """The JAX package's fp32 attention on `a`: Pallas in interpret mode and
    the einsum path, the rows' lse2, and (dq, dk, dv) by `jax.vjp` of the
    einsum path."""
    q, k, v, g = (jnp.asarray(a[n]) for n in "qkvg")
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = jnp.einsum("btc,bsc->bts", q * scale, k * scale)
    out, vjp = jax.vjp(attention_reference, q, k, v)
    return {"pallas": np.asarray(flash_attention(q, k, v, interpret=True)),
            "out": np.asarray(out), "lse": np.asarray(jax.nn.logsumexp(logits, axis=-1)) * LOG2E,
            **{f"d{n}": np.asarray(x) for n, x in zip("qkv", vjp(g))}}


def _rel(a, ref):
    """max|a - ref| / max|ref|; where ref is exactly 0 (dq and dk at T = 1),
    max|a|."""
    top = np.abs(ref).max()
    return float(np.abs(a - ref).max() / (top if top else 1.0))


def test_routes_send_the_fp32_flagship_to_tf32x3_and_forced_misfits_raise(tmp_path):
    child.run(__file__, "routes", tmp_path)


@pytest.mark.parametrize("shape", EMULATED, ids=IDS)
def test_tf32x3_emulations_match_pallas_and_jax_vjp(tmp_path, shape):
    a = _inputs(shape)
    pending = child.start(__file__, "emulations", tmp_path, **a)
    ref = _jax(a)
    out = pending.result()
    # the fp32 sides against each other: Pallas and the einsum path
    assert _rel(ref["pallas"], ref["out"]) <= TOL
    for name, val in out.items():
        if name == "lse":
            assert np.abs(val - ref["lse"]).max() <= TOL_LSE, np.abs(val - ref["lse"]).max()
            continue
        want = ref[name.split("_")[0]]
        assert val.shape == want.shape, name
        assert _rel(val, want) <= TOL, (name, _rel(val, want))
        if name == "out":
            assert _rel(val, ref["pallas"]) <= TOL, _rel(val, ref["pallas"])
    # the other key splits and chunks were emulated where the shape has them
    # (at (2, 256, 128) the backward takes 16-row chunks only)
    if shape[1] >= 64:
        assert any(n.startswith("out_split") for n in out), sorted(out)
    if shape[1] >= 64 and shape != (2, 256, 128):
        assert any("_chunk" in n for n in out), sorted(out)


@pytest.mark.parametrize("shape", FLAGSHIP, ids=[f"{bh}x{t}x{d}" for bh, t, d in FLAGSHIP])
def test_a_single_tf32_product_misses_fp32_accuracy(tmp_path, shape):
    a = _inputs(shape)
    pending = child.start(__file__, "single_tf32", tmp_path, **a)
    ref = _jax(a)
    out = pending.result()
    # the lo terms carry what fp32 keeps beyond TF32's 10 mantissa bits
    for name in ("out", "dq", "dk", "dv"):
        assert _rel(out[name], ref[name]) > TOL, (name, _rel(out[name], ref[name]))


def test_wrapper_on_cpu_takes_the_plain_versions_and_launches_nothing(tmp_path):
    rng = np.random.default_rng(18)
    a = {f"{i}_{n}": rng.normal(size=shape).astype(np.float32)
         for i, shape in enumerate([(8, 64, 64), (2, 37, 20)]) for n in "qkvg"}
    child.run(__file__, "wrapper_on_cpu", tmp_path, **a)
