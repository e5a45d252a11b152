"""The port's attention backward plan (`mma` or `simt`, chunk, grid), its CPU
emulation of the `mma` backward kernels, and the autograd Function on the CPU.

`backward_plan` is what the wrapper hands the CUDA kernels.
`attention_backward_mma_tiled_reference` carries out an `mma` plan step by
step in PyTorch: bf16 operands, lse2 from the emulation of the forward kernel
(`attention_tiled_reference(..., with_lse=True)`), P and dS rounded to bf16
where they feed a product, the 4 warps' partial sums added in warp order.  It
is held against `jax.vjp` of the JAX package's `attention_reference` on
bf16-representable inputs in fp32, within 1e-2 of max|ref|: the card's bf16
tolerance (chip_smoke.py `TOL`), since bf16 rounding of P, dS and the outputs
moves a result by 2^-9 of its size each.  The emulated lse2 is held against
JAX's logsumexp of the scaled logits, in log2, within 1e-5 (absolute; the
values are about 5 to 10, so fp32 sums in another order).  Inputs come from
numpy with a fixed seed.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.  On the CPU:
`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_attention_bwd_plan.py -q`.
"""
import math

import numpy as np
import pytest

import _torch_child as child

# (B·heads, T, d): the path's two shapes, ragged T with d = 20 (padded to
# 32), d = 128 over several chunks, T = 1
EMULATED = [(8, 256, 64), (8, 64, 64), (3, 37, 20), (2, 100, 128), (1, 1, 8)]
# the autograd Function on the CPU, fp32 and bf16
FUNCTION = [(2, 37, 20), (1, 1, 8), (2, 64, 64)]
TOL_BF16 = 1e-2     # of max|ref|, the card's bf16 tolerance
TOL_LSE = 1e-5      # absolute, on lse2 in log2 units
TOL_FP32 = 1e-5     # of max|ref|: fp32 sums of up to T products in another order
LOG2E = 1.4426950408889634


def _bf16(a):
    """fp32 -> the nearest bf16 value (round to nearest even), kept in fp32."""
    bits = a.astype(np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.view(np.float32)


# ------------------------------------------------------------- torch halves
def mma_emulation(**a):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    out = {}
    for i, (bh, t, d) in enumerate(EMULATED):
        q, k, v, g = (torch.from_numpy(a[f"{i}_{n}"]) for n in "qkvg")
        o, lse = A.attention_tiled_reference(q, k, v, A.plan(bh, t, d, torch.bfloat16),
                                             with_lse=True)
        p = A.backward_plan(bh, t, d, torch.bfloat16)
        assert p.variant == "mma"
        grads = A.attention_backward_mma_tiled_reference(q, k, v, o, g, lse, p)
        out[f"{i}_lse"] = lse.numpy()
        for name, grad in zip("qkv", grads):
            assert grad.dtype == torch.bfloat16 and grad.shape == (bh, t, d)
            out[f"{i}_d{name}"] = grad.float().numpy()
    with pytest.raises(ValueError, match="simt"):
        A.attention_backward_mma_tiled_reference(q, k, v, o, g, lse,
                                                 A.backward_plan(bh, t, d, torch.float32, "simt"))
    with pytest.raises(ValueError, match="mma"):
        A.attention_backward_tiled_reference(q, k, v, o, g, p)
    return out


def plan_routes_and_limits():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    bf16, fp32 = torch.bfloat16, torch.float32
    # the UNet's path: 3 calls at (8, 256, 64), 1 at (8, 64, 64); the
    # narrowest chunk that leaves each of the 4 warps at most one
    p = A.backward_plan(8, 256, 64, bf16)
    assert p == A.BackwardPlan("mma", 64, 64, 16, 4, 0, (16, 8))
    assert A.backward_plan(8, 256, 64, bf16) is p              # pure: the same plan
    assert A.backward_plan(8, 64, 64, bf16) == A.BackwardPlan("mma", 64, 16, 16, 4, 0, (4, 8))
    assert A.backward_plan(2, 100, 128, bf16).tile == 32
    assert A.backward_plan(3, 300, 128, bf16).tile == 32       # d > 64: at most 32
    assert A.backward_plan(8, 1024, 64, bf16).tile == 64
    assert A.backward_plan(3, 37, 20, bf16)[:2] == ("mma", 32)  # d padded to 32
    assert A.backward_plan(1, 1, 8, bf16) == A.BackwardPlan("mma", 16, 16, 16, 4, 0, (1, 1))
    assert A.backward_plan(8, 256, 64, bf16, tile=16).tile == 16
    # fp32 with d <= 128 goes to tf32x3 (tests/test_torch_attention_tf32x3.py),
    # and a forced simt still takes it; d > 128 goes to simt (its own layout)
    assert A.backward_plan(8, 256, 64, fp32).variant == A.backward_plan(1, 1, 8, fp32).variant \
        == "tf32x3"
    for args in ((8, 256, 64, fp32, "simt"), (8, 256, 160, bf16), (2, 64, 256, bf16),
                 (1, 1, 8, fp32, "simt")):
        assert A.backward_plan(*args).variant == "simt"
    assert A.backward_plan(8, 256, 64, fp32, "simt") == A.BackwardPlan("simt", 64, 32, 16, 1, 8,
                                                                       (16, 8))
    assert A.backward_plan(2, 64, 256, fp32)[1:4] == (256, 16, 8)
    assert A.backward_plan(8, 256, 64, bf16, "simt").variant == "simt"
    # past 256: simt in column chunks of 256, 8 rows a block; no head is
    # narrower than 1
    assert A.backward_plan(2, 64, 257, bf16) == A.BackwardPlan("simt", 512, 16, 8, 1, 16, (8, 2),
                                                               2)
    with pytest.raises(ValueError, match="head width"):
        A.backward_plan(2, 64, 0, bf16)
    # a forced choice that cannot take the shape raises
    for args, kw in (((8, 256, 64, fp32, "mma"), {}), ((8, 256, 160, bf16, "mma"), {}),
                     ((8, 256, 64, bf16, "wgmma"), {}), ((2, 100, 128, bf16), {"tile": 64}),
                     ((8, 256, 64, bf16), {"tile": 48}),
                     ((8, 256, 64, fp32, "simt"), {"tile": 16})):
        with pytest.raises(ValueError):
            A.backward_plan(*args, **kw)
    # off the CPU, mma needs the forward's lse2 and never recomputes it: on
    # the meta device the wrapper raises for it before it looks for CUDA
    m = torch.zeros(2, 37, 20, dtype=bf16, device="meta")
    with pytest.raises(ValueError, match="lse2"):
        A.attention_backward(m, m, m, m, m)
    with pytest.raises(ValueError, match="lse2"):
        A.attention_backward(m, m, m, m, m, torch.zeros(2, 36, device="meta"))
    with pytest.raises(ValueError, match="not on CUDA"):
        A.attention_backward(m, m, m, m, m, torch.zeros(2, 37, device="meta"))
    with pytest.raises(ValueError, match="not on CUDA"):        # simt takes no lse2
        A.attention_backward(m, m, m, m, m, variant="simt")


def function_on_cpu(**a):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    A.launches = A.backward_launches = 0
    A.launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    A.backward_launches_by_variant = dict.fromkeys(A.VARIANTS, 0)
    out = {}
    for i, (bh, t, d) in enumerate(FUNCTION):
        q, k, v, g = (torch.from_numpy(a[f"{i}_{n}"]) for n in "qkvg")
        for dtype in (torch.float32, torch.bfloat16):
            leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
            y = A.attention(*leaves)
            assert type(y.grad_fn).__name__ == "_AttentionBackward"
            grads = torch.autograd.grad(y, leaves, g.to(dtype))
            qd, kd, vd = (x.detach() for x in leaves)
            want = A.attention_backward_reference(qd, kd, vd, A.attention_reference(qd, kd, vd),
                                                  g.to(dtype))
            for name, got, ref in zip("qkv", grads, want):
                assert got.dtype == dtype and torch.equal(got, ref), (i, dtype, name)
                if dtype == torch.float32:
                    out[f"{i}_d{name}"] = got.numpy()
            o, lse = A.attention_with_lse(qd, kd, vd)
            assert torch.equal(o, A.attention_reference(qd, kd, vd))
            assert torch.equal(lse, A.attention_lse_reference(qd, kd))
    # no kernel ran, forward or backward
    assert A.launches == 0 and A.backward_launches == 0
    assert set(A.launches_by_variant.values()) == set(A.backward_launches_by_variant.values()) == {0}
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.ops.attention import attention_reference  # noqa: E402


def _vjp(q, k, v, g):
    _, vjp = jax.vjp(attention_reference, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(r) for r in vjp(jnp.asarray(g))]


def _close(out, ref, tol, what):
    assert out.shape == ref.shape, what
    if not np.abs(ref).max():               # T = 1: dq and dk are exactly 0 in the reference
        assert np.abs(out).max() <= tol, what
        return
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), what


def test_mma_backward_emulation_and_lse_match_jax(tmp_path):
    rng = np.random.default_rng(40)
    inputs, refs = {}, {}
    for i, shape in enumerate(EMULATED):
        # bf16-representable fp32 inputs and cotangent (rounded with numpy)
        q, k, v, g = (_bf16(rng.normal(size=shape).astype(np.float32)) for _ in range(4))
        inputs.update({f"{i}_q": q, f"{i}_k": k, f"{i}_v": v, f"{i}_g": g})
    pending = child.start(__file__, "mma_emulation", tmp_path, **inputs)
    for i, shape in enumerate(EMULATED):
        q, k, v, g = (inputs[f"{i}_{n}"] for n in "qkvg")
        scale = 1.0 / math.sqrt(math.sqrt(shape[-1]))
        logits = jnp.einsum("btc,bsc->bts", jnp.asarray(q) * scale, jnp.asarray(k) * scale)
        refs[i] = _vjp(q, k, v, g) + [np.asarray(jax.nn.logsumexp(logits, axis=-1)) * LOG2E]
    out = pending.result()
    for i, shape in enumerate(EMULATED):
        for name, ref in zip(("dq", "dk", "dv"), refs[i]):
            _close(out[f"{i}_{name}"], ref, TOL_BF16, (shape, name))
        assert np.abs(out[f"{i}_lse"] - refs[i][3]).max() <= TOL_LSE, shape


def test_backward_plan_routes_mma_and_simt_and_raises(tmp_path):
    child.run(__file__, "plan_routes_and_limits", tmp_path)


def test_autograd_function_on_cpu_runs_the_plain_backward_and_launches_nothing(tmp_path):
    rng = np.random.default_rng(41)
    inputs = {}
    for i, shape in enumerate(FUNCTION):
        for n in "qkvg":
            inputs[f"{i}_{n}"] = rng.normal(size=shape).astype(np.float32)
    pending = child.start(__file__, "function_on_cpu", tmp_path, **inputs)
    refs = {i: _vjp(*(inputs[f"{i}_{n}"] for n in "qkvg")) for i in range(len(FUNCTION))}
    out = pending.result()
    for i, shape in enumerate(FUNCTION):
        for name, ref in zip(("dq", "dk", "dv"), refs[i]):
            _close(out[f"{i}_{name}"], ref, TOL_FP32, (shape, name))
