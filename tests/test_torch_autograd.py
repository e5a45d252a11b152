"""Gradients through the port's two kernel modules against `jax.vjp`.

conv3x3: the autograd Function's input, weight and bias gradients on the
CPU (the input gradient is the conv of the output gradient with the
flipped, channel-swapped kernel) against `jax.vjp` of the JAX package's XLA
conv (`MatmulConv3x3` with threshold 0, fp32 at HIGHEST precision) and
against autograd of `conv3x3_reference`.  attention: the plain backward
`attention_backward_reference`, the CPU emulation of the CUDA backward's
tiling and the autograd Function against `jax.vjp` of the JAX package's
`attention_reference`, at ragged T and head widths up to 256.  Inputs and
cotangents come from numpy with a fixed seed; fp32 on both sides.

The torch half of each test runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

# (B, H, W, Cin, Cout): ragged map, Cin and Cout multiples of 64 (the tc
# shapes of the UNet), Cin = 1 (the stem), Cout = 1 (the final conv)
CONV_SHAPES = [(2, 8, 6, 16, 8), (1, 12, 20, 64, 64), (1, 8, 8, 1, 16), (1, 8, 8, 16, 1)]
# (B·heads, T, d): the path's d = 64 at T = 64, ragged T, d = 20, 128, 256, T = 1
ATTN_SHAPES = [(2, 64, 64), (3, 37, 20), (2, 100, 128), (2, 70, 256), (1, 1, 8)]
TOL = 1e-5      # of max|ref|: fp32 sums of up to 9·64 or T products in another order


def _conv_inputs(shape, rng):
    b, h, w, cin, cout = shape
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32),
            rng.normal(size=(b, h, w, cout)).astype(np.float32))


# ------------------------------------------------------------- torch halves
def conv_grads(**a):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    out = {}
    for i in range(len(CONV_SHAPES)):
        x, w, b, g = (torch.from_numpy(a[f"{i}_{n}"]) for n in ("x", "w", "b", "g"))
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = C.conv3x3(*leaves)
        assert type(y.grad_fn).__name__ == "_Conv3x3Backward"
        grads = torch.autograd.grad(y, leaves, g)
        ref_leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        ref = torch.autograd.grad(C.conv3x3_reference(*ref_leaves), ref_leaves, g)
        for name, got, want in zip(("x", "w", "b"), grads, ref):
            out[f"{i}_{name}"] = got.numpy()
            out[f"{i}_{name}_autograd"] = want.numpy()
        # a frozen weight: the input and bias gradients only, through the
        # swapped weight, made once and kept on the weight
        xf, bf = x.clone().requires_grad_(), b.clone().requires_grad_()
        gx, gb = torch.autograd.grad(C.conv3x3(xf, w, bf), (xf, bf), g)
        assert torch.equal(gx, grads[0]) and torch.equal(gb, grads[2])
        swapped = w._conv3x3_swapped[1]
        assert swapped.shape == (3, 3, w.shape[3], w.shape[2])
        assert C.swapped_weight(w) is swapped
        assert torch.equal(C.conv3x3_input_grad(g, w), gx)
    assert C.launches == 0 and C.backward_launches == 0           # no kernel ran
    # bf16: the gradients keep the dtypes of their inputs
    x, w, b, g = (torch.from_numpy(a[f"0_{n}"]) for n in ("x", "w", "b", "g"))
    xb = x.bfloat16().requires_grad_()
    bb = b.clone().requires_grad_()
    gx, gb = torch.autograd.grad(C.conv3x3(xb, w.bfloat16(), bb), (xb, bb), g.bfloat16())
    assert gx.dtype == torch.bfloat16 and gb.dtype == torch.float32
    return out


def attention_grads(**a):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    out = {}
    for i, (bh, t, d) in enumerate(ATTN_SHAPES):
        q, k, v, g = (torch.from_numpy(a[f"{i}_{n}"]) for n in ("q", "k", "v", "g"))
        o = A.attention_reference(q, k, v)
        plan = A.backward_plan(bh, t, d, torch.float32)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        y = A.attention(*leaves)
        assert type(y.grad_fn).__name__ == "_AttentionBackward"
        function = torch.autograd.grad(y, leaves, g)
        for kind, grads in (("plain", A.attention_backward_reference(q, k, v, o, g)),
                            ("tiled", A.attention_backward_tiled_reference(q, k, v, o, g, plan)),
                            ("function", function)):
            for name, grad in zip(("q", "k", "v"), grads):
                assert grad.dtype == torch.float32 and grad.shape == (bh, t, d)
                out[f"{i}_{kind}_{name}"] = grad.numpy()
    assert A.launches == 0 and A.backward_launches == 0           # no kernel ran
    with pytest.raises(ValueError, match="256"):
        A.attention_backward(*(torch.zeros(1, 4, 257) for _ in range(5)))
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.models.unet import MatmulConv3x3  # noqa: E402
from diffusion_models_dev_project_tpu.ops.attention import attention_reference  # noqa: E402


def _close(out, ref, what):
    assert out.shape == ref.shape, what
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max(), what


def test_conv3x3_gradients_match_jax_vjp(tmp_path):
    rng = np.random.default_rng(30)
    inputs, refs = {}, {}
    for i, shape in enumerate(CONV_SHAPES):
        x, w, b, g = _conv_inputs(shape, rng)
        inputs.update({f"{i}_x": x, f"{i}_w": w, f"{i}_b": b, f"{i}_g": g})
        conv = MatmulConv3x3(features=shape[-1], threshold=0,
                             precision=jax.lax.Precision.HIGHEST)

        def f(x, w, b, conv=conv):
            return conv.apply({"params": {"kernel": w, "bias": b}}, x)

        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, b)))
        refs[i] = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    out = child.run(__file__, "conv_grads", tmp_path, **inputs)
    for i, shape in enumerate(CONV_SHAPES):
        for name, ref in zip(("x", "w", "b"), refs[i]):
            _close(out[f"{i}_{name}"], ref, (shape, name))
            _close(out[f"{i}_{name}"], out[f"{i}_{name}_autograd"], (shape, name, "autograd"))


def test_attention_backward_and_its_emulation_match_jax_vjp(tmp_path):
    rng = np.random.default_rng(31)
    inputs, refs = {}, {}
    for i, shape in enumerate(ATTN_SHAPES):
        q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
        inputs.update({f"{i}_q": q, f"{i}_k": k, f"{i}_v": v, f"{i}_g": g})
        _, vjp = jax.vjp(attention_reference, *(jnp.asarray(a) for a in (q, k, v)))
        refs[i] = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    out = child.run(__file__, "attention_grads", tmp_path, **inputs)
    for i, shape in enumerate(ATTN_SHAPES):
        for kind in ("plain", "tiled", "function"):
            for name, ref in zip(("q", "k", "v"), refs[i]):
                if not np.abs(ref).max():        # T = 1: dq is exactly 0 on both sides
                    assert not np.abs(out[f"{i}_{kind}_{name}"]).max(), (shape, kind, name)
                    continue
                _close(out[f"{i}_{kind}_{name}"], ref, (shape, kind, name))
