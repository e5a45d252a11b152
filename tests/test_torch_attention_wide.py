"""The port's attention at head widths past 256 against the JAX package.

The JAX `flash_attention` takes any d (it zero-pads d to a multiple of 8);
the port's kernels take d past `MAX_HEAD_DIM` = 256 in column chunks of 256
(`simt`, forward and backward, a third grid axis over the chunks).

- `plan` and `backward_plan` at d = 300 and 512, fp32 and bf16: `simt` in
  2 chunks, the head padded to 512, the grids of the kernels;
- on the CPU the port's attention at (2, 64, 300) against JAX's
  `flash_attention` (interpret mode, as the JAX package's own tests run
  it), and its gradient through the autograd Function against `jax.grad`
  of the JAX `attention_reference`, within 1e-5 in fp32 (of max|JAX|);
  `attention_backward_tiled_reference` on the chunked plan within as much.
  No kernel launches on the CPU.

The kernels themselves run on the card only (`chip_smoke.py` phase 3 holds
them to the plain version at d = 320 and 512).  The torch half runs in a
child interpreter (tests/_torch_child.py): no pytest process runs torch
code.
"""
import numpy as np

import _torch_child as child

SHAPE = (2, 64, 300)
TOL = 1e-5


# ------------------------------------------------------------- torch halves
def plans(**_):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    out = {}
    for d in (300, 512):
        for dt in (torch.float32, torch.bfloat16):
            p, bp = A.plan(8, 256, d, dt), A.backward_plan(8, 256, d, dt)
            name = f"{d}_{str(dt).split('.')[-1]}"
            out[f"{name}_plan"] = np.array([p.variant, p.warps, p.key_splits, p.key_tile,
                                            p.d_pad, *p.grid, p.chunks], dtype=object).astype(str)
            out[f"{name}_bplan"] = np.array([bp.variant, bp.d_pad, bp.tile, bp.rows, bp.splits,
                                             bp.channels, *bp.grid, bp.chunks],
                                            dtype=object).astype(str)
    return out


def cpu_attention(q, k, v, g):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    A.launches = A.backward_launches = 0
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y = A.attention(*leaves)
    assert type(y.grad_fn).__name__ == "_AttentionBackward"
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    o = A.attention_reference(qt, kt, vt)
    tiled = A.attention_backward_tiled_reference(qt, kt, vt, o, gt,
                                                 A.backward_plan(*q.shape, torch.float32))
    assert A.launches == 0 and A.backward_launches == 0          # no kernel ran
    out = {"out": y.detach().numpy()}
    out.update({f"d{n}": a.numpy() for n, a in zip("qkv", grads)})
    out.update({f"tiled_d{n}": a.numpy() for n, a in zip("qkv", tiled)})
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.ops.attention import (attention_reference,  # noqa: E402
                                                            flash_attention)


def test_plans_take_heads_past_256_in_chunks(tmp_path):
    out = child.run(__file__, "plans", tmp_path)
    for d in (300, 512):
        for dt in ("float32", "bfloat16"):
            # simt, 8 warps over 64 query rows, key tiles of 16, 2 chunks of 256
            assert out[f"{d}_{dt}_plan"].tolist() == ["simt", "8", "1", "16", "512", "4", "8",
                                                      "2"], (d, dt)
            # 16 threads a row of a chunk, 8 rows a block, tiles of 16
            assert out[f"{d}_{dt}_bplan"].tolist() == ["simt", "512", "16", "8", "1", "16", "32",
                                                       "8", "2"], (d, dt)


def test_attention_and_its_gradient_at_d_300_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(4))
    pending = child.start(__file__, "cpu_attention", tmp_path, q=q, k=k, v=v, g=g)
    ref = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    _, vjp = jax.vjp(attention_reference, *(jnp.asarray(a) for a in (q, k, v)))
    grads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    out = pending.result()
    assert np.abs(out["out"] - ref).max() <= TOL * np.abs(ref).max()
    for name, want in zip(("dq", "dk", "dv"), grads):
        for key in (name, f"tiled_{name}"):
            assert out[key].shape == SHAPE and np.isfinite(out[key]).all()
            assert np.abs(out[key] - want).max() <= TOL * np.abs(want).max(), key
