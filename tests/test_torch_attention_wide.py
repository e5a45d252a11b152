"""The port's attention at head widths past 128 against the JAX package.

The JAX `flash_attention` takes any d (it zero-pads d to a multiple of 8);
the port's tensor-core kernels take d past 128 in column chunks (`mma` in
bf16, `tf32x3` in fp32, a third grid axis over the chunks: 128 or 256
output columns in the forward, 128 in the backward; q and k streamed in
slices of 64 columns).

- `plan` and `backward_plan` at d = 136, 192, 256, 300 and 512, B·heads 4
  and 8, fp32 and bf16: `mma` / `tf32x3` with their column chunks, padded
  heads, grids, splits and stages as timed on the card; the forced `simt`
  plans as before (column chunks of 256 past 256);
- on the CPU the port's attention at (2, 64, 192) and (2, 64, 300) against
  JAX's `flash_attention` (interpret mode, as the JAX package's own tests
  run it), and its gradient through the autograd Function against
  `jax.vjp` of the JAX `attention_reference`, within 1e-5 in fp32 (of
  max|JAX|); the chunked `tf32x3` emulations (forward with its lse2,
  backward) and the forced `simt` plan's emulation within as much.  No
  kernel launches on the CPU;
- the chunked emulations of both dtypes (`attention_tiled_reference`,
  `attention_tf32x3_tiled_reference`, `attention_backward_mma_tiled_reference`,
  `attention_backward_tf32x3_tiled_reference`) against the port's plain
  twins at those shapes and at ragged T (the forward in chunks of 128 and
  of 256 columns): fp32 within 1e-5 of max|plain|,
  bf16 within 1e-2 (the card's bf16 tolerance: P and dS rounded to bf16
  where they feed a product), lse2 within 1e-5 absolute (log2 units).

The kernels themselves run on the card only (`chip_smoke.py` phase 3 holds
them to the plain version at d = 136 to 512, phase 5b runs a UNet through
them).  The torch half runs in a child interpreter (tests/_torch_child.py):
no pytest process runs torch code.
"""
import numpy as np
import pytest

import _torch_child as child

TOL = 1e-5
TOL_BF16 = 1e-2
TOL_LSE = 1e-5
WIDTHS = (136, 192, 256, 300, 512)
# the emulations against the plain twins: the JAX shapes, ragged T over
# several key tiles and chunks, a last slice of 8 columns (d = 136), T = 1
TWINS = [(2, 64, 192), (2, 64, 300), (2, 37, 300), (3, 100, 136), (1, 1, 200)]


def _bf16(a):
    """fp32 -> the nearest bf16 value (round to nearest even), kept in fp32."""
    bits = a.astype(np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.view(np.float32)


# ------------------------------------------------------------- torch halves
def plans(**_):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    out = {}
    for bh in (4, 8):
        for d in WIDTHS:
            for dt in (torch.float32, torch.bfloat16):
                name = f"{bh}_{d}_{str(dt).split('.')[-1]}"
                for tag, variant in (("", None), ("simt_", "simt")):
                    p = A.plan(bh, 256, d, dt, variant)
                    bp = A.backward_plan(bh, 256, d, dt, variant)
                    out[f"{name}_{tag}plan"] = np.array(
                        [p.variant, p.warps, p.key_splits, p.key_tile, p.d_pad, *p.grid, p.chunks,
                         p.stages, p.chunk_cols], dtype=object).astype(str)
                    out[f"{name}_{tag}bplan"] = np.array(
                        [bp.variant, bp.d_pad, bp.tile, bp.rows, bp.splits, bp.channels, *bp.grid,
                         bp.chunks, bp.stages], dtype=object).astype(str)
    return out


def cpu_attention(q, k, v, g):
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    A.launches = A.backward_launches = A.wide_launches = A.wide_backward_launches = 0
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y = A.attention(*leaves)
    assert type(y.grad_fn).__name__ == "_AttentionBackward"
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    o = A.attention_reference(qt, kt, vt)
    p, bp = A.plan(*q.shape, torch.float32), A.backward_plan(*q.shape, torch.float32)
    assert p.variant == bp.variant == "tf32x3" and bp.chunks > 1
    emu, lse = A.attention_tf32x3_tiled_reference(qt, kt, vt, p, with_lse=True)
    emu_grads = A.attention_backward_tf32x3_tiled_reference(qt, kt, vt, o, gt, lse, bp)
    simt = A.attention_backward_tiled_reference(
        qt, kt, vt, o, gt, A.backward_plan(*q.shape, torch.float32, "simt"))
    assert A.launches == A.backward_launches == 0                 # no kernel ran
    assert A.wide_launches == A.wide_backward_launches == 0
    out = {"out": y.detach().numpy(), "emu_out": emu.numpy(), "emu_lse": lse.numpy()}
    out.update({f"d{n}": a.numpy() for n, a in zip("qkv", grads)})
    out.update({f"emu_d{n}": a.numpy() for n, a in zip("qkv", emu_grads)})
    out.update({f"simt_d{n}": a.numpy() for n, a in zip("qkv", simt)})
    return out


def emulations_and_twins(q, k, v, g):
    """The chunked emulations of both dtypes and the plain twins on the same
    inputs (bf16: the inputs rounded to bf16 on both sides)."""
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        qt, kt, vt, gt = (torch.from_numpy(a).to(dt) for a in (q, k, v, g))
        p, bp = A.plan(*q.shape, dt), A.backward_plan(*q.shape, dt)
        assert p.chunks == -(-p.d_pad // p.chunk_cols) and bp.chunks == -(-bp.d_pad // 128) > 1
        fwd = (A.attention_tf32x3_tiled_reference if dt == torch.float32
               else A.attention_tiled_reference)
        bwd = (A.attention_backward_tf32x3_tiled_reference if dt == torch.float32
               else A.attention_backward_mma_tiled_reference)
        emu, lse = fwd(qt, kt, vt, p, with_lse=True)
        o = A.attention_reference(qt, kt, vt)
        assert emu.dtype == o.dtype == dt and emu.shape == o.shape == qt.shape
        out[f"{name}_emu_out"], out[f"{name}_out"] = emu.float().numpy(), o.float().numpy()
        # the forward's other column chunk, 256 wide (the plans take it on
        # larger grids): the same rows' statistics in every chunk
        wide = p._replace(chunk_cols=256, chunks=-(-p.d_pad // 256))
        emu256, lse256 = fwd(qt, kt, vt, wide, with_lse=True)
        out[f"{name}_emu256_out"], out[f"{name}_emu256_lse"] = emu256.float().numpy(), lse256.numpy()
        out[f"{name}_emu_lse"] = lse.numpy()
        out[f"{name}_lse"] = A.attention_lse_reference(qt, kt).numpy()
        for n, e, r in zip("qkv", bwd(qt, kt, vt, o, gt, lse, bp),
                           A.attention_backward_reference(qt, kt, vt, o, gt)):
            assert e.dtype == r.dtype == dt
            out[f"{name}_emu_d{n}"], out[f"{name}_d{n}"] = e.float().numpy(), r.float().numpy()
    return out


if __name__ == "__main__":
    child.main(globals())

# ------------------------------------------------------------- JAX halves
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffusion_models_dev_project_tpu.ops.attention import (attention_reference,  # noqa: E402
                                                            flash_attention)


def _plans(tmp_path):
    return {key: a.tolist() for key, a in child.run(__file__, "plans", tmp_path).items()}


# (output columns a block, key splits, ring stages) of the forward and
# (chunk, stages) of the backward at (B·heads, 256, d), as timed on the card
# (PERF.md section 6, PR 19): 4 splits while the grid is small; 256 columns
# where 4 chunks of 128 would pass one wave (d = 512); 2 splits once the
# grid passes two waves (B·heads 8, d = 300); two stages while the grid fits
# one wave or two such blocks fit an SM (the bf16 backward always, the fp32
# backward's 32-row chunks only in one wave)
WANT = {(4, 136): ((128, 4, 2), (32, 2), (32, 2)), (4, 192): ((128, 4, 2), (32, 2), (32, 2)),
        (4, 256): ((128, 4, 2), (32, 2), (32, 2)), (4, 300): ((128, 4, 1), (32, 1), (32, 2)),
        (4, 512): ((256, 4, 2), (32, 1), (32, 2)), (8, 136): ((128, 4, 1), (32, 1), (32, 2)),
        (8, 192): ((128, 4, 1), (32, 1), (32, 2)), (8, 256): ((128, 4, 1), (32, 1), (32, 2)),
        (8, 300): ((128, 2, 2), (32, 1), (32, 2)), (8, 512): ((256, 4, 1), (32, 1), (32, 2))}


def _want(bh, d, dt):
    """The tensor-core plans at (bh, 256, d): `WANT`'s blocking, the head
    padded to a multiple of 16 (bf16) or 8 (fp32), the forward in
    ceil(d_pad / columns) chunks, the backward in ceil(d_pad / 128)."""
    (cols, splits, stages), b32, b16 = WANT[bh, d]
    tile, b_stages = b32 if dt == "float32" else b16
    variant, key_tile, width = ("mma", 64, 16) if dt == "bfloat16" else ("tf32x3", 32, 8)
    d_pad = -(-d // width) * width
    return ([variant, 4, splits, key_tile, d_pad, 256 * splits // 64, bh, -(-d_pad // cols),
             stages, cols],
            [variant, d_pad, tile, 16, 4, 0, 16, bh, -(-d_pad // 128), b_stages])


def test_plans_take_heads_past_256_in_chunks(tmp_path):
    out = _plans(tmp_path)
    for bh in (4, 8):
        for d in (300, 512):
            for dt in ("float32", "bfloat16"):
                plan, bplan = _want(bh, d, dt)
                assert out[f"{bh}_{d}_{dt}_plan"] == [str(x) for x in plan], (bh, d, dt)
                assert out[f"{bh}_{d}_{dt}_bplan"] == [str(x) for x in bplan], (bh, d, dt)
    # (4, 256, 300): 3 chunks of 128, 192 blocks, one stage; d = 512: 2 chunks
    # of 256, 128 blocks, two stages (v staged 128 columns at a time); the
    # backward in 4 chunks of 128
    assert out["4_300_bfloat16_plan"][4:] == ["304", "16", "4", "3", "1", "128"]
    assert out["4_512_float32_plan"][4:] == ["512", "16", "4", "2", "2", "256"]
    assert out["8_512_float32_bplan"][1:] == ["512", "32", "16", "4", "0", "16", "8", "4", "1"]


def test_plans_take_heads_from_129_to_256_to_the_tensor_cores(tmp_path):
    out = _plans(tmp_path)
    for bh in (4, 8):
        for d in (136, 192, 256):
            for dt in ("float32", "bfloat16"):
                plan, bplan = _want(bh, d, dt)
                assert out[f"{bh}_{d}_{dt}_plan"] == [str(x) for x in plan], (bh, d, dt)
                assert out[f"{bh}_{d}_{dt}_bplan"] == [str(x) for x in bplan], (bh, d, dt)
    # d = 136: 144 columns in bf16 (16-wide slices), 136 in fp32, 2 chunks;
    # at B·heads 4, 128 blocks fit the card's 132 SMs: two stages
    assert out["4_136_bfloat16_plan"] == ["mma", "4", "4", "64", "144", "16", "4", "2", "2",
                                          "128"]
    assert out["4_136_float32_plan"] == ["tf32x3", "4", "4", "32", "136", "16", "4", "2", "2",
                                         "128"]


def test_forced_simt_plans_as_before(tmp_path):
    out = _plans(tmp_path)
    for bh in (4, 8):
        for dt in ("float32", "bfloat16"):
            for d in (136, 192, 256):
                # one pass: 8 warps over 64 query rows, key tiles of 16
                assert out[f"{bh}_{d}_{dt}_simt_plan"][:8] == ["simt", "8", "1", "16", "256", "4",
                                                               str(bh), "1"], (bh, d, dt)
            for d in (300, 512):
                # 2 chunks of 256; backward 16 threads a row of a chunk, 8 rows a block
                assert out[f"{bh}_{d}_{dt}_simt_plan"][:8] == ["simt", "8", "1", "16", "512", "4",
                                                               str(bh), "2"], (bh, d, dt)
                assert out[f"{bh}_{d}_{dt}_simt_bplan"][:9] == ["simt", "512", "16", "8", "1",
                                                                "16", "32", str(bh), "2"]


def _match_jax(tmp_path, shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    pending = child.start(__file__, "cpu_attention", tmp_path, q=q, k=k, v=v, g=g)
    ref = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    _, vjp = jax.vjp(attention_reference, *(jnp.asarray(a) for a in (q, k, v)))
    grads = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    scale = 1.0 / np.sqrt(np.sqrt(shape[-1]))
    logits = jnp.einsum("btc,bsc->bts", jnp.asarray(q) * scale, jnp.asarray(k) * scale)
    lse = np.asarray(jax.nn.logsumexp(logits, axis=-1)) / np.log(2.0)
    out = pending.result()
    for key in ("out", "emu_out"):
        assert np.abs(out[key] - ref).max() <= TOL * np.abs(ref).max(), key
    assert np.abs(out["emu_lse"] - lse).max() <= TOL_LSE
    for name, want in zip(("dq", "dk", "dv"), grads):
        for key in (name, f"emu_{name}", f"simt_{name}"):
            assert out[key].shape == shape and np.isfinite(out[key]).all()
            assert np.abs(out[key] - want).max() <= TOL * np.abs(want).max(), key


def test_attention_and_its_gradient_at_d_300_match_jax(tmp_path):
    _match_jax(tmp_path, (2, 64, 300), 7)


def test_attention_and_its_gradient_at_d_192_match_jax(tmp_path):
    _match_jax(tmp_path, (2, 64, 192), 8)


@pytest.mark.parametrize("shape", TWINS, ids=[f"{b}x{t}x{d}" for b, t, d in TWINS])
def test_chunked_emulations_match_the_plain_twins(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    q, k, v, g = (_bf16(rng.normal(size=shape).astype(np.float32)) for _ in range(4))
    out = child.run(__file__, "emulations_and_twins", tmp_path, q=q, k=k, v=v, g=g)
    for dt, tol in (("float32", TOL), ("bfloat16", TOL_BF16)):
        for lse in ("emu_lse", "emu256_lse"):
            assert np.abs(out[f"{dt}_{lse}"] - out[f"{dt}_lse"]).max() <= TOL_LSE, (dt, lse)
        for key, ref in (("emu_out", "out"), ("emu256_out", "out"), ("emu_dq", "dq"),
                         ("emu_dk", "dk"), ("emu_dv", "dv")):
            got, want = out[f"{dt}_{key}"], out[f"{dt}_{ref}"]
            assert got.shape == shape and np.isfinite(got).all(), (dt, key)
            # T = 1: dq and dk are 0 in exact arithmetic, rounding noise here
            scale = np.abs(want).max() if shape[1] > 1 or ref in ("out", "dv") else 1.0
            assert np.abs(got - want).max() <= tol * scale, (dt, key)
