"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are checked against those versions on the card by chip_smoke.py).
The Pallas kernels run as the JAX package's own tests run them: conv3x3
under `force_tpu_interpret_mode`, attention with `interpret=True`.  Inputs
come from numpy with a fixed seed; both sides compute in fp32.

torch and the port are imported inside the tests, never at collection:
a JAX worker process that has imported torch can deadlock in the JAX
package's eager Pallas-interpret test (tests/test_conv3x3.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from diffusion_models_dev_project_tpu.ops.attention import flash_attention
from diffusion_models_dev_project_tpu.ops.conv3x3 import conv3x3_same

# the three shapes of tests/test_conv3x3.py, then Cin = 1 and Cout = 1
CONV_SHAPES = [(1, 32, 32, 8, 16), (2, 64, 16, 16, 8), (1, 16, 48, 32, 32),
               (2, 16, 16, 1, 8), (1, 16, 24, 8, 1)]
# the path's (T, d) at 16² and 8², and ragged T / odd d (padded in Pallas)
ATTN_SHAPES = [(256, 64), (64, 64), (300, 64), (100, 20)]


def _conv_inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    return x, k, bias


def test_conv3x3_and_attention_plain_versions_match_pallas():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    for shape in CONV_SHAPES:
        x, k, bias = _conv_inputs(shape)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(conv3x3_same(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                          tile_h=8))
        out = C.conv3x3(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias))
        # fp32 sums of up to 9*32 products in another order: a few ulps
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5, err_msg=str(shape))
    rng = np.random.default_rng(1)
    for t, d in ATTN_SHAPES:
        q, k, v = (rng.normal(size=(3, t, d)).astype(np.float32) for _ in range(3))
        ref = np.asarray(flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
        out = A.attention(*(torch.from_numpy(a) for a in (q, k, v)))
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5, err_msg=str((t, d)))


def test_wrappers_on_cpu_tensors_run_the_plain_version_and_check_inputs():
    import torch

    from diffusion_models_dev_project_tpu_torch.ops import attention as A
    from diffusion_models_dev_project_tpu_torch.ops import conv3x3 as C

    x, k, bias = (torch.from_numpy(a) for a in _conv_inputs((1, 8, 8, 4, 6)))
    q = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 10, 8)).astype(np.float32))
    C.launches = A.launches = 0
    torch.testing.assert_close(C.conv3x3(x, k, bias), C.conv3x3_reference(x, k, bias),
                               rtol=0, atol=0)
    torch.testing.assert_close(A.attention(q, q, q), A.attention_reference(q, q, q),
                               rtol=0, atol=0)
    assert C.launches == 0 and A.launches == 0        # no kernel ran
    # the plain versions keep the input dtype
    out = C.conv3x3(x.bfloat16(), k.bfloat16(), bias)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 8, 8, 6)
    assert A.attention(q.bfloat16(), q.bfloat16(), q.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        C.conv3x3(x, torch.zeros(3, 3, 5, 6), bias)
    with pytest.raises(ValueError):
        C.conv3x3(x, k, torch.zeros(5))
    with pytest.raises(ValueError):
        A.attention(q, q[:, :5], q)


def test_build_lists_sources_and_needs_nvcc(monkeypatch, tmp_path):
    from diffusion_models_dev_project_tpu_torch.ops import _build

    names = [s.name for s in _build.sources()]
    assert {"conv3x3.cu", "attention.cu"} <= set(names)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()
