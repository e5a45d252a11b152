"""PyTorch/CUDA port of `diffusion_models_dev_project_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; this package imports
nothing of it and nothing of JAX.  Sub-packages carry the same names as the
JAX package's, so every module has an obvious counterpart.  The two Pallas
TPU kernels of the reference are hand-written CUDA here (`csrc/`, built by
`ops/_build.py` with nvcc and loaded with ctypes); everything else is plain
PyTorch.

Entry points (`factory.py`) run on `cuda` unless the caller passes
`device="cpu"`, and raise when neither is possible.  Public tensors keep the
JAX layouts: NHWC images, HWIO conv weights, (B·heads, T, d) attention.
"""

__version__ = "0.1.0"
