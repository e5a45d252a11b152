"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` is compiled for `sm_90a` (one nvcc per source, all started
together) and linked into one shared library under `build/torch_kernels/`
at the repository root.  The library's name carries a hash of the sources
(the `*.cuh` headers they include too) and flags, so a changed source
builds anew and an unchanged one is loaded as it is.  Each source exports plain `extern "C"` functions; this module
declares their argument types (every pointer and the stream as
`c_void_p`: a pointer passed as a plain int would be cut to 32 bits).

Nothing here runs at import: the first kernel launch calls `library()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "check", "library", "sources"]

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported symbol -> argument types; every function returns a cudaError_t (or
# minus a CUresult, see csrc/errors.cu)
_SIGNATURES = {
    # x, w, bias, out, B, H, W, Cin, Cout, bias_stride (0: one bias; Cout: one
    # per image), is_bf16, stream
    "conv3x3_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "conv3x3_narrow_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, w, bias, out, workspace, B, H, W, Cin, Cout, bias_stride, box_h, box_w,
    # bm, splits, steps_per_split, stream
    "conv3x3_tc_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # the same for the fp32 tf32x3 variant, its kernel the split (2,3,3,Cout,Cin)
    "conv3x3_tf32x3_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P),
    # w (3,3,Cin,Cout), out (2,3,3,N,K), Cin, Cout, flip (1: the input gradient's), stream
    "conv3x3_tf32x3_split_weight": (_P, _P, _I, _I, _I, _P),
    # x, dy, dw, workspace, B, H, W, Cin, Cout, box_h, box_w, splits, cluster, stream
    "conv3x3_wgrad_tc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # cluster size, out: the most clusters of the tc weight-gradient kernel at once
    "conv3x3_wgrad_tc_max_clusters": (_I, ctypes.POINTER(_I)),
    # x, dy, dw, workspace, B, H, W, Cin, Cout, splits, steps_per_split, stream
    "conv3x3_wgrad_mma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "conv3x3_wgrad_tf32x3": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, dy, dw, workspace, B, H, W, Cin, Cout, is_bf16, out_side, box_h, box_w, splits, stream
    "conv3x3_wgrad_narrow": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, dy, dw, workspace, B, H, W, Cin, Cout, is_bf16, splits, steps_per_split, stream
    "conv3x3_wgrad_simt": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # workspace, dw, n, splits, stream: dw = the splits' partials added in order
    "conv3x3_wgrad_reduce": (_P, _P, ctypes.c_longlong, _I, _P),
    # q, k, v, out, BH, T, D, scale, is_bf16, stream
    "attention_forward": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, v, out, lse (or null), BH, T, D, scale_log2, splits, stream
    "attention_mma_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # the same for the fp32 tf32x3 variant, and its shared-memory stages
    "attention_tf32x3_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, out, dout, dq, dk, dv, workspace, BH, T, D, scale, is_bf16, stream
    "attention_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, v, out, dout, lse, dq, dk, dv, workspace, BH, T, D, scale_log2, scale,
    # tile, stream
    "attention_mma_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                               _P),
    # the same for the fp32 tf32x3 variant, and its shared-memory stages
    "attention_tf32x3_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                                  _I, _P),
    # heads past 128 (column chunks): q, k, v, out, lse (or null), BH, T, D,
    # scale_log2, splits, stages, chunk (output columns a block), stream; and
    # the backward's arguments with its stages
    "attention_mma_wide_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P),
    "attention_tf32x3_wide_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P),
    "attention_mma_wide_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                    _I, _I, _P),
    "attention_tf32x3_wide_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                       _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of the last build (registers, spills)
build_seconds = 0.0     # wall time of the last build; 0 when it was cached


def sources():
    return sorted((_PKG / "csrc").glob("*.cu"))


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_log, build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_PKG / 'csrc'}")
    out = BUILD_DIR / f"libtorch_kernels_{_digest()}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = []
    for s, p in zip(srcs, procs):
        text, _ = p.communicate()
        logs.append(f"== {s.name} (rc {p.returncode})\n{text}")
    log = "\n".join(logs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    build_log = log + link.stdout
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = (ctypes.c_int,)
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C function returned a CUDA error."""
    if rc != 0:
        text = library().kernels_error_string(rc).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc} ({text})")
