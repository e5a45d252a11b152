"""ctypes bridge to the native system-matrix assembler (`native/projector.cpp`).

Port of `physics/native.py` of the JAX package, with two differences:

- the library is built at first use, from the repository's own source, with
  the flags of `scripts/build_native.sh`, into `build/native/` at the
  repository root.  Its name carries a hash of the source, the flags and the
  host's CPU (`-march=native` code runs only where it was built), and it is
  written under a temporary name and renamed, so that processes building at
  once never load a half-written file.  `native/libprojector.so`, the path
  the JAX package loads, is never written;
- there is no silent fallback: a failed build raises with the compiler's
  output.  The numpy bodies (`geometry.joseph_system_matrix_plain`,
  `cone_beam.masked_slice_matrix_plain`) are the plain twins that tests and
  `chip_smoke.py` hold the library against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["SOURCE", "BUILD_DIR", "CXX_FLAGS", "build", "load_library", "native_joseph_coo",
           "native_cone_slice_coo"]

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "native" / "projector.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_id() -> str:
    """What `-march=native` compiles for: the machine and its CPU's flags."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            info = [ln for ln in f if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        info = []
    return platform.machine() + "".join(info)


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"native assembler source missing: {SOURCE}")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_id().encode())
    out = BUILD_DIR / f"libprojector-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
    res = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (rc {res.returncode}):\n{res.stdout}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded assembler, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, f64 = ctypes.c_int64, ctypes.c_double
            p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.joseph_parallel_coo.restype = i64
            lib.joseph_parallel_coo.argtypes = [p_f64, i64, i64, i64, i64, f64, ctypes.c_int,
                                                p_i64, p_i64, p_f32, i64]
            lib.cone_slice_coo.restype = i64
            lib.cone_slice_coo.argtypes = [p_f64, p_f64, i64, i64, i64, i64, f64, i64,
                                           ctypes.c_int, p_i64, p_i64, p_f32, i64]
            _lib = lib
        return _lib


def _nthreads() -> int:
    return max(1, (os.cpu_count() or 1) - 1)


def native_joseph_coo(angles: np.ndarray, H: int, W: int, D: int, det_spacing: float):
    """(rows, cols, vals) of the 2D parallel-beam Joseph matrix."""
    lib = load_library()
    angles = np.ascontiguousarray(angles, np.float64)
    cap = int(len(angles) * D * (2 * max(H, W) + 4))
    rows, cols = np.empty(cap, np.int64), np.empty(cap, np.int64)
    vals = np.empty(cap, np.float32)
    n = lib.joseph_parallel_coo(angles, len(angles), H, W, D, float(det_spacing), _nthreads(),
                                rows, cols, vals, cap)
    if n < 0:
        raise RuntimeError("native Joseph COO: capacity exceeded")
    return rows[:n], cols[:n], vals[:n]


def native_cone_slice_coo(src: np.ndarray, det: np.ndarray, vol_shape, vox: float, n_steps: int):
    """(rows, cols, vals) of the masked single-slice cone-beam matrix, one
    ray per row of `src`/`det` (world xyz)."""
    lib = load_library()
    nz, ny, nx = vol_shape
    src = np.ascontiguousarray(src, np.float64)
    det = np.ascontiguousarray(det, np.float64)
    n_rays = src.shape[0]
    cap = int(n_rays * min(ny * nx, 6 * n_steps))
    rows, cols = np.empty(cap, np.int64), np.empty(cap, np.int64)
    vals = np.empty(cap, np.float32)
    n = lib.cone_slice_coo(src, det, n_rays, nz, ny, nx, float(vox), int(n_steps), _nthreads(),
                           rows, cols, vals, cap)
    if n < 0:
        raise RuntimeError("native cone-slice COO: capacity exceeded")
    return rows[:n], cols[:n], vals[:n]
