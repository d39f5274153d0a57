"""Build and load the hand-written CUDA kernels of the port.

The CUDA C++ sources live in ``dexct_tpu_torch/csrc/*.cu``.  They expose a
plain C interface and are compiled by ``nvcc`` for Hopper (``sm_90a``) into
one shared library that is loaded with :mod:`ctypes`.  The build runs at the
first kernel launch of a process, never at import, into
``dexct_tpu_torch/_build/`` (listed in ``.gitignore``).  The library name
carries a hash of the sources and flags, so an edited source is rebuilt and a
finished build is reused.

Every C entry point takes device pointers and the CUDA stream as
``ctypes.c_void_p``, launches on that stream without synchronising, and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build", "library", "check", "stream_ptr"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("siddon_trace.cu", "gauss_newton.cu", "fan_backproject.cu")
# no --use_fast_math: the trace's plane crossings and the backprojector's
# atan2/sin/cos feed 1e-4 parity tolerances
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures: every pointer and the stream are c_void_p
_SIGNATURES = {
    # labels, src, dirs, out, n_rays, nx, ny, n_out, x0, y0, x1, y1, dx,
    # dy, eps, n_steps, stream
    "dexct_siddon_trace": (_P, _P, _P, _P, _L, _I, _I, _I, _F, _F, _F, _F,
                           _F, _F, _F, _I, _P),
    # counts, tables, out, n_pix, e_full, e_warm, n_warm, n_pol,
    # warm_bf16, scale, a_lo, a_hi, step_max, eps_init, clip, stream
    "dexct_gauss_newton": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _F,
                           _F, _F, _F, _P),
    # packed, cos_b, sin_b, out, n_images, V, C, N, px, half, sid, dgamma,
    # dbeta, stream
    "dexct_fan_backproject": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                              _F, _F, _P),
}


def _nvcc():
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if no build of these sources exists; return the
    path of the shared library."""
    lib = BUILD_DIR / f"libdexct_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc, name):
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")


def stream_ptr(device):
    """The current CUDA stream of ``device`` as a ``c_void_p``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
