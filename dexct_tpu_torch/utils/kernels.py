"""Build and load the hand-written CUDA kernels of the port.

The CUDA C++ sources live in ``dexct_tpu_torch/csrc/*.cu``.  They expose a
plain C interface and are compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library that is loaded with :mod:`ctypes`.  The build runs at the
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

__all__ = ["build", "library", "check", "require", "stream_ptr"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("siddon_trace.cu", "gauss_newton.cu", "fan_backproject.cu",
           "gather_taps.cu", "parallel_backproject.cu", "kb_sample.cu",
           "analytic_chords.cu", "siddon_trace_3d.cu", "cone_backproject.cu",
           "trilinear_sample.cu", "siddon_trace_stack.cu",
           "siddon_project_3d.cu", "pi_backproject.cu", "dose.cu",
           "scatter.cu", "afterglow.cu", "gather_probe.cu",
           "spectral_counts.cu")
# headers the sources include (hashed with them, compiled through them)
HEADERS = ("siddon_walk.cuh", "siddon_walk_3d.cuh", "td_window.cuh",
           "scatter_march.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# no --use_fast_math: the trace's plane crossings and the backprojectors'
# edge tests feed 1e-4 parity tolerances
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

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
    # counts, tables, scale (a device pointer), out, n_pix, e_full, e_warm,
    # n_warm, n_pol, warm_bf16, a_lo, a_hi, step_max, eps_init, clip,
    # stream
    "dexct_gauss_newton": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F,
                           _F, _F, _F, _P),
    # counts, block_group, scales, tables, out, n_pix, block, e_full,
    # e_warm, n_warm, n_pol, warm_bf16, a_lo, a_hi, step_max, eps_init,
    # clip, stream
    "dexct_gauss_newton_grouped": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                   _I, _I, _F, _F, _F, _F, _F, _P),
    # counts, tables, scale (a device pointer), out, n_pix, n_meas, n_mats,
    # newton, e_full, e_warm, n_warm, n_pol, warm_bf16, warm_log,
    # polish_log, lm_damping, a_lo, a_hi, step_max, eps_init, clip, stream
    "dexct_gauss_newton_general": (_P, _P, _P, _P, _L) + (_I,) * 10
                                  + (_F,) * 6 + (_P,),
    # packed, cos_b, sin_b, out, n_images, V, C, N, px, half, sid, dgamma,
    # dbeta, stream
    "dexct_fan_backproject": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                              _F, _F, _P),
    # sinos, idx, w, out, n_bins, K, n_src, taps, stream
    "dexct_rebin_to_parallel": (_P, _P, _P, _P, _L, _I, _L, _I, _P),
    # r0, r1, cos_b, sin_b, out, n_fields, V, C, N, px, half, sid, dgamma,
    # dbeta^2, stream
    "dexct_fan_backproject_var": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                  _F, _F, _F, _F, _P),
    # q, cos_b, sin_b, cos_p, sin_p, dx, dy, out, V, C, N, px, half, sid,
    # dgamma, dbeta, stream
    "dexct_fan_backproject_motion": (_P,) * 8 + (_I,) * 3 + (_F,) * 5
                                    + (_P,),
    # q, cos_b, sin_b, w, out, n_gates, V, C, N, px, half, sid, dgamma,
    # stream
    "dexct_gated_backproject": (_P,) * 5 + (_I,) * 4 + (_F,) * 4 + (_P,),
    # radon, idx, w, out, n_rays, M, n_src, stream
    "dexct_resample_to_fan": (_P, _P, _P, _P, _L, _I, _L, _P),
    # packed, cos_t, sin_t, mask, out, n_images, n_theta, nt, N, px, half,
    # t0, dt, dtheta, stream
    "dexct_parallel_backproject": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                   _F, _F, _F, _F, _P),
    # F, items, origin, rec, w, out, S, M, G, n_items, stream
    "dexct_kb_sample": (_P,) * 6 + (_I,) * 4 + (_P,),
    # g, row_ptr, entries, rows, ell, ell_offset, phase_cos, phase_sin, z,
    # F, S, M, n_cells, n_long, stream
    "dexct_kb_sample_adjoint": (_P,) * 10 + (_I,) * 4 + (_P,),
    # g, row_ptr, ray, w, radon, n_bins, M, stream
    "dexct_resample_to_fan_adjoint": (_P, _P, _P, _P, _P, _L, _I, _P),
    # tab, labels, src, dirs, out, n_rays, S, n_materials, stream
    "dexct_analytic_chords": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    # paths, mu, i0, i2 (null: none), out, var, n_rays, n_m, n_e, stream
    "dexct_spectral_counts": (_P,) * 6 + (_L, _I, _I, _P),
    # labels, labels_yx (scratch), src, dirs, out, n_rays, nx, ny, nz,
    # n_out, x0, y0, z0, x1, y1, z1, dx, dy, dz, eps, n_steps, stream
    "dexct_siddon_trace_3d": (_P,) * 5 + (_L,) + (_I,) * 4 + (_F,) * 10
                             + (_I, _P),
    # qs, cos_b, sin_b, X, Y, sel, zc, out, n_images, V, R, C, P, nz,
    # plane, sid, dgamma, row_h, dbeta, stream
    "dexct_fdk_backproject": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _L, _F, _F, _F, _F, _P),
    # packed, cos_b, sin_b, betas, src_z, row_off, beta_c, X, Y, sel, zc,
    # out, n_images, weighting, V, R, C, P, nz, plane, sid, dgamma, row_h,
    # dbeta, then the 11 window scalars (hwpi .. scale), stream
    "dexct_helical_backproject": (_P,) * 12 + (_I,) * 7 + (_L,)
                                 + (_F,) * 15 + (_P,),
    # qs, cos_b, sin_b, cos_p, sin_p, dx, dy, dz, X, Y, sel, zc, out,
    # n_images, V, R, C, P, nz, plane, sid, dgamma, row_h, stream
    "dexct_fdk_backproject_motion": (_P,) * 13 + (_I,) * 6 + (_L,)
                                    + (_F,) * 3 + (_P,),
    # qs, cos_b, sin_b, betas, src_z, cos_p, sin_p, dx, dy, dz, X, Y, sel,
    # zc, out, n_images, V, R, C, P, nz, plane, sid, dgamma, row_h, pitch,
    # beta_mid, dbeta, shift_lo, shift_hi, stream (betas[0] read on the card)
    "dexct_helical_backproject_motion": (_P,) * 15 + (_I,) * 6 + (_L,)
                                        + (_F,) * 8 + (_P,),
    # qs, cos_b, sin_b, X, Y, sel, zc, out, n_images, V, R, C, P, nz,
    # plane, sid, du, dv, off_c, off_r, dbeta, stream
    "dexct_flat_backproject": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _L, _F, _F, _F, _F, _F, _F, _P),
    # gf, cos_b, sin_b, src_z, X, Y, sel, zc, out, n_images, cubic, V, R, C,
    # P, nz, plane, sid, dgamma, row_h, qp, taper, scale, sz0, dzv, z_reach,
    # stream
    "dexct_katsevich_backproject": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _L, _F, _F, _F,
                                    _F, _F, _F, _F, _F, _F, _P),
    # vols, zi, yi, xi, out, n_images, n0, n1, n2, the strides of zi, yi
    # and xi (three each), nz, ny, nx, stream
    "dexct_trilinear_sample": (_P,) * 5 + (_I,) + (_L,) * 12 + (_I,) * 3
                              + (_P,),
    # vol, out, nx, ny, nz, stream
    "dexct_swap_xy": (_P, _P, _I, _I, _I, _P),
    # vol, vol_yx, src, dirs, out, n_rays, nx, ny, nz, x0, y0, z0, x1, y1,
    # z1, dx, dy, dz, eps, n_steps, stream
    "dexct_project_3d": (_P,) * 5 + (_L, _I, _I, _I) + (_F,) * 10
                        + (_I, _P),
    # src, dirs, count, offset, rec, n_rays, rows, cols, nx, ny, nz, x0,
    # y0, z0, x1, y1, z1, dx, dy, dz, eps, n_steps, fill, stream
    "dexct_cone_transpose_walk": (_P,) * 5 + (_L,) + (_I,) * 5 + (_F,) * 10
                                 + (_I, _I, _P),
    # length, offset, rec, n_cells, longest, r0, n_rays, stream
    "dexct_cone_transpose_sort": (_P,) * 3 + (_L, _I, _L, _L, _P),
    # y, length, offset, rec, vol, n_cells, accumulate, stream
    "dexct_backproject_3d": (_P,) * 5 + (_L, _I, _P),
    # par, thetas, cos_t, sin_t, X, Y, sel, zc, out, nT, nt, R, P, nz,
    # plane, sid, row_h, pitch, z0_src, t0, dt, dtheta, qp, nqp, taper, hdet,
    # th_lo, th_hi, stream
    "dexct_pi_backproject": (_P,) * 9 + (_I,) * 5 + (_L,) + (_F,) * 13
                            + (_P,),
    # labels, src, ca, sa, vw, gammas, rs, vox, rho, lab, muT, mu_dep, i0w,
    # quads, T, terms, dose, edep; maxk, nv, n_g, n_r, K, E, nx, ny; n_vox;
    # sid, dx, dy, geom, g_half, h_over_sid, dxdy; stream
    "dexct_dose_2d": (_P,) * 18 + (_I,) * 8 + (_L,) + (_F,) * 7 + (_P,),
    # labels, src, src_z, ca, sa, vw, k0s, gammas, ts, sec, rs, xc, yc, zc,
    # rho, lab, muT, mu_dep, i0w, quads, contrib, dose, edep; maxk, nv, n_g,
    # n_t, n_r, K, E, nx, ny, nz, depth; n_vox; sid, dx, dy, dz, geom,
    # g_half, t_half, dvol; stream
    "dexct_dose_3d": (_P,) * 23 + (_I,) * 11 + (_L,) + (_F,) * 8 + (_P,),
    # labels, cells, ne_w, f2w, mu_gE, mu_fine, resp_fine, resp_g, n0_g,
    # e_g, src, d0, det, nrm, phi, aux, out; maxk, nv, X, D, G, F, Q, nx,
    # ny, nz, s_in, s_out, coherent; dx, dy, dz, hx, hy, hz, cx, cy, cz,
    # geom, g_half, beam_a, beam_b, ef0, def, f_max, q_max, a_det, dq_inv,
    # c_r2, inv_hc, inv_mec2; stream
    "dexct_scatter_2d": (_P,) * 17 + (_I,) * 13 + (_F,) * 22 + (_P,),
    "dexct_scatter_3d": (_P,) * 17 + (_I,) * 13 + (_F,) * 22 + (_P,),
    # in, out, coef (host doubles), k, correct, is_double, V, P, warm,
    # stream
    "dexct_afterglow": (_P, _P, _P, _I, _I, _I, _I, _L, _I, _P),
    # tab, n_tab, idx, out, n, stream
    "dexct_gather_vmem": (_P, _I, _P, _P, _L, _P),
    # tab, idx, out, n, stream
    "dexct_gather_take": (_P, _P, _P, _L, _P),
    # labels, src, dirs, out, n_rays, nx, ny, nz, n_out, z_chunk, x0, y0,
    # x1, y1, dx, dy, eps, n_steps, stream
    "dexct_siddon_trace_stack": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F,
                                 _F, _F, _F, _F, _F, _F, _I, _P),
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
    for name in SOURCES + HEADERS:
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s[:-len(".cu")] + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(SOURCES, objs)]
        errors = []
        for src, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        so = os.path.join(tmp, lib.name)
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent build never sees half a file
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


def require(t, name, device, dtype, shape=None):
    """Return ``t`` after checking that it is a contiguous ``dtype`` tensor
    on ``device`` (and of ``shape``, when given) with no lazy conjugate or
    negation bit; raise ``ValueError`` otherwise.  Kernel wrappers call it on every tensor whose pointer they
    pass."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.is_conj() or t.is_neg():
        # a lazy view: the memory behind data_ptr() holds other values
        raise ValueError(f"{name} carries a lazy conjugate or negation; "
                         "resolve it first")
    return t


def stream_ptr(device):
    """The current CUDA stream of ``device`` as a ``c_void_p``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
