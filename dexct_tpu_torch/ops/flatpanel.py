"""Flat-panel (equidistant-detector) cone-beam reconstruction.

Port of :mod:`dexct_tpu.ops.flatpanel`: the flat-detector Feldkamp of a
:class:`~dexct_tpu_torch.system.geometry.FlatPanelConeBeamGeometry` scan
(the CBCT bench / C-arm configuration).  The host builds, in float64 as
the JAX package does, the panel cosine ``SID / sqrt(SID^2 + u^2 + v^2)``,
the equidistant ramp (:func:`~dexct_tpu_torch.ops.filters.
parallel_ramp_kernel` at ``du_iso``), Parker short-scan weights
(:func:`~dexct_tpu_torch.ops.fbp.parker_weights`) and the offset-detector
Wang weights (:func:`offset_detector_weights`); the filter FFTs are cuFFT
on the card; the backprojection is kernel K13
(``csrc/cone_backproject.cu``, beside K11 and K12), behind
:func:`_flat_backproject`, which runs its plain PyTorch version
:func:`_flat_backproject_plain` for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels
from .conebeam import _check_stack, _disc, _f32, _place, _stack

__all__ = ["fdk_flat_reconstruct", "flat_cone_sinogram",
           "offset_detector_weights", "_flat_backproject",
           "_flat_backproject_plain"]


def offset_detector_weights(geometry, *, feather=None):
    """Half-fan redundancy weights w[C] for an offset-detector scan
    (Wang 1993): ``w = sin^2(pi/4 (1 + g/f))`` across the feathered
    overlap band ``|g| <= f`` with ``w(g) + w(-g) = 1``, doubled, so that
    with the backprojector's dbeta/2 every line integrates to weight dbeta.

    ``feather``: the transition half-width [rad] (default: the whole
    overlap band, the smaller of the panel's two half-fans).  Raises when
    the panel misses the central ray or the overlap spans fewer than two
    channels.
    """
    ct = geometry
    gam = np.asarray(ct.gammas, np.float64)
    g_lo, g_hi = -gam[0], gam[-1]  # half-fans (lo side is gamma < 0)
    if min(g_lo, g_hi) <= 0:
        raise ValueError(
            "offset so large the panel no longer covers the central "
            "ray: the scan misses Radon lines entirely")
    g_ov = min(g_lo, g_hi)
    dg_min = float(np.diff(gam).min())
    if g_ov < 2.0 * dg_min:
        raise ValueError(
            f"overlap band ({g_ov:.4f} rad) narrower than two channels"
            " — not enough conjugate data to feather")
    f = g_ov if feather is None else float(feather)
    if not 0.0 < f <= g_ov + 1e-12:
        raise ValueError(f"feather {f:.4f} outside (0, {g_ov:.4f}]")
    # orient so the short side is gamma < 0; mirror for a negative offset
    sgn = 1.0 if g_hi >= g_lo else -1.0
    g = sgn * gam
    w = np.where(
        g < -f, 0.0,
        np.where(g > f, 1.0,
                 np.sin(np.pi / 4.0 * (1.0 + g / f)) ** 2))
    return 2.0 * w


@functools.lru_cache(maxsize=16)
def _flat_z_on(nz_out, dz_out, device):
    return _f32((np.arange(nz_out) + 0.5 - nz_out / 2.0) * dz_out, device)


def _flat_z(nz_out, dz_out, device):
    """Slice centres of the JAX flat-panel grid (float64, then float32),
    uploaded once per (grid, device) and kept, so that a CUDA graph can
    capture K13's wrapper.  Shared: never write."""
    return _flat_z_on(int(nz_out), float(dz_out), torch.device(device))


def _flat_backproject_plain(q, betas, sid, du_iso, dv_iso, off_c, off_r,
                            n_rows, n_matrix, nz_out, fov, dz_out, dbeta, *,
                            view_block=8):
    """``dexct_tpu.ops.flatpanel._flat_backproject`` in torch: blocks of
    ``view_block`` views over every (disc pixel, slice), each operation in
    the JAX program's float32 order (every division between tensors)."""
    from .conebeam import _bilinear

    M, V, R, C = q.shape
    dev = q.device
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _flat_z(nz_out, dz_out, dev)
    betas = betas.to(device=dev, dtype=torch.float32)
    s = float(np.float32(sid))
    s2 = float(np.float32(s) * np.float32(s))  # the float32 sid * sid
    qf = q.to(torch.float32).reshape(M, -1)
    acc = qf.new_zeros((M, nz_out, X.shape[0]))
    zs = zc * s  # sid z
    for v0 in range(0, V, view_block):
        beta = betas[v0:v0 + view_block]
        cb, sb = torch.cos(beta)[:, None], torch.sin(beta)[:, None]
        ell = s - (X[None, :] * cb + Y[None, :] * sb)
        vt = -X[None, :] * sb + Y[None, :] * cb
        u = (-s) * vt / ell
        cidx = u / torch.full_like(u, du_iso) - 0.5 - off_c + C / 2.0
        c0 = torch.clamp(torch.floor(cidx), 0, C - 2)
        fc = torch.clamp(cidx - c0, 0.0, 1.0)
        w_in = ((cidx >= 0.0) & (cidx <= C - 1.0)).to(torch.float32)
        w_amp = w_in * s2 / (ell * ell)
        v = zs[None, :, None] / ell[:, None, :]  # [B, nz, P]
        ridx = v / torch.full_like(v, dv_iso) - 0.5 - off_r + R / 2.0
        base = (torch.arange(v0, v0 + beta.shape[0], device=dev)
                * (R * C))[:, None, None]
        val, w_z = _bilinear(qf, base, c0.to(torch.int64)[:, None, :],
                             fc[:, None, :], ridx, R, C)
        acc += (val * (w_amp[:, None, :] * w_z)).sum(1)
    return _place(acc * (0.5 * float(np.float32(dbeta))), sel, n_matrix)


def _flat_cuda(q, betas, sid, du_iso, dv_iso, off_c, off_r, n_matrix,
               nz_out, fov, dz_out, dbeta):
    dev = q.device
    M, V, R, C = q.shape
    kernels.require(q, "q", dev, torch.float32)
    kernels.require(betas, "betas", dev, torch.float32, (V,))
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _flat_z(nz_out, dz_out, dev)
    cos_b, sin_b = torch.cos(betas), torch.sin(betas)
    out = torch.zeros((M, nz_out, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_flat_backproject(
        q.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), X.data_ptr(),
        Y.data_ptr(), sel.data_ptr(), zc.data_ptr(), out.data_ptr(), M, V, R,
        C, X.shape[0], nz_out, n_matrix * n_matrix, sid, du_iso, dv_iso,
        off_c, off_r, dbeta, kernels.stream_ptr(dev))
    kernels.check(rc, "flat_backproject")
    _flat_backproject.launches += 1
    return out


def _flat_backproject(q, betas, sid, du_iso, dv_iso, off_c, off_r, n_rows,
                      n_matrix, nz_out, fov, dz_out, dbeta, *,
                      pair_mode=False):
    """Voxel-driven flat-detector FDK backprojection.

    q: filtered projections ``[V, R, C]`` or ``[M, V, R, C]`` (the stacked
    volumes share every tap and weight); betas: ``[V]``.  Per (disc pixel,
    slice, view): panel column ``u = -sid vt / ell`` and row
    ``v = sid z / ell`` (iso-scaled, shifted by the detector offsets
    ``off_c``, ``off_r`` in pitches), bilinear taps with the panel-edge
    masks, weight ``sid^2 / ell^2``; the sum is multiplied by ``dbeta / 2``
    (full-orbit redundancy).  Returns ``[nz, N, N]`` / ``[M, nz, N, N]``,
    0 off the FOV disc.  ``pair_mode`` is the JAX program's slice-pair
    gather layout of the same image, accepted and ignored.

    CUDA tensors run kernel K13 (counted in ``_flat_backproject.launches``);
    CPU tensors run :func:`_flat_backproject_plain`.
    """
    del pair_mode
    q4, single = _stack(q, "q")
    _check_stack(q4, "q")
    if q4.shape[2] != n_rows:
        raise ValueError(f"q has {q4.shape[2]} rows, n_rows={n_rows}")
    args = (float(sid), float(du_iso), float(dv_iso), float(off_c),
            float(off_r))
    grid = (int(n_matrix), int(nz_out), float(fov), float(dz_out),
            float(dbeta))
    if q4.is_cuda:
        out = _flat_cuda(q4, betas, *args, *grid)
    elif q4.device.type != "cpu":
        raise ValueError(f"unsupported device {q4.device}")
    else:
        out = _flat_backproject_plain(q4, betas, *args, int(n_rows), *grid)
    return out[0] if single else out


_flat_backproject.launches = 0


def _flat_tables(ct, ramp, window="sinc"):
    """The host tables of the flat-panel filter (float64): the panel cosine
    ``SID / sqrt(SID^2 + u^2 + v^2)`` ``[R, C]``, the windowed equidistant
    ramp's half spectrum ``H`` and its FFT length ``m``."""
    from .filters import _next_pow2, _window, parallel_ramp_kernel

    C = int(ct.N_channels)
    u = np.asarray(ct.u_iso)  # [C]
    v = np.asarray(ct.z_iso)  # [R] iso-scale row heights
    w = ct.SID / np.sqrt(ct.SID ** 2 + u[None, :] ** 2 + v[:, None] ** 2)
    g = parallel_ramp_kernel(C, float(ct.du_iso))
    m = _next_pow2(2 * C)
    gpad = np.zeros(m, np.float64)
    gpad[: 2 * C - 1] = g
    gpad = np.roll(gpad, -(C - 1))
    H = np.fft.rfft(gpad).real
    f_norm = np.arange(len(H)) / (m / 2.0)
    return w, H * _window(f_norm, ramp, window), m


def _flat_filter(stack, ct, ramp, window="sinc", redundancy="auto",
                 offset_feather=None):
    """The flat-panel filter chain of ``[..., V, R, C]`` data: the panel
    cosine, the redundancy weights (offset-detector Wang weights or Parker
    short-scan weights), the windowed equidistant ramp along columns (cuFFT
    on the card), times ``du_iso``."""
    from .fbp import filter_views, parker_weights

    dev = stack.device
    w, H, m = _flat_tables(ct, ramp, window)
    if redundancy not in ("auto", "full", "offset"):
        raise ValueError(f"unknown redundancy mode {redundancy!r}")
    if redundancy == "auto":
        redundancy = ("offset" if abs(ct.det_offset_ch) >= 2.0
                      else "full")
    pw = stack.to(torch.float32) * _f32(w, dev)
    if redundancy == "offset":
        if ct.rotation_total < 2.0 * np.pi - 1e-6:
            raise ValueError(
                "offset-detector scans need the full 2*pi orbit (the "
                "missing fan side comes from conjugate views half a "
                "turn later)")
        pw = pw * _f32(offset_detector_weights(ct, feather=offset_feather),
                       dev)
    elif ct.rotation_total < 2.0 * np.pi - 1e-6:
        # C-arm short scan: Parker weights in the panel's true fan angles
        # (ct.gammas is the exact atan grid); raises below pi + gamma_fan
        pw = pw * _f32(parker_weights(ct), dev)[:, None, :]
    return filter_views(pw, 1.0, _f32(H, dev), m,
                        float(ct.du_iso)).contiguous()


def fdk_flat_reconstruct(sino_log, geometry, n_matrix, fov, ramp, *,
                         nz_out=None, dz_out=None, window="sinc",
                         view_block=None, redundancy="auto",
                         offset_feather=None):
    """Flat-detector FDK -> volume(s) ``[nz, N, N]`` in cm^-1.

    ``sino_log``: ``[V, R, C]`` or a stack ``[M, V, R, C]`` (all volumes
    in one K13 pass).  The z grid defaults to one slice per ``h_iso``
    centred on z = 0.  Full 2 pi orbits take the dbeta/2 redundancy
    weight; shorter orbits down to pi + gamma_fan Parker weights (the
    C-arm short scan).  ``redundancy``: ``"full"``, ``"offset"`` (Wang
    weights of an offset-detector scan, full orbit only) or ``"auto"``
    (offset when ``|det_offset_ch| >= 2``).  ``view_block`` (a TPU view-block
    layout) is accepted and ignored.
    """
    del view_block
    ct = geometry
    if not getattr(ct, "flat_panel", False):
        raise ValueError(
            "fdk_flat_reconstruct is the flat-panel path; cylindrical "
            "detectors reconstruct with ops.conebeam.fdk_reconstruct")
    stack, single = _stack(sino_log)
    V, R, C = stack.shape[-3:]
    if R != ct.N_rows or C != ct.N_channels:
        raise ValueError(f"sinogram [{V},{R},{C}] does not match the "
                         f"geometry ({ct.N_rows} rows x "
                         f"{ct.N_channels} channels)")
    nz = R if nz_out is None else int(nz_out)
    dz = float(ct.h_iso if dz_out is None else dz_out)
    q = _flat_filter(stack, ct, ramp, window, redundancy, offset_feather)
    out = _flat_backproject(
        q, _f32(ct.betas, stack.device), float(ct.SID), float(ct.du_iso),
        float(ct.h_iso), float(ct.det_offset_ch), float(ct.det_offset_row),
        int(R), int(n_matrix), nz, float(fov), dz,
        float(ct.rotation_total / V))
    return out[0] if single else out


def flat_cone_sinogram(phantom, geometry, spec, *, device, noise="none",
                       generator=None):
    """Polyenergetic flat-panel acquisition -> (counts, log sinogram) on
    ``device``: the trace (K10) and spectral chain (K2) are
    detector-agnostic; only the rays (``geometry.ray_geometry_3d``)
    differ.  Noise is drawn from ``generator`` (seed 0 if none)."""
    from . import spectral as sp_ops
    from .conebeam import cone_material_paths

    paths = cone_material_paths(phantom, geometry, device=device)
    mu_t = _f32(phantom.materials.mu_table(spec.E), device)
    i0 = sp_ops.effective_fluence(spec, geometry)
    counts = sp_ops.counts_from_paths(paths, mu_t, _f32(i0, device))
    if noise != "none":
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        counts = sp_ops.sample_noise(generator, counts, noise)
    return counts, sp_ops.log_sinogram(counts, float(np.sum(i0)))
