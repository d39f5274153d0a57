"""Quasi-exact helical reconstruction: the cone-parallel PI method.

Port of :mod:`dexct_tpu.ops.helical_pi` (Turbell 2001's "PI-original"
reconstruction; the module docstring there has the method and the measured
gFDK-vs-PI verdict):

1. the cone pre-weight cos(kappa) per row, then the azimuthal rebin of
   every detector row from (beta, gamma) to (theta, t) on the unwrapped
   scan range: the host plan :func:`_conepar_rebin_plan` (float64 NumPy,
   copied) gives each parallel bin 4 bilinear taps into the [V*C] fan grid,
   as two adjacent-channel pairs, and kernel K5
   (:func:`~dexct_tpu_torch.ops.fbp_fast.rebin_to_parallel` at 4 taps) sums
   them for all R rows at once, the rows being its image axis;
2. the parallel ramp filter along t (cuFFT on the card);
3. the Tam-Danielsson-window backprojection with a partition of unity over
   the nine helix copies of each line: kernel K20 (:func:`_pi_backproject`,
   ``csrc/pi_backproject.cu``), whose wrapper runs
   :func:`_pi_backproject_plain` for CPU tensors.

The JAX program's ``view_block`` and its t-pair-packed, theta-chunked tap
tables are TPU layouts of the same sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import upload
from .conebeam import _disc, _f32, _place
from .fbp import filter_views
from .fbp_fast import rebin_to_parallel
from .filters import filter_frequency_response

__all__ = ["helical_pi_reconstruct", "_pi_backproject",
           "_pi_backproject_plain"]


def _conepar_rebin_plan(ct, nt):
    """Host tables for the azimuthal rebin of one helical scan.

    Target grid: theta_j = beta_j - pi/2 (the views' count and spacing, so
    the unwrapped scan range maps 1:1), t_k symmetric over the fan.
    Returns (idx [nT*nt*4] int32 into V*C, w [nT*nt*4] float32, t0, dt,
    thetas [nT] float32); the backprojector recomputes each sample's source
    angle from (theta, t) in closed form.
    """
    sid = ct.SID
    v, c = ct.N_proj, ct.N_channels
    dgamma = ct.dgamma
    betas = np.asarray(ct.betas, np.float64)  # unwrapped, uniform
    dbeta = float(betas[1] - betas[0])
    gam_lim = ct.gamma_fan / 2.0
    t_max = sid * np.sin(gam_lim)
    dt = 2.0 * t_max / nt
    t0 = -t_max + 0.5 * dt
    thetas = betas - np.pi / 2.0
    ts = t0 + dt * np.arange(nt)

    tt, th = np.meshgrid(ts, thetas)  # [nT, nt]
    gam = np.arcsin(np.clip(tt / sid, -1.0, 1.0))
    # copy-A fan coordinates of line (theta, t): beta = theta - gamma +
    # pi/2, channel gamma
    beta_need = th + np.pi / 2.0 - gam
    fb = (beta_need - betas[0]) / dbeta
    ib0 = np.floor(fb).astype(np.int64)
    wb1 = (fb - ib0).astype(np.float64)
    valid_b = (ib0 >= 0) & (ib0 <= v - 2)
    ib0c = np.clip(ib0, 0, v - 2)
    fg = gam / dgamma - 0.5 + c / 2.0
    ig0 = np.clip(np.floor(fg), 0, c - 2).astype(np.int64)
    wg1 = np.clip(fg - ig0, 0.0, 1.0)
    valid = valid_b & (np.abs(gam) <= gam_lim)

    idx = np.stack([
        ib0c * c + ig0, ib0c * c + ig0 + 1,
        (ib0c + 1) * c + ig0, (ib0c + 1) * c + ig0 + 1,
    ], -1)
    w = np.stack([
        (1 - wb1) * (1 - wg1), (1 - wb1) * wg1,
        wb1 * (1 - wg1), wb1 * wg1,
    ], -1) * valid[..., None]
    return (idx.astype(np.int32).reshape(-1),
            w.astype(np.float32).reshape(-1),
            float(t0), float(dt),
            thetas.astype(np.float32))


def _pi_constants(pitch, row_h, R):
    """The scalars of the TD window, the reference's Python floats."""
    return dict(qp=pitch / (4.0 * np.pi), nqp=-(pitch / (4.0 * np.pi)),
                taper=0.5 * row_h, hdet=0.5 * row_h * (R + 1.0))


def _pi_terms(X, Y, zc, th, thetas, sid, row_h, R, pitch, z0_src, t0, dt,
              nt):
    """Per (line, slice, pixel) of the lines ``th`` [B]: the t-channel tap
    (c0, fc), the row taps (r0, r1, fr) and the weight w = w_in w_z w_td
    ``[B, nz, P]`` (w_td the line's TD window over the sum of its helix
    copies' windows), each operation in the JAX program's order, every
    division between tensors.  ``thetas`` [nT] are all the scan's lines."""
    k = _pi_constants(pitch, row_h, R)
    pi = np.pi
    th_lo = thetas[0] - 1e-6
    th_hi = thetas[-1] + 1e-6

    def full(v, like):
        return torch.full_like(like, v)

    def kfun(h, g):
        top = k["qp"] * (pi - 2.0 * g)
        bot = k["nqp"] * (pi + 2.0 * g)
        tap = full(k["taper"], h)
        in_det = (h.abs() <= k["hdet"]).to(h.dtype)
        return (torch.clamp((h - bot) / tap + 0.5, 0.0, 1.0)
                * torch.clamp((top - h) / tap + 0.5, 0.0, 1.0) * in_det)

    def z_src(beta):
        return z0_src + (pitch * beta) / full(2.0 * pi, beta)

    ct_, st_ = torch.cos(th)[:, None], torch.sin(th)[:, None]
    t = X[None, :] * ct_ + Y[None, :] * st_  # [B, P]
    s = -X[None, :] * st_ + Y[None, :] * ct_
    sg = torch.clamp(t / full(sid, t), -0.999, 0.999)
    gam = torch.asin(sg)
    cg = torch.sqrt(1.0 - sg * sg)
    L = torch.clamp_min(sid * cg - s, 1e-3)[:, None, :]
    L_odd = torch.clamp_min(sid * cg + s, 1e-3)[:, None, :]
    beta = th[:, None] + 0.5 * pi - gam
    cidx = (t - t0) / full(dt, t)
    c0 = torch.clamp(torch.floor(cidx), 0, nt - 2)
    fc = torch.clamp(cidx - c0, 0.0, 1.0)[:, None, :]
    w_in = ((cidx >= 0.0) & (cidx <= nt - 1.0)).to(t.dtype)[:, None, :]

    g3 = gam[:, None, :]
    h = ((zc - z_src(beta)[:, None, :]) * sid) / L  # [B, nz, P]
    k0 = kfun(h, g3)
    ksum = k0
    for m in range(-4, 5):
        if m == 0:
            continue
        odd = m % 2
        beta_m = beta + m * pi + (2.0 * gam if odd else 0.0)
        hm = ((zc - z_src(beta_m)[:, None, :]) * sid) / (
            L_odd if odd else L)
        th_m = th + m * pi
        ok = ((th_m >= th_lo) & (th_m <= th_hi)).to(h.dtype)
        ksum = ksum + kfun(hm, -g3 if odd else g3) * ok[:, None, None]
    w_td = k0 / torch.clamp_min(ksum, 1e-6)
    ridx = h / full(row_h, h) - 0.5 + R / 2.0
    r0 = torch.clamp(torch.floor(ridx), 0, max(R - 2, 0))
    fr = torch.clamp(ridx - r0, 0.0, 1.0)
    w_z = ((ridx >= -0.5) & (ridx <= R - 0.5)).to(h.dtype)
    r0 = r0.to(torch.int64)
    return (c0.to(torch.int64), fc, r0, torch.clamp_max(r0 + 1, R - 1), fr,
            w_in * w_z * w_td)


def _pi_backproject_plain(par, sid, row_h, n_rows, pitch, z0_src, thetas,
                          t0, dt, nt, n_matrix, nz_out, fov, dz_out, z_lo,
                          dtheta, *, view_block=8):
    """``dexct_tpu.ops.helical_pi._pi_backproject`` in torch: blocks of
    ``view_block`` theta lines over every (disc pixel, slice)
    (:func:`_pi_terms`), the bilinear (t, row) taps weighted and
    summed."""
    nT = par.shape[0]
    R = int(n_rows)
    dev = par.device
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _f32(z_lo + np.arange(nz_out) * dz_out, dev)[None, :, None]
    thetas = thetas.to(device=dev, dtype=torch.float32)
    flat = par.to(torch.float32).reshape(-1)
    num = flat.new_zeros((nz_out, X.shape[0]))
    for v0 in range(0, nT, view_block):
        th = thetas[v0:v0 + view_block]
        c0, fc, r0, r1, fr, w = _pi_terms(X, Y, zc, th, thetas, sid, row_h,
                                          R, pitch, z0_src, t0, dt, nt)
        lines = torch.arange(v0, v0 + th.shape[0], device=dev)[:, None]
        base = ((lines * nt + c0) * R)[:, None, :]
        v00, v01 = flat[base + r0], flat[base + r1]
        v10, v11 = flat[base + R + r0], flat[base + R + r1]
        val = ((v00 * (1 - fc) + v10 * fc) * (1 - fr)
               + (v01 * (1 - fc) + v11 * fc) * fr)
        num += (val * w).sum(0)
    return _place((num * dtheta)[None], sel, n_matrix)[0]


def _pi_cuda(par, sid, row_h, R, pitch, z0_src, thetas, t0, dt, nt,
             n_matrix, nz_out, fov, dz_out, z_lo, dtheta):
    dev = par.device
    nT = thetas.shape[0]
    kernels.require(par, "par", dev, torch.float32, (nT, nt, R))
    kernels.require(thetas, "thetas", dev, torch.float32, (nT,))
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _f32(z_lo + np.arange(nz_out) * dz_out, dev)
    cos_t, sin_t = torch.cos(thetas), torch.sin(thetas)
    k = _pi_constants(pitch, row_h, R)
    out = torch.zeros((nz_out, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_pi_backproject(
        par.data_ptr(), thetas.data_ptr(), cos_t.data_ptr(),
        sin_t.data_ptr(), X.data_ptr(), Y.data_ptr(), sel.data_ptr(),
        zc.data_ptr(), out.data_ptr(), nT, nt, R, X.shape[0], nz_out,
        n_matrix * n_matrix, sid, row_h, pitch, z0_src, t0, dt, dtheta,
        k["qp"], k["nqp"], k["taper"], k["hdet"],
        float(thetas[0] - 1e-6), float(thetas[-1] + 1e-6),  # float32 sums
        kernels.stream_ptr(dev))
    kernels.check(rc, "pi_backproject")
    _pi_backproject.launches += 1
    return out


def _pi_backproject(par, sid, row_h, n_rows, pitch, z0_src, thetas, t0, dt,
                    nt, n_matrix, nz_out, fov, dz_out, z_lo, dtheta, *,
                    view_block=None):
    """TD-windowed cone-parallel backprojection -> ``[nz_out, N, N]``, 0 off
    the FOV disc.

    par: [nT, nt, R] filtered cone-parallel data (row-minor); thetas: [nT]
    the lines' angles.  Per (disc pixel, slice z) and line theta: the
    in-plane t = x cos + y sin, the fan angle gamma = asin(t / SID), the
    source height z_s of the line's own helix copy and the row height h =
    (z - z_s) SID / L; the line's weight is its tapered TD window K(h) over
    the sum of K over the nine copies theta + m pi (|m| <= 4) that the scan
    holds, a partition of unity; the bilinear (t, row) tap times that
    weight is summed over the lines and times ``dtheta``.  CUDA tensors run
    kernel K20 (counted in ``_pi_backproject.launches``); CPU tensors run
    :func:`_pi_backproject_plain`.  ``view_block`` (a TPU layout) is
    accepted and ignored.
    """
    del view_block
    if par.dim() != 3 or par.shape[2] != n_rows or par.shape[1] != nt:
        raise ValueError(f"par must be [nT, {nt}, {n_rows}], got "
                         f"{tuple(par.shape)}")
    if nt < 2:
        raise ValueError("the PI backprojection needs nt >= 2")
    args = (float(sid), float(row_h), int(n_rows), float(pitch),
            float(z0_src), thetas, float(t0), float(dt), int(nt),
            int(n_matrix), int(nz_out), float(fov), float(dz_out),
            float(z_lo), float(dtheta))
    if par.is_cuda:
        return _pi_cuda(par, *args)
    if par.device.type != "cpu":
        raise ValueError(f"unsupported device {par.device}")
    return _pi_backproject_plain(par, *args)


_pi_backproject.launches = 0


def _default_z(ct, pitch):
    """The JAX default slice grid: one slice per ``h_iso`` across the
    central 80 % of the source travel."""
    travel = pitch * ct.rotation_total / (2.0 * np.pi)
    half = 0.4 * travel
    nz = max(int(2.0 * half / ct.h_iso), 1)
    return (np.arange(nz) + 0.5) * (2.0 * half / nz) - half


def helical_pi_reconstruct(sino_log, geometry, n_matrix, fov, ramp, *,
                           z_out=None, nt=None, window="sinc",
                           view_block=None):
    """Cone-parallel PI reconstruction -> ``[nz, N, N]`` in cm^-1.

    ``sino_log``: ``[V, R, C]`` helical line integrals (a tensor: the
    reconstruction runs on its device) of a
    :class:`~dexct_tpu_torch.system.geometry.HelicalConeBeamGeometry` scan.
    ``z_out`` defaults to one slice per ``h_iso`` across the central 80 %
    of the source travel; ``nt`` (default 2 C) parallel bins per line.
    The cone pre-weight, the 4-tap row rebin (K5), the parallel ramp filter
    (cuFFT), then K20.  Raises ``ValueError`` at pitch 0 (no
    Tam-Danielsson window: use ``fdk_reconstruct``) and for a flying focal
    spot (use ``helical_fdk_reconstruct``).  ``view_block`` (a TPU layout)
    is accepted and ignored.
    """
    del view_block
    ct = geometry
    V, R, C = sino_log.shape
    if R != ct.N_rows:
        raise ValueError(f"sinogram has {R} rows, geometry {ct.N_rows}")
    pitch = float(getattr(ct, "pitch", 0.0))
    if abs(pitch) < 1e-9:
        raise ValueError(
            "pitch = 0 has no Tam-Danielsson window; use fdk_reconstruct")
    if getattr(ct, "ffs", "none") != "none":
        raise ValueError(
            "the PI rebinning assumes a static focal spot; "
            "reconstruct z-FFS scans with helical_fdk_reconstruct")
    nt = int(2 * C) if nt is None else int(nt)
    z_out = np.asarray(_default_z(ct, pitch) if z_out is None else z_out,
                       np.float64)
    dz = float(z_out[1] - z_out[0]) if len(z_out) > 1 else float(ct.h_iso)
    dev = sino_log.device

    # cone pre-weight (cos kappa per row), then the rows rebinned at once:
    # [R, V, C] fan rows -> [R, nT, nt] parallel rows
    cosk = ct.SID / np.sqrt(ct.SID ** 2 + np.asarray(ct.z_iso) ** 2)
    pw = sino_log.to(torch.float32) * _f32(cosk, dev)[None, :, None]
    idx, w, t0, dt, thetas = _conepar_rebin_plan(ct, nt)
    par = rebin_to_parallel(
        pw.permute(1, 0, 2).contiguous(),
        upload(idx, dev), upload(w, dev),
        nt, taps=4)

    # parallel ramp filter along t, per (row, theta line)
    H, m = filter_frequency_response(nt, dt, ramp, window, "parallel")
    par = filter_views(par, 1.0, _f32(H, dev), m, dt)

    # source height z0 at beta = 0 (betas start at 0, z symmetric about
    # the scan centre)
    z0_src = float(np.asarray(ct.source_z)[0])
    return _pi_backproject(
        par.permute(1, 2, 0).contiguous(), float(ct.SID), float(ct.h_iso),
        int(R), pitch, z0_src, upload(thetas, dev), t0, dt,
        nt, int(n_matrix), len(z_out), float(fov), dz, float(z_out[0]),
        float(ct.rotation_total / V))
