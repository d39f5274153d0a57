"""Exact helical reconstruction: Katsevich filtered backprojection.

Port of :mod:`dexct_tpu.ops.katsevich` (the native cone-beam factorization
of Noo, Pack & Heuscher 2003, in this package's coordinates).  The chain,
on ``[M, V, R, C]`` stacks (the M volumes share every table):

1. derivative at constant ray direction ``g1 = dg/dbeta - dg/dgamma`` and
2. the cone-length weight ``cos kappa`` per row: kernel K14
   (:func:`_fixed_direction_derivative`, Triton).  The beta partial is a
   4th-order centred difference with edge views replicated; the gamma
   partial is a window-apodized spectral derivative (cuFFT, default) or the
   4th-order stencil (``deriv="stencil4"``, in the kernel);
3. forward kappa rebinning, a dense contraction with the host table ``Wf``
   (``torch.einsum`` in full float32, as the JAX program's
   ``Precision.HIGHEST``);
4. Hilbert filtering along each kappa line (cuFFT with the host spectrum
   ``kern_im``);
5. backward rebinning to detector rows (``torch.einsum`` with ``Wb``);
6. the PI-window backprojection: kernel K15 (:func:`_katsevich_backproject`,
   ``csrc/cone_backproject.cu``, beside K11-K13).

The host tables (``_plan``'s ``Wf``/``Wb``, the Hilbert spectrum, the cone
weights, the default slice grid) are float64 NumPy copies of the JAX
package's.  Each kernel's wrapper runs its plain PyTorch version
(:func:`_fixed_direction_derivative_plain`,
:func:`_katsevich_backproject_plain`) for CPU tensors.  The JAX program's
``view_block`` is accepted and ignored; its view-sharded
``axis_name``/``halo`` arguments (``parallel/``) are left out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels
from .conebeam import _check_stack, _disc, _f32, _place, _stack

__all__ = ["katsevich_reconstruct", "katsevich_arrays_from_numpy",
           "_fixed_direction_derivative", "_fixed_direction_derivative_plain",
           "_katsevich_backproject", "_katsevich_backproject_plain"]


# ---------------------------------------------------------------------------
# Host tables (float64 NumPy, as the JAX package)
# ---------------------------------------------------------------------------

def _kappa_height(psi, gam, c):
    """h_kappa(psi, g) in iso units; c = pitch/2pi.  psi=0 is the
    analytic limit  -c sin g  (psi/tan psi -> 1)."""
    psi = np.asarray(psi, np.float64)
    ratio = np.where(np.abs(psi) < 1e-12, 1.0,
                     psi / np.tan(np.where(np.abs(psi) < 1e-12, 1.0,
                                           psi)))
    return c * (psi * np.cos(gam) - ratio * np.sin(gam))


def _cr_weights(t):
    """Catmull-Rom weights for taps at offsets (-1, 0, 1, 2) from the
    floor index, fraction ``t`` in [0, 1]."""
    t = np.asarray(t, np.float64)
    t2, t3 = t * t, t * t * t
    return np.stack([-0.5 * t + t2 - 0.5 * t3,
                     1.0 - 2.5 * t2 + 1.5 * t3,
                     0.5 * t + 2.0 * t2 - 1.5 * t3,
                     -0.5 * t2 + 0.5 * t3], axis=-1)


def _plan(ct, n_psi, interp="linear"):
    """Host tables of one helical geometry: ``(Wf [n_psi, C, R],
    Wb [C, R, n_psi], psi grid)``, the tables float32.  ``interp``:
    "linear" (2-tap) or "cubic" (4-tap Catmull-Rom, edge taps clamped) for
    both resamplings.  Raises when the Tam-Danielsson window does not fit
    the detector."""
    P = float(ct.pitch)
    C, R = int(ct.N_channels), int(ct.N_rows)
    gam = np.asarray(ct.gammas, np.float64)
    h_iso = float(ct.h_iso)
    c = P / (2.0 * np.pi)
    gm = 0.5 * float(ct.gamma_fan)

    # TD window must fit the detector (else the PI data is truncated)
    h_need = (abs(P) / (4.0 * np.pi)) * (np.pi + 2.0 * gm) / np.cos(gm)
    h_det = 0.5 * R * h_iso
    if h_need > h_det + 1e-9:
        raise ValueError(
            f"TD window ({h_need:.3f} cm at iso) exceeds the detector "
            f"half-height ({h_det:.3f} cm): reduce pitch below "
            f"{abs(P) * h_det / h_need:.3f} cm/turn or add rows")

    psi_max = 0.5 * np.pi + gm + 0.35
    psis = np.linspace(-psi_max, psi_max, n_psi)

    # forward rebin: row interpolation of h_kappa(psi_p, gam_c)
    hk = _kappa_height(psis[:, None], gam[None, :], c)  # [n_psi, C]
    ridx = hk / h_iso - 0.5 + R / 2.0
    r0 = np.clip(np.floor(ridx), 0, R - 2).astype(np.int64)
    fr = np.clip(ridx - r0, 0.0, 1.0)
    Wf = np.zeros((n_psi, C, R), np.float64)
    ii, jj = np.meshgrid(np.arange(n_psi), np.arange(C), indexing="ij")
    if interp == "cubic":
        w4 = _cr_weights(fr)  # [n_psi, C, 4]
        for k, off in enumerate((-1, 0, 1, 2)):
            np.add.at(Wf, (ii, jj, np.clip(r0 + off, 0, R - 1)),
                      w4[..., k])
    else:
        Wf[ii, jj, r0] = 1.0 - fr
        Wf[ii, jj, r0 + 1] = fr

    # backward rebin: smallest-|psi| root of h_kappa(psi, g) = h_row,
    # walked outward from psi=0 on a fine grid
    fine = np.linspace(-psi_max, psi_max, 8192)
    mid = 4096  # index of psi ~ 0
    Wb = np.zeros((C, R, n_psi), np.float64)
    dpsi = psis[1] - psis[0]
    rows_h = np.asarray(ct.z_iso, np.float64)
    for ci in range(C):
        hfine = _kappa_height(fine, gam[ci], c)
        h0 = hfine[mid]
        for ri in range(R):
            h = rows_h[ri]
            if h >= h0:
                seg = hfine[mid:]
                k = np.searchsorted(np.maximum.accumulate(seg), h)
                if k >= len(seg):
                    continue  # row outside the kappa family: unused
                lo = mid + k - 1
            else:
                seg = hfine[mid::-1]
                k = np.searchsorted(np.maximum.accumulate(-seg), -h)
                if k >= len(seg):
                    continue
                lo = mid - k
            h_lo, h_hi = hfine[lo], hfine[lo + 1]
            t = 0.0 if h_hi == h_lo else (h - h_lo) / (h_hi - h_lo)
            psi_hat = fine[lo] + t * (fine[lo + 1] - fine[lo])
            pidx = (psi_hat - psis[0]) / dpsi
            p0 = int(np.clip(np.floor(pidx), 0, n_psi - 2))
            fp = np.clip(pidx - p0, 0.0, 1.0)
            if interp == "cubic":
                w4 = _cr_weights(fp)
                for k, off in enumerate((-1, 0, 1, 2)):
                    Wb[ci, ri, int(np.clip(p0 + off, 0, n_psi - 1))] \
                        += w4[k]
            else:
                Wb[ci, ri, p0] = 1.0 - fp
                Wb[ci, ri, p0 + 1] = fp
    return Wf.astype(np.float32), Wb.astype(np.float32), psis


def _hilbert_kernel(C, dgamma, L):
    """Band-limited (1/pi)/sin(g) convolution taps, length-L circular
    layout (odd taps 2 dg / (pi sin(j dg)), even taps 0)."""
    k = np.zeros(L, np.float64)
    j = np.arange(1, C)
    odd = j[j % 2 == 1]
    vals = 2.0 * dgamma / (np.pi * np.sin(odd * dgamma))
    k[odd] = vals
    k[L - odd] = -vals  # antisymmetric
    return k


_ARRAY_KEYS = ("betas", "src_z", "Wf", "Wb", "kern_im", "cosk")


def katsevich_arrays_from_numpy(arrays_np, device):
    """The JAX package's ``katsevich._host_prep`` arrays (as numpy) -> this
    port's float32 tensors on ``device``, so both chains run on identical
    tables."""
    return {k: torch.as_tensor(np.array(arrays_np[k]), dtype=torch.float32,
                               device=device) for k in _ARRAY_KEYS}


def _host_prep(sino_shape, geometry, n_matrix, fov, *, z_out, n_psi, taper,
               interp, deriv, ramp, window, device):
    """Validation and host tables: ``(arrays, statics)`` for
    :func:`_filter_backproject_chain`, the arrays float32 tensors on
    ``device`` (the JAX ``_host_prep``'s, without ``view_block``)."""
    ct = geometry
    V, R, C = sino_shape[-3:]
    if R != ct.N_rows:
        raise ValueError(f"sinogram has {R} rows, geometry {ct.N_rows}")
    pitch = float(getattr(ct, "pitch", 0.0))
    if abs(pitch) < 1e-9:
        raise ValueError(
            "pitch = 0 has no PI window; use fdk_reconstruct")
    if getattr(ct, "ffs", "none") != "none":
        raise ValueError(
            "the Katsevich chain assumes a static focal spot; "
            "reconstruct z-FFS scans with helical_fdk_reconstruct")
    dgamma = float(ct.dgamma)
    dbeta = float(ct.rotation_total / V)
    betas = np.asarray(ct.betas, np.float64)
    src_z = np.asarray(ct.source_z, np.float64)
    gm = 0.5 * float(ct.gamma_fan)

    if z_out is None:
        # PI interval half-length <= (pi/2 + gm) * dbeta of views
        margin = (0.5 * np.pi + gm + 0.5) * pitch / (2.0 * np.pi)
        lo, hi = src_z[0] + margin, src_z[-1] - margin
        if hi <= lo:
            raise ValueError("scan too short for any full PI interval")
        nz = max(int((hi - lo) / ct.h_iso), 1)
        z_out = lo + (np.arange(nz) + 0.5) * (hi - lo) / nz
    z_out = np.asarray(z_out, np.float64)
    dz = float(z_out[1] - z_out[0]) if len(z_out) > 1 else float(ct.h_iso)

    if interp not in ("linear", "cubic"):
        raise ValueError(f"interp must be 'linear'|'cubic', got {interp}")
    Wf, Wb, _ = _plan(ct, int(n_psi), interp)

    if deriv not in ("spectral", "stencil4"):
        raise ValueError(
            f"deriv must be 'spectral'|'stencil4', got {deriv}")
    if taper is None:
        taper = 0.5 * float(ct.h_iso)
    cosk = ct.SID / np.sqrt(ct.SID ** 2 + np.asarray(ct.z_iso) ** 2)
    # Hilbert kernel spectrum: real antisymmetric -> purely imaginary
    L = 1
    while L < 3 * C:
        L *= 2
    kern_im = np.imag(np.fft.fft(_hilbert_kernel(C, dgamma, L)))
    arrays = katsevich_arrays_from_numpy(
        {"betas": betas, "src_z": src_z, "Wf": Wf, "Wb": Wb,
         "kern_im": kern_im, "cosk": cosk}, device)
    statics = dict(
        dbeta=dbeta, dgamma=dgamma, deriv=deriv, ramp=ramp,
        window=window, fft_len=int(L), sid=float(ct.SID),
        row_h=float(ct.h_iso), n_rows=int(R), pitch=pitch,
        n_matrix=int(n_matrix), nz_out=int(len(z_out)),
        fov=float(fov), dz_out=dz, z0=float(z_out[0]),
        beta_mid=float(0.5 * (betas[0] + betas[-1])),
        taper=float(taper), interp=interp)
    return arrays, statics


# ---------------------------------------------------------------------------
# K14: the fixed-direction derivative and cone weight
# ---------------------------------------------------------------------------

def _spectral_gamma_derivative(g, dgamma, ramp, window):
    """The window-apodized spectral derivative along channels, ``i w`` with
    the 2-D fan filter's rolloff (zero-padded to a power of two >= 2C)."""
    from .filters import _window

    C = g.shape[-1]
    L = 1
    while L < 2 * C:
        L *= 2
    f = np.fft.rfftfreq(L, d=dgamma)  # cycles / radian
    apod = _window(f / (0.5 / dgamma), ramp, window)
    mult_im = _f32((2.0 * np.pi) * f * apod, g.device)
    spec = torch.fft.rfft(g, n=L, dim=-1) * (1j * mult_im)
    return torch.fft.irfft(spec, n=L, dim=-1)[..., :C].to(g.dtype)


def _centred_difference(g, dim, step):
    """``(8 (g[i+1] - g[i-1]) - (g[i+2] - g[i-2])) / (12 step)`` along
    ``dim`` with the edge samples replicated."""
    n = g.shape[dim]
    idx = torch.arange(n, device=g.device)

    def at(k):
        return g.index_select(dim, torch.clamp(idx + k, 0, n - 1))

    num = 8.0 * (at(1) - at(-1)) - (at(2) - at(-2))
    return num / torch.full_like(num, 12.0 * step)


def _fixed_direction_derivative_plain(g, cosk, dbeta, dgamma, *,
                                      deriv="stencil4", ramp=0.8,
                                      window="sinc"):
    """``(dg/dbeta - dg/dgamma) cos(kappa)[row]`` of ``g [..., V, R, C]``
    in torch: ``dexct_tpu.ops.katsevich._fixed_direction_derivative``
    followed by the chain's cone weight, in the JAX program's order."""
    g = g.to(torch.float32)
    d_b = _centred_difference(g, -3, dbeta)
    if deriv == "spectral":
        d_c = _spectral_gamma_derivative(g, dgamma, ramp, window)
    else:
        d_c = _centred_difference(g, -1, dgamma)
    return (d_b - d_c) * cosk.to(g)[:, None]


@functools.lru_cache(maxsize=1)
def _derivative_kernel():
    """Compile-on-first-use Triton kernel (``triton`` is imported here, not
    at module import: a CPU-only installation has no triton)."""
    import triton
    import triton.language as tl

    @triton.jit
    def derivative_kernel(g_ptr, dc_ptr, cosk_ptr, out_ptr, n, V, R, C,
                          den_b, den_c, SPECTRAL: tl.constexpr,
                          BLOCK: tl.constexpr):
        offs = (tl.program_id(0).to(tl.int64) * BLOCK
                + tl.arange(0, BLOCK).to(tl.int64))
        mask = offs < n
        c = offs % C
        r = (offs // C) % R
        v = (offs // (R * C)) % V
        rc = R * C
        view0 = offs - v * rc  # this (image, row, channel) at view 0
        row0 = offs - c  # channel 0 of this (image, view, row)
        vm2 = tl.maximum(v - 2, 0) * rc
        vm1 = tl.maximum(v - 1, 0) * rc
        vp1 = tl.minimum(v + 1, V - 1) * rc
        vp2 = tl.minimum(v + 2, V - 1) * rc
        d_b = (8.0 * (tl.load(g_ptr + view0 + vp1, mask=mask, other=0.0)
                      - tl.load(g_ptr + view0 + vm1, mask=mask, other=0.0))
               - (tl.load(g_ptr + view0 + vp2, mask=mask, other=0.0)
                  - tl.load(g_ptr + view0 + vm2, mask=mask, other=0.0))
               ) / den_b
        if SPECTRAL:
            d_c = tl.load(dc_ptr + offs, mask=mask, other=0.0)
        else:
            cm2 = tl.maximum(c - 2, 0)
            cm1 = tl.maximum(c - 1, 0)
            cp1 = tl.minimum(c + 1, C - 1)
            cp2 = tl.minimum(c + 2, C - 1)
            d_c = (8.0 * (tl.load(g_ptr + row0 + cp1, mask=mask, other=0.0)
                          - tl.load(g_ptr + row0 + cm1, mask=mask,
                                    other=0.0))
                   - (tl.load(g_ptr + row0 + cp2, mask=mask, other=0.0)
                      - tl.load(g_ptr + row0 + cm2, mask=mask, other=0.0))
                   ) / den_c
        w = tl.load(cosk_ptr + r, mask=mask, other=0.0)
        tl.store(out_ptr + offs, (d_b - d_c) * w, mask=mask)

    return derivative_kernel


_BLOCK = 1024


def _derivative_cuda(g, cosk, dbeta, dgamma, deriv, ramp, window):
    dev = g.device
    V, R, C = g.shape[-3:]
    kernels.require(g, "g", dev, torch.float32)
    kernels.require(cosk, "cosk", dev, torch.float32, (R,))
    spectral = deriv == "spectral"
    d_c = (_spectral_gamma_derivative(g, dgamma, ramp, window).contiguous()
           if spectral else g)  # unused by the stencil kernel
    out = torch.empty_like(g)
    n = g.numel()
    grid = (max(-(-n // _BLOCK), 1),)
    with torch.cuda.device(dev):
        _derivative_kernel()[grid](
            g, d_c, cosk, out, n, V, R, C, float(np.float32(12.0 * dbeta)),
            float(np.float32(12.0 * dgamma)), SPECTRAL=spectral,
            BLOCK=_BLOCK, num_warps=4)
    _fixed_direction_derivative.launches += 1
    return out


def _fixed_direction_derivative(g, cosk, dbeta, dgamma, *, deriv="stencil4",
                                ramp=0.8, window="sinc"):
    """Stages 1-2 of the chain: ``g1 = (dg/dbeta - dg/dgamma) cosk[row]``
    of ``g [..., V, R, C]``, the derivative at constant ray direction
    (direction depends on ``beta + gamma`` only) times the cone weight.
    The beta partial is a 4th-order centred difference with edge views
    replicated; the gamma partial is selected by ``deriv``: ``"spectral"``,
    the exact FFT derivative apodized by the fan filter's window
    (``ramp``, ``window``), or ``"stencil4"``, the 4th-order centred
    difference with edge channels replicated.

    CUDA tensors run kernel K14 (counted in
    ``_fixed_direction_derivative.launches``; the spectral derivative's
    FFTs are cuFFT); CPU tensors run
    :func:`_fixed_direction_derivative_plain`.
    """
    if deriv not in ("spectral", "stencil4"):
        raise ValueError(
            f"deriv must be 'spectral'|'stencil4', got {deriv}")
    if g.dim() < 3:
        raise ValueError(f"g must be [..., V, R, C], got {tuple(g.shape)}")
    kw = dict(deriv=deriv, ramp=ramp, window=window)
    if g.is_cuda:
        return _derivative_cuda(g, cosk, float(dbeta), float(dgamma), **kw)
    if g.device.type != "cpu":
        raise ValueError(f"unsupported device {g.device}")
    return _fixed_direction_derivative_plain(g, cosk, float(dbeta),
                                             float(dgamma), **kw)


_fixed_direction_derivative.launches = 0


# ---------------------------------------------------------------------------
# K15: the PI-window backprojection
# ---------------------------------------------------------------------------

def _katsevich_z(nz_out, dz_out, z0, device):
    """Slice centres of the JAX Katsevich grid (float64, then float32)."""
    return _f32(z0 + np.arange(nz_out) * dz_out, device)


def _z_reach(pitch, C, dgamma, taper, sid, fov):
    """How far [cm] a slice may lie from a view's source z and still take a
    nonzero tapered Tam-Danielsson weight: the window's largest height over
    the fan, hmax = |P / 4 pi| (pi + 2 gm) / cos gm + taper / 2, magnified
    to the far edge of the FOV disc (the JAX program's slice-window ``Dz``)."""
    gm = 0.5 * C * dgamma
    hmax = (abs(pitch / (4.0 * np.pi)) * (np.pi + 2.0 * gm) / np.cos(gm)
            + 0.5 * taper)
    return hmax * (sid + 0.5 * fov) / sid


def _pi_terms(X, Y, zc, beta, sz, sid, dgamma, row_h, R, C, qp, taper):
    """The geometry of a block of views ``beta``, ``sz [B]`` at the disc
    pixels ``X``, ``Y [P]`` and slices ``zc [nz]``: the channel index
    ``[B, P]``, the row index and the weight ``[B, nz, P]``, which is the
    amplitude ``1 / max(ell, 1e-3)`` on the detector times the tapered
    Tam-Danielsson window (0 where the term adds nothing)."""
    cb, sb = torch.cos(beta)[:, None], torch.sin(beta)[:, None]
    ell = sid - (X[None, :] * cb + Y[None, :] * sb)  # [B, P]
    vt = -X[None, :] * sb + Y[None, :] * cb
    gam = torch.atan2(-vt, ell)
    h2 = ell * ell + vt * vt
    inv_h = torch.ones_like(h2) / torch.sqrt(h2)
    cidx = gam / torch.full_like(gam, dgamma) - 0.5 + C / 2.0
    w_in = ((cidx >= 0.0) & (cidx <= C - 1.0)).to(torch.float32)
    w_amp = w_in / torch.clamp_min(ell, 1e-3)
    cg = torch.cos(gam)
    htop = (qp * (np.pi + 2.0 * gam) / cg)[:, None, :]
    hbot = (-qp * (np.pi - 2.0 * gam) / cg)[:, None, :]
    zt = ((zc[None, :] - sz[:, None]) * sid)[:, :, None] \
        * inv_h[:, None, :]  # [B, nz, P]
    ridx = zt / torch.full_like(zt, row_h) - 0.5 + R / 2.0
    w_z = ((ridx >= -0.5) & (ridx <= R - 0.5)).to(torch.float32)
    tap = torch.full_like(zt, taper)
    w_td = (torch.clamp((zt - hbot) / tap + 0.5, 0.0, 1.0)
            * torch.clamp((htop - zt) / tap + 0.5, 0.0, 1.0))
    return cidx, ridx, w_amp[:, None, :] * w_z * w_td


def _katsevich_backproject_plain(gf, betas, src_z, sid, dgamma, row_h,
                                 n_rows, pitch, n_matrix, nz_out, fov, dz_out,
                                 z0, dbeta, taper, *, interp="linear",
                                 view_block=8):
    """``dexct_tpu.ops.katsevich._katsevich_backproject`` in torch over
    every view (the JAX program's full scan), blocks of ``view_block``
    views over every (disc pixel, slice); divisions between tensors."""
    M, V, R, C = gf.shape
    dev = gf.device
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _katsevich_z(nz_out, dz_out, z0, dev)
    betas = betas.to(device=dev, dtype=torch.float32)
    src_z = src_z.to(device=dev, dtype=torch.float32)
    qp = pitch / (4.0 * np.pi)
    gflat = gf.to(torch.float32).reshape(M, -1)
    acc = gflat.new_zeros((M, nz_out, X.shape[0]))

    def lerp(rows, base, c0, fc):  # channel lerp of every image at rows
        i = base + rows * C + c0
        return gflat[:, i] * (1 - fc) + gflat[:, i + 1] * fc

    for v0 in range(0, V, view_block):
        cidx, ridx, w = _pi_terms(X, Y, zc, betas[v0:v0 + view_block],
                                  src_z[v0:v0 + view_block], sid, dgamma,
                                  row_h, R, C, qp, taper)
        c0 = torch.clamp(torch.floor(cidx), 0, C - 2)
        fc = torch.clamp(cidx - c0, 0.0, 1.0)[:, None, :]
        c0 = c0.to(torch.int64)[:, None, :]
        r0 = torch.clamp(torch.floor(ridx), 0, max(R - 2, 0))
        fr = torch.clamp(ridx - r0, 0.0, 1.0)
        r0 = r0.to(torch.int64)
        base = (torch.arange(v0, v0 + w.shape[0], device=dev)
                * (R * C))[:, None, None]
        if interp == "cubic":
            fr2 = fr * fr
            fr3 = fr * fr * fr
            wr = (-0.5 * fr + fr2 - 0.5 * fr3,
                  1.0 - 2.5 * fr2 + 1.5 * fr3,
                  0.5 * fr + 2.0 * fr2 - 1.5 * fr3,
                  -0.5 * fr2 + 0.5 * fr3)
            rows = [torch.clamp(r0 + d, 0, R - 1) for d in (-1, 0, 1, 2)]
        else:
            wr = (1.0 - fr, fr)
            rows = [r0, torch.clamp_max(r0 + 1, R - 1)]
        val = None
        for wj, rj in zip(wr, rows):
            term = wj * lerp(rj, base, c0, fc)
            val = term if val is None else val + term
        acc += (val * w).sum(1)
    return _place(acc * (-dbeta / (2.0 * np.pi)), sel, n_matrix)


def _katsevich_cuda(gf, betas, src_z, sid, dgamma, row_h, pitch, n_matrix,
                    nz_out, fov, dz_out, z0, dbeta, taper, interp):
    dev = gf.device
    M, V, R, C = gf.shape
    kernels.require(gf, "gf", dev, torch.float32)
    kernels.require(betas, "betas", dev, torch.float32, (V,))
    kernels.require(src_z, "src_z", dev, torch.float32, (V,))
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _katsevich_z(nz_out, dz_out, z0, dev)
    cos_b, sin_b = torch.cos(betas), torch.sin(betas)
    sz_ends = src_z[[0, -1]].tolist()  # the views' source z is linear in v
    dzv = (sz_ends[1] - sz_ends[0]) / max(V - 1, 1)
    z_reach = (_z_reach(pitch, C, dgamma, taper, sid, fov)
               if V > 1 and dzv != 0.0 else 0.0)  # 0: every view
    out = torch.zeros((M, nz_out, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_katsevich_backproject(
        gf.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), src_z.data_ptr(),
        X.data_ptr(), Y.data_ptr(), sel.data_ptr(), zc.data_ptr(),
        out.data_ptr(), M, int(interp == "cubic"), V, R, C, X.shape[0],
        nz_out, n_matrix * n_matrix, sid, dgamma, row_h,
        pitch / (4.0 * np.pi), taper, -dbeta / (2.0 * np.pi), sz_ends[0],
        dzv, z_reach, kernels.stream_ptr(dev))
    kernels.check(rc, "katsevich_backproject")
    _katsevich_backproject.launches += 1
    return out


def _katsevich_backproject(gf, betas, src_z, sid, dgamma, row_h, n_rows,
                           pitch, n_matrix, nz_out, fov, dz_out, z0, beta_mid,
                           dbeta, taper, *, interp="linear"):
    """PI-window backprojection of the Katsevich-filtered data.

    gf: ``[V, R, C]`` or ``[M, V, R, C]`` (stacked volumes share every tap
    and weight); betas, src_z: ``[V]``, uniformly spaced views.  Per (disc
    pixel, slice, view): amplitude ``1 / max(ell, 1e-3)`` (in-plane
    distance), the tapered Tam-Danielsson window (weight 1/2 on its
    boundary), linear or 4-row Catmull-Rom (``interp="cubic"``) row taps
    times two channel taps, no normalization; the sum is multiplied by
    ``-dbeta / 2 pi``.  Returns ``[nz, N, N]`` / ``[M, nz, N, N]``.
    ``beta_mid`` is unused, as in the JAX program.

    CUDA tensors run kernel K15 (counted in
    ``_katsevich_backproject.launches``), which visits per slice only the
    views whose source z can reach it (the terms it skips are exact
    zeros); CPU tensors run :func:`_katsevich_backproject_plain` over every
    view.  The JAX program's ``view_block`` and ``slice_window`` are
    gather layouts of the same image and are left out.
    """
    del beta_mid
    if interp not in ("linear", "cubic"):
        raise ValueError(f"interp must be 'linear'|'cubic', got {interp}")
    g4, single = _stack(gf, "gf")
    _check_stack(g4, "gf")
    if g4.shape[2] != n_rows:
        raise ValueError(f"gf has {g4.shape[2]} rows, n_rows={n_rows}")
    args = (float(sid), float(dgamma), float(row_h))
    grid = (int(n_matrix), int(nz_out), float(fov), float(dz_out), float(z0),
            float(dbeta), float(taper))
    if g4.is_cuda:
        out = _katsevich_cuda(g4, betas, src_z, *args, float(pitch), *grid,
                              interp)
    elif g4.device.type != "cpu":
        raise ValueError(f"unsupported device {g4.device}")
    else:
        out = _katsevich_backproject_plain(g4, betas, src_z, *args,
                                           int(n_rows), float(pitch), *grid,
                                           interp=interp)
    return out[0] if single else out


_katsevich_backproject.launches = 0


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------

def _katsevich_filter(g, Wf, Wb, kern_im, cosk, *, dbeta, dgamma, deriv,
                      ramp, window, fft_len):
    """Stages 1-5 of the Katsevich chain on ``g [M, V, R, C]``: K14, the
    forward kappa rebinning, the Hilbert filter along each kappa line and
    the backward rebinning.  Returns the filtered data ``[M, V, R, C]``."""
    C = g.shape[-1]
    # 1-2. derivative at constant ray direction, cone weight (K14)
    g1 = _fixed_direction_derivative(g, cosk, dbeta, dgamma, deriv=deriv,
                                     ramp=ramp, window=window)
    # 3. forward kappa rebinning (a dense float32 contraction over rows)
    gk = torch.einsum("mvrc,pcr->mvpc", g1, Wf)
    # 4. Hilbert filter along the kappa line: the kernel's spectrum is
    # purely imaginary and odd, so the half spectrum carries it exactly
    half = fft_len // 2 + 1
    spec = torch.fft.rfft(gk, n=fft_len, dim=-1) * (1j * kern_im[:half])
    gh = torch.fft.irfft(spec, n=fft_len, dim=-1)[..., :C].contiguous()
    del gk, spec
    # 5. backward rebinning to detector rows
    return torch.einsum("mvpc,crp->mvrc", gh, Wb).contiguous()


def _filter_backproject_chain(g, betas, src_z, Wf, Wb, kern_im, cosk, *,
                              dbeta, dgamma, deriv, ramp, window, fft_len,
                              sid, row_h, n_rows, pitch, n_matrix, nz_out,
                              fov, dz_out, z0, beta_mid, taper, interp):
    """Stages 1-6 of the Katsevich chain on ``g [M, V, R, C]``:
    :func:`_katsevich_filter`, then the PI backprojection (K15).  Returns
    ``[M, nz_out, N, N]``."""
    gf = _katsevich_filter(g, Wf, Wb, kern_im, cosk, dbeta=dbeta,
                           dgamma=dgamma, deriv=deriv, ramp=ramp,
                           window=window, fft_len=fft_len)
    return _katsevich_backproject(
        gf, betas, src_z, sid, dgamma, row_h, n_rows, pitch, n_matrix,
        nz_out, fov, dz_out, z0, beta_mid, dbeta, taper, interp=interp)


def katsevich_reconstruct(sino_log, geometry, n_matrix, fov, *, z_out=None,
                          n_psi=128, view_block=None, taper=None,
                          interp="linear", deriv="spectral", ramp=0.8,
                          window="sinc"):
    """Katsevich exact helical FBP -> ``[nz, N, N]`` in cm^-1 (or
    ``[M, nz, N, N]`` for a stack ``[M, V, R, C]``, all volumes through one
    chain and one K15 launch).

    ``sino_log``: helical line integrals on a uniform view grid of a
    :class:`~dexct_tpu_torch.system.geometry.HelicalConeBeamGeometry`.
    ``z_out`` defaults to the slices whose PI intervals fit the scan;
    ``n_psi`` kappa filtering lines; ``taper``: the TD-window edge feather
    in iso-height cm (default half a row).  ``deriv``/``ramp``/``window``
    select the gamma derivative (:func:`_fixed_direction_derivative`; the
    default window-matched spectral one gives the fan/FDK in-plane MTF).
    ``interp``: "linear" or "cubic" (Catmull-Rom) in both rebinnings and
    the backprojector's rows.  Raises ``ValueError`` at pitch 0, for a
    flying focal spot, when the TD window is taller than the detector and
    when the scan is too short for any full PI interval.  ``view_block`` (a TPU
    view-block layout) is accepted and ignored.
    """
    del view_block
    stack, single = _stack(sino_log)
    arrays, statics = _host_prep(
        stack.shape, geometry, n_matrix, fov, z_out=z_out, n_psi=n_psi,
        taper=taper, interp=interp, deriv=deriv, ramp=ramp, window=window,
        device=stack.device)
    out = _filter_backproject_chain(
        stack.to(torch.float32).contiguous(), *(arrays[k] for k in
                                                _ARRAY_KEYS), **statics)
    return out[0] if single else out
