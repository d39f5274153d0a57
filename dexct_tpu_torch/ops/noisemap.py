"""Analytic FBP noise maps: per-pixel reconstruction variance without
ensembles.

Port of :mod:`dexct_tpu.ops.noisemap`.  FBP is linear in the log
sinogram, so the recon variance at every pixel is an exact quadratic
propagation of the per-ray measurement variance (rays independent; the
filter correlates *channels within a view*, views stay independent):

1. **log stage** (delta method): ``var(log) = var(counts) / counts²``
   — Poisson (var = counts) or the compound-EID second moment.
2. **filter stage**: ``q = dγ · h ⊛ (SID cosγ · sino)`` makes
   ``var(q_c) = dγ² Σ_k h²[c−k] (SID cosγ)²_k var_k`` and the adjacent-
   channel covariance ``cov(q_c, q_{c+1})`` the same convolution with
   the lag-1 kernel ``h[d]h[d+1]`` — one FFT each (``torch.fft``, cuFFT
   on the card).
3. **backprojection stage**: the bilinear interpolation
   ``(1−f) q_{c0} + f q_{c0+1}`` contributes
   ``(1−f)² var_0 + f² var_1 + 2f(1−f) cov_01``, weighted ``(dβ / L²)²``
   per view: kernel K25 on the card (``csrc/fan_backproject.cu``, beside
   K4, whose channel geometry it shares), the plain twin
   :func:`_fan_backproject_var_plain` on the CPU.  The dual-energy basis
   maps' three fields (var1, var2, cov12) share one launch.

Uses: predicted noise maps for protocol planning (pair with
``ops/dose.py``), per-pixel statistical weights.  Fan-beam full-scan
geometry (the production recon path).  The entry points run on the device
of their sinogram argument when it is a tensor, else on ``device``
(default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import device_of
from .fbp_fast import _pixel_coords
from .filters import filter_frequency_response

__all__ = ["log_variance", "fbp_variance_map", "decomposition_covariance",
           "basis_variance_maps", "vmi_variance_map"]

# fields per K25 launch: one map, or the three basis fields
FIELDS = (1, 3)
# views per block of decomposition_covariance: bounds its [views, C, E]
# float32 intermediates (~74 MB each at 800 channels x 232 bins)
_COV_VIEWS = 100


def log_variance(counts, var_counts=None, *, device=None):
    """Delta-method variance of the log sinogram.

    var_counts defaults to ``counts`` (Poisson); pass the compound-EID
    per-ray variance (``counts_from_paths`` of the second-moment
    fluence, ops/spectral.py) for energy-integrating detectors.
    """
    dev = device_of(counts, device)
    c = torch.clamp_min(torch.as_tensor(counts, device=dev), 1e-30)
    v = c if var_counts is None else torch.as_tensor(var_counts, device=dev)
    return v / (c * c)


def _cov_filter(s, k0, k1, m, dgamma):
    """Variance and lag-1 covariance of the filtered sinogram.

    s: [..., V, C] (pre-weight² · log-variance); k0/k1: [m] spatial
    kernels (h², h·h₊₁) in the filter's rolled layout.  Returns (r0, r1)
    [..., V, C]."""
    n_ch = s.shape[-1]
    spec = torch.fft.rfft(s, n=m, dim=-1)
    r0 = torch.fft.irfft(spec * torch.fft.rfft(k0), n=m, dim=-1)[..., :n_ch]
    r1 = torch.fft.irfft(spec * torch.fft.rfft(k1), n=m, dim=-1)[..., :n_ch]
    scale = dgamma * dgamma
    return r0 * scale, r1 * scale


def _fan_backproject_var_plain(r0, r1, betas, sid, dgamma, n_matrix, fov,
                               dbeta, *, view_block=64):
    """The JAX program ``_fan_backproject_var`` in torch: blocks of
    ``view_block`` views, every pixel at once; r0, r1 [F, V, C] -> [F, N,
    N]."""
    n_fields, n_proj, n_ch = r0.shape
    dtype, dev = r0.dtype, r0.device
    X, Y = _pixel_coords(n_matrix, fov, dtype, dev)
    betas = betas.to(device=dev, dtype=dtype)
    acc = torch.zeros((n_fields, n_matrix * n_matrix), dtype=dtype,
                      device=dev)
    for v0 in range(0, n_proj, view_block):
        beta = betas[v0:v0 + view_block]
        cb, sb = torch.cos(beta)[:, None], torch.sin(beta)[:, None]
        vr = X[None, :] * cb + Y[None, :] * sb - sid
        vt = -X[None, :] * sb + Y[None, :] * cb
        gamma = torch.atan2(-vt, -vr)
        L2 = vr * vr + vt * vt
        # a tensor divisor: PyTorch on CUDA divides by a Python scalar
        # through its reciprocal, which moves the hard fan edge
        c = gamma / torch.full_like(gamma, dgamma) - 0.5 + n_ch / 2.0
        c0 = torch.clamp(torch.floor(c), 0, n_ch - 2)
        fc = torch.clamp(c - c0, 0.0, 1.0)
        inside = (c >= 0.0) & (c <= n_ch - 1.0)
        idx = (torch.arange(v0, v0 + beta.shape[0], device=dev)[:, None]
               * n_ch + c0.to(torch.int64)).reshape(-1)
        for k in range(n_fields):
            v_0, v_1 = r0[k].reshape(-1), r1[k].reshape(-1)
            var_i = ((1.0 - fc) ** 2 * v_0[idx].reshape(fc.shape)
                     + fc * fc * v_0[idx + 1].reshape(fc.shape)
                     + 2.0 * fc * (1.0 - fc) * v_1[idx].reshape(fc.shape))
            acc[k] += torch.where(inside, var_i / (L2 * L2),
                                  torch.zeros_like(L2)).sum(0)
    return (acc * float(np.float32(dbeta * dbeta))).reshape(
        n_fields, n_matrix, n_matrix)


def _fan_backproject_var_cuda(r0, r1, betas, sid, dgamma, n_matrix, fov,
                              dbeta):
    dev = r0.device
    n_fields, V, C = r0.shape
    kernels.require(r0, "r0", dev, torch.float32)
    kernels.require(r1, "r1", dev, torch.float32, (n_fields, V, C))
    betas = betas.to(device=dev, dtype=torch.float32)
    if betas.shape != (V,):
        raise ValueError(f"betas must be [{V}], got {tuple(betas.shape)}")
    cos_b = torch.cos(betas).contiguous()
    sin_b = torch.sin(betas).contiguous()
    out = torch.empty((n_fields, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_fan_backproject_var(
        r0.data_ptr(), r1.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
        out.data_ptr(), n_fields, V, C, n_matrix, fov / n_matrix,
        n_matrix / 2.0, sid, dgamma, float(np.float32(dbeta * dbeta)),
        kernels.stream_ptr(dev))
    kernels.check(rc, "fan_backproject_var")
    _fan_backproject_var.launches += 1
    return out


def _fan_backproject_var(r0, r1, betas, sid, dgamma, n_matrix, fov, *,
                         view_block=64, dbeta=None):
    """Squared-weight backprojection of (variance, lag-1 covariance).

    r0, r1: [V, C] or [F, V, C] (F = 3 fields backprojected with one
    geometry); betas [V].  Returns [N, N] (or [F, N, N]) times dbeta²
    (``dbeta`` defaults to 2 pi / V).  CUDA tensors run kernel K25
    (counted in ``_fan_backproject_var.launches``); CPU tensors run
    :func:`_fan_backproject_var_plain` (``view_block`` views at a
    time)."""
    single = r0.dim() == 2
    if single:
        r0, r1 = r0[None], r1[None]
    n_fields, n_proj, n_ch = r0.shape
    if n_fields not in FIELDS:
        raise ValueError(f"backprojects 1 or 3 fields, got {n_fields}")
    if n_ch < 2:
        raise ValueError("fan backprojection needs at least 2 channels")
    if dbeta is None:
        dbeta = 2.0 * np.pi / n_proj if n_proj else 0.0
    args = (r0, r1, betas, float(sid), float(dgamma), int(n_matrix),
            float(fov), float(dbeta))
    if r0.is_cuda:
        out = _fan_backproject_var_cuda(*args)
    elif r0.device.type == "cpu":
        out = _fan_backproject_var_plain(*args, view_block=view_block)
    else:
        raise ValueError(f"unsupported device {r0.device}")
    return out[0] if single else out


_fan_backproject_var.launches = 0


def _variance_filters(geometry, ramp, window, dtype, dev):
    """(k0, k1, m, w_pre): the lag-0 and lag-1 variance kernels h² and
    h·h₊₁ in the filter's rolled layout on an ``m`` grid, and the squared
    pre-weight (SID cos γ)², as tensors on ``dev``."""
    H, m = filter_frequency_response(geometry.N_channels, geometry.dgamma,
                                     ramp, window, "fan")
    h_sp = np.fft.irfft(H, m)
    k0 = torch.as_tensor(h_sp * h_sp, dtype=dtype, device=dev)
    k1 = torch.as_tensor(h_sp * np.roll(h_sp, -1), dtype=dtype, device=dev)
    w_pre = torch.as_tensor(
        (float(geometry.SID) * np.cos(np.asarray(geometry.gammas))) ** 2,
        dtype=dtype, device=dev)
    return k0, k1, m, w_pre


def _propagate(fields, geometry, n_matrix, fov, ramp, window, dtype):
    """Filter and backproject F log-domain variance fields [F, V, C]."""
    dev = fields.device
    k0, k1, m, w_pre = _variance_filters(geometry, ramp, window, dtype, dev)
    r0, r1 = _cov_filter(fields * w_pre, k0, k1, m, float(geometry.dgamma))
    return _fan_backproject_var(
        r0.contiguous(), r1.contiguous(),
        torch.as_tensor(geometry.betas, dtype=dtype, device=dev),
        float(geometry.SID), float(geometry.dgamma), int(n_matrix),
        float(fov), dbeta=float(geometry.rotation_total) / geometry.N_proj)


def fbp_variance_map(counts, geometry, n_matrix, fov, ramp=0.8,
                     window="sinc", *, var_counts=None, mu_water_eff=None,
                     dtype=torch.float32, device=None):
    """Predicted per-pixel variance of the fan-beam FBP reconstruction.

    counts: [V, C] detected counts (noise source); var_counts: per-ray
    count variance (default Poisson = counts).  Returns the variance
    map of ``recon_raw`` [1/cm²]; pass ``mu_water_eff`` to get the
    variance of ``recon_HU`` instead (scaled by (1000/mu_w)²).

    Full-scan equiangular fan geometry (the production 2-D recon);
    short-scan/parallel/FFS paths are not modeled here.  Runs on the device
    of ``counts`` when it is a tensor, else on ``device`` (default: the
    card: kernel K25).
    """
    from ..system.geometry import ParallelBeamGeometry

    if isinstance(geometry, ParallelBeamGeometry) or \
            getattr(geometry, "ffs", "none") != "none":
        raise ValueError("variance map models the direct fan-beam FBP "
                         "path only")
    dev = device_of(counts, device)
    var_log = log_variance(counts, var_counts, device=dev).to(dtype)
    var = _propagate(var_log[None], geometry, n_matrix, fov, ramp, window,
                     dtype)[0]
    if mu_water_eff is not None:
        var = var * (1000.0 / float(mu_water_eff)) ** 2
    return var


# ---------------------------------------------------------------------------
# Dual-energy extension: basis-image noise + analytic VMI noise curves
# ---------------------------------------------------------------------------

def _info_blocks(a, mus, i0, var_scale):
    """Fisher information [v, C, 2, 2] of one block of views a [v, C, 2]."""
    L = torch.matmul(a, mus)  # [v, C, E]
    att = torch.exp(-torch.clamp(L, 0.0, 700.0))
    c = torch.matmul(att, i0.T)  # [v, C, 2]
    # J[v,c,i,m] = -sum_E i0_iE mu_mE att_E
    p = (i0[:, None, :] * mus[None, :, :]).reshape(4, -1)
    J = -torch.matmul(att, p.T).reshape(*att.shape[:-1], 2, 2)
    var_c = c if var_scale is None else c * var_scale
    w = 1.0 / torch.clamp_min(var_c, 1e-30)  # [v, C, 2]
    return torch.einsum("vcim,vci,vcin->vcmn", J, w, J)


def decomposition_covariance(a_sinos, geometry, spec1, spec2, *,
                             basis=None, compound=False, device=None):
    """Per-ray CRLB covariance of the 2-basis decomposition.

    a_sinos: [V, C, 2] basis-coefficient sinogram (the noiseless
    decomposition or the exact basis projections — the linearization
    point).  Returns ``cov [V, C, 2, 2]`` — the asymptotic (Fisher)
    covariance the Poisson-MLE GN solve attains:

        I_mn = sum_i (dc_i/da_m)(dc_i/da_n) / var_i,   cov = I^{-1}

    with ``var_i = c_i`` (Poisson) or the compound-EID second moment
    when ``compound=True``.  The classic DE anticorrelation
    (cov_12 < 0) falls out.  Float32 on the device of ``a_sinos`` when it
    is a tensor, else on ``device`` (default: the card), in blocks of
    views (each block's [views, C, E] intermediates stay ~74 MB at 100
    views x 800 channels x 232 bins).
    """
    from .matdecomp import DEFAULT_BASIS, prepare_decomposition
    from .spectral import second_moment_fluence

    basis = DEFAULT_BASIS if basis is None else basis
    dev = device_of(a_sinos, device)
    f32 = dict(dtype=torch.float32, device=dev)
    _, i0, mus = prepare_decomposition(geometry, spec1, spec2, basis)
    a = torch.as_tensor(a_sinos, **f32)
    mus_t = torch.as_tensor(mus, **f32)  # [2, E]
    i0_t = torch.as_tensor(i0, **f32)  # [2, E]
    var_scale = None
    if compound:
        # var_i = sum_E n_E w_E^2 att_E with the union-grid tables:
        # approximate via the per-spectrum second-moment ratio
        i2 = []
        for spec in (spec1, spec2):
            r = second_moment_fluence(spec, geometry)
            n = spec.I0 * spec.bin_widths()
            # mean per-detected-unit weight: fold into the union grid
            i2.append(float(np.sum(r)) / max(float(np.sum(
                n * geometry.detector_response(spec.E))), 1e-300))
        var_scale = torch.as_tensor(i2, **f32)
    info = torch.cat([_info_blocks(a[v0:v0 + _COV_VIEWS], mus_t, i0_t,
                                   var_scale)
                      for v0 in range(0, a.shape[0], _COV_VIEWS)])
    det = (info[..., 0, 0] * info[..., 1, 1]
           - info[..., 0, 1] * info[..., 1, 0])
    det = torch.where(torch.abs(det) > 1e-30, det,
                      torch.full_like(det, 1e-30))
    cov = torch.stack([
        torch.stack([info[..., 1, 1], -info[..., 0, 1]], -1),
        torch.stack([-info[..., 1, 0], info[..., 0, 0]], -1)], -2)
    return cov / det[..., None, None]


def basis_variance_maps(cov_rays, geometry, n_matrix, fov, ramp=0.8,
                        window="sinc", dtype=torch.float32, device=None):
    """FBP-propagate the per-ray basis covariance to image space.

    cov_rays: [V, C, 2, 2] from :func:`decomposition_covariance`.
    Returns (var1, var2, cov12) image maps — the linear FBP applies the
    SAME weights to both basis sinograms, so the cross-covariance
    propagates through the identical quadratic form as the variances.
    The three fields are filtered together and backprojected by one K25
    launch on the card.
    """
    dev = device_of(cov_rays, device)
    cov = torch.as_tensor(cov_rays, dtype=dtype, device=dev)
    fields = torch.stack([cov[..., 0, 0], cov[..., 1, 1], cov[..., 0, 1]])
    out = _propagate(fields, geometry, n_matrix, fov, ramp, window, dtype)
    return out[0], out[1], out[2]


def vmi_variance_map(var1, var2, cov12, e0_keV, *, basis=None,
                     device=None):
    """Predicted VMI variance map [HU^2] at energy ``e0_keV``.

    The VMI is the linear combination ``mu = a_1 m_1(E0) + a_2 m_2(E0)``
    (plots.py:136-144), so its variance is the quadratic form over the
    basis-image covariance — including the (negative) cross term that
    produces the classic VMI noise minimum between the kVp energies.
    Elementwise on the device of ``var1`` when it is a tensor, else on
    ``device`` (default: the card).
    """
    from ..physics import xcom
    from .matdecomp import DEFAULT_BASIS

    basis = DEFAULT_BASIS if basis is None else basis
    e = np.atleast_1d(np.float64(e0_keV))
    m1 = float(basis[0].mass_atten(e)[0])
    m2 = float(basis[1].mass_atten(e)[0])
    mu_w = float(xcom.mixatten("H(11.2)O(88.8)", e)[0])
    dev = device_of(var1, device)
    var1, var2, cov12 = (torch.as_tensor(x, device=dev)
                         for x in (var1, var2, cov12))
    var_mu = m1 * m1 * var1 + m2 * m2 * var2 + 2.0 * m1 * m2 * cov12
    return var_mu * (1000.0 / mu_w) ** 2
