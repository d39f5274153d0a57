"""Filtered back-projection, fan-beam and parallel-beam.

Port of :mod:`dexct_tpu.ops.fbp`: cos(gamma) pre-weighting, FFT
ramp/sinc filtering (``torch.fft``) and distance-weighted backprojection
with linear channel interpolation (Kak & Slaney ch. 3.4, equiangular
geometry).  The backprojection of one image is kernel K4 with K = 1
(:func:`dexct_tpu_torch.ops.fbp_fast.fan_backproject_multi`); a
parallel-beam geometry backprojects through kernel K6 with K = 1
(:func:`dexct_tpu_torch.ops.fbp_fast.parallel_backproject_multi`), and an
in-plane flying-focal-spot scan rebins through K5 at 16 taps first
(:mod:`dexct_tpu_torch.ops.ffs`).
"""

from __future__ import annotations

import numpy as np
import torch

from .fbp_fast import (fan_backproject_multi, pack_filtered,
                       parallel_backproject_multi)
from ..utils.devices import check_float32, upload
from .filters import filter_frequency_response

__all__ = ["filter_sinogram", "filter_views", "fan_backproject",
           "parker_weights", "fbp_recon", "parallel_fbp", "hu_image"]


def filter_views(sino, cos_w, H, fft_len, dgamma):
    """Pre-weight by ``cos_w``, filter each view with the real response
    ``H`` on an ``fft_len`` grid, and scale by ``dgamma``."""
    n_ch = sino.shape[-1]
    spec = torch.fft.rfft(sino * cos_w, n=fft_len, dim=-1)
    filt = torch.fft.irfft(spec * H, n=fft_len, dim=-1)[..., :n_ch]
    return (filt * dgamma).to(sino.dtype)


def filter_sinogram(sino, geometry, ramp=0.8, window="sinc", dtype=None):
    """cos-weight + windowed-ramp filter each view (host-built response),
    on the device of ``sino``.  Returns the same shape, scaled by dgamma.
    ``dtype`` (the JAX signature's) must be float32 or None: the filter
    keeps the type of ``sino``.  The channel angles and the response go
    up through ``upload`` (no synchronising copy)."""
    check_float32(dtype)
    H, m = filter_frequency_response(geometry.N_channels, geometry.dgamma,
                                     ramp, window, "fan")
    w = torch.cos(upload(geometry.gammas, sino)) * geometry.SID
    return filter_views(sino, w, upload(H, sino), m, geometry.dgamma)


def fan_backproject(q, betas, sid, dgamma, n_matrix, fov, *, view_block=None,
                    dbeta=None):
    """Distance-weighted equiangular backprojection of one filtered
    sinogram q [N_proj, N_channels]; ``dbeta`` defaults to 2 pi / N_proj.
    Returns image [n_matrix, n_matrix].  ``view_block`` (a TPU view-block
    layout) is accepted and ignored."""
    del view_block
    n_proj, n_ch = q.shape
    if dbeta is None:
        dbeta = 2.0 * np.pi / n_proj if n_proj else 0.0
    return fan_backproject_multi(pack_filtered(q[None]), 1, betas, sid,
                                 dgamma, n_ch, n_matrix, fov, dbeta)[0]


def parker_weights(geometry):
    """Short-scan redundancy weights W[view, channel] (Parker 1982); full
    scans return ones; scans shorter than pi + gamma_fan raise."""
    two_pi = 2.0 * np.pi
    rot = float(geometry.rotation_total)
    gam_fan = float(geometry.gamma_fan)
    if rot >= two_pi - 1e-6:
        return np.ones((geometry.N_proj, geometry.N_channels))
    short = np.pi + gam_fan
    if rot < short - 1e-6:
        raise ValueError(
            f"rotation_total={rot:.4f} < pi + fan angle ({short:.4f}): "
            "not enough data for fan-beam FBP"
        )
    B, G = np.meshgrid(geometry.betas, geometry.gammas, indexing="ij")
    gm = gam_fan / 2.0
    w = np.ones_like(B)
    lo = gam_fan - 2.0 * G  # start-of-scan wedge
    with np.errstate(invalid="ignore", divide="ignore"):
        ws = np.sin(np.pi / 4.0 * B / np.maximum(gm - G, 1e-9)) ** 2
        we = np.sin(np.pi / 4.0 * (np.pi + gam_fan - B)
                    / np.maximum(gm + G, 1e-9)) ** 2
    w = np.where(B < lo, ws, w)
    w = np.where(B > np.pi - 2.0 * G, we, w)
    w = np.clip(w, 0.0, 1.0)
    w = np.where(B > np.pi + gam_fan, 0.0, w)
    # dbeta assumes full-2pi double coverage; short scans count each line
    # once, so the weights double
    return 2.0 * w


def hu_image(recon_raw, mu_water_eff):
    """cm^-1 -> Hounsfield units (formula pinned at plots.py:140-143).  A
    Python or NumPy scalar ``mu_water_eff`` enters as a tensor of the
    image's dtype on its device, as in ``spectral.log_sinogram``."""
    if not isinstance(mu_water_eff, torch.Tensor):
        mu_water_eff = torch.full((), float(mu_water_eff),
                                  dtype=recon_raw.dtype,
                                  device=recon_raw.device)
    return 1000.0 * (recon_raw - mu_water_eff) / mu_water_eff


def fbp_recon(sino_log, geometry, n_matrix, fov, ramp=0.8, window="sinc",
              mu_water_eff=None, dtype=None):
    """Full FBP on the device of ``sino_log``, in float32 (``dtype`` must be
    float32 or None): returns (recon_raw [1/cm], recon_HU or None).
    Dispatches on the geometry: equiangular fan beam (the reference's
    scanner), parallel beam, or a fan beam with an in-plane flying focal
    spot (the interleaved parallel rebin of
    :func:`~dexct_tpu_torch.ops.ffs.ffs_fbp_recon`).  The host tables
    (Parker weights, view angles) go up through ``upload``."""
    from ..system.geometry import ParallelBeamGeometry

    check_float32(dtype)

    if isinstance(geometry, ParallelBeamGeometry):
        img = parallel_fbp(sino_log, geometry, n_matrix, fov, ramp, window)
    elif getattr(geometry, "ffs", "none") != "none":
        # deflected-spot views break the uniform-gamma fan assumption of
        # the direct backprojector
        from .ffs import ffs_fbp_recon

        img = ffs_fbp_recon(sino_log, geometry, n_matrix, fov, ramp, window)
    else:
        sino_log = sino_log.to(torch.float32)
        if geometry.rotation_total < 2.0 * np.pi - 1e-6:
            sino_log = sino_log * upload(parker_weights(geometry), sino_log)
        q = filter_sinogram(sino_log, geometry, ramp, window)
        img = fan_backproject(
            q, upload(geometry.betas, q), float(geometry.SID),
            float(geometry.dgamma), int(n_matrix), float(fov),
            dbeta=float(geometry.rotation_total) / geometry.N_proj)
    if mu_water_eff is None:
        return img, None
    return img, hu_image(img, mu_water_eff)


def parallel_fbp(sino_log, geometry, n_matrix, fov, ramp=0.8,
                 window="sinc", dtype=None):
    """Parallel-beam FBP over the geometry's angular coverage, on the
    device of ``sino_log`` in float32 (``dtype`` must be float32 or None);
    returns the [n_matrix, n_matrix] image.  The response and the view
    angles go up through ``upload``."""
    check_float32(dtype)
    nt = geometry.N_channels
    ds = geometry.ds
    sino = sino_log.to(torch.float32)
    H, m = filter_frequency_response(nt, ds, ramp, window, "parallel")
    q = filter_views(sino[None],
                     torch.ones(nt, dtype=torch.float32, device=sino.device),
                     upload(H, sino), m, ds)
    # each line is counted rotation_total/pi times over the scan
    dtheta = float(geometry.rotation_total) / geometry.N_proj \
        * (np.pi / geometry.rotation_total)
    img = parallel_backproject_multi(
        pack_filtered(q), 1, upload(geometry.betas, sino),
        float(geometry.s_positions[0]), float(ds), nt, int(n_matrix),
        float(fov), dtheta)
    return img[0]
