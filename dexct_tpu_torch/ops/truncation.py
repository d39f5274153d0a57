"""Detector truncation (limited FOV) and projection data completion.

Port of :mod:`dexct_tpu.ops.truncation`.  When the patient extends past
the fan, each truncated projection ends mid-object and the ramp filter
sees a step.  The completion extrapolates each truncated edge with the
water-cylinder profile fitted to the edge value and slope, and returns the
channel-extended sinogram with the matching extended equiangular geometry,
so the standard FBP runs unchanged.  Elementwise per view: plain PyTorch
on the device of the sinogram when it is a tensor, else on ``device``
(default: the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.devices import as_float, device_of

__all__ = ["pad_truncated_sinogram", "truncation_severity"]


def truncation_severity(sino_log, thresh=0.05):
    """Fraction of views whose edge channels still carry signal above
    ``thresh`` (log units); 0 means the scan is not truncated (host)."""
    s = sino_log.cpu().numpy() if torch.is_tensor(sino_log) \
        else np.asarray(sino_log)
    edge = np.maximum(s[..., 0], s[..., -1])
    return float(np.mean(edge > thresh))


def pad_truncated_sinogram(sino_log, ct, n_pad=None, mu_ref=0.2, *,
                           device=None):
    """Complete truncated projections by the water-cylinder edge fit.

    A cylinder of attenuation ``mu_ref`` at offset u from a ray gives
    ``p(u) = 2 mu sqrt(R^2 - u^2)``; matching the measured edge value and
    slope (three-channel one-sided difference, channel spacing ``SID *
    dgamma``) gives ``u = -p p' / (4 mu^2)``, ``R^2 = u^2 + p^2 / (4
    mu^2)``, and the extension follows that profile to zero.  ``n_pad``
    defaults to the largest fitted remaining width (rounded up to 8,
    capped at 4x the detector).  Returns ``(padded_log [V, C + 2 n_pad],
    padded_ct)``.
    """
    dev = device_of(sino_log, device)
    s = as_float(sino_log, dev)
    c_n = s.shape[-1]
    ds = ct.SID * ct.dgamma
    mu = float(mu_ref)
    zero = torch.zeros((), dtype=s.dtype, device=dev)

    def edge_fit(p_e, slope_out):
        """(u, R) of the fitted cylinder; slope_out = dp/du moving
        OUTWARD off the detector [per cm]."""
        p_e = torch.clamp_min(p_e, 0.0)
        g = torch.clamp_max(slope_out, -1e-6)  # decaying outward
        u = -p_e * g / (4.0 * mu * mu)
        r2 = u * u + p_e * p_e / (4.0 * mu * mu)
        return u, torch.sqrt(r2)

    p_lo = torch.clamp_min(s[..., 0], 0.0)
    p_hi = torch.clamp_min(s[..., -1], 0.0)
    g_lo = (s[..., 0] - 0.5 * (s[..., 1] + s[..., 2])) / (1.5 * ds)
    g_hi = (s[..., -1] - 0.5 * (s[..., -2] + s[..., -3])) / (1.5 * ds)
    u_lo, r_lo = edge_fit(p_lo, g_lo)
    u_hi, r_hi = edge_fit(p_hi, g_hi)

    w_lo = torch.where(p_lo > 0, r_lo - u_lo, zero) / ds  # channels
    w_hi = torch.where(p_hi > 0, r_hi - u_hi, zero) / ds
    if n_pad is None:
        wmax = float(torch.maximum(w_lo.max(), w_hi.max()))
        n_pad = min(max(8, int(-(-wmax // 8) * 8)), 4 * c_n)
    k = torch.arange(1, n_pad + 1, dtype=s.dtype, device=dev)

    def extend(p_e, u, r):
        uu = u[..., None] + k * ds
        val = 2.0 * mu * torch.sqrt(torch.clamp_min(
            r[..., None] ** 2 - uu * uu, 0.0))
        # scale so the profile is continuous at the edge sample
        p0 = 2.0 * mu * torch.sqrt(torch.clamp_min(
            r ** 2 - u ** 2, 1e-30))[..., None]
        return torch.where(p_e[..., None] > 0, val * p_e[..., None] / p0,
                           zero)

    lo = extend(p_lo, u_lo, r_lo).flip(-1)
    hi = extend(p_hi, u_hi, r_hi)
    padded = torch.cat([lo, s, hi], -1)

    pct = dataclasses.replace(
        ct, N_channels=c_n + 2 * n_pad,
        gamma_fan=ct.gamma_fan * (c_n + 2 * n_pad) / c_n)
    return padded, pct
