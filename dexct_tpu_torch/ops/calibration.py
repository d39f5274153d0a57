"""Geometric calibration: detector-offset estimation from scan data.

Port of :mod:`dexct_tpu.ops.calibration`, its own copy (host NumPy in
float64, as the JAX module; a tensor sinogram is copied to the host).

A fan-beam detector arc mounted ``delta`` channels off its nominal
position shifts every fan angle by ``delta * dgamma``; reconstructing
with the nominal geometry then produces the classic center-of-rotation
artifacts (edge doubling / "tuning fork").  Scanners calibrate the
offset from the scan itself via CONJUGATE-RAY consistency: the same
line is measured twice per rotation,

    L(beta, gamma)  ==  L(beta + pi + 2*gamma, -gamma)

(the reference simulator has no calibration layer; its geometry is
assumed exact).  The estimator scans trial offsets, resamples each ray's
conjugate from the measured sinogram under the trial geometry, and
minimizes the mean squared mismatch — the identity holds exactly only
at the true offset.  Host-side NumPy: calibration is a one-time
per-scan fit of a single scalar, not a hot path.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["conjugate_inconsistency", "estimate_det_offset"]


def conjugate_inconsistency(sino_log, ct, delta_ch, margin=2):
    """Mean squared conjugate-ray mismatch under a trial offset.

    sino_log: [V, C] log sinogram of a full 2*pi scan on the uniform
    view grid; ``delta_ch`` the trial detector offset in channels.
    Rays whose conjugate channel falls off the detector (or within
    ``margin`` channels of its edge) are excluded.
    """
    s = (sino_log.detach().cpu().numpy() if torch.is_tensor(sino_log)
         else np.asarray(sino_log))
    v_n, c_n = s.shape
    dg = ct.dgamma
    rot = float(getattr(ct, "rotation_total", 2.0 * np.pi))
    if abs(rot - 2.0 * np.pi) > 1e-6:
        raise ValueError(
            "conjugate-ray calibration needs a full 2*pi scan (got "
            f"rotation_total={rot:.4f}): every ray's conjugate must be "
            "measured")
    dbeta = 2.0 * np.pi / v_n
    g = (np.arange(c_n) + 0.5 + delta_ch - c_n / 2.0) * dg

    beta_conj = np.arange(v_n)[:, None] * dbeta + np.pi + 2.0 * g[None, :]
    v_conj = (beta_conj / dbeta) % v_n
    c_conj = (-g / dg) - 0.5 - delta_ch + c_n / 2.0
    c_conj = np.broadcast_to(c_conj[None, :], (v_n, c_n))

    ok = (c_conj >= margin) & (c_conj <= c_n - 1 - margin)
    v0 = np.floor(v_conj).astype(int) % v_n
    v1 = (v0 + 1) % v_n
    fv = v_conj - np.floor(v_conj)
    c0 = np.clip(np.floor(c_conj).astype(int), 0, c_n - 2)
    fc = np.clip(c_conj - c0, 0.0, 1.0)
    interp = ((1 - fv) * ((1 - fc) * s[v0, c0] + fc * s[v0, c0 + 1])
              + fv * ((1 - fc) * s[v1, c0] + fc * s[v1, c0 + 1]))
    diff = np.where(ok, s - interp, 0.0)
    n = max(int(ok.sum()), 1)
    return float(np.sum(diff * diff) / n)


def estimate_det_offset(sino_log, ct, search_ch=2.0, n_coarse=41):
    """Estimate the detector offset [channels] from one full scan.

    Coarse grid over ``[-search_ch, +search_ch]`` then a parabolic
    refinement around the minimum; typical precision is a few
    hundredths of a channel on structured objects.  (A rotationally
    symmetric object is degenerate — every trial offset is conjugate-
    consistent with it; calibrate on a structured phantom.)
    """
    if torch.is_tensor(sino_log):
        sino_log = sino_log.detach().cpu().numpy()
    deltas = np.linspace(-search_ch, search_ch, int(n_coarse))
    errs = np.array([conjugate_inconsistency(sino_log, ct, d)
                     for d in deltas])
    i = int(np.argmin(errs))
    if 0 < i < len(deltas) - 1:
        a, b, c = errs[i - 1], errs[i], errs[i + 1]
        denom = a - 2 * b + c
        frac = 0.5 * (a - c) / denom if abs(denom) > 1e-30 else 0.0
        return float(deltas[i] + frac * (deltas[1] - deltas[0]))
    return float(deltas[i])
