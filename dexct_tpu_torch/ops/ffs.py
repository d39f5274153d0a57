"""Flying-focal-spot (FFS) rebinning and reconstruction.

Port of :mod:`dexct_tpu.ops.ffs`.  The host plan
(:func:`parallel_rebin_plan_ffs`, float64 NumPy) is copied; the rebin is
kernel K5 at 16 taps per bin and the backprojection kernel K6
(:mod:`dexct_tpu_torch.ops.fbp_fast`).

Beyond-reference subsystem (the reference's geometry is static —
reference plots.py:109-111 constructs one fixed FanBeamGeometry):
the in-plane flying focal spot of clinical scanners, where the focal
spot alternates between two tangentially-deflected anode positions on
successive views while the detector stays put.  The two view subsets
sample *interleaved* radial positions, so rebinning BOTH subsets onto
one parallel (theta, t) grid doubles the radial sampling density —
the classic anti-aliasing / resolution lever that extra channels would
otherwise buy.

Exact per-sample mapping (rotated frame: nominal source on +x, spot
displaced tangentially by delta; detector arc centered on the NOMINAL
spot, SURVEY.md §3.3 conventions):

    src   = (SID, delta)
    p_det = (SID - SDD cos g, -SDD sin g)          # channel angle g
    t(g, delta)     = [SID SDD sin g + SID delta - delta SDD cos g]
                      / sqrt(SDD^2 + 2 delta SDD sin g + delta^2)
    g_eff(g, delta) = atan2(SDD sin g + delta, SDD cos g)
    theta           = beta + g_eff - pi/2   (mod pi, t sign flips)

delta = 0 recovers the static identities t = SID sin g, g_eff = g
(ops/fbp_fast.py:108-114).  The plan inverts t(g, delta_s) per subset
on a fine host grid (monotone in g) and, for every parallel bin,
combines the two subsets with weights proportional to the OTHER
subset's distance from its nearest channel sample: where the bin falls
exactly on a subset's ray, that subset gets weight 1 and the bin is
interpolation-free — realizing the doubled effective sampling.  Both
redundant fan copies (direct + conjugate) are averaged as in the
standard plan, giving 16 taps per bin in the same adjacent-channel
pair layout `rebin_to_parallel` fetches (taps=16).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["parallel_rebin_plan_ffs", "ffs_fbp_recon"]


def _t_of_gamma(gam, delta, sid, sdd):
    """Exact signed radial ray distance t(g, delta) [cm], float64."""
    num = sid * sdd * np.sin(gam) + sid * delta - delta * sdd * np.cos(gam)
    den = np.sqrt(sdd * sdd + 2.0 * delta * sdd * np.sin(gam)
                  + delta * delta)
    return num / den


def _gamma_eff(gam, delta, sdd):
    """Effective fan angle of the deflected ray [rad], float64."""
    return np.arctan2(sdd * np.sin(gam) + delta, sdd * np.cos(gam))


def parallel_rebin_plan_ffs(geometry, n_theta=None, nt=None, t_max=None):
    """Host tables mapping an FFS fan sinogram onto a (theta, t) grid.

    Returns ``(idx [ntheta*nt*16], w [same], t0, dt)`` — FLAT int32 /
    float32 tables in the 16-taps-per-bin adjacent-channel-pair layout
    of :func:`~dexct_tpu_torch.ops.fbp_fast.rebin_to_parallel` (``taps=16``).
    Defaults: ``nt = 2*N_channels`` (the radial density FFS actually
    delivers), ``n_theta = N_proj // 2``.
    """
    if getattr(geometry, "ffs", "none") != "inplane":
        raise ValueError("geometry has no in-plane flying focal spot; "
                         "use parallel_rebin_plan")
    if abs(geometry.rotation_total - 2.0 * np.pi) > 1e-3:
        raise ValueError(
            "FFS rebinning requires a full 2*pi acquisition "
            f"(rotation_total={geometry.rotation_total})")
    sid, sdd = float(geometry.SID), float(geometry.SDD)
    v, c = geometry.N_proj, geometry.N_channels
    dgamma = float(geometry.dgamma)
    dbeta = geometry.rotation_total / v
    gm = geometry.gamma_fan / 2.0
    if nt is None:
        nt = 2 * c
    if n_theta is None:
        n_theta = v // 2
    if t_max is None:
        t_max = sid * np.sin(gm)
    dt = 2.0 * t_max / nt
    t0 = -t_max + 0.5 * dt
    thetas = np.arange(n_theta) * (np.pi / n_theta)
    ts = t0 + dt * np.arange(nt)
    tt, th = np.meshgrid(ts, thetas)  # [ntheta, nt]

    # per-subset inverse maps t -> gamma on a fine grid (t is monotone
    # increasing in gamma over the fan for |delta| << SDD)
    deltas = (0.5 * float(geometry.ffs_delta),
              -0.5 * float(geometry.ffs_delta))
    pad = 2.0 * dgamma
    gfine = np.linspace(-gm - pad, gm + pad, 16384)

    def subset_taps(theta_target, t_target, s):
        """4 bilinear taps + in-fan flag for subset s at one copy."""
        d_s = deltas[s]
        tf = _t_of_gamma(gfine, d_s, sid, sdd)
        gam = np.interp(t_target, tf, gfine)
        fg = gam / dgamma - 0.5 + c / 2.0
        ok = (fg >= 0.0) & (fg <= c - 1.0)
        ig0 = np.clip(np.floor(fg), 0, c - 2).astype(np.int64)
        wg1 = np.clip(fg - ig0, 0.0, 1.0)
        # distance to the subset's nearest radial sample, channel units
        frac = fg - np.floor(fg)
        near = np.minimum(frac, 1.0 - frac)
        beta = theta_target - _gamma_eff(gam, d_s, sdd) + np.pi / 2.0
        # bracket beta within the subset's view comb (s, s+2, ...)
        fs = (np.mod(beta, 2.0 * np.pi) / dbeta - s) / 2.0
        i0 = np.floor(fs).astype(np.int64)
        wb1 = fs - i0
        half = v // 2
        v0 = s + 2 * np.mod(i0, half)
        v1 = s + 2 * np.mod(i0 + 1, half)
        idx = np.stack([v0 * c + ig0, v0 * c + ig0 + 1,
                        v1 * c + ig0, v1 * c + ig0 + 1], -1)
        w = np.stack([(1 - wb1) * (1 - wg1), (1 - wb1) * wg1,
                      wb1 * (1 - wg1), wb1 * wg1], -1)
        return idx, w, ok, near

    parts_idx, parts_w = [], []
    for copy in range(2):  # direct ray / conjugate ray
        th_t = th if copy == 0 else th + np.pi
        tt_t = tt if copy == 0 else -tt
        i0_, w0_, ok0, near0 = subset_taps(th_t, tt_t, 0)
        i1_, w1_, ok1, near1 = subset_taps(th_t, tt_t, 1)
        # subset mix: weight by the OTHER subset's sample distance, so
        # a bin ON a subset ray uses that subset alone (near == 0)
        a0 = np.where(ok0, near1 + 1e-12, 0.0)
        a1 = np.where(ok1, near0 + 1e-12, 0.0)
        norm = a0 + a1
        with np.errstate(invalid="ignore"):
            m0 = np.where(norm > 0.0, a0 / np.where(norm > 0, norm, 1.0),
                          0.0)
            m1 = np.where(norm > 0.0, a1 / np.where(norm > 0, norm, 1.0),
                          0.0)
        parts_idx += [i0_, i1_]
        parts_w += [w0_ * (0.5 * m0)[..., None], w1_ * (0.5 * m1)[..., None]]
    idx = np.concatenate(parts_idx, -1).reshape(-1, 16)
    w = np.concatenate(parts_w, -1).reshape(-1, 16)
    return (idx.astype(np.int32).reshape(-1),
            w.astype(np.float32).reshape(-1), float(t0), float(dt))


def ffs_fbp_recon(sino_log, geometry, n_matrix, fov, ramp=0.8,
                  window="sinc", n_theta=None, nt=None, dtype=None):
    """FBP of a flying-focal-spot fan scan on the device of ``sino_log``
    -> [N, N] image [cm^-1], in float32 (``dtype`` must be float32 or
    None).

    Rebins both focal-spot subsets onto one parallel grid at the
    doubled radial density (plan above; K5 at 16 taps), filters the
    PARALLEL sinogram (the fan cos-preweight/response does not apply to
    the deflected rays), and backprojects it (K6).  Host plan tables are
    rebuilt per call, as in the JAX package.
    """
    from ..utils.devices import check_float32, upload
    from .fbp import filter_views
    from .fbp_fast import (pack_filtered, parallel_backproject_multi,
                           rebin_to_parallel)
    from .filters import filter_frequency_response

    check_float32(dtype)
    dev = sino_log.device
    idx, w, t0, dt = parallel_rebin_plan_ffs(geometry, n_theta, nt)
    nt_eff = 2 * geometry.N_channels if nt is None else int(nt)
    n_th = idx.size // (16 * nt_eff)
    par = rebin_to_parallel(sino_log.to(torch.float32)[None],
                            upload(idx, dev), upload(w, dev), nt_eff, taps=16)
    H, m = filter_frequency_response(nt_eff, dt, ramp, window, "parallel")
    q = filter_views(par, torch.ones(nt_eff, dtype=torch.float32, device=dev),
                     upload(H, dev, torch.float32), m, dt)
    thetas = upload(np.arange(n_th) * (np.pi / n_th), dev, torch.float32)
    img = parallel_backproject_multi(
        pack_filtered(q), 1, thetas, float(t0), float(dt), nt_eff,
        int(n_matrix), float(fov), float(np.pi / n_th))
    return img[0]
