"""Beam-hardening correction (BHC): water linearization + bone second pass.

Port of :mod:`dexct_tpu.ops.bhc`.  The calibration fits are host float64
NumPy, copied; the corrections are elementwise PyTorch on the device of
the sinogram (the Horner evaluation and the bone correction polynomial
have no hand kernel: they are elementwise ``jnp`` in the JAX package
too), and the reconstructions and the bone reprojection run the port's
FBP (K4, or K5 + K6) and Fourier projector (K7, K8).  The bowtie variant
(``WaterBhcBowtie``, ``fit_water_bhc_bowtie``: one calibration curve per
bowtie thickness level, host float64, applied per channel on the device of
the sinogram) runs on the port's :mod:`~dexct_tpu_torch.ops.bowtie`.

The reference analysis consumes ``recon_{water,bone}BHC_*`` images
(reference plots.py:184-195) whose producer is not in the snapshot
(SURVEY.md §0.2); this module provides the missing stage as first-class
ops:

* **Water BHC** (polynomial linearization): the polyenergetic calibration
  curve ``L(t) = -ln( sum_E i0 e^{-mu_w(E) t} / sum_E i0 )`` is computed
  analytically for the spectrum+detector, and a polynomial fit of
  ``L -> mu_eff t`` is applied to the measured log sinogram, removing
  cupping for water-like objects.
* **Bone BHC** (Joseph & Spital two-pass): the water-corrected image is
  segmented at a HU threshold; the bone partial image is re-projected
  (Fourier-slice projector); a host-fitted 2-D correction surface
  ``delta(t_w, t_b)`` converts the water-linearized sinogram to the ideal
  two-material linear combination, and the corrected sinogram is
  reconstructed again.

All calibration runs host-side (float64); the applied corrections are
polynomial evaluations and one extra projection/reconstruction on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..physics import xcom
from ..physics.materials import BONE
from .spectral import effective_fluence

__all__ = ["WaterBhc", "fit_water_bhc", "fit_water_bhc_from_scan",
           "apply_water_bhc", "bone_bhc_recon", "water_bhc_recon",
           "WaterBhcBowtie", "fit_water_bhc_bowtie"]


@dataclasses.dataclass
class WaterBhc:
    """Water-linearization polynomial: L -> mu_eff * t_water."""

    coeffs: np.ndarray  # polynomial coefficients (np.polyval order)
    mu_eff: float  # target effective water attenuation [1/cm]
    t_max: float

    def __call__(self, sino_log):
        out = torch.zeros_like(sino_log)
        for c in self.coeffs:  # Horner, device-side
            out = out * sino_log + float(c)
        return out


def _calibration_curve(spec, geometry, mu_E, t, weights=None):
    """Polyenergetic log curve L(t); ``weights`` overrides the fluence
    (pre-filtered spectra, e.g. per-bowtie-level)."""
    w = effective_fluence(spec, geometry) if weights is None else weights
    w = w / w.sum()
    trans = np.exp(-np.outer(t, mu_E)) @ w
    return -np.log(np.clip(trans, 1e-300, None))


def _fit_origin_poly(L, target, degree):
    """Least-squares polynomial L -> target constrained through the
    origin (basis {L, L^2, .., L^d}); returns np.polyval-order coeffs."""
    powers = np.arange(1, degree + 1)
    A = np.asarray(L)[:, None] ** powers[None, :]
    sol, *_ = np.linalg.lstsq(A, target, rcond=None)
    return np.concatenate([sol[::-1], [0.0]])


def fit_water_bhc(spec, geometry, *, t_max=50.0, degree=6, n_cal=256,
                  calibration_cm=10.0):
    """Fit the water-linearization polynomial for one spectrum."""
    from ..pipeline.api import effective_water_mu

    mu_w = xcom.mixatten("H(11.2)O(88.8)", spec.E)
    t = np.linspace(0.0, t_max, n_cal)
    L = _calibration_curve(spec, geometry, mu_w, t)
    mu_eff = effective_water_mu(spec, geometry, calibration_cm)
    coeffs = _fit_origin_poly(L, mu_eff * t, degree)
    return WaterBhc(coeffs, float(mu_eff), float(t_max))


def apply_water_bhc(bhc: WaterBhc, sino_log):
    """Linearize a log sinogram (device op, float32)."""
    return bhc(sino_log.to(torch.float32))


@dataclasses.dataclass
class WaterBhcBowtie:
    """Per-channel water linearization under a bowtie filter.

    One calibration curve per bowtie thickness level, all mapped to the
    SAME ``mu_eff`` target (the unfiltered central channel's), so every
    channel lands on a common HU scale.  Duck-types as :class:`WaterBhc`
    (``__call__`` + ``mu_eff``).
    """

    coeffs_ch: np.ndarray  # [C, D+1] polynomial per channel (polyval order)
    mu_eff: float
    t_max: float

    def __call__(self, sino_log):
        cs = torch.as_tensor(self.coeffs_ch.astype(np.float32),
                             device=sino_log.device)  # [C, D+1]
        out = torch.zeros_like(sino_log)
        for i in range(cs.shape[1]):  # Horner, broadcast over views
            out = out * sino_log + cs[:, i]
        return out


def fit_water_bhc_bowtie(spec, geometry, bowtie, *, t_max=50.0, degree=6,
                         n_cal=256, calibration_cm=10.0):
    """Fit per-thickness-group water-BHC polynomials under a bowtie (host,
    float64): one analytic calibration curve per thickness level (the
    level's hardened fluence), fitted to the common unfiltered ``mu_eff *
    t`` target; channels inherit their level's polynomial."""
    from ..pipeline.api import effective_water_mu

    mu_w = xcom.mixatten("H(11.2)O(88.8)", spec.E)
    mu_bt = bowtie.material.linear_atten(spec.E)
    w_base = effective_fluence(spec, geometry)
    levels, gidx = bowtie.groups()
    mu_eff = effective_water_mu(spec, geometry, calibration_cm)
    t = np.linspace(0.0, t_max, n_cal)
    coeffs = []
    for tl in levels:
        w = w_base * np.exp(-mu_bt * float(tl))
        L = _calibration_curve(spec, geometry, mu_w, t, weights=w)
        coeffs.append(_fit_origin_poly(L, mu_eff * t, degree))
    return WaterBhcBowtie(np.stack(coeffs)[gidx], float(mu_eff),
                          float(t_max))


def fit_water_bhc_from_scan(sino_log, geometry, radius, *,
                            center=(0.0, 0.0), degree=6,
                            calibration_cm=10.0, mu_eff=None,
                            t_min=0.25):
    """Scanner-style auto-calibration: fit the water-linearization
    polynomial from a measured scan of a known water cylinder, with NO
    spectrum model.

    This is how physical scanners calibrate BHC (the spectrum is never
    known exactly): every measured ray of the calibration phantom pairs
    a known water path — the exact chord of the cylinder (``radius``,
    ``center``) along the ray from ``geometry.ray_geometry()`` — with a
    measured log value, and the L -> mu_eff*t polynomial is a
    least-squares fit over all object-intersecting rays.  ``mu_eff``
    (the HU reference) defaults to the measured slope at the
    ``calibration_cm`` water path — the same 10-cm convention as the
    analytic :func:`fit_water_bhc` / ``effective_water_mu`` — so
    scan-calibrated and spectrum-calibrated corrections agree to the
    fit residual (noiseless parity ≤0.5%, pinned in ``test_bhc.py``).

    Rays with chord < ``t_min`` cm are excluded (air rays carry no
    calibration information, only noise).
    """
    if isinstance(sino_log, torch.Tensor):
        sino_log = sino_log.detach().cpu().numpy()
    sino_log = np.asarray(sino_log, np.float64)
    src, dirs = geometry.ray_geometry()
    rel = np.asarray(center, np.float64) - src
    dist = np.abs(dirs[..., 0] * rel[..., 1] - dirs[..., 1] * rel[..., 0])
    t = 2.0 * np.sqrt(np.maximum(radius * radius - dist * dist, 0.0))
    sel = t >= t_min
    if not np.any(sel):
        raise ValueError("no ray intersects the calibration cylinder")
    L, tw = sino_log[sel], t[sel]
    if mu_eff is None:
        near = np.abs(tw - calibration_cm) <= 0.1 * calibration_cm
        if not np.any(near):
            raise ValueError(
                f"no calibration ray near t = {calibration_cm} cm "
                f"(chords span {tw.min():.2f}-{tw.max():.2f} cm); pass "
                "mu_eff or adjust calibration_cm")
        mu_eff = float(np.sum(L[near] * tw[near])
                       / np.sum(tw[near] * tw[near]))
    coeffs = _fit_origin_poly(L, mu_eff * tw, degree)
    return WaterBhc(coeffs, float(mu_eff), float(tw.max()))


def bone_bhc_recon(sino_log, geometry, spec, n_matrix, fov, ramp, *,
                   phantom_grid=None, bone_hu_threshold=300.0,
                   bone_density=BONE.density, degree=3, window="sinc",
                   water_bhc=None, n_theta=768):
    """Two-pass bone BHC: returns (recon_raw, recon_HU) corrected images.

    sino_log: measured polyenergetic log sinogram [V, C].
    phantom_grid: (N, dx) of the reprojection grid; defaults to
        (n_matrix, fov/n_matrix).
    """
    from ..pipeline.api import get_recon
    from ..system.phantom import VoxelPhantom
    from ..physics.materials import AIR, MaterialTable, WATER
    from .fourier import fourier_project_images, plan_fourier_projector
    from .fbp import hu_image

    sino_log = sino_log.to(torch.float32)
    if water_bhc is None:
        water_bhc = fit_water_bhc(spec, geometry)
    mu_eff_w = water_bhc.mu_eff

    # pass 1: water-linearized reconstruction
    sino_w = apply_water_bhc(water_bhc, sino_log)
    recon_w, _ = get_recon(sino_w, geometry, None, n_matrix, fov, ramp,
                           window=window)
    hu_w = hu_image(recon_w, mu_eff_w)

    # bone segmentation -> bone partial image (fraction of bone density)
    n_grid, dxg = phantom_grid or (n_matrix, fov / n_matrix)
    if n_grid != n_matrix:
        raise ValueError("reprojection grid must match the recon grid")
    bone_frac = torch.clamp(
        (hu_w - bone_hu_threshold)
        / max(1000.0 * (BONE.density * 0.5), 1e-6), 0.0, 1.0,
    )
    # smooth proxy: fraction ramps from 0 at threshold to 1 over ~960 HU
    bone_img = bone_frac  # [N, N] in units of "full bone fraction"

    # re-projection of the bone image: t_b per ray [V, C] (cm of bone)
    dummy = VoxelPhantom("bhc", np.zeros((n_grid, n_grid), np.uint8),
                         MaterialTable([AIR, WATER]), dxg, dxg, dxg)
    plan = plan_fourier_projector(dummy, geometry, n_theta=n_theta,
                                  device=sino_log.device)
    t_b = fourier_project_images(plan, bone_img[None], sino_log.shape)[..., 0]
    t_b = torch.clamp_min(t_b, 0.0)

    # calibration surface: L(t_w, t_b) for the true two-material beam
    mu_w_E = xcom.mixatten("H(11.2)O(88.8)", spec.E)
    mu_b_E = BONE.linear_atten(spec.E)
    w = effective_fluence(spec, geometry)
    w = w / w.sum()
    tw = np.linspace(0.0, water_bhc.t_max, 48)
    tb = np.linspace(0.0, 12.0, 24)
    TW, TB = np.meshgrid(tw, tb, indexing="ij")
    L_cal = -np.log(np.clip(
        np.exp(-(TW[..., None] * mu_w_E + TB[..., None] * mu_b_E)) @ w,
        1e-300, None))
    # effective bone mu: slope of L at small t_b through water paths
    mu_eff_b = float((w * mu_b_E).sum())
    # ideal linear sinogram minus what water-BHC yields on the true L:
    p_of_L = np.polyval(water_bhc.coeffs, L_cal)
    target = mu_eff_w * TW + mu_eff_b * TB
    delta = target - p_of_L  # correction as a function of (t_w approx, t_b)
    # fit delta ~ poly2d in (p_of_L, t_b): features t_b, t_b^2, t_b*L, ...
    feats = np.stack([
        TB, TB**2, TB * p_of_L, TB**2 * p_of_L, TB * p_of_L**2,
    ], -1).reshape(-1, 5)
    coef, *_ = np.linalg.lstsq(feats, delta.reshape(-1), rcond=None)

    # apply on device
    coef = [float(c) for c in coef]
    pL = sino_w
    tb_d = t_b
    delta_d = (coef[0] * tb_d + coef[1] * tb_d**2 + coef[2] * tb_d * pL
               + coef[3] * tb_d**2 * pL + coef[4] * tb_d * pL**2)
    sino_corr = pL + delta_d

    recon_b, _ = get_recon(sino_corr, geometry, None, n_matrix, fov, ramp,
                           window=window)
    return recon_b, hu_image(recon_b, mu_eff_w)


def water_bhc_recon(sino_log, geometry, spec, n_matrix, fov, ramp, *,
                    window="sinc", water_bhc=None):
    """Water-BHC reconstruction: (recon_raw, recon_HU)."""
    from ..pipeline.api import get_recon
    from .fbp import hu_image

    if water_bhc is None:
        water_bhc = fit_water_bhc(spec, geometry)
    sino_w = apply_water_bhc(water_bhc, sino_log)
    recon, _ = get_recon(sino_w, geometry, None, n_matrix, fov, ramp,
                         window=window)
    return recon, hu_image(recon, water_bhc.mu_eff)
