"""Quantitative image analysis: VMI synthesis, ROI statistics, RMSE/CNR.

Functional rebuild of the metric machinery in the reference's analysis
script (``plots.py``): VMI synthesis (plots.py:136-144), ROI
mean/variance (plots.py:146-158), RMSE vs the monoenergetic ground truth
(plots.py:296-306), CNR/SNR (plots.py:381-397), contrast (plots.py:589-603)
and noise (plots.py:679-693).  All are plain NumPy functions on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics import xcom

__all__ = [
    "make_vmi",
    "measure_roi",
    "Roi",
    "crop_img",
    "nonair_mask",
    "rmse",
    "cnr",
    "contrast",
    "noise",
    "vmi_metric_curve",
]

# default basis compositions: ICRU tissue / bone (matdecomp.py:12-17)
from ..physics.materials import BONE, TISSUE

WATER_MATCOMP = "H(11.2)O(88.8)"  # plots.py:140


def make_vmi(E0, M1, M2, HU=True, matcomp1=TISSUE.matcomp,
             matcomp2=BONE.matcomp):
    """Virtual monoenergetic image from two basis-material images.

    vmi = (mu/rho)_1(E0) * M1 + (mu/rho)_2(E0) * M2, optionally converted
    to HU against water at rho=1 (plots.py:136-144).
    """
    e = np.atleast_1d(np.float64(E0))
    u1 = float(xcom.mixatten(matcomp1, e)[0])
    u2 = float(xcom.mixatten(matcomp2, e)[0])
    vmi = u1 * M1 + u2 * M2
    if HU:
        u_w = float(xcom.mixatten(WATER_MATCOMP, e)[0])
        vmi = 1000.0 * (vmi - u_w) / u_w
    return vmi


@dataclasses.dataclass(frozen=True)
class Roi:
    """Rectangular ROI (x0, y0, dx, dy) in pixels (plots.py:146-149)."""

    x0: int
    y0: int
    dx: int
    dy: int

    def extract(self, M):
        return M[self.y0:self.y0 + self.dy, self.x0:self.x0 + self.dx]


def measure_roi(M, roi, give_roi=False):
    """(mean, variance) of a rectangular ROI (plots.py:146-158)."""
    roi = roi if isinstance(roi, Roi) else Roi(*roi)
    vals = roi.extract(M)
    if give_roi:
        return vals
    return float(np.mean(vals)), float(np.var(vals))


def crop_img(M, crop):
    """Center crop (plots.py:167-170)."""
    r0 = M.shape[0] // 2
    return M[r0 - crop // 2:r0 + crop // 2, r0 - crop // 2:r0 + crop // 2]


def nonair_mask(M, threshold=-900.0):
    """Mask of non-air pixels in an HU image (plots.py:226-231)."""
    return np.asarray(M) > threshold


def rmse(img, gt, mask=None):
    """Root mean squared error, optionally masked (plots.py:302)."""
    img, gt = np.asarray(img), np.asarray(gt)
    d = (img - gt) ** 2
    if mask is not None:
        d = d[mask]
    return float(np.sqrt(np.mean(d)))


def cnr(M, roi_signal, roi_background):
    """Contrast-to-noise ratio: (u1-u2)/sqrt(v1+v2) (plots.py:373,393)."""
    u1, v1 = measure_roi(M, roi_signal)
    u2, v2 = measure_roi(M, roi_background)
    return (u1 - u2) / np.sqrt(v1 + v2)


def contrast(M, roi_signal, roi_background):
    """|u1 - u2| (plots.py:582,602)."""
    u1, _ = measure_roi(M, roi_signal)
    u2, _ = measure_roi(M, roi_background)
    return abs(u1 - u2)


def noise(M, roi_signal, roi_background):
    """sqrt(v1 + v2) (plots.py:672,692)."""
    _, v1 = measure_roi(M, roi_signal)
    _, v2 = measure_roi(M, roi_background)
    return float(np.sqrt(v1 + v2))


def vmi_metric_curve(M1, M2, energies, metric, **kw):
    """Evaluate ``metric(vmi)`` over a VMI energy sweep — the pattern behind
    every figure in the reference analysis (plots.py:298-306, 387-397).

    ``metric`` is a callable vmi -> float; returns an array parallel to
    ``energies``.
    """
    return np.array([metric(make_vmi(e, M1, M2, **kw)) for e in energies])
