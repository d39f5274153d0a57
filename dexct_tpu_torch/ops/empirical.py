"""Empirical (calibration-based) dual-energy decomposition.

Port of :mod:`dexct_tpu.ops.empirical`.  The projection-domain Poisson-MLE
solve (:mod:`~dexct_tpu_torch.ops.matdecomp`) needs the spectra and the
basis attenuation curves.  A real scanner often has neither to sufficient
accuracy; the clinical workaround is empirical decomposition: scan a
step-wedge grid of known basis thicknesses, record the two log
measurements per (t1, t2) combination, and fit the inverse map

    t_k = P_k(L1, L2),   P_k a 2-D polynomial through the origin,

then decompose object scans by evaluating P on every ray.  No spectrum,
detector response or attenuation table enters the application path.

Calibration is host float64 least squares on a few hundred wedge points
(the wedge measurements on the port's own effective fluences,
:func:`~dexct_tpu_torch.ops.spectral.effective_fluence`).  Application is
one feature build and one feature x coefficient product (``torch.einsum``
in full float32) on the device of the log sinograms.

Accuracy and limits are the JAX module's: noiseless held-out wedge points
recover to < 0.25 % of range at degree 5; the polynomial is valid only
inside the calibrated thickness hull, and L values are clipped to the
calibration box to keep extrapolation bounded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.devices import as_float, device_of
from .matdecomp import DEFAULT_BASIS

__all__ = [
    "EmpiricalDEModel",
    "wedge_log_measurements",
    "fit_empirical_de",
    "apply_empirical_de",
]


def _poly_exponents(degree):
    """Exponent pairs (p, q) with 1 <= p+q <= degree (no constant term:
    zero path length must map to exactly zero thickness)."""
    return [(p, q) for total in range(1, degree + 1)
            for p in range(total + 1) for q in [total - p]]


@dataclass(frozen=True)
class EmpiricalDEModel:
    """Fitted inverse map (L1, L2) -> (t1, t2) [g/cm^2].

    coeffs [n_terms, 2] acts on features (L1/s1)^p (L2/s2)^q; L_max
    is the calibration-box corner used for scaling AND for clipping at
    application time (extrapolation guard).
    """

    exponents: tuple  # ((p, q), ...)
    coeffs: np.ndarray  # [n_terms, 2] float64
    L_max: np.ndarray  # [2] float64
    fit_residual: float  # rms over the calibration grid [g/cm^2]

    def features(self, L1, L2):
        """Scaled polynomial features of float32 tensors, [..., n_terms]
        (the box corner rounded to float32, as the JAX program's)."""
        lm = [float(np.float32(v)) for v in self.L_max]
        u1 = torch.clamp(L1, 0.0, lm[0]) / torch.full_like(L1, lm[0])
        u2 = torch.clamp(L2, 0.0, lm[1]) / torch.full_like(L2, lm[1])
        cols = [u1 ** p * u2 ** q for (p, q) in self.exponents]
        return torch.stack(cols, dim=-1)


def wedge_log_measurements(geometry, spec1, spec2, t1, t2,
                           basis=DEFAULT_BASIS):
    """Noiseless log measurements of basis slabs (host, float64).

    t1, t2: area densities [g/cm^2] of the two basis materials
    (broadcastable arrays).  Returns L [2, ...] matching the pipeline's
    sino_log convention, L_m = -ln(sum_E i0_m e^{-mu.t} / sum_E i0_m),
    with i0 evaluated by the pipeline's own quadrature
    (``spectral.effective_fluence`` on each spectrum's native grid, no
    pruning): union-grid interpolation or detectable-bin pruning would
    shift every calibration L against the measured sino_log by a
    per-spectrum constant.
    """
    from ..physics import xcom
    from .spectral import effective_fluence

    t1 = np.asarray(t1, np.float64)
    t2 = np.asarray(t2, np.float64)
    L = []
    for spec in (spec1, spec2):
        i0 = np.asarray(effective_fluence(spec, geometry), np.float64)
        mus = np.stack([xcom.mixatten(m.matcomp, spec.E) for m in basis])
        path = t1[..., None] * mus[0] + t2[..., None] * mus[1]  # [..., E]
        L.append(-np.log(np.tensordot(np.exp(-path), i0, axes=(-1, 0))
                         / i0.sum()))
    return np.stack(L)


def fit_empirical_de(geometry, spec1, spec2, *, basis=DEFAULT_BASIS,
                     t1_max=50.0, t2_max=35.0, n_grid=14, degree=5,
                     L_meas=None, T_grid=None):
    """Fit the empirical inverse map from a wedge-calibration grid.

    By default the wedge measurements are simulated from the spectral
    model.  A real calibration substitutes measured data: pass ``L_meas``
    [2, N] and ``T_grid`` [2, N] and the spectra are never consulted.
    t1_max/t2_max bound the calibrated thickness hull [g/cm^2]; degree=5
    is the JAX study's held-out optimum.
    """
    if (L_meas is None) != (T_grid is None):
        raise ValueError("pass both L_meas and T_grid, or neither")
    if L_meas is None:
        g1 = np.linspace(0.0, t1_max, n_grid)
        g2 = np.linspace(0.0, t2_max, n_grid)
        T1, T2 = np.meshgrid(g1, g2, indexing="ij")
        L = wedge_log_measurements(geometry, spec1, spec2, T1, T2,
                                   basis=basis)
        T = np.stack([T1, T2])
    else:
        L = np.asarray(L_meas, np.float64)
        T = np.asarray(T_grid, np.float64)

    L = L.reshape(2, -1)
    T = T.reshape(2, -1)
    L_max = np.maximum(L.max(axis=1), 1e-12)
    exponents = tuple(_poly_exponents(degree))
    u = L / L_max[:, None]
    A = np.stack([u[0] ** p * u[1] ** q for (p, q) in exponents], axis=1)
    coeffs, *_ = np.linalg.lstsq(A, T.T, rcond=None)
    resid = float(np.sqrt(np.mean((A @ coeffs - T.T) ** 2)))
    return EmpiricalDEModel(exponents=exponents, coeffs=coeffs,
                            L_max=L_max, fit_residual=resid)


def apply_empirical_de(model, sino_log1, sino_log2, *, device=None):
    """Decompose a log-sinogram pair -> basis area densities [2, ...]
    (float32).

    One feature build and one product with the float32 coefficients, in
    full float32, on the device of ``sino_log1`` when it is a tensor, else
    on ``device`` (default: the card).  Zero log signal maps to exactly
    zero thickness (no constant term), so air rays need no mask.
    """
    dev = device_of(sino_log1, device)
    F = model.features(as_float(sino_log1, dev).to(torch.float32),
                       as_float(sino_log2, dev).to(torch.float32))
    C = torch.as_tensor(model.coeffs, dtype=torch.float32, device=dev)
    return torch.einsum("...t,tk->k...", F, C)
