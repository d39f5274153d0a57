"""Spectrum estimation from transmission measurements (EM).

Real scanners never know their spectrum exactly — they estimate an
*equivalent* spectrum from transmission measurements of known step
wedges (the classic expectation-maximization estimator: Sidky et al.,
"A robust method of x-ray source spectrum estimation from transmission
measurements", JAP 97, 2005).  The reference ships measured spectrum
files; this module provides the calibration path that produces such a
file from data the simulator itself can generate:

    T_j = sum_E w_E exp(-mu(E) t_j)        (wedge thicknesses t_j)

with the multiplicative EM update (nonnegative, flux-conserving under
normalized measurements):

    w_E  <-  w_E * sum_j [ (T_j^meas / T_j^model) a_jE ] / sum_j a_jE,
    a_jE = exp(-mu(E) t_j)

Transmission is an exponentially ill-posed moment problem: many
spectra match any finite T(t) to measurement precision.  What IS
recovered — and what downstream physics uses — are the transmission
function itself, the effective attenuation/energy, and beam-hardening
behavior.  The tests therefore pin *functional* recovery (transmission
curve, effective water mu, BHC built from the estimate) rather than
bin-wise spectrum equality.

Port of :mod:`dexct_tpu.physics.spectrum_calibration` (host float64
NumPy, as there).
"""

from __future__ import annotations

import numpy as np

from .spectrum import Spectrum

__all__ = ["wedge_transmissions", "estimate_spectrum_em"]


def wedge_transmissions(spec, geometry, material, thicknesses):
    """Ideal detected transmissions of a step wedge (the calibration
    measurement this module inverts): T_j = sum w_E e^{-mu t_j} with
    w the detector-weighted fluence, normalized so T(0) = 1."""
    from ..ops.spectral import effective_fluence

    w = effective_fluence(spec, geometry)
    w = w / w.sum()
    mu = material.linear_atten(spec.E)
    t = np.asarray(thicknesses, np.float64)
    return np.exp(-np.outer(t, mu)) @ w


def estimate_spectrum_em(transmissions, thicknesses, material, e_grid, *,
                         n_iters=2000, w_init=None, name="EM estimate",
                         detector=None):
    """EM spectrum estimate from step-wedge transmissions.

    transmissions: T_j (air-normalized detected signal, T(0)=1 ideally);
    thicknesses: t_j [cm] of ``material``; e_grid: energy support [keV]
    of the estimate (choose [~10, kVp]).  Returns a
    :class:`~dexct_tpu_torch.physics.spectrum.Spectrum` whose I0 is the
    estimated *detected-weight* distribution (detector response folded
    in — exactly what forward models consume; pass ``detector`` (a
    geometry) to divide the response back out for a source-side
    spectrum).

    Monotone in the Poisson/KL objective (standard EM property); use
    >= a few hundred iterations — convergence is slow in the flat
    directions of this ill-posed problem, which is also what keeps the
    estimate smooth.
    """
    t = np.asarray(thicknesses, np.float64)
    T = np.asarray(transmissions, np.float64)
    if t.shape != T.shape or t.ndim != 1:
        raise ValueError("thicknesses and transmissions must be matching "
                         "1-D arrays")
    if not np.any(t == 0.0):
        raise ValueError("include a t=0 (air) measurement: the estimate "
                         "is normalized against it")
    e = np.asarray(e_grid, np.float64)
    mu = material.linear_atten(e)  # [E]
    A = np.exp(-np.outer(t, mu))  # [J, E]
    w = (np.ones_like(e) if w_init is None
         else np.asarray(w_init, np.float64).copy())
    w = np.clip(w, 1e-12, None)
    w /= w.sum()
    col = A.sum(0)  # [E]
    for _ in range(int(n_iters)):
        model = A @ w  # [J]
        ratio = T / np.maximum(model, 1e-300)
        w = w * (A.T @ ratio) / col
        w /= w.sum()
    if detector is not None:
        resp = np.maximum(detector.detector_response(e), 1e-12)
        w = w / resp
        w /= w.sum()
    return Spectrum(e, w, name)
