"""Photon-counting detector pulse pileup: dead-time count loss,
first-order sum-energy spectral distortion, and their correction.

Port of :mod:`dexct_tpu.physics.pileup`.  Parametrized by the
dimensionless per-event dead-time fraction ``rho = N_tot * tau / T_view``;
the bin model is exact to O(rho^2) and keeps the recorded total at the
dead-time model's value:

    recorded[b] = m_tot * [(1 - rho/2) p_b + (rho/2) (p (*) p)_b]

The rate models are elementwise (the paralyzable inversion a fixed number
of Newton steps: a ``lax.scan`` in the JAX package, a Python loop here);
the bin redistribution is an ``einsum``.  No hand kernel: elementwise
PyTorch on the device of the counts when they are a tensor, else on
``device`` (default: the card).  The bin tables are host float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import _scalar, as_float, device_of

__all__ = ["recorded_rate", "true_rate", "bin_mean_energies",
           "bin_sum_redistribution", "apply_pileup_bins",
           "correct_pileup_bins"]


def _as_tensor(x, device):
    return as_float(x, device_of(x, device))


def recorded_rate(n_tau, model="paralyzable", *, device=None):
    """Recorded-per-window rate m*tau from true rate ``n_tau = n*tau``:
    paralyzable ``n e^-n``, non-paralyzable ``n / (1+n)``."""
    n = _as_tensor(n_tau, device)
    if model == "paralyzable":
        return n * torch.exp(-n)
    if model == "nonparalyzable":
        return n / (1.0 + n)
    raise ValueError(f"unknown dead-time model {model!r}")


def true_rate(m_tau, model="paralyzable", n_iters=30, *, device=None):
    """Invert the dead-time curve: true ``n*tau`` from recorded ``m*tau``.
    Non-paralyzable is closed form (``m/(1-m)``); paralyzable takes
    ``n_iters`` Newton steps from n = m on the low-rate branch of
    ``n e^-n = m``, the recorded rate clipped just below the peak 1/e."""
    m = _as_tensor(m_tau, device)
    if model == "nonparalyzable":
        return m / torch.clamp_min(1.0 - m, 1e-6)
    if model != "paralyzable":
        raise ValueError(f"unknown dead-time model {model!r}")
    mc = torch.clamp(m, 0.0, float(np.exp(-1.0)) - 1e-4)
    n = mc
    for _ in range(n_iters):
        f = n * torch.exp(-n) - mc
        fp = (1.0 - n) * torch.exp(-n)
        n = n - f / fp
    return n


def bin_mean_energies(i0s, energies):
    """Mean detected energy per counting bin [M] from the air-path
    effective fluences ``i0s`` [M, E] (host, float64)."""
    i0s = np.asarray(i0s, np.float64)
    e = np.asarray(energies, np.float64)
    w = i0s.sum(axis=1)
    return (i0s * e[None, :]).sum(axis=1) / np.maximum(w, 1e-300)


def bin_sum_redistribution(thresholds, mean_E):
    """Pairwise sum-energy routing tensor S [M, M, M] (host): ``S[i, j, b]
    = 1`` when a coincidence of a bin-i and a bin-j photon lands in bin b
    (sums above the last threshold stay in the open last bin)."""
    thr = np.asarray(thresholds, np.float64)
    me = np.asarray(mean_E, np.float64)
    m = len(me)
    if len(thr) != m:
        raise ValueError("need one threshold per bin (lower edges)")
    esum = me[:, None] + me[None, :]
    idx = np.searchsorted(thr, esum, side="right") - 1
    idx = np.clip(idx, 0, m - 1)
    s = np.zeros((m, m, m))
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    s[ii, jj, idx] = 1.0
    return s


def _psum(s, p):
    return torch.einsum("ijb,i...,j...->b...", s, p, p)


def apply_pileup_bins(counts, tau_ratio, sum_tensor, model="paralyzable",
                      *, device=None):
    """Pileup-distorted recorded counts [M, ...] from true per-bin counts
    [M, ...]; ``tau_ratio = tau / T_view``; ``sum_tensor`` from
    :func:`bin_sum_redistribution`."""
    c = _as_tensor(counts, device)
    s = torch.as_tensor(sum_tensor, dtype=c.dtype, device=c.device)
    n_tot = torch.sum(c, dim=0, keepdim=True)
    safe_tot = torch.clamp_min(n_tot, 1e-12)
    rho = torch.clamp_max(n_tot * tau_ratio, 1.0)  # guard deep saturation
    p = c / safe_tot
    m_tot = recorded_rate(n_tot * tau_ratio, model) / _scalar(tau_ratio, c)
    return m_tot * ((1.0 - 0.5 * rho) * p + 0.5 * rho * _psum(s, p))


def correct_pileup_bins(recorded, tau_ratio, sum_tensor,
                        model="paralyzable", n_iters=8, *, device=None):
    """Invert :func:`apply_pileup_bins`: dead-time inversion of the total,
    then ``n_iters`` damped fixed-point sweeps unmixing the sum-energy
    routing (nonnegativity clamp and renormalization each sweep)."""
    r = _as_tensor(recorded, device)
    s = torch.as_tensor(sum_tensor, dtype=r.dtype, device=r.device)
    m_tot = torch.sum(r, dim=0, keepdim=True)
    n_tot = true_rate(m_tot * tau_ratio, model) / _scalar(tau_ratio, r)
    rho = torch.clamp_max(n_tot * tau_ratio, 1.0)
    q = r / torch.clamp_min(m_tot, 1e-12)  # recorded fractions
    p = q
    for _ in range(n_iters):
        p_new = (q - 0.5 * rho * _psum(s, p)) / (1.0 - 0.5 * rho)
        p_new = torch.clamp_min(p_new, 0.0)
        p = p_new / torch.clamp_min(torch.sum(p_new, dim=0, keepdim=True),
                                    1e-12)
    return n_tot * p
