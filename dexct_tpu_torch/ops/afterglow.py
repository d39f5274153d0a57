"""Scintillator afterglow (detector lag): view-axis temporal blur
simulation and its exact recursive correction.

Port of :mod:`dexct_tpu.ops.afterglow`.  With per-view decay factors
``b_i = exp(-T_view / tau_i)`` and trap fractions ``a_i``:

    y_i[v] = b_i y_i[v-1] + (1 - b_i) x[v]        (trap state i)
    m[v]   = (1 - sum_i a_i) x[v] + sum_i a_i y_i[v]

which keeps the DC gain exactly.  The inversion is algebraic: ``m[v] =
x[v] (1 - s) + sum_i a_i b_i y_i[v-1]`` with ``s = sum_i a_i b_i``.  Both
directions are a recursion over views (a ``lax.scan`` in the JAX package,
a plain loop over views here, [K, ...] state per channel): no hand kernel.
They run on the device of their counts when those are a tensor, else on
``device`` (default: the card).  The lag calibration is host float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import as_float, device_of

__all__ = ["decay_per_view", "apply_afterglow", "correct_afterglow",
           "lag_impulse_response", "fit_lag_parameters"]


def decay_per_view(tau_ms, view_time_ms):
    """Per-view decay factor(s) b = exp(-T_view / tau)."""
    return np.exp(-np.asarray(view_time_ms, np.float64)
                  / np.asarray(tau_ms, np.float64))


def _check(fractions, decay):
    a = np.atleast_1d(np.asarray(fractions, np.float64))
    b = np.atleast_1d(np.asarray(decay, np.float64))
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError("fractions and decay must be matching 1-D")
    if a.sum() >= 1.0 or np.any(a < 0.0):
        raise ValueError("trap fractions must be >= 0 and sum < 1")
    if np.any((b < 0.0) | (b >= 1.0)):
        raise ValueError("decay factors must be in [0, 1)")
    return a, b


def _bcast(v, x, k):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device).reshape(
        (k,) + (1,) * (x.ndim - 1))


def apply_afterglow(counts, fractions, decay, *, warm_start=False,
                    device=None):
    """Lagged measurement [V, ...] from the true per-view signal
    ``counts`` [V, ...]; ``warm_start`` starts the trap states in
    equilibrium with the first view instead of empty."""
    a, b = _check(fractions, decay)
    # floating: integer counts would truncate the trap fractions to zero
    x = as_float(counts, device_of(counts, device))
    prompt = 1.0 - a.sum()
    k = len(a)
    shape = (k,) + tuple(x.shape[1:])
    y = x[0].expand(shape) if warm_start \
        else torch.zeros(shape, dtype=x.dtype, device=x.device)
    bc, ac = _bcast(b, x, k), _bcast(a, x, k)
    out = torch.empty_like(x)
    for v in range(x.shape[0]):
        xv = x[v]
        y = bc * y + (1.0 - bc) * xv[None]
        out[v] = prompt * xv + torch.sum(ac * y, dim=0)
    return out


def correct_afterglow(measured, fractions, decay, *, warm_start=False,
                      device=None):
    """Exact inversion of :func:`apply_afterglow` (same parameters and
    ``warm_start`` convention): peels the known trap-state contribution
    off each view."""
    a, b = _check(fractions, decay)
    m = as_float(measured, device_of(measured, device))
    k = len(a)
    gain = 1.0 - float((a * b).sum())  # coefficient of x[v] in m[v]
    bc, ac = _bcast(b, m, k), _bcast(a, m, k)
    shape = (k,) + tuple(m.shape[1:])
    # warm start: y[-1] = x[0] and m[0] = x[0] exactly (equilibrium)
    y = m[0].expand(shape) if warm_start \
        else torch.zeros(shape, dtype=m.dtype, device=m.device)
    out = torch.empty_like(m)
    for v in range(m.shape[0]):
        xv = (m[v] - torch.sum(ac * bc * y, dim=0)) / gain
        y = bc * y + (1.0 - bc) * xv[None]
        out[v] = xv
    return out


def lag_impulse_response(fractions, decay, n=32):
    """Discrete impulse response h[0..n-1] of the lag model (host)."""
    a, b = _check(fractions, decay)
    h = np.zeros(n)
    h[0] = 1.0 - a.sum() + (a * (1.0 - b)).sum()
    kk = np.arange(1, n)
    h[1:] = ((a * (1.0 - b))[None, :] * (b[None, :] ** kk[:, None])).sum(1)
    return h


def fit_lag_parameters(decay_tail, n_exp=2):
    """Calibrate the lag model from a measured shutter-off decay tail
    h[1..n] by Prony's method (host, float64): the decay factors are the
    roots of the tail's linear recurrence, the amplitudes one linear
    least-squares fit on their Vandermonde.  Returns ``(fractions
    [n_exp], decay [n_exp])``."""
    h = np.asarray(decay_tail, np.float64)
    p = int(n_exp)
    if len(h) < 2 * p + 1:
        raise ValueError(f"need >= {2 * p + 1} tail samples for "
                         f"{p} exponentials")
    rows = len(h) - p
    A = np.stack([h[p - 1 - j:p - 1 - j + rows] for j in range(p)], -1)
    rhs = h[p:p + rows]
    c, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    roots = np.roots(np.concatenate([[1.0], -c]))
    b = np.clip(np.real(roots), 0.0, 1.0 - 1e-9)
    b = np.sort(b)
    kk = np.arange(1, len(h) + 1)
    V = b[None, :] ** kk[:, None]
    w, *_ = np.linalg.lstsq(V, h, rcond=None)
    a = w / np.maximum(1.0 - b, 1e-12)
    a = np.clip(a, 0.0, None)
    return a, b
