"""Scintillator afterglow (detector lag): view-axis temporal blur
simulation and its exact recursive correction.

Port of :mod:`dexct_tpu.ops.afterglow`.  With per-view decay factors
``b_i = exp(-T_view / tau_i)`` and trap fractions ``a_i``:

    y_i[v] = b_i y_i[v-1] + (1 - b_i) x[v]        (trap state i)
    m[v]   = (1 - sum_i a_i) x[v] + sum_i a_i y_i[v]

which keeps the DC gain exactly.  The inversion is algebraic: ``m[v] =
x[v] (1 - s) + sum_i a_i b_i y_i[v-1]`` with ``s = sum_i a_i b_i``.  Both
directions are a recursion over views (a ``lax.scan`` in the JAX package).
On CUDA tensors :func:`apply_afterglow` runs kernel K36 and
:func:`correct_afterglow` kernel K37 (``csrc/afterglow.cu``: one thread per
detector column, the trap states in registers, every operation rounded as
the plain twin rounds it); on CPU tensors they run their plain twins
:func:`apply_afterglow_plain` and :func:`correct_afterglow_plain`, a loop
over views with [K, ...] state per column.  Both forms take at most
:data:`MAX_TRAPS` traps (the kernels keep the states in registers; the JAX
model uses one or two).  They run on the device of their counts when those
are a tensor, else on ``device`` (default: the card).  The lag calibration
is host float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import as_float, device_of

__all__ = ["decay_per_view", "apply_afterglow", "correct_afterglow",
           "apply_afterglow_plain", "correct_afterglow_plain",
           "lag_impulse_response", "fit_lag_parameters", "MAX_TRAPS"]

# the kernels' compile-time maximum number of traps (their states live in
# registers); both devices refuse more
MAX_TRAPS = 8


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
    if len(a) > MAX_TRAPS:
        raise ValueError(f"at most MAX_TRAPS = {MAX_TRAPS} traps, got "
                         f"{len(a)}")
    return a, b


def _coefficients(a, b, dtype, correct):
    """The recursion's coefficients in the working ``dtype``, formed as the
    JAX program forms them (on the CPU; IEEE rounding of one operation is
    the same on every device): ``(b, 1 - b, w, scalar)``, with ``w`` the
    trap fractions and ``scalar`` the prompt fraction ``1 - sum a`` (taken
    in float64) for the apply direction, and ``w = a b`` and ``scalar`` the
    gain ``1 - sum a b`` (float64) for the correction."""
    bt = torch.as_tensor(b, dtype=dtype)
    at = torch.as_tensor(a, dtype=dtype)
    if correct:
        w, scalar = at * bt, 1.0 - float((a * b).sum())
    else:
        w, scalar = at, 1.0 - a.sum()
    return bt, 1.0 - bt, w, torch.as_tensor(scalar, dtype=dtype)


def _prepare(counts, fractions, decay, device, correct):
    a, b = _check(fractions, decay)
    # floating: integer counts would truncate the trap fractions to zero
    x = as_float(counts, device_of(counts, device))
    return x, _coefficients(a, b, x.dtype, correct)


def _on(t, x):
    """A [K] coefficient tensor on the device of ``x``, shaped to broadcast
    over its trailing dims."""
    return t.to(x.device).reshape((t.shape[0],) + (1,) * (x.ndim - 1))


def apply_afterglow_plain(counts, fractions, decay, *, warm_start=False,
                          device=None):
    """The plain twin of :func:`apply_afterglow` (K36), on any device: a
    loop over views."""
    x, (b, omb, w, prompt) = _prepare(counts, fractions, decay, device,
                                      False)
    bc, ombc, ac = (_on(t, x) for t in (b, omb, w))
    prompt = prompt.to(x.device)  # a tensor: see correct_afterglow_plain
    k = bc.shape[0]
    shape = (k,) + tuple(x.shape[1:])
    y = x[0].expand(shape) if warm_start \
        else torch.zeros(shape, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    for v in range(x.shape[0]):
        xv = x[v]
        y = bc * y + ombc * xv[None]
        out[v] = prompt * xv + torch.sum(ac * y, dim=0)
    return out


def correct_afterglow_plain(measured, fractions, decay, *, warm_start=False,
                            device=None):
    """The plain twin of :func:`correct_afterglow` (K37), on any device: a
    loop over views.  The gain is a 0-d tensor of the working type on the
    device of the counts: PyTorch on CUDA divides by a Python scalar as a
    product with its reciprocal, which rounds differently."""
    m, (b, omb, w, gain) = _prepare(measured, fractions, decay, device,
                                    True)
    bc, ombc, abc = (_on(t, m) for t in (b, omb, w))
    gain = gain.to(m.device)
    k = bc.shape[0]
    shape = (k,) + tuple(m.shape[1:])
    # warm start: y[-1] = x[0] and m[0] = x[0] exactly (equilibrium)
    y = m[0].expand(shape) if warm_start \
        else torch.zeros(shape, dtype=m.dtype, device=m.device)
    out = torch.empty_like(m)
    for v in range(m.shape[0]):
        xv = (m[v] - torch.sum(abc * y, dim=0)) / gain
        y = bc * y + ombc * xv[None]
        out[v] = xv
    return out


def _afterglow_cuda(x, coef, warm_start, correct):
    """K36 (``correct=False``) or K37 on a CUDA tensor [V, ...]."""
    dev = x.device
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError("the afterglow kernels take float32 or float64 "
                         f"counts, got {x.dtype}")
    x = kernels.require(x.contiguous(), "counts", dev, x.dtype)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, omb, w, scalar = coef
    k = b.shape[0]
    host = np.concatenate([t.double().numpy().reshape(-1)
                           for t in (b, omb, w, scalar)])
    V = x.shape[0]
    rc = kernels.library().dexct_afterglow(
        x.data_ptr(), out.data_ptr(), host.ctypes.data, k, int(correct),
        int(x.dtype == torch.float64), V, x.numel() // V, int(warm_start),
        kernels.stream_ptr(dev))
    kernels.check(rc, "afterglow_correct" if correct else "afterglow_apply")
    return out


def apply_afterglow(counts, fractions, decay, *, warm_start=False,
                    device=None):
    """Lagged measurement [V, ...] from the true per-view signal
    ``counts`` [V, ...]; ``warm_start`` starts the trap states in
    equilibrium with the first view instead of empty.

    CUDA tensors run kernel K36 (counted in ``apply_afterglow.launches``;
    float32 or float64); CPU tensors run :func:`apply_afterglow_plain`."""
    x, coef = _prepare(counts, fractions, decay, device, False)
    if x.is_cuda:
        out = _afterglow_cuda(x, coef, warm_start, False)
        apply_afterglow.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return apply_afterglow_plain(x, fractions, decay, warm_start=warm_start)


apply_afterglow.launches = 0


def correct_afterglow(measured, fractions, decay, *, warm_start=False,
                      device=None):
    """Exact inversion of :func:`apply_afterglow` (same parameters and
    ``warm_start`` convention): peels the known trap-state contribution
    off each view.

    CUDA tensors run kernel K37 (counted in ``correct_afterglow.launches``;
    float32 or float64); CPU tensors run :func:`correct_afterglow_plain`."""
    m, coef = _prepare(measured, fractions, decay, device, True)
    if m.is_cuda:
        out = _afterglow_cuda(m, coef, warm_start, True)
        correct_afterglow.launches += 1
        return out
    if m.device.type != "cpu":
        raise ValueError(f"unsupported device {m.device}")
    return correct_afterglow_plain(m, fractions, decay,
                                   warm_start=warm_start)


correct_afterglow.launches = 0


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
