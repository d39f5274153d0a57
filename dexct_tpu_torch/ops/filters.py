"""Reconstruction filters for filtered back-projection.

The reference reconstructs with a "sinc window filter" whose cutoff is a
fraction of Nyquist (``ramp`` = 0.8 in params.txt:35; README.md:21,31).  We
implement the standard discrete equiangular ramp kernel (exact DC handling)
with a frequency-domain apodization window; the Shepp-Logan/'sinc' window is
the default to match the reference description, and ram-lak/hann/hamming/
cosine are provided as first-class options.
"""

from __future__ import annotations

import numpy as np

__all__ = ["equiangular_ramp_kernel", "filter_frequency_response",
           "WINDOWS"]


def _next_pow2(n):
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def equiangular_ramp_kernel(n_channels, dgamma):
    """Discrete ramp kernel g[n] for equiangular fan-beam filtering.

    Kak & Slaney eq. (3.49): g[0] = 1/(8 dgamma^2); for odd n,
    g[n] = -0.5 / (pi sin(n dgamma))^2; even n vanish.  Length 2N-1,
    centered at index N-1.  (For parallel-beam geometry pass
    ``sin(x) -> x``; see :func:`parallel_ramp_kernel`.)
    """
    n = np.arange(-(n_channels - 1), n_channels)
    g = np.zeros(n.shape, np.float64)
    g[n % 2 == 1] = -0.5 / (np.pi * np.sin(n[n % 2 == 1] * dgamma)) ** 2
    g[n == 0] = 1.0 / (8.0 * dgamma**2)
    return g


def parallel_ramp_kernel(n_channels, ds):
    """Discrete ramp kernel for parallel-beam / linear detectors
    (Kak & Slaney eq. 3.29)."""
    n = np.arange(-(n_channels - 1), n_channels)
    g = np.zeros(n.shape, np.float64)
    g[n % 2 == 1] = -1.0 / (np.pi * n[n % 2 == 1] * ds) ** 2
    g[n == 0] = 1.0 / (4.0 * ds**2)
    return g


WINDOWS = ("ramp", "sinc", "hann", "hamming", "cosine")


def _window(f_norm, ramp, kind):
    """Apodization over normalized frequency f_norm in [0, 1] (1=Nyquist),
    cutoff at ``ramp`` * Nyquist."""
    passband = f_norm <= ramp + 1e-12
    x = np.where(passband, f_norm / max(ramp, 1e-12), 1.0)
    if kind == "ramp":
        w = np.ones_like(x)
    elif kind == "sinc":  # Shepp-Logan
        w = np.sinc(x / 2.0)
    elif kind == "hann":
        w = 0.5 * (1.0 + np.cos(np.pi * x))
    elif kind == "hamming":
        w = 0.54 + 0.46 * np.cos(np.pi * x)
    elif kind == "cosine":
        w = np.cos(np.pi * x / 2.0)
    else:
        raise ValueError(f"unknown filter window {kind!r}; known: {WINDOWS}")
    return np.where(passband, w, 0.0)


def filter_frequency_response(n_channels, dgamma, ramp=0.8, window="sinc",
                              geometry_kind="fan"):
    """Windowed ramp response H[k] on an FFT grid, plus the FFT size.

    Returns ``(H, m)``: ``H`` is the rfft of the zero-padded spatial ramp
    kernel multiplied by the apodization window, ready for
    ``irfft(rfft(sino_padded) * H)``; ``m`` is the padded FFT length
    (>= 2 * n_channels, power of two).
    """
    m = _next_pow2(2 * n_channels)
    if geometry_kind == "fan":
        g = equiangular_ramp_kernel(n_channels, dgamma)
    elif geometry_kind == "parallel":
        g = parallel_ramp_kernel(n_channels, dgamma)
    else:
        raise ValueError(f"unknown geometry_kind {geometry_kind!r}")
    gpad = np.zeros(m, np.float64)
    gpad[: 2 * n_channels - 1] = g
    # center the kernel at index 0 (circular shift) so convolution aligns
    gpad = np.roll(gpad, -(n_channels - 1))
    H = np.fft.rfft(gpad)
    # the rolled kernel is even, so H is purely real — return it as float
    assert np.abs(H.imag).max() < 1e-9 * np.abs(H.real).max() + 1e-12
    H = H.real
    f_norm = np.arange(len(H)) / (m / 2.0)  # 1.0 at Nyquist
    H = H * _window(f_norm, ramp, window)
    return H, m
