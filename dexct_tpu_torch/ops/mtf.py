"""Detector/source MTF realism: finite focal spot blur, channel
crosstalk, and Wiener restoration.

Port of :mod:`dexct_tpu.ops.mtf`.  A finite focal spot (penumbra of width
``spot * (SDD - SID) / SID`` on the detector) and channel crosstalk (a
short symmetric kernel) are linear shift-invariant along channels: the
blur is one edge-padded correlation (``ops.scatter._conv_axis``: plain
PyTorch, cuDNN with TF32 off) and the restoration the frequency-domain
Wiener filter ``H* / (|H|^2 + NSR)`` per view (one rfft/irfft pair).  The
kernels are host NumPy; the blur and the restoration run on the device of
their sinogram when it is a tensor, else on ``device`` (default: the
card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import as_float, device_of
from .scatter import _conv_axis

__all__ = ["focal_spot_kernel", "crosstalk_kernel", "apply_detector_mtf",
           "wiener_restore_channels"]


def focal_spot_kernel(geometry, spot_width_cm, dtype=np.float32):
    """Channel-axis blur kernel of a finite focal spot (host): the rect of
    full penumbra width ``spot * (SDD - SID) / SID`` on the detector, in
    channels, rasterized onto the channel grid by bin overlap."""
    width_det = spot_width_cm * (geometry.SDD - geometry.SID) \
        / geometry.SID
    width_ch = width_det / (geometry.SDD * geometry.dgamma)
    hw = max(int(np.ceil((width_ch + 1.0) / 2.0)), 1)
    x = np.arange(-hw, hw + 1, dtype=np.float64)
    k = np.clip(np.minimum(x + 0.5, width_ch / 2.0)
                - np.maximum(x - 0.5, -width_ch / 2.0), 0.0, 1.0)
    if k.sum() <= 0.0:  # degenerate zero-width spot: identity
        k[hw] = 1.0
    return (k / k.sum()).astype(dtype)


def crosstalk_kernel(frac=0.05, dtype=np.float32):
    """Nearest-neighbor crosstalk kernel [frac, 1-2*frac, frac]."""
    if not 0.0 <= frac < 0.5:
        raise ValueError("crosstalk fraction must be in [0, 0.5)")
    return np.asarray([frac, 1.0 - 2.0 * frac, frac], dtype)


def apply_detector_mtf(counts, kernel, *, device=None):
    """Blur the sinogram counts along channels (edge-padded correlation)."""
    dev = device_of(counts, device)
    return _conv_axis(as_float(counts, dev), kernel, -1)


def wiener_restore_channels(sino, kernel, *, nsr=1e-3, device=None):
    """Wiener deconvolution along the channel axis.

    sino: [..., C] blurred data; kernel: the 1-D blur kernel; ``nsr``: the
    noise-to-signal power floor.  Both sides are edge-replicated by the
    kernel half-width so the circular FFT never wraps data across the fan
    edges.  The filter is computed in float64 on the host and applied as
    a real float32 array (the kernel is symmetric and zero-phase).
    """
    dev = device_of(sino, device)
    x = as_float(sino, dev)
    c = x.shape[-1]
    k = np.asarray(kernel, np.float64)
    hw = (len(k) - 1) // 2
    n = int(c + 2 * hw)
    kpad = np.zeros(n)
    for i, v in enumerate(k):
        kpad[(i - hw) % n] += v
    H = np.fft.rfft(kpad)
    W = np.conj(H) / (np.abs(H) ** 2 + float(nsr))
    W = torch.as_tensor(np.real(W).astype(np.float32), device=dev)
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], hw), x,
                    x[..., -1:].expand(*x.shape[:-1], hw)], -1)
    spec = torch.fft.rfft(xp, dim=-1)
    out = torch.fft.irfft(spec * W, n=n, dim=-1)
    return out[..., hw:hw + c].to(x.dtype)
