"""X-ray scatter: kernel-superposition simulation, anti-scatter grid,
and iterative scatter correction.

Port of :mod:`dexct_tpu.ops.scatter`.  The forward model is scatter-free —
every detected photon took the geometric ray path.  Real fan-beam systems
detect a broad, low-frequency scatter background on top of the primary
signal; its image-domain signature is cupping/shading and streaks between
dense objects, and scanners combat it with an anti-scatter grid plus a
software kernel correction.

Model (scatter-kernel superposition, the standard projection-domain
family): each ray's PRIMARY signal seeds scatter proportional to how
much of the beam it scattered out, spread across neighboring detector
channels by a broad normalized kernel:

    S[v, c] = spr * conv_c( P[v, :] * (1 - T[v, :]), G_sigma )[c]

with T the transmitted fraction (air-normalized primary) — a thick ray
(T -> 0) seeds the most scatter, an air ray none — and the measured
signal is ``P + grid_s * S`` (grid_s = the grid's scatter
transmission; a grid also costs ``grid_p`` on the primary).

Correction inverts the same model from the MEASURED data by fixed-point
iteration (S depends on P = M - S; two iterations converge to <1% for
SPR <= 1): the standard deconvolution-free kernel correction.

The spread is an edge-padded same-size correlation along one axis
(:func:`_conv_axis`): plain PyTorch, no hand kernel (``F.conv1d``, with
cuDNN's TF32 turned off around it so the card keeps float32).  Everything
else is elementwise.  The entry points run on the device of their counts
when those are a tensor, else on ``device`` (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.devices import _scalar, as_float, device_of, upload

__all__ = ["scatter_kernel", "add_scatter", "correct_scatter",
           "scatter_fraction"]


def scatter_kernel(n_channels, sigma_ch=40.0, dtype=np.float32):
    """Normalized broad channel-domain scatter kernel [C_k] (host).

    A Gaussian of ``sigma_ch`` channels, truncated at 3 sigma (and at
    the detector width — a wider kernel adds only zero-weight work) and
    renormalized; scatter tails are object- and geometry-dependent in
    reality — the width is a model parameter, not physics.
    """
    hw = min(int(3.0 * sigma_ch), int(n_channels) - 1)
    x = np.arange(-hw, hw + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / float(sigma_ch)) ** 2)
    return (g / g.sum()).astype(dtype)


def _conv_channels(x, kernel):
    """Same-size correlation along the last (channel) axis (edge-padded);
    the dual-source cross-scatter's spread."""
    return _conv_axis(x, kernel, -1)


def _conv_axis(x, kernel, axis):
    """Same-size correlation along ``axis`` (edge-padded), in float32 on
    the device of ``x``."""
    xm = torch.movedim(x, axis, -1)
    shape = xm.shape
    k = upload(kernel, x)
    hw = (k.shape[0] - 1) // 2
    rows = xm.reshape(-1, 1, shape[-1])
    rows = F.pad(rows, (hw, hw), mode="replicate")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv1d(rows, k.reshape(1, 1, -1))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return torch.movedim(out.reshape(shape), -1, axis)


def _spread(seed, kernel, row_kernel):
    """Separable scatter spread: channels always, rows when a cone
    sinogram [..., R, C] carries a ``row_kernel``."""
    s = _conv_axis(seed, kernel, -1)
    if row_kernel is not None:
        s = _conv_axis(s, row_kernel, -2)
    return s


def _as_air(air, like):
    """The air counts as a tensor on ``like``'s device: a scalar as a 0-d
    tensor of its dtype, filled there (``utils.devices._scalar``)."""
    return _scalar(air, like) if np.isscalar(air) else as_float(air,
                                                                like.device)


def add_scatter(primary, air, kernel, *, spr=0.2, grid_p=0.95,
                grid_s=0.2, row_kernel=None, device=None):
    """Measured counts with scatter: ``grid_p * P + grid_s * S``.

    primary: scatter-free counts [..., V, C]; ``air``: the air-scan
    counts normalizing T (scalar or [C]); ``spr`` scales the seeded
    scatter (the scatter-to-primary ratio behind a fully absorbing
    neighborhood); ``grid_p``/``grid_s``: anti-scatter grid primary /
    scatter transmissions (1/1 = no grid).  For cone-beam data
    [..., V, R, C] pass ``row_kernel`` (a second 1-D kernel, e.g.
    ``scatter_kernel(n_rows, sigma_rows)``) — the spread becomes the
    separable 2-D kernel over the detector face, which is the physical
    situation (scatter is diffuse in BOTH detector axes).  Runs on the
    device of ``primary`` when it is a tensor, else on ``device``
    (default: the card).
    """
    dev = device_of(primary, device)
    primary = as_float(primary, dev)
    air = _as_air(air, primary)
    t = primary / air
    seed = primary * (1.0 - t)
    s = spr * _spread(seed, kernel, row_kernel)
    return grid_p * primary + grid_s * s


def correct_scatter(measured, air, kernel, *, spr=0.2, grid_p=0.95,
                    grid_s=0.2, n_iters=2, row_kernel=None, device=None):
    """Estimate and remove the scatter background from measured counts.

    Fixed-point on the same kernel model: start from P ~= M / grid_p,
    re-estimate S(P), subtract, repeat ``n_iters`` times; clamps keep
    the result positive.  Returns the estimated primary counts (same
    normalization as the scatter-free forward model), on the device of
    ``measured`` when it is a tensor, else on ``device`` (default: the
    card).
    """
    dev = device_of(measured, device)
    measured = as_float(measured, dev)
    air = _as_air(air, measured)
    floor = 1e-6 * air
    gp = _scalar(grid_p, measured)
    p = measured / gp
    for _ in range(n_iters):
        t = torch.clamp(p / air, 0.0, 1.0)
        s = spr * _spread(p * (1.0 - t), kernel, row_kernel)
        p = torch.maximum((measured - grid_s * s) / gp, floor)
    return p


def scatter_fraction(measured, primary, grid_p=1.0, *, device=None):
    """Mean scatter-to-total fraction of a measured sinogram (metric), on
    the device of ``measured`` when it is a tensor, else on ``device``
    (default: the card)."""
    dev = device_of(measured, device)
    measured, primary = as_float(measured, dev), as_float(primary, dev)
    s = measured - grid_p * primary
    return float(torch.mean(s / torch.clamp_min(measured, 1e-30)))
