"""Detector gain nonuniformity: ring artifact simulation, air-scan
calibration, and sinogram-domain ring correction.

Port of :mod:`dexct_tpu.ops.rings`.  A per-channel gain error multiplies
every view of its channel and becomes a ring after reconstruction;
scanners fix it by air-scan calibration and a residual sinogram-domain
correction.  Gains are a broadcast multiply, calibration a view mean, the
corrector a sliding channel median and a median across views, the
defective-channel inpainting the MAR bridge (``ops.mar``): plain PyTorch,
no hand kernel.  Random draws take a ``torch.Generator`` (or an int that
seeds one) in place of the JAX package's PRNG key.  The functions run on
the device of their counts when those are a tensor, else on ``device``
(default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import _scalar, as_float, device_of

__all__ = ["sample_channel_gains", "apply_channel_gains",
           "air_calibration_gains", "ring_correct_sinogram",
           "apply_channel_defects", "detect_defective_channels",
           "inpaint_defective_channels"]


def _generator(gen, device):
    """A ``torch.Generator`` on ``device``: ``gen`` itself, or one seeded
    with the int ``gen``."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def _median(x, dim):
    """NumPy's median along ``dim``: the mean of the two middle values of
    an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) / 2).squeeze(dim)


def sample_channel_gains(generator, n_channels, sigma=0.003, drift=0.0, *,
                         device=None):
    """Per-channel multiplicative gains ``g_c ~ 1 + N(0, sigma)`` (float32,
    on ``device``, default the card, or the generator's device), times an
    optional smooth drift ``1 + drift sin(6 pi c / (C - 1) + phase)`` with
    a uniform random phase.  ``generator``: a ``torch.Generator`` or an int
    seed."""
    dev = (generator.device if isinstance(generator, torch.Generator)
           else torch.device("cuda" if device is None else device))
    gen = _generator(generator, dev)
    g = 1.0 + sigma * torch.randn(n_channels, generator=gen, device=dev)
    if drift:
        phase = 2 * np.pi * torch.rand((), generator=gen, device=dev)
        c = torch.arange(n_channels, device=dev) / max(n_channels - 1, 1)
        g = g * (1.0 + drift * torch.sin(2 * np.pi * 3 * c + phase))
    return g


def apply_channel_gains(counts, gains, *, device=None):
    """Measured counts with per-channel gains: counts[..., v, c] * g_c."""
    dev = device_of(counts, device)
    return as_float(counts, dev) * as_float(gains, dev)


def air_calibration_gains(counts_air, i0_expected, *, device=None):
    """Per-channel gains from an air scan [V, C]: the view mean over the
    forward model's air counts (scalar or [C])."""
    dev = device_of(counts_air, device)
    mean = torch.mean(as_float(counts_air, dev), dim=0)
    i0 = _scalar(i0_expected, mean) if np.isscalar(i0_expected) else (
        as_float(i0_expected, dev))
    return mean / i0


def ring_correct_sinogram(sino_log, half_width=2, clip=0.05, *,
                          device=None):
    """Residual ring correction in the log-sinogram domain: high-pass each
    view with a sliding channel median (edge-replicated, width ``2 *
    half_width + 1``), take the median across views per channel (the
    view-constant offset h_c) and subtract it, clipped at ``clip``."""
    dev = device_of(sino_log, device)
    s = as_float(sino_log, dev)
    hw = int(half_width)
    w = 2 * hw + 1
    c = s.shape[-1]
    padded = torch.cat([s[..., :1].expand(*s.shape[:-1], hw), s,
                        s[..., -1:].expand(*s.shape[:-1], hw)], -1)
    wins = torch.stack([padded[..., k:k + c] for k in range(w)], 0)
    resid = s - _median(wins, 0)  # per-view high-pass
    h_hat = _median(resid, -2).unsqueeze(-2)  # view-constant
    return s - torch.clamp(h_hat, -clip, clip)


def apply_channel_defects(counts, *, dead=None, flicker=None,
                          flicker_sigma=0.2, generator=None, device=None):
    """Simulate defective channels on measured counts [..., V, C]: ``dead``
    channels read 1e-6 of their signal, ``flicker`` channels take a
    view-to-view gain ``1 + N(0, flicker_sigma)`` clipped at 0.05
    (``generator``: a ``torch.Generator`` or an int seed)."""
    dev = device_of(counts, device)
    c = as_float(counts, dev)
    n_ch = c.shape[-1]
    if dead is not None and len(np.atleast_1d(dead)):
        mask = torch.zeros(n_ch, dtype=torch.bool, device=dev)
        mask[torch.as_tensor(np.atleast_1d(dead), device=dev)] = True
        c = torch.where(mask, 1e-6 * c, c)
    if flicker is not None and len(np.atleast_1d(flicker)):
        if generator is None:
            raise ValueError("flicker needs a torch.Generator")
        fl = torch.as_tensor(np.atleast_1d(flicker), device=dev)
        g = 1.0 + flicker_sigma * torch.randn(
            tuple(c.shape[:-1]) + (fl.numel(),),
            generator=_generator(generator, dev), dtype=c.dtype, device=dev)
        full = torch.ones_like(c)
        full[..., fl] = torch.clamp_min(g, 0.05)
        c = c * full
    return c


def detect_defective_channels(air_counts, *, dead_floor=0.5,
                              flicker_factor=6.0, device=None):
    """Defective-channel mask [C] from an air scan [V, C]: dead (view mean
    below ``dead_floor`` x the median channel) or flickering (view
    variance above ``flicker_factor`` x the median channel variance)."""
    dev = device_of(air_counts, device)
    a = as_float(air_counts, dev)
    m = a.mean(dim=-2)
    v = a.var(dim=-2, unbiased=False)
    dead = m < dead_floor * _median(m, -1)
    flicker = v > flicker_factor * torch.clamp_min(_median(v, -1), 1e-30)
    return dead | flicker


def inpaint_defective_channels(sino_log, bad_mask, *, device=None):
    """Replace defective channels by linear interpolation from their
    nearest healthy neighbors per view (the MAR sinogram bridge)."""
    from .mar import interpolate_sinogram

    dev = device_of(sino_log, device)
    s = as_float(sino_log, dev)
    trace = torch.as_tensor(bad_mask, device=dev).to(torch.bool)
    return interpolate_sinogram(s, trace.expand(s.shape))
