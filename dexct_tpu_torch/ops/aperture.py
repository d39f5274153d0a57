"""Finite detector aperture: sub-ray integration and the nonlinear
partial-volume effect.

Port of :mod:`dexct_tpu.ops.aperture`.  A real channel averages the
transmitted INTENSITY over its aperture, ``counts = mean_s sum_E i0(E)
exp(-L_s(E))``, which by Jensen's inequality exceeds the single-ray counts
through a heterogeneous aperture (the nonlinear partial-volume effect).
Sub-rays are fractional ``det_offset_ch`` shifts of the whole fan traced
by the exact trace (K1); their counts are K2's; the intensity average is
one mean.  Paths run on ``device`` (default: the card); counts on the
device of their paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.devices import _scalar, upload
from .siddon import material_path_sinogram

__all__ = ["finite_aperture_paths", "aperture_counts",
           "nlpv_bias_sinogram"]


def finite_aperture_paths(phantom, geometry, n_sub=4, *, device=None,
                          dtype=torch.float32, method="auto"):
    """Exact material paths at ``n_sub`` sub-aperture ray offsets [S, V,
    C, M]: sub-ray s samples ``gamma_c + off_s * dgamma`` with midpoint
    offsets ``off_s = (s + 0.5)/S - 0.5``.  ``n_sub=1`` is the center-line
    sinogram.  ``method`` (the JAX package's tracer choice) is accepted
    and ignored: one exact trace serves every grid."""
    del method
    if n_sub < 1:
        raise ValueError("n_sub must be >= 1")
    dev = torch.device("cuda" if device is None else device)
    offs = (np.arange(n_sub) + 0.5) / n_sub - 0.5
    out = []
    for off in offs:
        g = dataclasses.replace(
            geometry, det_offset_ch=geometry.det_offset_ch + float(off))
        out.append(material_path_sinogram(phantom, g, device=dev,
                                          dtype=dtype))
    return torch.stack(out)


def _counts(paths_sub, mu_table, i0_eff):
    from .spectral import counts_from_paths

    f32 = torch.float32
    return counts_from_paths(paths_sub, upload(mu_table, paths_sub, f32),
                             upload(i0_eff, paths_sub, f32))


def aperture_counts(paths_sub, mu_table, i0_eff):
    """Aperture-integrated detected counts [V, C]: the sub-ray INTENSITIES
    average (the physical detector), not the line integrals."""
    return torch.mean(_counts(paths_sub, mu_table, i0_eff), dim=0)


def nlpv_bias_sinogram(paths_sub, mu_table, i0_eff):
    """The nonlinear partial-volume bias in log units [V, C]:
    ``mean_s(L_eff) - (-ln(mean_s exp(-L_eff)))``, zero through
    homogeneous apertures and positive at edges."""
    c = _counts(paths_sub, mu_table, i0_eff)  # [S, V, C]
    # the air counts as a 0-d tensor on the counts' device: summed where
    # i0_eff lies (no host read of a card tensor), filled on the card from
    # a host sum (a Python-float divisor runs as a reciprocal product there)
    air = torch.as_tensor(i0_eff, dtype=torch.float32).sum()
    if air.device != c.device:
        air = _scalar(float(air), c)
    log_mean = -torch.log(torch.clamp_min(torch.mean(c, 0), 1e-30) / air)
    mean_log = torch.mean(-torch.log(torch.clamp_min(c, 1e-30) / air), 0)
    return mean_log - log_mean
