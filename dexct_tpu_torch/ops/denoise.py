"""Anticorrelated dual-energy basis-noise suppression (KL-line filter).

Port of :mod:`dexct_tpu.ops.denoise`.  The two basis estimates of a DE
decomposition carry strongly anticorrelated noise, so the filter smooths
only the noisy eigencomponent and keeps the quiet one at full resolution:

    m' = smooth(m) + u u^T (m - smooth(m)),   u ⟂ v_high-noise,

so ``u·m' == u·m`` exactly.  The eigendirections come from the analytic
covariance maps of ``ops.noisemap``.  Separable edge-padded Gaussian
correlations (``ops.scatter._conv_axis``: plain PyTorch, cuDNN with TF32
off) and per-pixel 2x2 eigenrotations: no hand kernel.  Runs on the device
of the basis images when they are tensors, else on ``device`` (default:
the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import as_float, device_of
from .scatter import _conv_axis

__all__ = [
    "gaussian_kernel",
    "smooth_separable",
    "high_noise_direction",
    "anticorrelated_denoise",
    "anticorrelated_denoise_sinos",
]


def gaussian_kernel(sigma, radius=None):
    """Normalized 1-D Gaussian taps (host, float32)."""
    if radius is None:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-12)) ** 2)
    return (k / k.sum()).astype(np.float32)


def smooth_separable(img, sigma, axes=(-2, -1), *, device=None):
    """Separable edge-padded Gaussian blur along ``axes``."""
    k = gaussian_kernel(sigma)
    out = as_float(img, device_of(img, device))
    for ax in axes:
        out = _conv_axis(out, k, ax)
    return out


def high_noise_direction(var1, var2, cov12, *, device=None):
    """Unit eigenvector of the larger noise eigenvalue, shape [..., 2]:
    ``phi = atan2(2 cov12, var1 - var2) / 2``."""
    dev = device_of(var1, device)
    v1, v2, c12 = (as_float(x, dev) for x in (var1, var2, cov12))
    phi = 0.5 * torch.atan2(2.0 * c12, v1 - v2)
    return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


def _filter_pair(m, v, sigma, axes):
    """m [..., 2], v [..., 2] high-noise unit directions."""
    d = m - smooth_separable(m, sigma, axes=axes)
    # remove the high-frequency content along v only
    return m - v * torch.sum(d * v, dim=-1, keepdim=True)


def anticorrelated_denoise(m1, m2, var1, var2, cov12, *, sigma_px=2.0,
                           device=None):
    """Filter a basis-image pair [N, N] with its per-pixel covariance maps
    (``ops.noisemap.basis_variance_maps``).  Returns the filtered pair;
    the low-noise component is preserved exactly."""
    dev = device_of(m1, device)
    m = torch.stack([as_float(m1, dev), as_float(m2, dev)], dim=-1)
    v = high_noise_direction(var1, var2, cov12, device=dev)
    v = v.expand(m.shape)
    out = _filter_pair(m, v, sigma_px, axes=(-3, -2))
    return out[..., 0], out[..., 1]


def anticorrelated_denoise_sinos(a_sinos, cov_rays, *, sigma_ch=2.0,
                                 device=None):
    """Projection-domain variant: basis sinograms a [V, C, 2] with
    ``decomposition_covariance``'s cov [V, C, 2, 2], smoothed along the
    channel axis only."""
    dev = device_of(a_sinos, device)
    a = as_float(a_sinos, dev)
    cov = as_float(cov_rays, dev)
    v = high_noise_direction(cov[..., 0, 0], cov[..., 1, 1],
                             cov[..., 0, 1])
    ms = _conv_axis(a, gaussian_kernel(sigma_ch), -2)
    d = a - ms
    return a - v * torch.sum(d * v, dim=-1, keepdim=True)
