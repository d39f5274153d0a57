"""Image registration for ground-truth comparison.

Rebuild of the reference's ``register_xcat`` (plots.py:209-224): bilinear
rescale by a known pixel-size ratio plus an integer shift, used to align the
analytic phantom ground truth with reconstructed images before RMSE/VMI
comparisons.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rescale_shift", "register_phantom_to_recon"]


def _bilinear(M, yq, xq):
    """Sample M at float coordinates (grid-aligned, clamped edges)."""
    M = np.asarray(M, np.float64)
    ny, nx = M.shape
    y0 = np.clip(np.floor(yq).astype(int), 0, ny - 2)
    x0 = np.clip(np.floor(xq).astype(int), 0, nx - 2)
    fy = np.clip(yq - y0, 0.0, 1.0)
    fx = np.clip(xq - x0, 0.0, 1.0)
    return ((M[y0, x0] * (1 - fy) + M[y0 + 1, x0] * fy) * (1 - fx)
            + (M[y0, x0 + 1] * (1 - fy) + M[y0 + 1, x0 + 1] * fy) * fx)


def rescale_shift(M0, Nf, dx=0, dy=0):
    """Bilinearly rescale an [N0, N0] image onto an Nf-wide grid spanning
    the same extent, then crop back to N0 with an integer (dx, dy) shift —
    the reference's registration transform (plots.py:209-224)."""
    M0 = np.asarray(M0)
    n0 = M0.shape[0]
    grid = np.linspace(0.0, n0 - 1.0, Nf)
    yq, xq = np.meshgrid(grid, grid, indexing="ij")
    M = _bilinear(M0, yq, xq)
    return M[dy:dy + n0, dx:dx + n0]


def register_phantom_to_recon(phantom, n_matrix, fov, image=None,
                              energy_keV=None):
    """Resample a phantom-grid image onto the recon grid (both centered on
    the isocenter), using the known voxel size / FOV relationship.

    The reference hand-tuned scale/shift constants per dataset
    (plots.py:211-213 "chosen by visual inspection"); here the geometry is
    known exactly, so the mapping is analytic: recon pixel (iy, ix) at world
    (x, y) samples the phantom at index (y/dy + Ny/2 - 0.5).
    """
    img = phantom.M_mono(energy_keV) if image is None else np.asarray(image)
    ny, nx = img.shape
    px = fov / n_matrix
    coords = (np.arange(n_matrix) + 0.5 - n_matrix / 2.0) * px
    xq = coords / phantom.dx + nx / 2.0 - 0.5
    yq = coords / phantom.dy + ny / 2.0 - 0.5
    YY, XX = np.meshgrid(yq, xq, indexing="ij")
    out = _bilinear(img, YY, XX)
    # outside the phantom grid: clamp-edge values are already applied;
    # mark far-outside as the edge value (air)
    return out
