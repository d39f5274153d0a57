"""Fast kV-switching dual-energy acquisition.

Port of :mod:`dexct_tpu.pipeline.kvswitch`.  The reference acquires its
DE pair as two full rotations (main.py:101-176).  Fast kV-switching
scanners instead alternate the tube voltage VIEW BY VIEW within one
rotation: even views see spectrum A, odd views spectrum B.  Each spectrum
therefore samples only half the view grid, and the projection-domain
decomposition needs both measurements on a COMMON grid: the standard
approach (and the mode's characteristic artifact source) is angular
interpolation of each kV's log sinogram onto the skipped views before
decomposing.

The full-grid trace is shared (K1), acquisition keeps the alternating
halves (K2), and the interpolation is one ring-wrapped average per
spectrum (elementwise torch, no kernel of its own).  Everything downstream
(decomposition K3, FBP K4) is the composed DE path on the interpolated
common grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import spectral as sp_ops
from ..ops.siddon import material_path_sinogram
from .api import DectResult, get_basismat_sinos, get_recon, get_sino

__all__ = ["interleave_views", "interp_skipped_views",
           "simulate_kvswitch_dect"]


def _view_parity(n_views, device):
    return torch.arange(n_views, device=device) % 2


def interleave_views(sino_a, sino_b, phase=0):
    """Compose the acquired kV-switching sinogram: view v comes from A
    when ``v % 2 == phase``, else from B.  (The inverse of the masks
    :func:`simulate_kvswitch_dect` applies.)"""
    v = _view_parity(sino_a.shape[0], sino_a.device) == phase
    return torch.where(v[:, None], sino_a, sino_b)


def interp_skipped_views(sino_log, acquired_parity):
    """Fill the skipped views of one kV's log sinogram by ring-wrapped
    neighbor averaging.

    ``acquired_parity``: 0 when this spectrum acquired the even views,
    1 for the odd views.  Acquired views pass through untouched; each
    skipped view becomes the mean of its two acquired neighbors (the
    view axis wraps: a full 2*pi rotation).  Interpolating LOG data (line
    integrals) rather than counts keeps the fill linear in the object.
    """
    acquired = _view_parity(sino_log.shape[0],
                            sino_log.device) == acquired_parity
    neighbor_mean = 0.5 * (torch.roll(sino_log, 1, dims=0)
                           + torch.roll(sino_log, -1, dims=0))
    return torch.where(acquired[:, None], sino_log, neighbor_mean)


def simulate_kvswitch_dect(ct, phantom, spec_a, spec_b, N_matrix, FOV,
                           ramp, *, n_iters=50, noise="none", generator=None,
                           window="sinc", phase=0, do_recon=True,
                           device=None):
    """One-rotation kV-switching DECT on ``device`` (default: the card).

    Views with ``v % 2 == phase`` are acquired with ``spec_a``, the
    rest with ``spec_b``; each kV's log sinogram is completed by
    ring-neighbor interpolation and the pair decomposes and reconstructs
    through the standard DE path.  Returns the
    :class:`~dexct_tpu_torch.pipeline.api.DectResult` contract of
    ``simulate_dect``: ``sino_raw`` carries the forward-modeled counts with
    the SKIPPED views zeroed (what the scanner measured), while
    ``sino_log`` and what follows carry the interpolated common-grid data.
    Noise draws come from ``generator`` (spectrum A first).

    Dose note: with half the views acquired per kV, a matched-total-dose
    protocol doubles the per-view dose (rescale with ``2 * dose``).
    """
    if ct.N_proj % 2:
        raise ValueError("kV-switching needs an even view count "
                         f"(got N_proj={ct.N_proj})")
    rot = float(getattr(ct, "rotation_total", 2.0 * np.pi))
    if abs(rot - 2.0 * np.pi) > 1e-6:
        raise ValueError(
            "kV-switching view interpolation ring-wraps a full 2*pi "
            f"rotation (got rotation_total={rot:.4f}); short scans "
            "would wrap non-adjacent views into each other")
    if phase not in (0, 1):
        raise ValueError(f"phase must be 0 or 1, got {phase}")
    dev = torch.device("cuda" if device is None else device)
    paths = material_path_sinogram(phantom, ct, device=dev)
    raw_a, log_a = get_sino(ct, phantom, spec_a, device=dev, noise=noise,
                            generator=generator, paths=paths)
    raw_b, log_b = get_sino(ct, phantom, spec_b, device=dev, noise=noise,
                            generator=generator, paths=paths)

    mask_a = (_view_parity(ct.N_proj, dev) == phase)[:, None]
    log_a_full = interp_skipped_views(log_a, phase)
    log_b_full = interp_skipped_views(log_b, 1 - phase)

    # decomposition consumes counts; rebuild pseudo-counts from the
    # interpolated logs with each spectrum's own air normalization
    air_a = float(np.sum(sp_ops.effective_fluence(spec_a, ct)))
    air_b = float(np.sum(sp_ops.effective_fluence(spec_b, ct)))
    counts_a = air_a * torch.exp(-log_a_full)
    counts_b = air_b * torch.exp(-log_b_full)
    mat1, mat2 = get_basismat_sinos(ct, counts_a, counts_b, spec_a,
                                    spec_b, n_iters=n_iters)

    zero = torch.zeros((), dtype=raw_a.dtype, device=dev)
    raw_acq = (torch.where(mask_a, raw_a, zero),
               torch.where(mask_a, zero, raw_b))
    logs = (log_a_full, log_b_full)
    if not do_recon:
        return DectResult(raw_acq, logs, (None, None), (None, None),
                          (mat1, mat2), (None, None))
    r1, h1 = get_recon(log_a_full, ct, spec_a, N_matrix, FOV, ramp,
                       window=window)
    r2, h2 = get_recon(log_b_full, ct, spec_b, N_matrix, FOV, ramp,
                       window=window)
    m1r, _ = get_recon(mat1, ct, None, N_matrix, FOV, ramp, window=window)
    m2r, _ = get_recon(mat2, ct, None, N_matrix, FOV, ramp, window=window)
    return DectResult(raw_acq, logs, (r1, r2), (h1, h2), (mat1, mat2),
                      (m1r, m2r))
