"""Dual-source dual-energy acquisition.

Port of :mod:`dexct_tpu.pipeline.dualsource`.  The fourth clinically
deployed DE geometry (beside dual-scan, the reference's mode, dual-layer
and fast kV-switching): TWO tube/detector pairs mounted on one gantry ~90
deg apart, acquiring both spectra SIMULTANEOUSLY, full DE data in a single
rotation.  Its characteristic physics:

* **Angular offset**: tube B leads tube A by ``offset_views`` view
  spacings; after the full rotation each spectrum has a complete view
  set and aligning B onto A's angular grid is an exact ring roll.
* **Cross-scatter**: photons from tube A scattered in the patient land on
  detector B and vice versa.  Modeled with the kernel-superposition
  machinery of :mod:`dexct_tpu_torch.ops.scatter`: the cross term seeds
  from the OTHER tube's same-time interaction profile, spread by a wide
  detector kernel, scaled by ``cross_spr``; the correction is the coupled
  fixed point of the same model.

One shared trace for both tubes (K1), counts (K2), decomposition (K3) and
FBP (K4); the alignment is a roll and the cross-scatter a channel
convolution (cuDNN ``conv1d`` with TF32 off, ``ops.scatter._conv_axis``):
no kernel of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import spectral as sp_ops
from ..ops.scatter import _conv_channels, scatter_kernel
from ..ops.siddon import material_path_sinogram
from ..utils.devices import _scalar
from .api import DectResult, get_basismat_sinos, get_recon, get_sino

__all__ = ["align_tube_b", "add_cross_scatter", "correct_cross_scatter",
           "simulate_dualsource_dect"]


def align_tube_b(sino_b_time, offset_views):
    """Map tube B's time-indexed sinogram onto tube A's angular grid.

    At time index v tube B points at ``beta_v + offset``; the sample it
    records there belongs at angular index ``v + offset_views`` of the
    common grid: a ring roll over the full rotation.
    """
    return torch.roll(sino_b_time, int(offset_views), dims=0)


def add_cross_scatter(counts_a, counts_b, air_a, air_b, kernel, *,
                      cross_spr=0.1):
    """Measured counts of both detectors with cross-scatter added.

    ``counts_a`` / ``counts_b``: same-TIME-index primary counts [V, C]
    of the two tubes; the cross term on detector A seeds from tube B's
    simultaneous interaction profile ``counts_b * (1 - T_b)`` (photons
    removed from B's beam), spread by ``kernel`` and scaled by
    ``cross_spr``, and symmetrically.  A scalar air count divides as a
    0-d tensor of the counts' dtype on their device (:func:`_scalar`).
    """
    t_a = counts_a / _scalar(air_a, counts_a)
    t_b = counts_b / _scalar(air_b, counts_b)
    s_on_a = cross_spr * _conv_channels(counts_b * (1.0 - t_b), kernel)
    s_on_b = cross_spr * _conv_channels(counts_a * (1.0 - t_a), kernel)
    return counts_a + s_on_a, counts_b + s_on_b


def correct_cross_scatter(meas_a, meas_b, air_a, air_b, kernel, *,
                          cross_spr=0.1, n_iters=3):
    """Coupled fixed-point removal of the cross-scatter background:
    re-estimate each detector's cross term from the OTHER's current
    primary estimate and subtract, alternating ``n_iters`` times (as
    :func:`~dexct_tpu_torch.ops.scatter.correct_scatter`).  The air counts
    and the floors enter as 0-d tensors filled on the data's device
    (:func:`_scalar`)."""
    floor_a = _scalar(1e-6 * air_a, meas_a)
    floor_b = _scalar(1e-6 * air_b, meas_b)
    air_a, air_b = _scalar(air_a, meas_a), _scalar(air_b, meas_b)
    p_a, p_b = meas_a, meas_b
    for _ in range(n_iters):
        t_b = torch.clamp(p_b / air_b, 0.0, 1.0)
        t_a = torch.clamp(p_a / air_a, 0.0, 1.0)
        s_on_a = cross_spr * _conv_channels(p_b * (1.0 - t_b), kernel)
        s_on_b = cross_spr * _conv_channels(p_a * (1.0 - t_a), kernel)
        p_a = torch.maximum(meas_a - s_on_a, floor_a)
        p_b = torch.maximum(meas_b - s_on_b, floor_b)
    return p_a, p_b


def simulate_dualsource_dect(ct, phantom, spec_a, spec_b, N_matrix, FOV,
                             ramp, *, offset_views=None, cross_spr=0.0,
                             kernel_sigma_ch=80.0, correct=True,
                             n_iters=50, noise="none", generator=None,
                             window="sinc", do_recon=True, motion=None,
                             device=None):
    """One-rotation dual-source DECT on ``device`` (default: the card).

    Tube A (``spec_a``) fires at ``betas[v]``, tube B (``spec_b``) at
    ``betas[v] + offset_views * dbeta`` (default: a quarter rotation),
    both over one full rotation.  With ``cross_spr > 0`` the two
    time-synchronous count streams exchange kernel-superposition
    cross-scatter; ``correct`` runs the coupled fixed-point removal before
    decomposition.  Both tubes share one detector geometry.

    ``motion`` (a :class:`~dexct_tpu_torch.ops.motion.MotionProfile`
    indexed by TIME) makes both tubes see the same instantaneous pose: the
    two spectra of a ray are measured a quarter-turn apart instead of a
    full rotation.  Noise draws come from ``generator`` (tube A first).

    Returns the standard :class:`~dexct_tpu_torch.pipeline.api.DectResult`
    on tube A's angular grid.
    """
    V = ct.N_proj
    if offset_views is None:
        offset_views = V // 4
    offset_views = int(offset_views)
    rot = float(getattr(ct, "rotation_total", 2.0 * np.pi))
    if abs(rot - 2.0 * np.pi) > 1e-6:
        raise ValueError(
            "dual-source alignment ring-rolls a full 2*pi rotation "
            f"(got rotation_total={rot:.4f})")
    dev = torch.device("cuda" if device is None else device)
    # tube A: angular == time grid.  tube B: time index v measures the
    # ray set of angular index (v + offset), one roll of the shared
    # full-grid forward model
    if motion is None:
        paths = material_path_sinogram(phantom, ct, device=dev)
        paths_b_ang = paths
    else:
        from ..ops.motion import (MotionProfile,
                                  material_path_sinogram_motion)

        if motion.n_views != V:
            raise ValueError(
                f"motion has {motion.n_views} views, geometry {V}")
        paths = material_path_sinogram_motion(phantom, ct, motion,
                                              device=dev)
        # tube B's sample at ANGULAR index w is taken at time w - offset:
        # its pose track on the angular grid is the time track rolled
        motion_b = MotionProfile(np.roll(motion.phi, offset_views),
                                 np.roll(motion.disp, offset_views,
                                         axis=0))
        paths_b_ang = material_path_sinogram_motion(phantom, ct, motion_b,
                                                    device=dev)
    raw_a, _ = get_sino(ct, phantom, spec_a, device=dev, paths=paths)
    raw_b_ang, _ = get_sino(ct, phantom, spec_b, device=dev,
                            paths=paths_b_ang)
    raw_b_time = torch.roll(raw_b_ang, -offset_views, dims=0)

    air_a = float(np.sum(sp_ops.effective_fluence(spec_a, ct)))
    air_b = float(np.sum(sp_ops.effective_fluence(spec_b, ct)))

    meas_a, meas_b_time = raw_a, raw_b_time
    kern = None
    if cross_spr > 0.0:
        # on the device once: each spread would copy a host kernel again
        kern = torch.as_tensor(scatter_kernel(ct.N_channels,
                                              sigma_ch=kernel_sigma_ch),
                               device=dev)
        meas_a, meas_b_time = add_cross_scatter(
            raw_a, raw_b_time, air_a, air_b, kern, cross_spr=cross_spr)
    if noise != "none":
        if generator is None:
            raise ValueError("noise sampling requires a torch.Generator")
        meas_a = sp_ops.sample_noise(generator, meas_a, noise)
        meas_b_time = sp_ops.sample_noise(generator, meas_b_time, noise)

    prim_a, prim_b_time = meas_a, meas_b_time
    if cross_spr > 0.0 and correct:
        prim_a, prim_b_time = correct_cross_scatter(
            meas_a, meas_b_time, air_a, air_b, kern, cross_spr=cross_spr)
    prim_b = align_tube_b(prim_b_time, offset_views)

    log_a = sp_ops.log_sinogram(prim_a, air_a)
    log_b = sp_ops.log_sinogram(prim_b, air_b)
    mat1, mat2 = get_basismat_sinos(ct, prim_a, prim_b, spec_a, spec_b,
                                    n_iters=n_iters)
    raws = (meas_a, align_tube_b(meas_b_time, offset_views))
    if not do_recon:
        return DectResult(raws, (log_a, log_b), (None, None),
                          (None, None), (mat1, mat2), (None, None))
    r1, h1 = get_recon(log_a, ct, spec_a, N_matrix, FOV, ramp,
                       window=window)
    r2, h2 = get_recon(log_b, ct, spec_b, N_matrix, FOV, ramp,
                       window=window)
    m1r, _ = get_recon(mat1, ct, None, N_matrix, FOV, ramp, window=window)
    m2r, _ = get_recon(mat2, ct, None, N_matrix, FOV, ramp, window=window)
    return DectResult(raws, (log_a, log_b), (r1, r2), (h1, h2),
                      (mat1, mat2), (m1r, m2r))
