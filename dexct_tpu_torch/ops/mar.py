"""Metal artifact reduction: sinogram inpainting (LI-MAR and NMAR).

Port of :mod:`dexct_tpu.ops.mar`.  Metal-crossing rays are treated as
missing and bridged per view: LI-MAR (Kalender 1987) linearly between the
nearest clean channels, NMAR (Meyer 2010) on the sinogram normalized by
the forward projection of a class prior.  The nearest-clean-channel search
is two running maxima (``torch.cummax``), the bridge one gather and lerp
per ray; the metal trace and the prior sinogram run the port's Fourier
projector (K7, K8) and the reconstructions its FBP (K4).  Everything runs
on the device of the sinogram when it is a tensor, else on ``device``
(default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import as_float, device_of

__all__ = ["segment_metal", "metal_trace", "interpolate_sinogram",
           "li_mar_sinogram", "nmar_sinogram", "mar_recon"]


def segment_metal(recon_HU, threshold_HU=2500.0, *, device=None):
    """Binary metal mask from an uncorrected HU reconstruction (implant
    alloys sit far above 3000 HU; 2500 HU separates them from bone)."""
    hu = as_float(recon_HU, device_of(recon_HU, device))
    return hu >= threshold_HU


def _image_projector_plan(n, dx, geometry, n_theta, device):
    """Fourier-slice plan for projecting arbitrary n x n images."""
    from ..physics.materials import AIR, WATER, MaterialTable
    from ..system.phantom import VoxelPhantom
    from .fourier import plan_fourier_projector

    dummy = VoxelPhantom("mar", np.zeros((n, n), np.uint8),
                         MaterialTable([AIR, WATER]), dx, dx, dx)
    return plan_fourier_projector(dummy, geometry, n_theta=n_theta,
                                  device=device)


def metal_trace(metal_mask, geometry, view_shape, *, dx, n_theta=768,
                path_eps=0.05, plan=None, device=None):
    """Sinogram-domain metal shadow [V, C] (bool): the Fourier-slice
    projection of the mask above ``path_eps`` cm of metal path.  Pass
    ``plan`` to reuse a projector plan."""
    from .fourier import fourier_project_images

    dev = device_of(metal_mask, device)
    mask = torch.as_tensor(metal_mask, device=dev).to(torch.float32)
    if plan is None:
        plan = _image_projector_plan(mask.shape[-1], dx, geometry, n_theta,
                                     dev)
    t = fourier_project_images(plan, mask[None], view_shape)[..., 0]
    return t > path_eps


def interpolate_sinogram(sino, trace, *, device=None):
    """Bridge masked channels of each view by linear interpolation between
    the nearest unmasked channels; rays masked to a detector edge take the
    nearest clean value, and a fully masked view is returned unchanged."""
    dev = device_of(sino, device)
    s = as_float(sino, dev)
    m = torch.as_tensor(trace, device=dev).to(torch.bool)
    m = m.expand(s.shape)
    c = s.shape[-1]
    idx = torch.arange(c, device=dev)
    clean = ~m
    neg = torch.full_like(idx, -1)
    # nearest clean channel at or left of each position
    left = torch.cummax(torch.where(clean, idx, neg), dim=-1).values
    # nearest clean at or right: the same on the mirrored rows
    right_rev = torch.cummax(torch.where(clean.flip(-1), idx, neg),
                             dim=-1).values.flip(-1)
    right = torch.where(right_rev >= 0, c - 1 - right_rev,
                        torch.full_like(right_rev, c))
    has_l = left >= 0
    has_r = right <= c - 1
    li = torch.clamp(left, 0, c - 1)
    ri = torch.clamp(right, 0, c - 1)
    vl = torch.take_along_dim(s, li, -1)
    vr = torch.take_along_dim(s, ri, -1)
    span = torch.clamp_min(ri - li, 1)
    w = ((idx - li) / span).to(s.dtype)
    bridged = vl * (1.0 - w) + vr * w
    bridged = torch.where(has_l & has_r, bridged,
                          torch.where(has_l, vl, torch.where(has_r, vr, s)))
    return torch.where(m, bridged, s)


def li_mar_sinogram(sino_log, trace, *, device=None):
    """LI-MAR: linear bridge of the metal shadow in the log sinogram."""
    return interpolate_sinogram(sino_log, trace, device=device)


def nmar_sinogram(sino_log, trace, prior_sino, *, floor=1e-3, device=None):
    """NMAR: interpolate ``sino / prior`` and re-multiply; ``prior_sino``
    is the forward projection of a smooth prior image on the same [V, C]
    grid."""
    dev = device_of(sino_log, device)
    p = torch.clamp_min(as_float(prior_sino, dev), floor)
    norm = as_float(sino_log, dev) / p
    return interpolate_sinogram(norm, trace) * p


def _prior_image(recon_HU, metal_mask, *, air_HU=-500.0, bone_HU=300.0,
                 mu_water):
    """NMAR class prior [1/cm]: air -> 0, soft tissue -> water, bone kept
    (its own values), metal -> water."""
    hu = recon_HU
    mu = mu_water * (1.0 + hu / 1000.0)
    water = mu_water * torch.ones_like(mu)
    prior = torch.where(hu < air_HU, torch.zeros_like(mu),
                        torch.where(hu < bone_HU, water, mu))
    return torch.where(metal_mask, water, prior)


def mar_recon(sino_log, geometry, spec, n_matrix, fov, ramp, *,
              method="nmar", threshold_HU=2500.0, window="sinc",
              reinsert_metal=True, n_theta=768, path_eps=0.05,
              device=None):
    """Full MAR pipeline: ``(recon_raw, recon_HU, diag)``.

    Uncorrected FBP -> metal segmentation -> metal trace -> inpainting of
    the log sinogram (``method`` 'li' or 'nmar') -> FBP of the completed
    sinogram, optionally with the metal pixels reinserted.  ``diag`` holds
    the metal mask, trace and inpainted sinogram.  With no metal the input
    reconstruction is returned unchanged.
    """
    from ..pipeline.api import effective_water_mu, get_recon
    from .fourier import fourier_project_images

    dev = device_of(sino_log, device)
    sino_log = as_float(sino_log, dev)
    recon0, hu0 = get_recon(sino_log, geometry, spec, n_matrix, fov,
                            ramp, window=window)
    mask = segment_metal(hu0, threshold_HU)
    if not bool(torch.any(mask)):
        return recon0, hu0, {"metal_mask": mask, "trace": None,
                             "sino_inpainted": sino_log}
    dx = fov / n_matrix
    plan = _image_projector_plan(n_matrix, dx, geometry, n_theta, dev)
    trace = metal_trace(mask, geometry, sino_log.shape, dx=dx,
                        n_theta=n_theta, path_eps=path_eps, plan=plan)
    if method == "li":
        sino_in = li_mar_sinogram(sino_log, trace)
    elif method == "nmar":
        mu_w = effective_water_mu(spec, geometry)
        prior = _prior_image(hu0, mask, mu_water=mu_w)
        prior_sino = fourier_project_images(
            plan, prior[None], sino_log.shape)[..., 0]
        prior_sino = torch.clamp_min(prior_sino, 0.0)
        sino_in = nmar_sinogram(sino_log, trace, prior_sino)
    else:
        raise ValueError(f"unknown MAR method {method!r}")
    recon1, hu1 = get_recon(sino_in, geometry, spec, n_matrix, fov,
                            ramp, window=window)
    if reinsert_metal:
        recon1 = torch.where(mask, recon0, recon1)
        hu1 = torch.where(mask, hu0, hu1)
    return recon1, hu1, {"metal_mask": mask, "trace": trace,
                         "sino_inpainted": sino_in}
