"""Anode heel effect: row-dependent source intensity and hardness.

Port of :mod:`dexct_tpu.ops.heel`.  X-rays leave the tungsten target
through the anode bevel; a ray at cone angle ``kappa`` toward the anode
side sees a self-filtration path ``d0 / tan(alpha - kappa)`` (anode angle
``alpha``, production depth ``d0``), so the beam dims and hardens along
the detector rows:

* per-row effective fluence ``[R, E]``: the counts read it through kernel
  K28 (``ops.spectral.counts_from_table`` with stride C, the row of ray
  ``(v, r, c)`` being ``r``);
* per-row air normalization (the air calibration removes the intensity
  profile, not the hardening);
* exact per-row decomposition: each detector row is a fluence group of
  ``ops.matdecomp.gauss_newton_solve_grouped`` (kernel K29).

The heel transmission is host float64, copied from the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..physics.materials import Material
from ..utils.devices import device_of, upload
from . import matdecomp as md_ops
from . import spectral as sp_ops

__all__ = ["TUNGSTEN", "HeelEffect", "heel_fluence",
           "heel_second_moment", "counts_from_paths_heel",
           "cone_sinogram_heel", "decompose_cone_sinograms_heel"]

TUNGSTEN = Material("tungsten", 19.3, "W(100.0)")


@dataclasses.dataclass(frozen=True)
class HeelEffect:
    """Target self-filtration model of the heel effect.

    anode_angle: target bevel angle [rad] (clinical tubes ~7-16 deg).
    d0_cm:       effective x-ray production depth in the target [cm].
    toward_positive_z: True when the anode sits on the +z side, i.e.
                 rows with kappa > 0 harden.
    material:    target material (tungsten).

    The per-row EXCESS path is referenced to the central ray,
    ``d0*(1/tan(alpha - kappa) - 1/tan(alpha))``: a ``kappa = 0`` row sees
    the nominal spectrum, and ``d0_cm = 0`` reproduces the heel-free
    simulation bit for bit.
    """

    anode_angle: float = np.deg2rad(12.0)
    d0_cm: float = 10e-4  # 10 um
    toward_positive_z: bool = True
    material: Material = TUNGSTEN

    def excess_path(self, geometry):
        """Per-row extra target path [cm], shape [N_rows]."""
        kap = np.arctan2(np.asarray(geometry.z_iso, np.float64),
                         float(geometry.SID))
        if not self.toward_positive_z:
            kap = -kap
        a = float(self.anode_angle)
        if np.any(kap >= a - 1e-6):
            raise ValueError(
                "detector rows reach past the anode angle (the beam is "
                f"cut off there): max kappa {np.max(kap):.4f} rad vs "
                f"anode angle {a:.4f} rad")
        return self.d0_cm * (1.0 / np.tan(a - kap) - 1.0 / np.tan(a))

    def transmission(self, geometry, energy_keV):
        """Per-row spectral transmission [R, E] (host, float64)."""
        mu = self.material.linear_atten(np.asarray(energy_keV))  # [E]
        return np.exp(-np.outer(self.excess_path(geometry), mu))


def heel_fluence(spec, geometry, heel):
    """Per-row effective fluence [N_rows, E] (host, float64)."""
    i0 = sp_ops.effective_fluence(spec, geometry)  # [E]
    return i0[None, :] * heel.transmission(geometry, spec.E)


def heel_second_moment(spec, geometry, heel):
    """Per-row second-moment table [N_rows, E] for compound EID noise."""
    base = sp_ops.second_moment_fluence(spec, geometry)
    return heel.transmission(geometry, spec.E) * base[None, :]


def counts_from_paths_heel(paths, mu_table, i0_rows, i2_rows=None, *,
                           dtype=None):
    """Detected counts [V, R, C] for per-row fluence ``i0_rows [R, E]``
    (kernel K28 on the card, one row per detector row; with ``i2_rows``
    the second moment comes from the same pass, ``(counts, var)``).
    Runs on the device of ``paths``, in float32 (``dtype``, the JAX
    signature's, is accepted and ignored)."""
    del dtype
    dev = paths.device
    if paths.ndim != 4:
        raise ValueError(f"paths must be [V, R, C, M], got "
                         f"{tuple(paths.shape)}")

    def tab(x):
        return None if x is None else upload(x, dev, torch.float32)

    t0 = tab(i0_rows)
    if t0.shape[0] != paths.shape[1]:
        raise ValueError(f"i0_rows has {t0.shape[0]} rows, paths "
                         f"{paths.shape[1]}")
    return sp_ops.counts_from_table(
        paths.to(torch.float32), mu_table.to(device=dev), t0, tab(i2_rows),
        stride=paths.shape[2])


def cone_sinogram_heel(phantom, geometry, spectrum, heel, *, device,
                       dtype=None, view_block=None):
    """Polyenergetic cone-beam acquisition with the heel effect: ``(counts,
    log sinogram)`` [V, R, C] on ``device``, with the per-row fluence and
    PER-ROW air normalization.  ``heel=None`` or ``d0_cm=0`` is the
    heel-free :func:`~dexct_tpu_torch.ops.conebeam.cone_sinogram`.
    ``view_block`` (a TPU layout) and ``dtype`` (float32 here) are
    accepted and ignored."""
    from .conebeam import cone_material_paths, cone_sinogram

    del dtype
    if heel is None or heel.d0_cm == 0.0:
        return cone_sinogram(phantom, geometry, spectrum, device=device)
    del view_block
    paths = cone_material_paths(phantom, geometry, device=device)
    mu_t = upload(phantom.materials.mu_table(spectrum.E), device,
                  torch.float32)
    i0_r = heel_fluence(spectrum, geometry, heel)  # [R, E]
    counts = counts_from_paths_heel(paths, mu_t, i0_r)
    air_r = upload(i0_r.sum(-1), device, torch.float32)
    return counts, sp_ops.log_sinogram(counts, air_r[None, :, None])


def decompose_cone_sinograms_heel(geometry, sino1, sino2, spec1, spec2,
                                  heel, *, n_iters=30, mask_thresh=0.95,
                                  basis=md_ops.DEFAULT_BASIS,
                                  dtype=None, pixel_block=65536,
                                  device=None):
    """Heel-aware GN decomposition of a cone-beam DE pair.

    ``sino1/sino2``: raw counts [V, R, C].  Each detector row is a fluence
    group with its own exact table (``gauss_newton_solve_grouped``, kernel
    K29 on the card).  Air rays are masked per row against the known
    per-row air counts.  Returns ``(mat1, mat2)`` [V, R, C] in g/cm^2, on
    the device of ``sino1`` when it is a tensor, else on ``device``
    (default: the card), in float32 (``dtype`` is accepted and ignored).
    """
    del dtype
    ee, i0_base, mus = md_ops.prepare_decomposition(
        geometry, spec1, spec2, basis)
    tr = np.exp(-np.outer(heel.excess_path(geometry),
                          heel.material.linear_atten(ee)))  # [R, E']
    i0_r = i0_base[None] * tr[:, None, :]  # [R, 2, E']

    dev = device_of(sino1, device)
    s1 = upload(sino1, dev, torch.float32)
    s2 = upload(sino2, dev, torch.float32)
    V, R, C = s1.shape
    group = torch.arange(R, device=dev)[None, :, None].expand(V, R, C)
    a = md_ops.gauss_newton_solve_grouped(
        torch.stack([s1.reshape(-1), s2.reshape(-1)]), group.reshape(-1),
        upload(i0_r, dev, torch.float32), upload(mus, dev, torch.float32),
        n_iters=n_iters, pixel_block=pixel_block)

    air1 = heel_fluence(spec1, geometry, heel).sum(-1)  # [R]
    mask = s1 >= mask_thresh * upload(air1, dev,
                                      torch.float32)[None, :, None]
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    mat1 = torch.where(mask, zero, a[:, 0].reshape(V, R, C))
    mat2 = torch.where(mask, zero, a[:, 1].reshape(V, R, C))
    return mat1, mat2
