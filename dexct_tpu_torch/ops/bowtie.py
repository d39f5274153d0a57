"""Bowtie (beam-shaping) filtration: channel-dependent source spectra.

Port of :mod:`dexct_tpu.ops.bowtie`.  A shaped compensator between tube
and patient attenuates and hardens the beam toward the fan periphery, so
the detected flux, the spectrum's shape and the air normalization become
per channel.  The profile is stepped (thickness quantized to ``n_steps``
levels), so channels of one level share an exact fluence table:

* the forward model reads a per-channel ``[C, E]`` table
  (``ops.spectral.counts_from_paths(..., per_channel=True)``, kernel K28);
* the decomposition solves each thickness group with its own exact
  ``i0`` table (``ops.matdecomp.gauss_newton_solve_grouped``, kernel
  K29), with no spectral-model mismatch.

The design and the tables are host float64 NumPy, copied from the JAX
package.  The decomposition runs on the device of its sinograms when they
are tensors, else on ``device`` (default: the card).

Usage::

    bt = design_flattening_bowtie(ct, water_radius_cm=15.0)
    raw, log = get_sino(ct, phantom, spec, device=dev, bowtie=bt)
    mat1, mat2 = decompose_sinograms_bowtie(ct, raw1, raw2, s1, s2, bt)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..physics import xcom
from ..physics.materials import Material
from ..utils.devices import device_of, upload
from . import matdecomp as md_ops
from . import spectral as sp_ops

__all__ = [
    "Bowtie",
    "ALUMINUM",
    "PTFE",
    "design_flattening_bowtie",
    "bowtie_fluence",
    "bowtie_second_moment",
    "decompose_sinograms_bowtie",
]

ALUMINUM = Material("aluminum", 2.699, "Al(100.0)")
PTFE = Material("PTFE", 2.2, "C(24.0)F(76.0)")


@dataclasses.dataclass(frozen=True)
class Bowtie:
    """A stepped bowtie: per-channel filter thickness of one material.

    ``t_ch`` [cm] must contain few distinct values (its unique levels
    define the decomposition groups); build via
    :func:`design_flattening_bowtie` or quantize your own profile.
    """

    material: Material
    t_ch: np.ndarray  # [C] thickness per channel [cm]
    name: str = "bowtie"

    def __post_init__(self):
        object.__setattr__(
            self, "t_ch", np.asarray(self.t_ch, np.float64))
        if self.t_ch.ndim != 1:
            raise ValueError("t_ch must be 1-D [N_channels]")
        if np.any(self.t_ch < 0):
            raise ValueError("bowtie thickness must be >= 0")

    def transmission(self, energy_keV):
        """Per-channel spectral transmission [C, E] (host, float64)."""
        mu = self.material.linear_atten(np.asarray(energy_keV))  # [E]
        return np.exp(-np.outer(self.t_ch, mu))

    def groups(self):
        """(t_levels [G], group_of_channel [C]) for the grouped solve."""
        levels, idx = np.unique(self.t_ch, return_inverse=True)
        return levels, idx


def design_flattening_bowtie(ct, water_radius_cm, material=ALUMINUM,
                             e_ref=60.0, n_steps=32, t_max_cm=None,
                             name=None):
    """Design a flux-flattening bowtie for a centered water cylinder.

    The water-equivalent path through a radius-``R`` cylinder at fan
    angle gamma is ``2 sqrt(R^2 - s^2)`` with ``s = SID sin(gamma)``; the
    bowtie supplies the deficit ``path(0) - path(gamma)`` converted to
    filter material at the reference energy ``e_ref`` [keV]:

        t(gamma) = (path(0) - path(gamma)) * mu_water(e_ref) / mu_mat(e_ref)

    quantized to ``n_steps`` thickness levels over [0, max] (exact zero
    kept, so the central channels stay unfiltered) and optionally clipped
    at ``t_max_cm``.
    """
    gam = ct.gammas  # [C]
    s = ct.SID * np.sin(gam)
    r = float(water_radius_cm)
    path = 2.0 * np.sqrt(np.clip(r * r - s * s, 0.0, None))
    weq = path.max() - path  # missing water-equivalent thickness [cm]
    e = np.atleast_1d(np.float64(e_ref))
    mu_w = float(xcom.mixatten("H(11.2)O(88.8)", e)[0])  # rho = 1
    mu_m = float(material.linear_atten(e)[0])
    t = weq * mu_w / mu_m
    if t_max_cm is not None:
        t = np.minimum(t, float(t_max_cm))
    if n_steps:
        if int(n_steps) < 2:
            raise ValueError("n_steps must be >= 2 (or 0/None to skip "
                             "quantization)")
        hi = t.max()
        if hi > 0:
            q = hi / (int(n_steps) - 1)
            t = np.round(t / q) * q
    return Bowtie(material, t, name or f"{material.name} flattening bowtie")


def bowtie_fluence(spec, geometry, bowtie):
    """Per-channel effective fluence i0 [C, E] (host, float64):
    ``effective_fluence`` times the bowtie's spectral transmission."""
    base = sp_ops.effective_fluence(spec, geometry)  # [E]
    return bowtie.transmission(spec.E) * base[None, :]


def bowtie_second_moment(spec, geometry, bowtie):
    """Per-channel second-moment table [C, E] for compound EID noise."""
    base = sp_ops.second_moment_fluence(spec, geometry)
    return bowtie.transmission(spec.E) * base[None, :]


def decompose_sinograms_bowtie(geometry, sino1, sino2, spec1, spec2,
                               bowtie, *, n_iters=30, mask_thresh=0.95,
                               basis=md_ops.DEFAULT_BASIS, dtype=None,
                               pixel_block=65536, device=None):
    """Bowtie-aware GN decomposition: exact per-thickness-group tables.

    Each channel's rays are solved with its thickness level's ``i0``
    (``ops.matdecomp.gauss_newton_solve_grouped``: kernel K29 on the
    card), so the solver's forward model matches the bowtie-filtered
    acquisition exactly.  Returns (mat1, mat2) [N_proj, N_channels] in
    g/cm^2 with air rays masked per channel (``s1 >= mask_thresh *
    air1[c]``: the bowtie makes raw air counts channel-dependent).  The
    port solves in float32 (``dtype``, the JAX signature's, is accepted and
    ignored).
    """
    del dtype
    # union-grid tables WITHOUT the bowtie (pruning on the unfiltered
    # center channel keeps a superset of every group's detectable bins)
    ee, i0_base, mus = md_ops.prepare_decomposition(
        geometry, spec1, spec2, basis)
    levels, gidx = bowtie.groups()
    mu_bt = bowtie.material.linear_atten(ee)  # [E']
    t_g = np.exp(-np.outer(levels, mu_bt))  # [G, E']
    i0_g = i0_base[None] * t_g[:, None, :]  # [G, 2, E']

    dev = device_of(sino1, device)
    s1 = upload(sino1, dev, torch.float32)
    s2 = upload(sino2, dev, torch.float32)
    V, C = s1.shape
    group = upload(gidx, dev, torch.int64).expand(V, C).reshape(-1)
    a = md_ops.gauss_newton_solve_grouped(
        torch.stack([s1.reshape(-1), s2.reshape(-1)]), group,
        upload(i0_g, dev, torch.float32), upload(mus, dev, torch.float32),
        n_iters=n_iters, pixel_block=pixel_block)

    air1 = upload(bowtie_fluence(spec1, geometry, bowtie).sum(-1), dev,
                  torch.float32)  # [C]
    mask = s1 >= mask_thresh * air1[None, :]
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    mat1 = torch.where(mask, zero, a[:, 0].reshape(V, C))
    mat2 = torch.where(mask, zero, a[:, 1].reshape(V, C))
    return mat1, mat2
