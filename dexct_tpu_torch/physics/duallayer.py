"""Dual-layer (sandwich) detector dual-energy acquisition.

The reference studies dual-SCAN DE (two tube spectra, two rotations: the
reference main.py:101-176).  Real scanners also implement DE with
ONE tube spectrum and a stacked detector: a thin low-Z front layer
absorbs preferentially low energies, a thick back layer (behind an
optional metal interlayer filter) absorbs the transmitted beam.  The
two layer signals are two spectrally distinct measurements of the SAME
ray at the SAME instant — no spectrum switching, no registration error.

Port of :mod:`dexct_tpu.physics.duallayer`.  Each photon is absorbed in
exactly one layer, so the two layer counts are disjoint Poisson thinnings
of the tube stream; folding the layer absorption a_k(E) into a *virtual
spectrum* ``I0_k(E) = I0(E) * a_k(E)`` makes dual-layer DE exactly the
existing two-spectrum machinery (ops/spectral.py, ops/matdecomp.py,
pipeline/api.py) with a single shared trace and independent
per-measurement noise: no kernel of its own (K1-K4 through
``simulate_dect``).
Keep the geometry's own detector response for shared effects only
(usually ideal absorption + ``eid=True`` energy weighting); the layer
model supplies the absorption split.

Default stack approximates a clinical dual-layer design: 1 mm ZnSe
front, 2 mm Gd2O2S back.  (Zn/Se/Gd attenuation comes from the xcom
log-Z interpolation — detector-grade accuracy, not basis-material
grade; the decomposition's accuracy is set by the BASIS tables, which
are vendored.)
"""

from __future__ import annotations

import numpy as np

from . import xcom
from .spectrum import Spectrum

__all__ = ["layer_absorptions", "dual_layer_spectra",
           "simulate_dual_layer_dect"]

# Gd2O2S by weight: 2*157.25 Gd, 2*16.00 O, 32.07 S of 378.57 g/mol
_GOS = "Gd(83.08)O(8.45)S(8.47)"
_ZNSE = "Zn(45.29)Se(54.71)"


def layer_absorptions(E, *, front_matcomp=_ZNSE, front_density=5.27,
                      front_thickness_cm=0.1, back_matcomp=_GOS,
                      back_density=7.32, back_thickness_cm=0.2,
                      inter_matcomp=None, inter_density=1.0,
                      inter_thickness_cm=0.0):
    """(a_front(E), a_back(E)): absorbed fractions of the two layers.

    a_front = 1 - exp(-mu_f t_f); the back layer sees the front layer's
    (and optional interlayer filter's) transmission:
    a_back = T_front * T_inter * (1 - exp(-mu_b t_b)).
    """
    E = np.asarray(E, dtype=np.float64)
    mu_f = xcom.mixatten(front_matcomp, E) * front_density
    a_front = 1.0 - np.exp(-mu_f * front_thickness_cm)
    trans = np.exp(-mu_f * front_thickness_cm)
    if inter_matcomp is not None and inter_thickness_cm > 0.0:
        mu_i = xcom.mixatten(inter_matcomp, E) * inter_density
        trans = trans * np.exp(-mu_i * inter_thickness_cm)
    mu_b = xcom.mixatten(back_matcomp, E) * back_density
    a_back = trans * (1.0 - np.exp(-mu_b * back_thickness_cm))
    return a_front, a_back


def dual_layer_spectra(spec, **layer_kw):
    """Fold the layer absorptions into two virtual spectra.

    ``spec`` should already be rescaled to the acquisition dose (the
    layers then split those counts).  Returns ``(spec_front,
    spec_back)`` — feed them anywhere the framework takes a DE spectrum
    pair (``pack_dect``, ``simulate_dect``, sweeps, sharded packs); the
    fused pipeline's shared trace + independent per-measurement noise
    are exactly the dual-layer physics (Poisson thinning into disjoint
    layers).
    """
    a_front, a_back = layer_absorptions(spec.E, **layer_kw)
    return (Spectrum(spec.E.copy(), spec.I0 * a_front,
                     f"{spec.name}_frontlayer"),
            Spectrum(spec.E.copy(), spec.I0 * a_back,
                     f"{spec.name}_backlayer"))


def simulate_dual_layer_dect(ct, phantom, spec, N_matrix, FOV, ramp, *,
                             n_iters=50, noise="none", generator=None,
                             window="sinc", do_recon=True, device=None,
                             **layer_kw):
    """One-scan dual-layer DECT: the reference main-loop product
    (sinograms, recons, basis images) from a single acquisition, on
    ``device`` (default: the card).

    Thin wrapper: splits ``spec`` with :func:`dual_layer_spectra` and
    runs :func:`~dexct_tpu_torch.pipeline.api.simulate_dect` (single
    shared trace; independent layer noise drawn from ``generator``, a
    ``torch.Generator``).
    """
    import torch

    from ..pipeline.api import simulate_dect

    s_front, s_back = dual_layer_spectra(spec, **layer_kw)
    return simulate_dect(ct, phantom, s_front, s_back, N_matrix, FOV,
                         ramp, device=torch.device(
                             "cuda" if device is None else device),
                         n_iters=n_iters, noise=noise, generator=generator,
                         window=window, do_recon=do_recon)
