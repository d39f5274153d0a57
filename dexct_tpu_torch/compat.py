"""Drop-in compatibility surface for gjadick/dex-ct-sim users.

Port of :mod:`dexct_tpu.compat`.  The reference pipeline imports symbols
from ``xtomosim.system``, ``xtomosim.forward_project``,
``xtomosim.back_project``, ``xcompy`` and ``matdecomp``; this module
re-exports the port's equivalents under those names, so porting a
reference script is an import swap:

    from dexct_tpu_torch.compat import (
        read_parameter_file, xRaySpectrum, FanBeamGeometry, VoxelPhantom,
        get_sino, get_recon, get_basismat_sinos, mixatten,
        mat1, mat2, matcomp1, matcomp2, density1, density2,
    )

``get_sino`` takes the port's ``device=`` keyword (the card, or ``"cpu"``);
the other entry points run on the device of their array inputs.  Shapes,
units and file formats match the reference contract (SURVEY.md §2.3,
§2.6).
"""

from __future__ import annotations

import numpy as np
import torch

from .physics.materials import BONE, TISSUE
from .physics.spectrum import xRaySpectrum
from .physics.xcom import mixatten
from .pipeline.api import get_basismat_sinos, get_recon, get_sino, load_spectrum
from .system.config import read_parameter_file
from .system.geometry import FanBeamGeometry, ScannerGeometry
from .system.phantom import VoxelPhantom
from .utils.devices import as_float, device_of

# hardcoded basis materials of the reference (matdecomp.py:12-17)
mat1 = TISSUE.name
matcomp1 = TISSUE.matcomp
density1 = TISSUE.density
mat2 = BONE.name
matcomp2 = BONE.matcomp
density2 = BONE.density


def do_matdecomp_gn(ct, sino1, sino2, spec1, spec2, n_iters, *,
                    device=None):
    """Reference-shaped solver entry (matdecomp.py:130-164).

    Returns Sino_aa [N_proj, N_channels, 2] density line integrals
    [g/cm^2] as a NumPy array, the reference's pre-mask layout
    (matdecomp.py:42): air rays are included, where the tissue/bone basis
    is ill-conditioned.  The solve is :func:`gauss_newton_solve` (kernel K3
    on the card) on the device of ``sino1`` when it is a tensor, else on
    ``device`` (default: the card)."""
    from .ops.matdecomp import gauss_newton_solve, prepare_decomposition

    dev = device_of(sino1, device)
    _, i0, mus = prepare_decomposition(ct, spec1, spec2)
    s1 = as_float(sino1, dev).to(torch.float32)
    s2 = as_float(sino2, dev).to(torch.float32)
    a = gauss_newton_solve(
        torch.stack([s1.reshape(-1), s2.reshape(-1)]),
        torch.as_tensor(i0, dtype=torch.float32, device=dev),
        torch.as_tensor(mus, dtype=torch.float32, device=dev),
        n_iters=n_iters)
    return a.cpu().numpy().reshape(tuple(s1.shape) + (2,))


def optimize_sino_cpu(Sino_gg, ee, i0, mus, n_iters, verbose=False):
    """Reference-shaped float64 CPU solver (matdecomp.py:87-127 surface).

    Sino_gg: [n_meas, nViews, nBins] counts; returns [nViews, nBins,
    nMats].  Backed by the vectorized float64 NumPy solve
    :func:`_gauss_newton_numpy`."""
    g = np.asarray(Sino_gg, np.float64)
    m, v, c = g.shape
    i0 = np.asarray(i0, np.float64)
    if i0.ndim == 3:  # reference channel-tiled layout [nMeas, nBins, nE]
        i0 = i0[:, 0, :]
    a = _gauss_newton_numpy(g.reshape(m, -1), i0, np.asarray(mus), n_iters)
    return a.reshape(v, c, -1)


def _gauss_newton_numpy(counts, i0, mus, n_iters, eps_init=1e-6,
                        step_max=5.0, a_bounds=(-20.0, 500.0),
                        method="gn"):
    """Float64 vectorized Gauss-Newton basis decomposition (a copy of the
    JAX package's NumPy oracle ``gauss_newton_decompose_numpy``): the
    reference solver's Poisson-MLE Newton iteration with a closed-form 2x2
    solve.

    counts: [n_meas, P]; i0: [n_meas, E]; mus: [n_mats, E] (n_mats = 2).
    Returns a: [P, n_mats] area densities [g/cm^2]."""
    counts = np.asarray(counts, np.float64)
    i0 = np.asarray(i0, np.float64)
    mus = np.asarray(mus, np.float64)
    n_meas, P = counts.shape
    n_mats = mus.shape[0]
    assert n_mats == 2, "closed-form solve is 2-material"

    a = np.full((P, n_mats), eps_init)
    for _ in range(n_iters):
        L = a @ mus  # [P, E]
        atten = np.exp(np.clip(-L, -700.0, 20.0))
        nu = atten @ i0.T  # [P, n_meas]
        # d nu_m / d a_i = -sum_E i0_m mus_i atten
        grad = -np.einsum("pe,me,ie->pmi", atten, i0, mus)
        hess = np.einsum("pe,me,ie,je->pmij", atten, i0, mus, mus)
        r = counts.T / nu - 1.0  # [P, m]
        yv2 = counts.T / nu**2
        dF = -np.einsum("pm,pmi->pi", r, grad)
        if method == "newton":
            H = -(np.einsum("pm,pmij->pij", r, hess)
                  - np.einsum("pm,pmi,pmj->pij", yv2, grad, grad))
        else:  # Gauss-Newton / Fisher scoring (PSD)
            H = np.einsum("pm,pmi,pmj->pij", yv2, grad, grad)
        det = H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 1, 0]
        det = np.where(np.abs(det) < 1e-300, 1e-300, det)
        dx0 = (H[:, 1, 1] * dF[:, 0] - H[:, 0, 1] * dF[:, 1]) / det
        dx1 = (H[:, 0, 0] * dF[:, 1] - H[:, 1, 0] * dF[:, 0]) / det
        step = np.stack([dx0, dx1], -1)
        norm = np.linalg.norm(step, axis=-1, keepdims=True)
        step = step * np.minimum(1.0, step_max / np.maximum(norm, 1e-30))
        a = np.clip(a - step, a_bounds[0], a_bounds[1])
    return a


__all__ = [
    "read_parameter_file",
    "xRaySpectrum",
    "FanBeamGeometry",
    "ScannerGeometry",
    "VoxelPhantom",
    "get_sino",
    "get_recon",
    "get_basismat_sinos",
    "do_matdecomp_gn",
    "optimize_sino_cpu",
    "load_spectrum",
    "mixatten",
    "mat1",
    "matcomp1",
    "density1",
    "mat2",
    "matcomp2",
    "density2",
]
