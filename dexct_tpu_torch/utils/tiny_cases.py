"""Tiny cases that hold the card against the CPU.

Each function builds its inputs afresh from a fixed seed, runs one entry
point of the port on the given device and returns the result on the CPU,
so that a caller runs it once per device and compares the two: the 2-D
iterative reconstructions and the one-step fit on a 48^2 Fourier plan
(n_theta = 96, 64 x 48 rays), one gradient of the one-step objective, and
the 2-D and 3-D dose maps of a 32^2 three-material phantom.  The card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s phase 5 both run
them, with the tolerances below.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ITERATIVE_PATHS", "ITERATIVE_TOL", "GRADIENT_TOL", "DOSE_KINDS",
           "DOSE_TOL", "fourier_plan", "iterative_2d", "onestep_gradient",
           "dose_inputs", "dose"]

ITERATIVE_PATHS = ("cg", "sirt", "pwls", "onestep")
# of the result's largest value: the adjoints' float32 atomics add in no
# fixed order, and the loops carry that rounding on
ITERATIVE_TOL = 1e-3
# of the gradient's largest value: one autograd pass, nothing amplifies it
GRADIENT_TOL = 1e-4
DOSE_KINDS = ("fan", "cone", "helical")
# of the map's largest value, and the deposited energy relative
DOSE_TOL = 1e-4

VIEW_SHAPE = (64, 48)


def fourier_plan(device):
    """The 48^2 water cylinder's Fourier plan at 0.4 cm, n_theta = 96, on
    a 64-view, 48-channel fan."""
    from ..ops.fourier import plan_fourier_projector
    from ..system import FanBeamGeometry, water_cylinder_phantom

    return plan_fourier_projector(water_cylinder_phantom(N=48, dx=0.4),
                                  FanBeamGeometry(N_channels=48, N_proj=64),
                                  n_theta=96, device=device)


def _fourier_inputs():
    """A random log sinogram, its counts at 2e3 per ray, the power
    iteration's start vector and two basis images near 0.5 g/cm^3."""
    rng = np.random.default_rng(32)
    sino = rng.uniform(0.0, 2.0, VIEW_SHAPE).astype(np.float32)
    counts = np.maximum(2e3 * np.exp(-sino), 1.0).astype(np.float32)
    v0 = rng.normal(size=(48, 48)).astype(np.float32)
    x0 = np.clip(rng.normal(0.5, 0.1, (2, 48, 48)), 0.0,
                 None).astype(np.float32)
    return sino, counts, v0, x0


def _spectral_tables():
    """Energy grid, fluences [2, E] of a 140 / 80 kV Kramers pair at 1/64
    of the isocentre fluence per view, and the water / bone attenuation
    [2, E]."""
    from ..ops.matdecomp import prepare_decomposition
    from ..physics import kramers_spectrum
    from ..physics.materials import BONE, WATER
    from ..system import FanBeamGeometry

    ct = FanBeamGeometry(N_channels=48, N_proj=64)
    s1, s2 = kramers_spectrum(140.0), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso / 64)
    s2.rescale_counts(ct.A_iso / 64)
    ee, i0, _ = prepare_decomposition(ct, s1, s2)
    mus = np.stack([WATER.mass_atten(ee), BONE.mass_atten(ee)])
    return ee, i0, mus.astype(np.float32)


def _onestep_counts(x0):
    """The expected counts [2, V, C] of the basis images x0, computed on
    the CPU so that every device fits the same data."""
    from ..ops.onestep import spectral_forward_images

    _, i0, mus = _spectral_tables()
    f32 = dict(dtype=torch.float32)
    return spectral_forward_images(
        fourier_plan("cpu"), torch.as_tensor(x0), torch.as_tensor(mus, **f32),
        torch.as_tensor(i0, **f32), VIEW_SHAPE).numpy()


def iterative_2d(path, device):
    """One of :data:`ITERATIVE_PATHS` on the tiny plan: CG (6 iterations,
    lam 0.05), SIRT (10) and PWLS (10, beta 3e-2) of the random sinogram
    fed one power-iteration start, or 10 one-step iterations from the
    basis images + 0.05 on their own expected counts.  Returns the image
    (or the [2, N, N] basis images) on the CPU."""
    from ..ops import iterative, onestep
    from ..physics.materials import BONE, WATER

    sino, counts, v0, x0 = _fourier_inputs()
    plan = fourier_plan(device)
    if path == "cg":
        x = iterative.cg_recon(plan, sino, VIEW_SHAPE, n_iters=6,
                               lam=0.05)[0]
    elif path == "sirt":
        x = iterative.sirt_recon(plan, sino, VIEW_SHAPE, n_iters=10, _v0=v0)
    elif path == "pwls":
        x = iterative.pwls_recon(plan, sino, counts, VIEW_SHAPE, n_iters=10,
                                 beta=3e-2, _v0=v0)
    elif path == "onestep":
        ee, i0, _ = _spectral_tables()
        x = onestep.onestep_spectral_recon(
            _onestep_counts(x0), ee, i0, (WATER, BONE), plan, VIEW_SHAPE,
            x0=np.clip(x0 + 0.05, 0.0, None), n_iters=10)
    else:
        raise ValueError(f"path must be one of {ITERATIVE_PATHS}, got "
                         f"{path!r}")
    return x.cpu()


def onestep_gradient(device):
    """The gradient [2, N, N] of the one-step objective (its default beta
    and delta) at the basis images + 0.05, on their own expected counts:
    the autograd path through K7, K8, K21 and K22 once.  Returned on the
    CPU."""
    from ..ops import onestep

    _, _, _, x0 = _fourier_inputs()
    _, i0, mus = _spectral_tables()
    plan = fourier_plan(device)
    f32 = dict(dtype=torch.float32, device=device)
    loss = onestep._objective(
        lambda im, m, i: onestep.spectral_forward_images(plan, im, m, i,
                                                         VIEW_SHAPE),
        torch.as_tensor(_onestep_counts(x0), **f32),
        torch.as_tensor(mus, **f32), torch.as_tensor(i0, **f32), 3e-3, 1e-2)
    x = torch.as_tensor(np.clip(x0 + 0.05, 0.0, None),
                        **f32).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    return g.cpu()


def dose_inputs(kind):
    """A 32^2 water disc with a bone rod in air at 0.5 cm, and a 120 kV
    Kramers spectrum at 10x the isocentre fluence over the scan, for one of
    :data:`DOSE_KINDS`: a 64-channel, 48-view fan; an 8-slice cone scan of
    16 views x 4 rows; a 32-slice (0.25 cm) helix of three turns at pitch
    1.6 cm, 48 views x 4 rows, whose dose map runs the z-slab window."""
    from ..physics import kramers_spectrum
    from ..physics.materials import AIR, BONE, WATER, MaterialTable
    from ..system import (ConeBeamGeometry, FanBeamGeometry,
                          HelicalConeBeamGeometry, VoxelPhantom)

    ys = (np.arange(32) + 0.5 - 16) * 0.5
    lab = (np.hypot(ys[None, :], ys[:, None]) <= 6.0).astype(np.uint8)
    lab[np.hypot(ys[None, :] - 2.0, ys[:, None] - 1.0) <= 1.5] = 2
    mats = MaterialTable([AIR, WATER, BONE])
    spec = kramers_spectrum(120.0)
    if kind == "fan":
        ct = FanBeamGeometry(N_channels=64, N_proj=48, h_iso=0.1)
        ph = VoxelPhantom("rods", lab[None], mats, 0.5, 0.5, 0.5)
    elif kind == "cone":
        ct = ConeBeamGeometry(N_channels=32, N_proj=16, N_rows=4, h_iso=0.25)
        ph = VoxelPhantom("rods", np.broadcast_to(lab, (8, 32, 32)).copy(),
                          mats, 0.5, 0.5, 0.5)
    elif kind == "helical":
        ct = HelicalConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4,
                                     h_iso=0.4, rotation_total=6 * np.pi,
                                     pitch=1.6)
        ph = VoxelPhantom("rods", np.broadcast_to(lab, (32, 32, 32)).copy(),
                          mats, 0.5, 0.5, 0.25)
    else:
        raise ValueError(f"kind must be one of {DOSE_KINDS}, got {kind!r}")
    spec.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    return ph, ct, spec


def dose(kind, device):
    """The dose map of :func:`dose_inputs` (``dose_map`` for the fan,
    ``dose_map_3d`` otherwise) on ``device``; a
    :class:`~dexct_tpu_torch.ops.dose.DoseResult` of host arrays."""
    from ..ops import dose as dose_ops

    ph, ct, spec = dose_inputs(kind)
    fn = dose_ops.dose_map if kind == "fan" else dose_ops.dose_map_3d
    return fn(ph, ct, spec, device=device)
