"""Tiny cases that hold the card against the CPU.

Each function builds its inputs afresh from a fixed seed, runs one entry
point of the port on the given device and returns the result on the CPU,
so that a caller runs it once per device and compares the two: the 2-D
iterative reconstructions and the one-step fit on a 48^2 Fourier plan
(n_theta = 96, 64 x 48 rays), one gradient of the one-step objective, the
2-D and 3-D dose maps of a 32^2 three-material phantom, the single- and
dual-energy noise maps of a 48^2 cylinder, fan- and cone-beam single
scatter through a 32^2 (x 8) three-material phantom, and the realism
paths (a bowtie under an artifact chain, tube-current modulation, the
anode heel) through the same phantom, and the motion paths (a breathing
scan of it through the motion-compensated FBP, the estimators and the
motion-compensated one-step fit; a gated series; the motion-compensated
cone and helical reconstructions), and the spectral paths (photon-counting
CT of the same phantom in 2-D and as a cone, kV switching, dual source
with cross-scatter and motion, the dual-layer detector), and the
parameter sweeps on tests/test_sweep.py's 64^2 water cylinder.  The card
tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s phase 5 both run
them, with the tolerances below.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ITERATIVE_PATHS", "ITERATIVE_TOL", "GRADIENT_TOL", "DOSE_KINDS",
           "DOSE_TOL", "NOISE_TOL", "SCATTER_KINDS", "SCATTER_TOL",
           "REALISM_KINDS", "REALISM_TOL", "MOTION_KINDS", "MOTION_TOL",
           "SPECTRAL_KINDS", "SPECTRAL_TOL", "spectral", "NEWTON_TOL",
           "newton_agreement", "newton_agrees",
           "fourier_plan", "iterative_2d", "onestep_gradient",
           "dose_inputs", "dose", "noise_maps", "scatter", "realism",
           "motion", "SWEEP_KINDS", "SWEEP_TOL", "sweep"]

ITERATIVE_PATHS = ("cg", "sirt", "pwls", "onestep")
SWEEP_KINDS = ("dose", "dose_parallel", "ramp", "slice")
# absolute, per output: the pipeline tolerances of
# tests/test_torch_pipeline.py (HU images 1 HU, basis sinograms and images
# 1e-3)
SWEEP_TOL = {"recon_HU": 1.0, "mat_recons": 1e-3, "mat_sinos": 1e-3}
# of the result's largest value: the adjoints' float32 atomics add in no
# fixed order, and the loops carry that rounding on
ITERATIVE_TOL = 1e-3
# of the gradient's largest value: one autograd pass, nothing amplifies it
GRADIENT_TOL = 1e-4
DOSE_KINDS = ("fan", "cone", "helical")
# of the map's largest value, and the deposited energy relative
DOSE_TOL = 1e-4
# of each noise map's largest value: float32 sums over views in another
# order, atan2 of another library
NOISE_TOL = 1e-4
SCATTER_KINDS = ("fan", "fan_compton", "fan_mev", "cone")
# of the scatter sinogram's largest value: float32 sums over vertices,
# energies and march steps in another order
SCATTER_TOL = 1e-4
REALISM_KINDS = ("realistic", "tcm", "heel")
# of each output's largest value: K29's bfloat16 warm phase rounds apart
# from its plain twin (1e-4 of the basis sinogram), and the chain's Wiener
# restoration and afterglow recursion carry the convolutions' rounding
REALISM_TOL = 1e-3
MOTION_KINDS = ("motion", "gated", "motion_3d")
# of each output's largest value: the fits (Adam on the joint track and
# the one-step images) carry the adjoints' unordered float32 atomics on, as
# ITERATIVE_TOL's loops do
MOTION_TOL = 1e-3
SPECTRAL_KINDS = ("pcd", "pcd_cone", "kvswitch", "dualsource", "duallayer")
# every output's max abs difference over its max |CPU|: the decompositions
# iterate float32 sums taken in another order (K35 and K3 against their
# plain versions)
SPECTRAL_TOL = 1e-3
# K35 against its plain version: |d| / max(|a|, 1), K3's bar; at K = 4 on
# 99 % of the pixels (the float32 Poisson-MLE polish of the 4x4 system is
# chaotic on the hardest rays, where the plain version and the JAX program
# disagree as much, tests/test_torch_multibin.py)
NEWTON_TOL = 1e-4


def newton_agreement(got, want):
    """(max, 99th percentile) over pixels of max_k |got - want| /
    max(|want|, 1) for two [P, K] decompositions."""
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).amax(-1)
    return float(rel.max()), float(torch.quantile(rel.double(), 0.99))


def newton_agrees(got, want):
    """K35's bar (:data:`NEWTON_TOL`): on every pixel for K <= 3, on 99 %
    of them for K = 4."""
    worst, p99 = newton_agreement(got, want)
    return (p99 if got.shape[-1] == 4 else worst) <= NEWTON_TOL

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


def _three_materials(nz=None, dz=0.5):
    """A 32^2 water disc with a bone rod in air at 0.5 cm (``nz`` slices
    of it ``dz`` apart for a 3-D phantom)."""
    from ..physics.materials import AIR, BONE, WATER, MaterialTable
    from ..system import VoxelPhantom

    ys = (np.arange(32) + 0.5 - 16) * 0.5
    lab = (np.hypot(ys[None, :], ys[:, None]) <= 6.0).astype(np.uint8)
    lab[np.hypot(ys[None, :] - 2.0, ys[:, None] - 1.0) <= 1.5] = 2
    lab = lab[None] if nz is None else np.broadcast_to(lab, (nz, 32, 32))
    return VoxelPhantom("rods", lab.copy(), MaterialTable([AIR, WATER, BONE]),
                        0.5, 0.5, dz)


def dose_inputs(kind):
    """A 32^2 water disc with a bone rod in air at 0.5 cm, and a 120 kV
    Kramers spectrum at 10x the isocentre fluence over the scan, for one of
    :data:`DOSE_KINDS`: a 64-channel, 48-view fan; an 8-slice cone scan of
    16 views x 4 rows; a 32-slice (0.25 cm) helix of three turns at pitch
    1.6 cm, 48 views x 4 rows, whose dose map runs the z-slab window."""
    from ..physics import kramers_spectrum
    from ..system import (ConeBeamGeometry, FanBeamGeometry,
                          HelicalConeBeamGeometry)

    spec = kramers_spectrum(120.0)
    if kind == "fan":
        ct = FanBeamGeometry(N_channels=64, N_proj=48, h_iso=0.1)
        ph = _three_materials()
    elif kind == "cone":
        ct = ConeBeamGeometry(N_channels=32, N_proj=16, N_rows=4, h_iso=0.25)
        ph = _three_materials(8)
    elif kind == "helical":
        ct = HelicalConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4,
                                     h_iso=0.4, rotation_total=6 * np.pi,
                                     pitch=1.6)
        ph = _three_materials(32, dz=0.25)
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


def noise_maps(device):
    """The predicted FBP variance of a 120 kV scan of a 48^2 water cylinder
    (64 channels, 48 views) and the three basis maps of an 80 / 140 kV
    pair decomposed from its exact paths: [4, 32, 32] on the CPU (K25 with
    one field, then with three)."""
    from ..ops import matdecomp, noisemap, spectral
    from ..ops.siddon import material_path_sinogram
    from ..physics import kramers_spectrum
    from ..system import FanBeamGeometry, water_cylinder_phantom

    ct = FanBeamGeometry(N_channels=64, N_proj=48, eid=False)
    ph = water_cylinder_phantom(N=48, dx=0.25, radius_cm=4.5)
    s1, s2 = kramers_spectrum(140.0), kramers_spectrum(80.0)
    for s in (s1, s2):
        s.rescale_counts(3e4 / float(np.sum(spectral.effective_fluence(s,
                                                                       ct))))
    paths = material_path_sinogram(ph, ct, device=device)
    c1, _ = spectral.forward_counts(paths, ph, s1, ct)
    c2, _ = spectral.forward_counts(paths, ph, s2, ct)
    m1, m2 = matdecomp.decompose_sinograms(ct, c1, c2, s1, s2, n_iters=20)
    var = noisemap.fbp_variance_map(c1, ct, 32, 12.0)
    cov = noisemap.decomposition_covariance(torch.stack([m1, m2], -1), ct,
                                            s1, s2)
    maps = noisemap.basis_variance_maps(cov, ct, 32, 12.0)
    return torch.stack([var, *maps]).cpu()


def scatter(kind, device):
    """Single scatter of one of :data:`SCATTER_KINDS` through
    :func:`_three_materials` at 120 kV, two views: the fan (32 channels,
    coarse 2, 8 bins, Compton + Rayleigh, Compton alone, or both with the
    megavoltage linac spectrum) and a 4-row cone over 8 slices (coarse 2,
    6 bins, every 2nd row and channel).  Returns the float64 sinogram on
    the host."""
    from ..ops import scatter_physics
    from ..physics import kramers_spectrum, linac_spectrum
    from ..system import ConeBeamGeometry, FanBeamGeometry

    spec = linac_spectrum() if kind == "fan_mev" else kramers_spectrum(120.0)
    spec.rescale_counts(1e6)
    views = np.array([0.0, 2.0])
    if kind == "cone":
        ct = ConeBeamGeometry(N_channels=32, N_proj=4, N_rows=4, h_iso=0.5,
                              gamma_fan=0.9, SID=60.0, SDD=100.0, eid=True)
        return scatter_physics.single_scatter_conebeam(
            _three_materials(8), ct, spec, coarse=2, n_energy=6,
            channel_sub=2, row_sub=2, views=views, device=device)
    if kind not in SCATTER_KINDS:
        raise ValueError(f"kind must be one of {SCATTER_KINDS}, got "
                         f"{kind!r}")
    ct = FanBeamGeometry(N_channels=32, N_proj=4, gamma_fan=0.9, SID=60.0,
                         SDD=100.0, h_iso=0.1, eid=True)
    return scatter_physics.single_scatter_sinogram(
        _three_materials(), ct, spec, coarse=2, n_energy=8, views=views,
        coherent=kind != "fan_compton", device=device)


def _realism_spectra(ct):
    from ..physics import kramers_spectrum, linac_spectrum

    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return s1, s2


def realism(kind, device):
    """One realism path on a tiny scan, no noise: ``'realistic'`` (a
    4-level bowtie under MTF, gains and afterglow, 48 views x 64 channels
    through the 32^2 phantom; K1, K28, K29), ``'tcm'`` (the auto profile,
    K1, K2, K3) or ``'heel'`` (a 20 um heel on a 24 x 4 x 32 cone through
    the phantom extruded to 8 slices; K10, K28, K29).  Returns the log and
    basis sinograms stacked, [4, ...], on the CPU."""
    from ..ops.afterglow import decay_per_view
    from ..ops.bowtie import bowtie_fluence, design_flattening_bowtie
    from ..ops.conebeam import simulate_cone_dect
    from ..ops.heel import HeelEffect
    from ..ops.mtf import focal_spot_kernel
    from ..pipeline import realism as rl
    from ..pipeline.tcm import simulate_tcm_dect
    from ..system import ConeBeamGeometry, FanBeamGeometry

    kw = dict(gamma_fan=0.9, SID=60.0, SDD=100.0, eid=True)
    if kind == "heel":
        ct = ConeBeamGeometry(N_channels=32, N_proj=24, N_rows=4, h_iso=0.5,
                              **kw)
        res = simulate_cone_dect(ct, _three_materials(8), *_realism_spectra(
            ct), 32, 20.0, 0.8, device=device, n_iters=10, do_recon=False,
            heel=HeelEffect(d0_cm=20e-4))
        out = res["sino_log"] + res["mat_sinos"]
    else:
        ct = FanBeamGeometry(N_channels=64, N_proj=48, **kw)
        s1, s2 = _realism_spectra(ct)
        ph = _three_materials()
        if kind == "tcm":
            res = simulate_tcm_dect(ct, ph, s1, s2, 32, 20.0, 0.8,
                                    n_iters=10, do_recon=False,
                                    device=device)
        else:
            bt = design_flattening_bowtie(ct, 6.0, n_steps=4)
            gains = np.random.default_rng(12).normal(1.0, 0.01, 64)

            def chain(spec):
                air = torch.as_tensor(bowtie_fluence(spec, ct, bt).sum(-1),
                                      dtype=torch.float32)
                return [rl.stage_mtf(focal_spot_kernel(ct, 0.1), nsr=1e-6),
                        rl.stage_gains(gains.astype(np.float32), air),
                        rl.stage_afterglow([0.05], decay_per_view([3.0],
                                                                  1.0))]

            res = rl.simulate_dect_realistic(
                ct, ph, s1, s2, 32, 20.0, 0.8, chain(s1), chain(s2),
                n_iters=10, do_recon=False, bowtie=bt, device=device)
        out = res.sino_log + res.mat_sinos
    return torch.stack(out).cpu()


def motion(kind, device):
    """One motion path on a tiny scan.  ``'motion'``: a 1 cm lateral
    breathing track over a 64-view, 48-channel fan through the 32^2
    phantom (K1), counts of two spectra (K2) and their decomposition (K3),
    the motion-compensated FBP of the 80 kV log and both basis sinograms
    (K30), the centroid estimate, 20 iterations of the joint estimator (K7,
    K21) and 10 of the motion-compensated one-step fit on a 32^2 plan.
    ``'gated'``: two turns of 48 views under a periodic 0.6 cm shift (K1),
    a four-gate series (K31).  ``'motion_3d'``: a 0.8 cm z drift over a 24
    x 4 x 32 cone (K10, K32) and a 1.6 cm drift over a 2-turn, 48-view
    helix (K10, K33) through the phantom extruded to 8 slices.  Returns the
    outputs as a list of CPU tensors."""
    from ..ops import matdecomp, motion as mo, onestep, spectral
    from ..ops.fourier import plan_fourier_projector
    from ..ops.siddon import mono_sinogram
    from ..pipeline.gated import gated_series, view_phases
    from ..system import (ConeBeamGeometry, FanBeamGeometry,
                          HelicalConeBeamGeometry)

    kw = dict(gamma_fan=0.9, SID=60.0, SDD=100.0, eid=True)
    mu = np.array([0.0, 0.2, 0.45])
    if kind == "motion_3d":
        ph = _three_materials(8)
        out = []
        for ct in (ConeBeamGeometry(N_channels=32, N_proj=24, N_rows=4,
                                    h_iso=0.5, **kw),
                   HelicalConeBeamGeometry(N_channels=32, N_proj=48,
                                           N_rows=4, h_iso=0.5, pitch=1.5,
                                           rotation_total=4 * np.pi, **kw)):
            helix = getattr(ct, "pitch", 0.0) != 0.0
            track = mo.MotionProfile3D.breathing_z(
                ct.N_proj, amplitude_cm=1.6 if helix else 0.8)
            sino = mono_sinogram(mo.cone_material_paths_motion(
                ph, ct, track, device=device), mu)
            recon = (mo.helical_fdk_reconstruct_motion if helix
                     else mo.fdk_reconstruct_motion)
            out.append(recon(sino, ct, 32, 20.0, 0.8, track))
        return [t.cpu() for t in out]
    ph = _three_materials()
    if kind == "gated":
        ct = FanBeamGeometry(N_channels=48, N_proj=96,
                             rotation_total=4 * np.pi, **kw)
        period = 96 / 3.0
        ph_v = view_phases(ct.N_proj, period)
        track = mo.MotionProfile(np.zeros(ct.N_proj), 0.6 * np.sin(
            2 * np.pi * ph_v)[:, None] * np.array([[1.0, 0.0]]))
        sino = mono_sinogram(mo.material_path_sinogram_motion(
            ph, ct, track, device=device), mu)
        return [gated_series(sino, ct, 32, 20.0, period).cpu()]
    ct = FanBeamGeometry(N_channels=48, N_proj=64, **kw)
    s1, s2 = _realism_spectra(ct)
    track = mo.MotionProfile.breathing(ct.N_proj, amplitude_cm=1.0,
                                       direction=(1.0, 0.4))
    paths = mo.material_path_sinogram_motion(ph, ct, track, device=device)
    (c1, _), (c2, l2) = (spectral.forward_counts(paths, ph, s, ct)
                         for s in (s1, s2))
    m1, m2 = matdecomp.decompose_sinograms(ct, c1, c2, s1, s2, n_iters=10)
    imgs = [mo.fbp_recon_motion(s, ct, 32, 20.0, track)[0]
            for s in (l2, m1, m2)]
    est, _ = mo.estimate_translation(l2, ct, n_modes=4)
    joint, x = mo.estimate_motion_joint(l2, ct, 32, 20.0, n_modes=4,
                                        n_iters=20, n_theta=64, init=est)
    ee, i0s, _ = matdecomp.prepare_decomposition(ct, s1, s2)
    grid = dataclasses.replace(ph, labels=np.zeros((1, 32, 32), np.uint8),
                               dx=20.0 / 32, dy=20.0 / 32, dz=20.0 / 32)
    plan = plan_fourier_projector(grid, ct, n_theta=64, device=device)
    x0 = torch.clamp_min(torch.stack(imgs[1:]), 0.0)
    fit = onestep.onestep_spectral_recon(
        torch.stack([c1, c2]), ee, i0s, matdecomp.DEFAULT_BASIS, plan,
        (ct.N_proj, ct.N_channels), x0=x0, n_iters=10, motion=track,
        geometry=ct)
    return [t.cpu() for t in (l2, m1, m2, *imgs,
                              torch.as_tensor(joint.disp), x, fit)]


def spectral(kind, device):
    """One spectral path on a tiny scan, no noise, through the 32^2
    phantom: ``'pcd'`` (photon-counting CT with bins [20, 34, 50, 70] keV
    of a 140 kV spectrum, 48 views x 48 channels, pileup on; K1, K34, K35,
    K4), ``'pcd_cone'`` (the same over a 24 x 4 x 32 cone through the
    phantom extruded to 8 slices; K10, K34, K35, K11), ``'kvswitch'``,
    ``'dualsource'`` (cross-scatter 0.15 and a 0.5 cm breathing track) and
    ``'duallayer'`` (K1-K4 each).  Returns the outputs as a list of CPU
    tensors."""
    from ..ops.motion import MotionProfile
    from ..physics import duallayer, kramers_spectrum
    from ..physics.detector import photon_counting_response
    from ..physics.materials import BONE, WATER
    from ..pipeline import dualsource, kvswitch, spectralct
    from ..system import ConeBeamGeometry, FanBeamGeometry

    kw = dict(gamma_fan=0.9, SID=60.0, SDD=100.0)
    if kind in ("pcd", "pcd_cone"):
        cone = kind == "pcd_cone"
        ct = (ConeBeamGeometry(N_channels=32, N_proj=24, N_rows=4,
                               h_iso=0.5, eid=False,
                               detector=photon_counting_response(), **kw)
              if cone else
              FanBeamGeometry(N_channels=48, N_proj=48, eid=False,
                              detector=photon_counting_response(), **kw))
        spec = kramers_spectrum(140.0)
        spec.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
        sim = (spectralct.simulate_pcd_spectral_cone if cone
               else spectralct.simulate_pcd_spectral)
        res = sim(ct, _three_materials(8 if cone else None), spec,
                  [20.0, 34.0, 50.0, 70.0], (WATER, BONE), 32, 20.0, 0.8,
                  n_iters=20, pileup_tau=1e-9, device=device)
        return [t.cpu() for t in (res.counts, res.basis_sinos,
                                  res.basis_recons)]
    ph = _three_materials()
    ct = FanBeamGeometry(N_channels=48, N_proj=48, eid=True, **kw)
    s1, s2 = _realism_spectra(ct)
    if kind == "kvswitch":
        out = kvswitch.simulate_kvswitch_dect(ct, ph, s1, s2, 32, 20.0, 0.8,
                                              n_iters=10, device=device)
    elif kind == "dualsource":
        track = MotionProfile.breathing(ct.N_proj, amplitude_cm=0.5,
                                        cycles=0.5, direction=(1.0, 0.3))
        out = dualsource.simulate_dualsource_dect(
            ct, ph, s1, s2, 32, 20.0, 0.8, cross_spr=0.15,
            kernel_sigma_ch=20.0, motion=track, n_iters=10, device=device)
    else:
        spec = kramers_spectrum(120.0)
        spec.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
        out = duallayer.simulate_dual_layer_dect(ct, ph, spec, 32, 20.0,
                                                 0.8, n_iters=10,
                                                 device=device)
    return [t.cpu() for pair in (out.sino_log, out.mat_sinos,
                                 out.mat_recons) for t in pair]


def sweep(kind, device):
    """One sweep on tests/test_sweep.py's scan (96 views x 64 channels
    through a 64^2 water cylinder at 0.35 cm, 12 iterations, 64^2 images
    over 20 cm), no noise: ``'dose'`` (scales 0.5 and 2.0; K1-K4),
    ``'dose_parallel'`` (the same on a 96 x 128 parallel grid; K1, K2, K3,
    K5, K6), ``'ramp'`` (sinc ramps 0.3 and 1.0) or ``'slice'`` (the
    cylinder, an empty slice and the cylinder rolled by 5 columns).
    Returns ``{output: tensor}`` (the keys of :data:`SWEEP_TOL` it has) on
    the CPU."""
    from ..ops.filters import filter_frequency_response
    from ..pipeline import sweep as sw
    from ..pipeline.fused import pack_dect
    from ..system import FanBeamGeometry, water_cylinder_phantom

    ct = FanBeamGeometry(N_channels=64, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    ph = water_cylinder_phantom(N=64, dx=0.35)
    s1, s2 = _realism_spectra(ct)
    par = kind == "dose_parallel"
    kw = dict(recon="parallel", recon_n_theta=96, recon_nt=128) if par \
        else {}
    arrays, meta = pack_dect(ct, ph, s1, s2, 64, 20.0, 0.8, device=device,
                             n_iters=12, **kw)
    if kind == "ramp":
        H = np.stack([filter_frequency_response(ct.N_channels, ct.dgamma,
                                                r, "sinc", "fan")[0]
                      for r in (0.3, 1.0)])
        return {"recon_HU": sw.ramp_sweep(arrays, meta, H).cpu()}
    if kind == "slice":
        base = ph.slice_labels()
        vol = np.stack([base, np.zeros_like(base), np.roll(base, 5, 1)])
        out = sw.slice_sweep(arrays, meta, vol)
        return {k: torch.stack(out[k]).cpu() for k in SWEEP_TOL}
    out = sw.dose_sweep(arrays, meta, [0.5, 2.0], 0, noise="none")
    return {k: v.cpu() for k, v in out.items()}
