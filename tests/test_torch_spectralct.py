"""The port's spectral photon-counting pipelines (plain versions on the CPU)
against the JAX package's: ``simulate_pcd_spectral`` and
``simulate_pcd_spectral_cone``, the packed ``pcd_step`` and
``pcd_cone_step`` on the JAX packs' arrays (carried by
``arrays_from_numpy`` / ``cone_arrays_from_numpy``), the packed pipelines
of the port itself, the noise path, and the refusals.

Scenes are the JAX tests' (tests/test_spectralct.py): a 64^2 water
cylinder under 96 x 96 rays with a 140 kV photon-counting spectrum and
bins [20, 34, 50, 70] keV; the contrast-rod phantom at 120 kV for the
packed steps; an 8-row cone of 96 views x 64 channels through 8 slices.
Tolerances are the JAX tests' packed-against-stateless bars (counts 1e-4
of their maximum, basis sinograms 5e-3, basis images 1e-3; cone volumes
5e-3) unless a test says otherwise, and the JAX tests' physics bars on
the port's own outputs.  The JAX runs are module-scope fixtures.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dexct_tpu.ops import spectral as j_sp
from dexct_tpu.physics import kramers_spectrum, xcom
from dexct_tpu.physics.detector import photon_counting_response
from dexct_tpu.physics.materials import BONE, TISSUE, WATER
from dexct_tpu.pipeline import spectralct as j_pcd
from dexct_tpu.system import (ConeBeamGeometry, FanBeamGeometry,
                              HelicalConeBeamGeometry,
                              water_cylinder_phantom)
from dexct_tpu.system.phantom import contrast_rods_phantom
from dexct_tpu_torch.pipeline import cone as t_cone
from dexct_tpu_torch.pipeline import fused as t_fused
from dexct_tpu_torch.pipeline import spectralct as t_pcd

THRESH = [20.0, 34.0, 50.0, 70.0]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_geometry(ct):
    """The port's geometry of the JAX one, detector response included."""
    from dexct_tpu_torch.physics.detector import DetectorResponse
    from dexct_tpu_torch.system import geometry as t_geo

    fields = {f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)}
    d = ct.detector
    if d is not None:
        fields["detector"] = DetectorResponse(d.E, d.eta, d.name)
    return getattr(t_geo, type(ct).__name__)(**fields)


def _system():
    ct = FanBeamGeometry(N_channels=96, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=False,
                         detector=photon_counting_response())
    s = kramers_spectrum(140.0)
    s.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    return ct, water_cylinder_phantom(N=64, dx=0.3), s


def _np(res):
    return {f: np.asarray(getattr(res, f)) for f in
            ("counts", "counts_corrected", "basis_sinos", "basis_recons",
             "air_mask", "bin_energies")}


def _close(got, want, counts_rtol=1e-4, sino_atol=5e-3, img_atol=1e-3):
    cs = float(np.abs(want["counts"]).max())
    for k in ("counts", "counts_corrected"):
        assert np.abs(got[k] - want[k]).max() < counts_rtol * cs, k
    assert np.abs(got["basis_sinos"] - want["basis_sinos"]).max() \
        < sino_atol
    assert np.abs(got["basis_recons"] - want["basis_recons"]).max() \
        < img_atol


@pytest.fixture(scope="module")
def fan_runs():
    """The JAX package's and the port's simulate_pcd_spectral on the
    water cylinder: clean, and with pileup (air rays at rho = 0.5,
    corrected) under a realistic detector response."""
    from dexct_tpu.physics.pcd_response import pcd_response_matrix

    ct, ph, s = _system()
    tct = _port_geometry(ct)
    r = pcd_response_matrix(s.E, sigma_e_keV=3.0, share_frac=0.15)
    out = {}
    clean = j_pcd.simulate_pcd_spectral(ct, ph, s, THRESH, (WATER, BONE),
                                        64, 19.2)
    tau = 0.5 / float(np.asarray(clean.counts).sum(0).max())
    kw = dict(pileup_tau=tau, response=r)
    for name, extra in (("clean", {}), ("pileup_response", kw)):
        want = clean if not extra else j_pcd.simulate_pcd_spectral(
            ct, ph, s, THRESH, (WATER, BONE), 64, 19.2, **extra)
        got = t_pcd.simulate_pcd_spectral(tct, ph, s, THRESH, (WATER, BONE),
                                          64, 19.2, device="cpu", **extra)
        out[name] = (got, _np(want))
    return out


@pytest.mark.parametrize("name", ["clean", "pileup_response"])
def test_simulate_pcd_spectral_matches_jax(fan_runs, name):
    """Same scan through both packages: counts within 1e-4 of their
    maximum, basis sinograms within 1e-3 g/cm^2 and basis images within
    1e-3 g/cm^3 (the JAX tests' pipeline bars), the same air mask."""
    got, want = fan_runs[name]
    g = {k: np.asarray(v) for k, v in _np(got).items()}
    _close(g, want, sino_atol=1e-3)
    assert np.array_equal(g["air_mask"], want["air_mask"])
    np.testing.assert_allclose(g["bin_energies"], want["bin_energies"],
                               rtol=1e-12)


def test_water_density_and_vmi(fan_runs):
    """The JAX tests' physics bars on the port's clean run
    (tests/test_spectralct.py:34-49): water 1.0 and bone 0 within 0.02
    g/cm^3 in the centre, air 0 at the corner; the 70 keV VMI within 2 %
    of water's mu; the realistic-response run still recovers water within
    0.03."""
    got, _ = fan_runs["clean"]
    water, bone = got.basis_recons.numpy()
    assert abs(water[28:36, 28:36].mean() - 1.0) < 0.02
    assert abs(bone[28:36, 28:36].mean()) < 0.02
    assert abs(water[2:6, 2:6].mean()) < 0.02
    mu_w = float(xcom.mixatten(WATER.matcomp, np.array([70.0]))[0])
    vmi = got.vmi(70.0).numpy()
    assert abs(vmi[28:36, 28:36].mean() - mu_w) / mu_w < 0.02
    real, _ = fan_runs["pileup_response"]
    assert abs(real.basis_recons[0].numpy()[28:36, 28:36].mean() - 1.0) \
        < 0.03


def _rods():
    ct = FanBeamGeometry(N_channels=96, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=False)
    spec = kramers_spectrum(120.0)
    spec.rescale_counts(
        2e4 / float(np.sum(j_sp.effective_fluence(spec, ct))))
    return ct, contrast_rods_phantom(N=96, dx=0.4), spec


def _port_meta(meta, base_cls):
    base = base_cls(**{f: getattr(meta.base, f) for f in base_cls._fields
                       if hasattr(meta.base, f)})
    return t_pcd.PcdMeta(base, *meta[1:])


@pytest.mark.parametrize("recon", ["fan", "parallel"])
def test_pcd_step_on_jax_arrays_matches_jax(recon):
    """``pcd_step`` on the JAX ``pack_pcd_spectral`` arrays (exact trace,
    pileup distortion and inversion in the chain, 10 iterations) against
    the JAX step: the pipeline bars (counts 1e-4 of the maximum, basis
    sinograms 1e-3, images 1e-3); the port's own pack gives the same
    step within the same bars."""
    ct, ph, spec = _rods()
    args = (ct, ph, spec, THRESH, [TISSUE, BONE], 96, 30.0, 0.8)
    kw = dict(n_iters=10, pileup_tau=1e-5, projector="siddon", recon=recon,
              recon_n_theta=64, recon_nt=128)
    a, m = j_pcd.pack_pcd_spectral(*args, **kw)
    want = {k: np.asarray(v) for k, v in
            j_pcd.make_jitted_pcd_step(m)(a).items()}
    ta = t_fused.arrays_from_numpy({k: np.asarray(v) for k, v in a.items()},
                                   "cpu")
    assert "i0_bins_T" in ta and "pileup_route" in ta and "mu_t2" not in ta
    tm = _port_meta(m, t_fused.DectMeta)
    got = {k: v.numpy() for k, v in
           t_pcd.make_jitted_pcd_step(tm)(ta).items()}
    _close(got, want, sino_atol=1e-3)
    assert np.array_equal(got["air_mask"], want["air_mask"])
    pa, pm = t_pcd.pack_pcd_spectral(_port_geometry(ct), *args[1:],
                                     device="cpu", **kw)
    own = {k: v.numpy() for k, v in t_pcd.pcd_step(pa, pm).items()}
    _close(own, want, sino_atol=1e-3)


def test_pcd_step_noise_path_runs_and_rails_bounded():
    """Poisson noise from the pack's seed, a physical a_bounds (-20, 60):
    the basis sinograms stay finite and within the bound, the counts move
    off the noiseless ones, and the same seed repeats the draw
    (tests/test_spectralct.py:220-238)."""
    ct, ph, spec = _rods()
    args = (_port_geometry(ct), ph, spec, THRESH, [TISSUE, BONE], 96, 30.0,
            0.8)
    kw = dict(n_iters=10, projector="siddon", recon="fan", device="cpu")
    a, m = t_pcd.pack_pcd_spectral(*args, noise="poisson", seed=3,
                                   a_bounds=(-20.0, 60.0), **kw)
    out = t_pcd.pcd_step(a, m)
    s = out["basis_sinos"].numpy()
    assert np.isfinite(s).all()
    assert s.max() <= 60.0 + 1e-3
    a0, m0 = t_pcd.pack_pcd_spectral(*args, **kw)
    out0 = t_pcd.pcd_step(a0, m0)
    assert float((out["counts"] - out0["counts"]).abs().max()) > 1.0
    assert torch.equal(t_pcd.pcd_step(a, m)["counts"], out["counts"])


def _cone_inputs(helical=False):
    if helical:
        ct = HelicalConeBeamGeometry(
            N_channels=64, N_proj=96, N_rows=8, gamma_fan=0.8230337,
            SID=60.0, SDD=100.0, h_iso=0.5, eid=False,
            rotation_total=4 * np.pi, pitch=2.0)
    else:
        ct = ConeBeamGeometry(N_channels=64, N_proj=96, N_rows=8,
                              gamma_fan=0.8230337, SID=60.0, SDD=100.0,
                              h_iso=0.5, eid=False)
    ph2 = contrast_rods_phantom(N=64, dx=0.5)
    ph3 = dataclasses.replace(
        ph2, labels=np.broadcast_to(ph2.labels[0], (8, 64, 64)).copy(),
        dz=0.5)
    spec = kramers_spectrum(120.0)
    spec.rescale_counts(
        2e4 / float(np.sum(j_sp.effective_fluence(spec, ct))))
    return ct, ph3, spec


def test_simulate_pcd_spectral_cone_matches_jax():
    """The stateless cone PCD scan (K10, K34, K35, K11 on the card) against
    JAX: counts within 1e-4 of their maximum, basis sinograms 1e-3 g/cm^2,
    basis volumes 5e-3 g/cm^3 (the JAX cone test's volume bar); the water
    region reads tissue ~1 and no bone."""
    ct, ph3, spec = _cone_inputs()
    args = (ph3, spec, THRESH, [TISSUE, BONE], 64, 24.0, 0.8)
    want = _np(j_pcd.simulate_pcd_spectral_cone(ct, *args, n_iters=10,
                                                pileup_tau=1e-5))
    got = t_pcd.simulate_pcd_spectral_cone(_port_geometry(ct), *args,
                                           n_iters=10, pileup_tau=1e-5,
                                           device="cpu")
    g = {k: np.asarray(v) for k, v in _np(got).items()}
    assert g["basis_recons"].shape == (2, 8, 64, 64)
    _close(g, want, sino_atol=1e-3, img_atol=5e-3)
    assert np.array_equal(g["air_mask"], want["air_mask"])


def test_pcd_cone_step_on_jax_arrays_matches_jax():
    """``pcd_cone_step`` on the JAX ``pack_pcd_spectral_cone`` arrays
    (labels and rays from the host model, the JAX pack keeping them only
    in its TPU layouts) against the JAX step: the bars of the test above."""
    ct, ph3, spec = _cone_inputs()
    a, m = j_pcd.pack_pcd_spectral_cone(ct, ph3, spec, THRESH,
                                        [TISSUE, BONE], 64, 24.0, 0.8,
                                        n_iters=10, pileup_tau=1e-5)
    want = {k: np.asarray(v) for k, v in
            j_pcd.make_jitted_pcd_cone_step(m)(a).items()}
    src, dirs = ct.ray_geometry_3d()
    ta = t_cone.cone_arrays_from_numpy(
        {k: np.asarray(v) for k, v in a.items()}, "cpu", ph3.labels, src,
        dirs)
    assert "i0_bins_T" in ta and "pileup_route" in ta and "mu_t2" not in ta
    got = {k: v.numpy() for k, v in t_pcd.make_jitted_pcd_cone_step(
        _port_meta(m, t_cone.ConeDectMeta))(ta).items()}
    _close(got, want, sino_atol=1e-3, img_atol=5e-3)


def test_helical_pcd_cone_step_basis_volumes():
    """The port's packed helical PCD (the gFDK stage, K12 on the card):
    the JAX test's bars on the mid slice (tests/test_spectralct.py:
    311-327): tissue 1 within 0.08, bone 0 within 0.05, finite."""
    ct, ph3, spec = _cone_inputs(helical=True)
    a, m = t_pcd.pack_pcd_spectral_cone(
        _port_geometry(ct), ph3, spec, THRESH, [TISSUE, BONE], 64, 24.0,
        0.8, n_iters=10, device="cpu")
    r = t_pcd.pcd_cone_step(a, m)["basis_recons"].numpy()
    assert r.shape[0] == 2 and r.shape[2:] == (64, 64)
    mid = r.shape[1] // 2
    assert abs(r[0][mid, 28:36, 28:36].mean() - 1.0) < 0.08
    assert abs(r[1][mid, 28:36, 28:36].mean()) < 0.05
    assert np.isfinite(r).all()


@pytest.mark.parametrize("fn", ["simulate_pcd_spectral",
                                "simulate_pcd_spectral_cone",
                                "pack_pcd_spectral", "pack_pcd_spectral_cone"])
def test_eid_and_bin_count_refusals(fn):
    """An energy-integrating geometry and fewer bins than basis materials
    raise the JAX ValueErrors; the packs refuse compound noise (the EID
    second-moment model)."""
    ct, ph, s = _system() if "cone" not in fn else _cone_inputs()
    tct = _port_geometry(ct)
    call = getattr(t_pcd, fn)
    ct_eid = dataclasses.replace(tct, eid=True)
    with pytest.raises(ValueError, match="eid"):
        call(ct_eid, ph, s, THRESH, (WATER, BONE), 32, 19.2, device="cpu")
    with pytest.raises(ValueError, match="bins"):
        call(tct, ph, s, THRESH[:1], (WATER, BONE), 32, 19.2, device="cpu")
    if fn.startswith("pack"):
        with pytest.raises(ValueError, match="compound"):
            call(tct, ph, s, THRESH, (WATER, BONE), 32, 19.2,
                 noise="compound", device="cpu")


def kedge_reference():
    """The JAX package's reading of ``chip_smoke.py``'s two K-edge scenes
    at half their resolution, run as a script from the repository's root
    (~6 min on 2 CPU threads, < 4 GB):

        PYTHONPATH=. python tests/test_torch_spectralct.py

    The reference protocol as a photon-counting scan (the shipped Si PCD
    response, 140 kV at 10 mGy) at 400 channels and 500 views; six bins
    (KEDGE_THRESHOLDS), basis (water, bone, iodine, gadolinium), 60
    iterations.  The scenes (KEDGE_SCENES) at half resolution: the 19.2 cm
    water cylinder at 128^2 x 0.15 cm, images 128^2; the pelvis as every
    other label (128^2 at 0.4 cm), images 256^2 over 50 cm; each with
    chip_smoke's 10 mg/mL iodine and gadolinium rods.  Prints each rod's
    iodine and gadolinium basis densities (chip_smoke's KEDGE_REF) and the
    cylinder's 70 keV VMI between the rods against water's mu."""
    import json
    import os

    import chip_smoke
    from dexct_tpu.physics.materials import Material, MaterialTable
    from dexct_tpu.pipeline.runner import (_resolve_spectrum,
                                           default_generators)
    from dexct_tpu.system.config import _build_geometry, read_parameter_file
    from dexct_tpu.system.phantom import VoxelPhantom

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = os.path.join(repo, "input", "params.txt")
    base = json.loads(open(params).read())
    base.update(chip_smoke.PCD_PARAMS)
    base["detector_filename"] = os.path.join(repo, base["detector_filename"])
    old = os.getcwd()
    os.chdir(repo)
    try:
        ref = read_parameter_file(params)[0].phantom
    finally:
        os.chdir(old)
    pelvis = VoxelPhantom("pelvis", np.ascontiguousarray(
        ref.labels[:, ::2, ::2]), ref.materials, 0.4, 0.4, 0.4)
    cyl = chip_smoke.KEDGE_CYLINDER
    n_cyl, fov_cyl = chip_smoke.KEDGE_CYLINDER_IMAGE
    cylinder = water_cylinder_phantom(N=cyl["N"] // 2, dx=2 * cyl["dx"])
    ct = _build_geometry(dict(base, N_channels=400, N_projections=500))
    spec = _resolve_spectrum("140kV", chip_smoke.PCD_DOSE_MGY, ct,
                             os.path.join(repo, "input", "spectrum"),
                             default_generators())
    basis = (WATER, BONE, Material("iodine", 4.93, "I(100.0)"),
             Material("gadolinium", 7.9, "Gd(100.0)"))
    mu_w = float(xcom.mixatten(WATER.matcomp, np.array([70.0]))[0])
    for scene, ph, n, fov in (("cylinder", cylinder, n_cyl // 2, fov_cyl),
                              ("pelvis", pelvis, 256, 50.0)):
        ph = chip_smoke.kedge_phantom(ph, scene, MaterialTable, Material)
        res = j_pcd.simulate_pcd_spectral(
            ct, ph, spec, list(chip_smoke.KEDGE_THRESHOLDS), basis, n, fov,
            n_iters=60)
        reading = chip_smoke.kedge_reading(np.asarray(res.basis_recons),
                                           fov, scene)
        for rod, (i_, g_) in reading.items():
            print(f"{scene} {rod} rod: iodine {i_:.5f}, gadolinium "
                  f"{g_:.5f} g/cm^3")
        if scene == "cylinder":
            vmi = chip_smoke.roi_mean(np.asarray(res.vmi(70.0))[None], 0.0,
                                      0.0, 0, fov)
            print(f"cylinder VMI(70 keV) between the rods {vmi:.5f} 1/cm, "
                  f"water {mu_w:.5f} (off {vmi / mu_w - 1.0:.4f})")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    kedge_reference()
