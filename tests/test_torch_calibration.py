"""The port's host-only calibration modules against the JAX package's, on
the CPU: ``ops/calibration.py`` (detector offset from conjugate rays),
``ops/geocal.py`` (cone geometry from a bead phantom, its shadows traced by
K10's plain version) and ``ops/empirical.py`` (wedge-calibrated
dual-energy decomposition, applied in float32 on the device of the
sinograms).

Tolerances: the float64 host functions (inconsistency, offset estimate,
projected points, bead phantom, geometry fit, wedge measurements,
calibration fit) exact or rel 1e-12 on the same inputs; the bead
centroids of the port's trace against the JAX trace's atol 1e-3 sample
(measured 2.5e-5);
the float32 empirical application rel 1e-4 of the thickness range (the
degree-5 polynomial cancels in float32: the two programs lie 2.8e-5 of
the range apart, and the JAX program itself 8.1e-5 from the same
polynomial evaluated in float64); the physics bounds are the JAX tests' (offset
within 0.1 channel, calibrated recon error under 0.15x the nominal's, the
bead fit's du/dv within 0.05, pitch scales within 2e-3, empirical basis
sinograms within 3e-3 of max rms of the MLE's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import calibration as j_cal
from dexct_tpu.ops import empirical as j_emp
from dexct_tpu.ops import geocal as j_geo
from dexct_tpu.ops.conebeam import cone_material_paths as j_cone_paths
from dexct_tpu.physics import kramers_spectrum as j_kramers
from dexct_tpu.physics import linac_spectrum as j_linac
from dexct_tpu.system import ConeBeamGeometry as JCone
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu_torch.ops import calibration as t_cal
from dexct_tpu_torch.ops import empirical as t_emp
from dexct_tpu_torch.ops import geocal as t_geo
from dexct_tpu_torch.ops.conebeam import cone_material_paths, fdk_reconstruct
from dexct_tpu_torch.ops.matdecomp import air_mask, decompose_sinograms
from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
from dexct_tpu_torch.pipeline.api import get_recon, get_sino
from dexct_tpu_torch.system import ConeBeamGeometry as TCone
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import contrast_rods_phantom, pelvis_phantom

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- detector offset (ops/calibration.py) ----------------------------------

def _fan(offset=0.0, cls=TFan):
    return cls(N_channels=96, N_proj=128, gamma_fan=0.8230337, SID=60.0,
               SDD=100.0, eid=True, det_offset_ch=offset)


def _offset_scan(offset):
    """The port's 80 kV scan of the 64^2 rods with the detector mounted
    ``offset`` channels off (K1, K2 plain versions)."""
    ct = _fan(offset)
    s = kramers_spectrum(80.0)
    s.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    _, log = get_sino(ct, contrast_rods_phantom(N=64, dx=0.35), s,
                      device=CPU)
    return log, s


@pytest.fixture(scope="module")
def offset_scan():
    return _offset_scan(0.7)


def test_inconsistency_and_estimate_match_jax(offset_scan):
    log, _ = offset_scan
    for delta in (0.0, 0.7, -1.2):
        assert t_cal.conjugate_inconsistency(log, _fan(), delta) == \
            j_cal.conjugate_inconsistency(log.numpy(), _fan(cls=JFan), delta)
    assert t_cal.estimate_det_offset(log, _fan()) == \
        j_cal.estimate_det_offset(log.numpy(), _fan(cls=JFan))


def test_estimator_recovers_offset(offset_scan):
    log, _ = offset_scan
    ct = _fan()
    assert abs(t_cal.estimate_det_offset(log, ct) - 0.7) < 0.1
    assert t_cal.conjugate_inconsistency(log, ct, 0.7) < \
        0.2 * t_cal.conjugate_inconsistency(log, ct, 0.0)


def test_calibrated_recon_removes_artifact():
    log, s = _offset_scan(1.0)
    est = t_cal.estimate_det_offset(log, _fan())
    recs = {k: get_recon(log, _fan(o), s, 64, 20.0, 0.8)[0]
            for k, o in (("bad", 0.0), ("cal", est), ("true", 1.0))}
    err = {k: float(torch.sqrt(torch.mean((recs[k] - recs["true"]) ** 2)))
           for k in ("bad", "cal")}
    assert err["cal"] < 0.15 * err["bad"], err


def test_short_scan_refused():
    ct = dataclasses.replace(_fan(), rotation_total=np.pi + 1.0)
    with pytest.raises(ValueError, match="2\\*pi"):
        t_cal.conjugate_inconsistency(np.zeros((128, 96)), ct, 0.0)


# --- bead geometry calibration (ops/geocal.py) ------------------------------

TRUTH = {"du": 1.7, "dv": 0.8, "s_u": 0.012, "s_v": -0.015}
CONE = dict(N_channels=128, N_proj=64, N_rows=24, gamma_fan=0.7, SID=60.0,
            SDD=100.0, h_iso=0.25, eid=False)


def _misaligned(nom):
    return dataclasses.replace(
        nom, det_offset_ch=TRUTH["du"], det_offset_row=TRUTH["dv"],
        gamma_fan=nom.gamma_fan * (1 + TRUTH["s_u"]),
        h_iso=nom.h_iso * (1 + TRUTH["s_v"]))


@pytest.fixture(scope="module")
def beads():
    """The JAX test's bench: 4 steel beads in a 96^2 x 48 volume, a
    nominal and a misaligned 128-channel, 24-row, 64-view cone; the
    misaligned scan's bead paths traced by the port."""
    nom = TCone(**CONE)
    ph, pts = t_geo.bead_phantom_3d(nom, n_beads=4, radius_vox=2.2, N=96,
                                    nz=48, dx=0.3)
    paths = cone_material_paths(ph, _misaligned(nom), device=CPU)[..., 1]
    return nom, ph, pts, paths


def test_bead_phantom_and_projection_match_jax(beads):
    nom, ph, pts, _ = beads
    jnom = JCone(**CONE)
    jph, jpts = j_geo.bead_phantom_3d(jnom, n_beads=4, radius_vox=2.2, N=96,
                                      nz=48, dx=0.3)
    np.testing.assert_array_equal(ph.labels, jph.labels)
    np.testing.assert_array_equal(pts, jpts)
    assert [m.name for m in ph.materials] == [m.name for m in jph.materials]
    kw = dict(du=0.4, dv=-0.3, eta=0.004, s_u=0.01, s_v=-0.02)
    for a, b in zip(t_geo.project_points(pts, nom, **kw),
                    j_geo.project_points(jpts, jnom, **kw)):
        np.testing.assert_array_equal(a, b)


def test_centroids_and_fit_match_jax(beads):
    nom, ph, pts, paths = beads
    jnom = JCone(**CONE)
    jpaths = np.asarray(j_cone_paths(
        j_geo.bead_phantom_3d(jnom, n_beads=4, radius_vox=2.2, N=96, nz=48,
                              dx=0.3)[0], _misaligned(jnom)))[..., 1]
    got = t_geo.bead_centroids(paths, 4)
    want = j_geo.bead_centroids(jpaths, 4)
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a[got[2]], b[want[2]], atol=1e-3)
    fit = t_geo.fit_cone_geometry(*want, pts, nom)
    assert fit == j_geo.fit_cone_geometry(*want, pts, jnom)


def test_parameters_from_traced_beads(beads):
    nom, _, pts, paths = beads
    u, v, ok = t_geo.bead_centroids(paths, 4)
    assert ok.mean() > 0.25
    fit = t_geo.fit_cone_geometry(u, v, ok, pts, nom)
    assert abs(fit["du_ch"] - TRUTH["du"]) < 0.05
    assert abs(fit["dv_row"] - TRUTH["dv"]) < 0.05
    assert abs(fit["s_u"] - TRUTH["s_u"]) < 0.002
    assert abs(fit["s_v"] - TRUTH["s_v"]) < 0.002
    assert abs(fit["eta_rad"]) < 0.002
    assert fit["rms_residual"] < 0.3
    cal = t_geo.apply_calibration(nom, fit)
    assert cal.det_offset_ch == nom.det_offset_ch + fit["du_ch"]
    assert cal.h_iso == nom.h_iso * (1.0 + fit["s_v"])
    # the calibrated geometry reconstructs the scan like the true one
    sino = paths * 0.3
    vols = {k: fdk_reconstruct(sino, g, 96, 28.8, 0.8, nz_out=24)
            for k, g in (("nom", nom), ("cal", cal),
                         ("true", _misaligned(nom)))}
    e_nom = float(torch.sqrt(torch.mean((vols["nom"] - vols["true"]) ** 2)))
    e_cal = float(torch.sqrt(torch.mean((vols["cal"] - vols["true"]) ** 2)))
    assert e_nom > 20.0 * e_cal, (e_nom, e_cal)


def test_twist_recovery_on_synthetic_centroids(beads):
    nom, _, pts, _ = beads
    u, v = t_geo.project_points(pts, nom, du=0.4, eta=0.004)
    fit = t_geo.fit_cone_geometry(u, v, np.ones(u.shape, bool), pts, nom)
    assert abs(fit["eta_rad"] - 0.004) < 2e-4
    assert abs(fit["du_ch"] - 0.4) < 1e-3


# --- empirical decomposition (ops/empirical.py) -----------------------------

def _de_setup(fan_cls, linac, kramers):
    ct = fan_cls(N_channels=128, N_proj=96, gamma_fan=0.8230337, SID=60.0,
                 SDD=100.0, eid=True)
    s1 = linac()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return ct, s1, s2


@pytest.fixture(scope="module")
def de():
    return (_de_setup(TFan, linac_spectrum, kramers_spectrum),
            _de_setup(JFan, j_linac, j_kramers))


def _midpoints():
    g1 = np.linspace(0.0, 50.0, 14)
    g2 = np.linspace(0.0, 35.0, 14)
    return np.meshgrid((g1[:-1] + g1[1:]) / 2, (g2[:-1] + g2[1:]) / 2,
                       indexing="ij")


def test_wedges_fit_and_application_match_jax(de):
    (ct, s1, s2), (jct, j1, j2) = de
    T1, T2 = _midpoints()
    L = t_emp.wedge_log_measurements(ct, s1, s2, T1, T2)
    np.testing.assert_allclose(
        L, j_emp.wedge_log_measurements(jct, j1, j2, T1, T2), rtol=1e-12)
    model = t_emp.fit_empirical_de(ct, s1, s2)
    jmodel = j_emp.fit_empirical_de(jct, j1, j2)
    assert model.exponents == jmodel.exponents
    np.testing.assert_allclose(model.coeffs, jmodel.coeffs, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(model.L_max, jmodel.L_max, rtol=1e-12)
    t = t_emp.apply_empirical_de(model, L[0], L[1], device=CPU)
    want = np.asarray(j_emp.apply_empirical_de(jmodel, jnp.asarray(L[0]),
                                               jnp.asarray(L[1])))
    assert t.dtype == torch.float32 and t.shape == (2,) + T1.shape
    for k, rng_ in enumerate((50.0, 35.0)):
        assert np.abs(t[k].numpy() - want[k]).max() / rng_ <= 1e-4
        # held-out wedge inversion, the JAX test's bound
        assert np.abs(t[k].numpy() - (T1, T2)[k]).max() / rng_ < 2.5e-3


def test_air_and_argument_guards(de):
    (ct, s1, s2), _ = de
    model = t_emp.fit_empirical_de(ct, s1, s2)
    t = t_emp.apply_empirical_de(model, 0.0, 0.0, device=CPU)
    assert float(t[0]) == 0.0 and float(t[1]) == 0.0
    with pytest.raises(ValueError):
        t_emp.fit_empirical_de(ct, s1, s2, L_meas=np.zeros((2, 4)))
    g = np.linspace(0.0, 50.0, 14)
    h = np.linspace(0.0, 35.0, 14)
    T1, T2 = np.meshgrid(g, h, indexing="ij")
    L = t_emp.wedge_log_measurements(ct, s1, s2, T1, T2)
    m_data = t_emp.fit_empirical_de(ct, s1, s2, L_meas=L,
                                    T_grid=np.stack([T1, T2]))
    np.testing.assert_allclose(m_data.coeffs, model.coeffs, rtol=1e-8)


def test_matches_mle_on_pelvis(de):
    """The JAX test's bound on the port's pipeline: the empirical basis
    sinograms of a 96^2 pelvis within 3e-3 of max rms of the Poisson MLE's
    (K1, K2, K3 plain versions)."""
    (ct, s1, s2), _ = de
    ph = pelvis_phantom(N=96, dx=0.5)
    r1, l1 = get_sino(ct, ph, s1, device=CPU)
    r2, l2 = get_sino(ct, ph, s2, device=CPU)
    m1, m2 = decompose_sinograms(ct, r1, r2, s1, s2)
    t = t_emp.apply_empirical_de(t_emp.fit_empirical_de(ct, s1, s2), l1, l2)
    sel = ~air_mask(r1)
    for k, m in enumerate((m1, m2)):
        rms = float(torch.sqrt(torch.mean((t[k] - m)[sel] ** 2)))
        assert rms / float(m.max()) < 3e-3
