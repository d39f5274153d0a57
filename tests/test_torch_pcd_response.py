"""The port's host-only photon-counting response and spectrum-calibration
modules against the JAX package's: ``pcd_response_matrix``,
``bin_weights_from_response``, ``pcd_bin_fluences_realistic``,
``wedge_transmissions`` and ``estimate_spectrum_em``.  Both sides are the
same float64 NumPy, so the bar is float64 rounding (rtol 1e-12, and bit
for bit where the operations are the same), plus the JAX tests' own
physics checks on the port's outputs (tests/test_pcd_response.py,
tests/test_spectrum_calibration.py).
"""

import dataclasses

import numpy as np
import pytest

from dexct_tpu.physics import kramers_spectrum as j_kramers
from dexct_tpu.physics import pcd_response as j_resp
from dexct_tpu.physics import spectrum_calibration as j_cal
from dexct_tpu.physics.detector import photon_counting_response
from dexct_tpu.physics.materials import WATER, Material
from dexct_tpu.system import FanBeamGeometry
from dexct_tpu_torch.physics import kramers_spectrum as t_kramers
from dexct_tpu_torch.physics import pcd_response as t_resp
from dexct_tpu_torch.physics import spectrum_calibration as t_cal
from dexct_tpu_torch.physics.detector import \
    photon_counting_response as t_pcr
from dexct_tpu_torch.system import FanBeamGeometry as TFan

E = np.arange(10.0, 141.0, 1.0)
THR = [20.0, 34.0, 50.0, 70.0]
ALUMINUM = Material("aluminum", 2.699, "Al(100.0)")


@pytest.mark.parametrize("kw", [
    dict(), dict(sigma_e_keV=0.3, share_frac=0.0),
    dict(share_frac=0.3, fano_keV2_per_keV=0.05),
    dict(sensor="CdTe"), dict(sensor="CZT", escape_frac=0.2)],
    ids=["default", "ideal", "sharing_fano", "CdTe", "CZT"])
def test_response_matrix_matches_jax(kw):
    """Column-stochastic R[E_rec, E_true]: bit for bit the JAX package's."""
    got = t_resp.pcd_response_matrix(E, **kw)
    want = j_resp.pcd_response_matrix(E, **kw)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got.sum(0), 1.0, rtol=1e-12)


def test_response_matrix_refuses_what_jax_refuses():
    for mod in (t_resp, j_resp):
        with pytest.raises(ValueError, match="share_frac"):
            mod.pcd_response_matrix(E, share_frac=0.7, sensor="CdTe",
                                    escape_frac=0.4)


def test_bin_weights_and_realistic_fluences_match_jax():
    """Bin weights of a response equal the JAX package's bit for bit, and
    the realistic bin fluences built on a spectrum's grid to float64
    rounding."""
    r = j_resp.pcd_response_matrix(E, share_frac=0.15, sigma_e_keV=3.0)
    assert np.array_equal(t_resp.bin_weights_from_response(r, E, THR),
                          j_resp.bin_weights_from_response(r, E, THR))
    det = photon_counting_response()
    jct = FanBeamGeometry(N_channels=16, N_proj=8, eid=False, detector=det)
    tct = TFan(**{f.name: getattr(jct, f.name)
                  for f in dataclasses.fields(jct) if f.name != "detector"},
               detector=t_pcr())
    js, ts = j_kramers(140.0), t_kramers(140.0)
    want = j_resp.pcd_bin_fluences_realistic(jct, js, THR,
                                             sigma_e_keV=3.0,
                                             share_frac=0.15)
    got = t_resp.pcd_bin_fluences_realistic(tct, ts, THR, sigma_e_keV=3.0,
                                            share_frac=0.15)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    assert got.shape == (len(THR), len(ts.E))


def _geometry(eid=True):
    return FanBeamGeometry(N_channels=16, N_proj=8, gamma_fan=0.9,
                           SID=60.0, SDD=100.0, h_iso=0.1, eid=eid)


def test_wedge_transmissions_match_jax():
    ct = _geometry()
    tct = TFan(N_channels=16, N_proj=8, gamma_fan=0.9, SID=60.0, SDD=100.0,
               h_iso=0.1, eid=True)
    t = np.concatenate([[0.0], np.geomspace(0.2, 30.0, 12)])
    want = j_cal.wedge_transmissions(j_kramers(120.0), ct, WATER, t)
    got = t_cal.wedge_transmissions(t_kramers(120.0), tct, WATER, t)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("material", [WATER, ALUMINUM],
                         ids=["water", "aluminum"])
def test_em_estimate_matches_jax(material):
    """The EM estimate after 8000 multiplicative updates equals the JAX
    package's to float64 rounding (rtol 1e-12 on the weights) and
    reproduces held-out water-wedge transmissions within the JAX tests'
    bars: rtol 5e-3, atol 2e-4 calibrated on water, rtol 0.03 calibrated
    on aluminum (tests/test_spectrum_calibration.py:24-74)."""
    ct = _geometry()
    t = np.concatenate([[0.0], np.geomspace(0.2, 30.0, 12)])
    if material is ALUMINUM:
        t = np.concatenate([[0.0], np.geomspace(0.05, 8.0, 12)])
    T = j_cal.wedge_transmissions(j_kramers(120.0), ct, material, t)
    grid = np.arange(15.0, 121.0, 1.0)
    want = j_cal.estimate_spectrum_em(T, t, material, grid, n_iters=8000)
    got = t_cal.estimate_spectrum_em(T, t, material, grid, n_iters=8000)
    np.testing.assert_allclose(got.I0, want.I0, rtol=1e-12, atol=1e-300)
    assert np.array_equal(got.E, want.E)
    t_w = np.array([0.5, 3.7, 11.0, 24.0])
    T_true = j_cal.wedge_transmissions(j_kramers(120.0), ct, WATER, t_w)
    mu_w = WATER.linear_atten(got.E)
    T_est = np.exp(-np.outer(t_w, mu_w)) @ (got.I0 / got.I0.sum())
    if material is WATER:
        np.testing.assert_allclose(T_est, T_true, rtol=5e-3, atol=2e-4)
    else:
        np.testing.assert_allclose(T_est, T_true, rtol=0.03)


def test_em_estimate_validation_matches_jax():
    for mod in (t_cal, j_cal):
        with pytest.raises(ValueError, match="air"):
            mod.estimate_spectrum_em(np.array([0.5]), np.array([5.0]),
                                     WATER, np.arange(15.0, 121.0))
        with pytest.raises(ValueError, match="matching"):
            mod.estimate_spectrum_em(np.array([1.0, 0.5]), np.array([0.0]),
                                     WATER, np.arange(15.0, 121.0))
