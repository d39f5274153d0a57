"""The port's other dual-energy acquisition modes against the JAX
package's: fast kV switching (``pipeline.kvswitch``), dual source with
cross-scatter and patient motion (``pipeline.dualsource``), and the
dual-layer detector (``physics.duallayer``).

Scenes are the JAX tests' (tests/test_acquisition_modes.py): the 64^2
contrast-rod phantom at 0.35 cm under 48 or 64 views x 96 channels of an
energy-integrating fan, detunedMV 9 mGy / 80 kV 1 mGy (dual source, kV
switching) or 120 kV split by the sandwich detector.  Tolerances are the
JAX pipeline tests' (tests/test_pipeline.py): raw counts rtol 1e-4, log
sinograms atol 1e-4, basis sinograms and basis images atol 1e-3, images
atol 1e-4 cm^-1, HU atol 1; host tables bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops.motion import MotionProfile as JMotion
from dexct_tpu.physics import duallayer as j_dl
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline import dualsource as j_ds
from dexct_tpu.pipeline import kvswitch as j_kv
from dexct_tpu.system import FanBeamGeometry, contrast_rods_phantom
from dexct_tpu_torch.ops.motion import MotionProfile as TMotion
from dexct_tpu_torch.physics import duallayer as t_dl
from dexct_tpu_torch.pipeline import dualsource as t_ds
from dexct_tpu_torch.pipeline import kvswitch as t_kv

TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
       "sino_log": dict(rtol=0.0, atol=1e-4),
       "mat_sinos": dict(rtol=0.0, atol=1e-3),
       "recon_raw": dict(rtol=0.0, atol=1e-4),
       "recon_HU": dict(rtol=0.0, atol=1.0),
       "mat_recons": dict(rtol=0.0, atol=1e-3)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _system(n_proj=48):
    ct = FanBeamGeometry(N_channels=96, N_proj=n_proj, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    return ct, contrast_rods_phantom(N=64, dx=0.35)


def _port(ct):
    from dexct_tpu_torch.physics.detector import DetectorResponse
    from dexct_tpu_torch.system import geometry as t_geo

    fields = {f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)}
    d = ct.detector
    if d is not None:
        fields["detector"] = DetectorResponse(d.E, d.eta, d.name)
    return getattr(t_geo, type(ct).__name__)(**fields)


def _spectra(ct):
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return s1, s2


def _close(got, want, keys=TOL):
    for key in keys:
        for i in range(2):
            g, w = getattr(got, key)[i], getattr(want, key)[i]
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{key}[{i}]", **TOL[key])


def test_view_interleave_and_interpolation_match_jax():
    """Elementwise and ring rolls: bit for bit the JAX functions."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(16, 8)).astype(np.float32)
    for parity in (0, 1):
        np.testing.assert_array_equal(
            t_kv.interp_skipped_views(torch.as_tensor(a), parity).numpy(),
            np.asarray(j_kv.interp_skipped_views(jnp.asarray(a), parity)))
        np.testing.assert_array_equal(
            t_kv.interleave_views(torch.as_tensor(a), torch.as_tensor(b),
                                  parity).numpy(),
            np.asarray(j_kv.interleave_views(jnp.asarray(a),
                                             jnp.asarray(b), parity)))
    np.testing.assert_array_equal(
        t_ds.align_tube_b(torch.as_tensor(a), 5).numpy(),
        np.asarray(j_ds.align_tube_b(jnp.asarray(a), 5)))


def test_kvswitch_matches_jax():
    """One rotation of alternating spectra, the skipped views filled in the
    log domain: every output within the pipeline tolerances, the skipped
    views of the raw counts zero on both."""
    ct, ph = _system()
    s1, s2 = _spectra(ct)
    args = (ph, s1, s2, 64, 20.0, 0.8)
    want = j_kv.simulate_kvswitch_dect(ct, *args, n_iters=10)
    got = t_kv.simulate_kvswitch_dect(_port(ct), *args, n_iters=10,
                                      device="cpu")
    _close(got, want)
    ra, rb = (x.numpy() for x in got.sino_raw)
    assert np.all(ra[1::2] == 0) and np.all(ra[0::2] > 0)
    assert np.all(rb[0::2] == 0) and np.all(rb[1::2] > 0)


def test_kvswitch_refusals_and_independent_noise():
    """The JAX ValueErrors (odd view count, short scan, bad phase); the
    two spectra's Poisson draws from one generator are independent
    (standardized residuals correlated below 0.1, the JAX test's bar,
    tests/test_acquisition_modes.py:142-166)."""
    ct, ph = _system(n_proj=32)
    tct = _port(ct)
    s1, s2 = _spectra(ct)
    args = (ph, s1, s2, 64, 20.0, 0.8)
    with pytest.raises(ValueError, match="even view count"):
        t_kv.simulate_kvswitch_dect(dataclasses.replace(tct, N_proj=31),
                                    *args, device="cpu")
    with pytest.raises(ValueError, match="2\\*pi"):
        t_kv.simulate_kvswitch_dect(
            dataclasses.replace(tct, rotation_total=np.pi), *args,
            device="cpu")
    with pytest.raises(ValueError, match="phase"):
        t_kv.simulate_kvswitch_dect(tct, *args, phase=2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    noisy = t_kv.simulate_kvswitch_dect(tct, *args, n_iters=5,
                                        noise="poisson", generator=gen,
                                        do_recon=False, device="cpu")
    clean = t_kv.simulate_kvswitch_dect(tct, *args, n_iters=5,
                                        do_recon=False, device="cpu")
    ra, rb = (x.numpy() for x in noisy.sino_raw)
    ca, cb = (x.numpy() for x in clean.sino_raw)
    assert ra[0::2].std() > 0
    res_a = (ra[0::2] - ca[0::2]) / np.sqrt(np.maximum(ca[0::2], 1))
    res_b = (rb[1::2] - cb[1::2]) / np.sqrt(np.maximum(cb[1::2], 1))
    assert abs(np.corrcoef(res_a.ravel(), res_b.ravel())[0, 1]) < 0.1


def test_cross_scatter_model_matches_jax():
    """Kernel-superposition cross-scatter and its coupled correction on
    the same counts: rtol 1e-5 (a float32 channel convolution summed in
    another order)."""
    from dexct_tpu.ops.scatter import scatter_kernel

    rng = np.random.default_rng(2)
    a = rng.uniform(1e4, 1e6, (24, 96)).astype(np.float32)
    b = rng.uniform(1e3, 1e5, (24, 96)).astype(np.float32)
    k = scatter_kernel(96, sigma_ch=20.0)
    want = j_ds.add_cross_scatter(jnp.asarray(a), jnp.asarray(b), 1e6, 1e5,
                                  jnp.asarray(k), cross_spr=0.15)
    got = t_ds.add_cross_scatter(torch.as_tensor(a), torch.as_tensor(b),
                                 1e6, 1e5, k, cross_spr=0.15)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    want = j_ds.correct_cross_scatter(*want, 1e6, 1e5, jnp.asarray(k),
                                      cross_spr=0.15)
    got = t_ds.correct_cross_scatter(*got, 1e6, 1e5, k, cross_spr=0.15)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_dualsource_with_cross_scatter_matches_jax():
    """Two tubes a quarter turn apart exchanging cross-scatter (SPR 0.15),
    added and corrected: every output within the pipeline tolerances of
    the JAX run, but the corrected log sinograms within 2e-4: the
    correction subtracts scatter up to 0.36 of the primary on the thickest
    80 kV rays, which turns the counts' rtol 1e-4 into ~1.4e-4 on the log
    of the primary estimate."""
    ct, ph = _system(n_proj=64)
    s1, s2 = _spectra(ct)
    kw = dict(n_iters=10, cross_spr=0.15, kernel_sigma_ch=40.0)
    want = j_ds.simulate_dualsource_dect(ct, ph, s1, s2, 64, 20.0, 0.8,
                                         **kw)
    got = t_ds.simulate_dualsource_dect(_port(ct), ph, s1, s2, 64, 20.0,
                                        0.8, device="cpu", **kw)
    _close(got, want, keys=[k for k in TOL if k != "sino_log"])
    for g, w in zip(got.sino_log, want.sino_log):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)


def test_dualsource_with_motion_matches_jax():
    """Both tubes under one breathing track (time-indexed, tube B's pose
    rolled onto its angular grid): counts, log sinograms and images within
    the pipeline tolerances of the JAX run.  The JAX run traces the
    object-frame rays with its dominant-axis tracer, up to 2e-3 cm off the
    exact trace (tests/test_torch_motion.py), and on the few rays that
    graze the phantom the decomposition turns that into basis differences
    up to ~0.1 g/cm^2: the basis sinograms are held to 1e-3 on 99.9 % of
    rays and 0.1 on all, the basis images to 2e-3 g/cm^3."""
    ct, ph = _system(n_proj=64)
    s1, s2 = _spectra(ct)
    track = JMotion.breathing(64, amplitude_cm=0.5, cycles=0.5,
                              direction=(1.0, 0.3))
    want = j_ds.simulate_dualsource_dect(ct, ph, s1, s2, 64, 20.0, 0.8,
                                         motion=track, n_iters=10)
    got = t_ds.simulate_dualsource_dect(
        _port(ct), ph, s1, s2, 64, 20.0, 0.8,
        motion=TMotion(track.phi, track.disp), n_iters=10, device="cpu")
    _close(got, want, keys=("sino_raw", "sino_log", "recon_raw",
                            "recon_HU"))
    for i in range(2):
        d = np.abs(got.mat_sinos[i].numpy() - np.asarray(want.mat_sinos[i]))
        assert (d > 1e-3).mean() <= 1e-3 and d.max() < 0.1
        np.testing.assert_allclose(got.mat_recons[i].numpy(),
                                   np.asarray(want.mat_recons[i]), rtol=0,
                                   atol=2e-3)


def test_dualsource_refusals():
    ct, ph = _system()
    tct = _port(ct)
    s1, s2 = _spectra(ct)
    with pytest.raises(ValueError, match="2\\*pi"):
        t_ds.simulate_dualsource_dect(
            dataclasses.replace(tct, rotation_total=np.pi), ph, s1, s2, 64,
            20.0, 0.8, device="cpu")
    with pytest.raises(ValueError, match="motion has"):
        t_ds.simulate_dualsource_dect(tct, ph, s1, s2, 64, 20.0, 0.8,
                                      motion=TMotion.static(7),
                                      device="cpu")


def test_dual_layer_matches_jax():
    """Host float64 layer absorptions and virtual spectra bit for bit;
    the one-scan dual-layer DE run within the pipeline tolerances, its
    tissue basis image at the JAX test's water-density bar (0.8-1.2,
    tests/test_acquisition_modes.py:57-67)."""
    from dexct_tpu_torch.physics import kramers_spectrum as t_kramers

    E = np.arange(10.0, 150.0)
    for got, want in zip(t_dl.layer_absorptions(E, inter_matcomp="Cu(100.0)",
                                                inter_density=8.96,
                                                inter_thickness_cm=0.01),
                         j_dl.layer_absorptions(E, inter_matcomp="Cu(100.0)",
                                                inter_density=8.96,
                                                inter_thickness_cm=0.01)):
        assert np.array_equal(got, want)
    ct, ph = _system()
    s, ts = kramers_spectrum(120.0), t_kramers(120.0)
    s.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    ts.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    for got, want in zip(t_dl.dual_layer_spectra(ts),
                         j_dl.dual_layer_spectra(s)):
        assert np.array_equal(got.I0, want.I0) and got.name == want.name
    want = j_dl.simulate_dual_layer_dect(ct, ph, s, 64, 20.0, 0.8,
                                         n_iters=10)
    got = t_dl.simulate_dual_layer_dect(_port(ct), ph, ts, 64, 20.0, 0.8,
                                        n_iters=10, device="cpu")
    _close(got, want)
    assert 0.8 < float(got.mat_recons[0][28:36, 28:36].mean()) < 1.2
