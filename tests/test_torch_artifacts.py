"""The port's detector and scan artifact models against the JAX package's,
on the CPU: ``ops/{mtf,rings,mar,afterglow,lowdose,truncation,aperture,
denoise}.py`` and ``physics/pileup.py``.

Inputs are made with numpy from seeds and handed to both packages; where a
model needs a scan, the JAX package makes it (the JAX tests' small fans).
Tolerances, each with its reason:
- host float64 tables and fits equal, or to rtol 1e-12 (the same NumPy);
- elementwise models and recursions (pileup, afterglow, gains, defects,
  truncation completion, denoiser rotations) to rel 1e-5 / 1e-6 (float32
  operations in another order; exp and log round in other libraries);
- edge-padded correlations and rFFTs (MTF, denoiser smoothing) to rel
  1e-5, the Wiener restoration to 1e-5 of the signal's maximum (pocketfft
  against XLA's FFT);
- the MAR bridges exactly where they only gather, to 1e-6 where they
  interpolate; the metal trace to 1 mismatched ray in 1000 (a threshold on
  the Fourier projection, whose two FFT libraries differ by ~1e-6 cm) and
  the MAR images to 1 HU (tests/test_torch_pipeline.py's TOL);
- the aperture's sub-ray paths to 2e-3 cm (the JAX tracer bar, as in
  tests/test_torch_siddon.py) and its counts on the same paths to rel 1e-5;
- random draws (gains, flicker, synthetic dose reduction) by their
  statistics, within 5 standard errors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import afterglow as j_ag
from dexct_tpu.ops import aperture as j_ap
from dexct_tpu.ops import denoise as j_dn
from dexct_tpu.ops import lowdose as j_ld
from dexct_tpu.ops import mar as j_mar
from dexct_tpu.ops import mtf as j_mtf
from dexct_tpu.ops import rings as j_rings
from dexct_tpu.ops import truncation as j_tr
from dexct_tpu.physics import kramers_spectrum
from dexct_tpu.physics import pileup as j_pu
from dexct_tpu.physics.materials import (AIR, BONE, Material, MaterialTable,
                                         WATER)
from dexct_tpu.pipeline.api import get_sino
from dexct_tpu.system import FanBeamGeometry, water_cylinder_phantom
from dexct_tpu.system.phantom import VoxelPhantom
from dexct_tpu_torch.ops import afterglow as t_ag
from dexct_tpu_torch.ops import aperture as t_ap
from dexct_tpu_torch.ops import denoise as t_dn
from dexct_tpu_torch.ops import lowdose as t_ld
from dexct_tpu_torch.ops import mar as t_mar
from dexct_tpu_torch.ops import mtf as t_mtf
from dexct_tpu_torch.ops import rings as t_rings
from dexct_tpu_torch.ops import truncation as t_tr
from dexct_tpu_torch.physics import pileup as t_pu
from dexct_tpu_torch.system import FanBeamGeometry as TFan


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _counts(shape=(48, 96), seed=0):
    """Channel-smooth counts, as a real sinogram's (white data has full
    spectral content at the blur kernels' near-zeros)."""
    rng = np.random.default_rng(seed)
    c = np.arange(shape[-1])
    prof = 1e5 * np.exp(-2.5 * np.exp(-((c - shape[-1] / 2) / 20.0) ** 2))
    ripple = 1 + 0.05 * np.sin(rng.uniform(0, 6, shape[:-1] + (1,)) + c / 7)
    return (prof * ripple).astype(np.float32)


def _fan(n_ch=96, n_proj=48, **kw):
    kw = {**dict(gamma_fan=0.8230337, SID=60.0, SDD=100.0, eid=True), **kw}
    return (FanBeamGeometry(N_channels=n_ch, N_proj=n_proj, **kw),
            TFan(N_channels=n_ch, N_proj=n_proj, **kw))


# ---------------------------------------------------------------- MTF

@pytest.mark.parametrize("spot", [0.0, 0.05, 0.45, 1.2])
def test_mtf_kernels_and_blur_match_jax(spot):
    jct, tct = _fan()
    k = t_mtf.focal_spot_kernel(tct, spot)
    np.testing.assert_array_equal(k, j_mtf.focal_spot_kernel(jct, spot))
    np.testing.assert_array_equal(t_mtf.crosstalk_kernel(0.1),
                                  j_mtf.crosstalk_kernel(0.1))
    x = _counts()
    want = np.asarray(j_mtf.apply_detector_mtf(jnp.asarray(x), k))
    got = t_mtf.apply_detector_mtf(_t(x), k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    rw = np.asarray(j_mtf.wiener_restore_channels(jnp.asarray(want), k,
                                                  nsr=1e-6))
    rg = t_mtf.wiener_restore_channels(got, k, nsr=1e-6)
    np.testing.assert_allclose(rg.numpy(), rw, rtol=0,
                               atol=1e-5 * np.abs(rw).max())
    with pytest.raises(ValueError, match="crosstalk"):
        t_mtf.crosstalk_kernel(0.5)


# ---------------------------------------------------------------- pileup

@pytest.mark.parametrize("model", ["paralyzable", "nonparalyzable"])
def test_dead_time_rates_match_jax(model):
    n = np.linspace(0.0, 0.9, 301).astype(np.float32)
    m = np.asarray(j_pu.recorded_rate(jnp.asarray(n), model))
    np.testing.assert_allclose(t_pu.recorded_rate(_t(n), model).numpy(), m,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_pu.true_rate(_t(m), model).numpy(),
                               np.asarray(j_pu.true_rate(jnp.asarray(m),
                                                         model)),
                               rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="dead-time"):
        t_pu.recorded_rate(_t(n), "ideal")


def test_pileup_bins_match_jax():
    rng = np.random.default_rng(2)
    e = np.linspace(20.0, 120.0, 101)
    i0s = rng.uniform(0, 1, (4, 101)) * np.exp(-((e - 60) / 30) ** 2)
    me = t_pu.bin_mean_energies(i0s, e)
    np.testing.assert_array_equal(me, j_pu.bin_mean_energies(i0s, e))
    thr = np.array([20.0, 45.0, 70.0, 95.0])
    s = t_pu.bin_sum_redistribution(thr, me)
    np.testing.assert_array_equal(s, j_pu.bin_sum_redistribution(thr, me))
    counts = rng.uniform(1e3, 1e5, (4, 6, 10)).astype(np.float32)
    tau = 1e-6
    for model in ("paralyzable", "nonparalyzable"):
        want = np.asarray(j_pu.apply_pileup_bins(jnp.asarray(counts), tau, s,
                                                 model))
        got = t_pu.apply_pileup_bins(_t(counts), tau, s, model)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        back = t_pu.correct_pileup_bins(got, tau, s, model)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(j_pu.correct_pileup_bins(
                jnp.asarray(want), tau, s, model)), rtol=1e-5)
        np.testing.assert_allclose(back.numpy(), counts, rtol=1e-3)


# ---------------------------------------------------------------- afterglow

def test_afterglow_host_calibration_matches_jax():
    a, b = [0.05, 0.02], t_ag.decay_per_view([2.0, 20.0], 1.0)
    np.testing.assert_array_equal(b, j_ag.decay_per_view([2.0, 20.0], 1.0))
    h = t_ag.lag_impulse_response(a, b, 40)
    np.testing.assert_array_equal(h, j_ag.lag_impulse_response(a, b, 40))
    for got, want in zip(t_ag.fit_lag_parameters(h[1:]),
                         j_ag.fit_lag_parameters(h[1:])):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    with pytest.raises(ValueError, match="sum < 1"):
        t_ag.apply_afterglow(_t(np.ones((3, 2))), [0.6, 0.5], [0.1, 0.1])


@pytest.mark.parametrize("warm", [False, True])
def test_afterglow_matches_jax_on_integer_counts(warm):
    """Integer counts become float (the trap fractions would truncate)."""
    x = (np.arange(40 * 8).reshape(40, 8) % 17 + 3) * 1000
    a, b = [0.04, 0.01], t_ag.decay_per_view([1.5, 9.0], 1.0)
    want = np.asarray(j_ag.apply_afterglow(jnp.asarray(x), a, b,
                                           warm_start=warm))
    got = t_ag.apply_afterglow(_t(x), a, b, warm_start=warm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    back = t_ag.correct_afterglow(got, a, b, warm_start=warm)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5)


# ---------------------------------------------------------------- rings

def test_gains_calibration_and_ring_correction_match_jax():
    rng = np.random.default_rng(4)
    g = (1 + 0.01 * rng.standard_normal(96)).astype(np.float32)
    x = _counts()
    np.testing.assert_allclose(
        t_rings.apply_channel_gains(_t(x), _t(g)).numpy(),
        np.asarray(j_rings.apply_channel_gains(jnp.asarray(x),
                                               jnp.asarray(g))), rtol=1e-7)
    air = np.broadcast_to(1e5 * g, (64, 96)).astype(np.float32)
    np.testing.assert_allclose(
        t_rings.air_calibration_gains(_t(air), 1e5).numpy(),
        np.asarray(j_rings.air_calibration_gains(jnp.asarray(air), 1e5)),
        rtol=1e-6)
    log = -np.log(x / 1.2e5).astype(np.float32) + np.log(g)  # 48 views
    for hw in (1, 2):
        np.testing.assert_allclose(
            t_rings.ring_correct_sinogram(_t(log), half_width=hw).numpy(),
            np.asarray(j_rings.ring_correct_sinogram(jnp.asarray(log),
                                                     half_width=hw)),
            rtol=0, atol=1e-6)


def test_defects_detection_and_inpainting_match_jax():
    x = _counts()
    dead = [3, 50]
    want = np.asarray(j_rings.apply_channel_defects(jnp.asarray(x),
                                                    dead=dead))
    got = t_rings.apply_channel_defects(_t(x), dead=dead)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)
    rng = np.random.default_rng(6)
    air = np.tile(_counts((1, 96))[0], (64, 1)) * (
        1 + 0.003 * rng.standard_normal((64, 96))).astype(np.float32)
    air[:, 10] *= 0.1
    air[::2, 20] *= 1.5  # a flickering channel
    bad = np.asarray(j_rings.detect_defective_channels(jnp.asarray(air)))
    assert bad[10] and bad[20]
    np.testing.assert_array_equal(
        t_rings.detect_defective_channels(_t(air)).numpy(), bad)
    log = -np.log(got.numpy() / 1.2e5)
    np.testing.assert_allclose(
        t_rings.inpaint_defective_channels(_t(log), _t(bad)).numpy(),
        np.asarray(j_rings.inpaint_defective_channels(jnp.asarray(log),
                                                      bad)),
        rtol=1e-6, atol=1e-6)


def test_random_gains_and_flicker_have_the_model_statistics():
    g = t_rings.sample_channel_gains(7, 20000, sigma=0.01, device="cpu")
    assert g.device.type == "cpu" and g.dtype == torch.float32
    assert abs(float(g.mean()) - 1.0) < 5 * 0.01 / np.sqrt(20000)
    assert abs(float(g.std()) / 0.01 - 1.0) < 5 * np.sqrt(0.5 / 20000)
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(g, t_rings.sample_channel_gains(gen, 20000,
                                                       sigma=0.01))
    d = t_rings.sample_channel_gains(8, 64, sigma=0.0, drift=0.02,
                                     device="cpu")
    assert 0.97 < float(d.min()) and float(d.max()) < 1.03
    x = np.ones((4000, 6), np.float32)
    f = t_rings.apply_channel_defects(x, flicker=[1], flicker_sigma=0.2,
                                      generator=3, device="cpu")
    assert torch.equal(f[:, [0, 2, 3, 4, 5]], torch.ones(4000, 5))
    assert abs(float(f[:, 1].std()) / 0.2 - 1.0) < 5 * np.sqrt(0.5 / 4000)
    with pytest.raises(ValueError, match="flicker"):
        t_rings.apply_channel_defects(x, flicker=[1], device="cpu")


# ---------------------------------------------------------------- MAR

def test_interpolation_matches_jax():
    rng = np.random.default_rng(5)
    s = rng.random((6, 40)).astype(np.float32)
    m = rng.random((6, 40)) < 0.3
    m[1, :5] = True  # edge run
    m[2, -7:] = True
    m[3] = True  # fully masked view
    m[4] = False
    want = np.asarray(j_mar.interpolate_sinogram(jnp.asarray(s),
                                                 jnp.asarray(m)))
    got = t_mar.interpolate_sinogram(_t(s), _t(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    prior = (1.0 + rng.random((6, 40))).astype(np.float32)
    np.testing.assert_allclose(
        t_mar.nmar_sinogram(_t(s), _t(m), _t(prior)).numpy(),
        np.asarray(j_mar.nmar_sinogram(jnp.asarray(s), jnp.asarray(m),
                                       jnp.asarray(prior))),
        rtol=1e-6, atol=1e-7)
    assert torch.equal(t_mar.li_mar_sinogram(_t(s), _t(m)), got)


_MAR = {}


def _mar_scan():
    """The JAX MAR test's implant (a titanium rod in a water body) at 64^2,
    a 96 x 96 fan at 120 kV."""
    if not _MAR:
        ti = Material("titanium", 4.506, "Ti(100.0)")
        n, dx = 64, 0.5
        ys = (np.arange(n) + 0.5 - n / 2) * dx
        lab = (np.hypot(ys[None, :], ys[:, None]) <= 10.0).astype(np.uint8)
        lab[np.hypot(ys[None, :] - 3.0, ys[:, None]) <= 1.0] = 2
        ph = VoxelPhantom("imp", lab, MaterialTable([AIR, WATER, ti]), dx,
                          dx, dx)
        jct, tct = _fan(96, 96, gamma_fan=0.9, h_iso=0.1)
        spec = kramers_spectrum(120.0)
        spec.rescale_counts(1e6)
        _MAR.update(jct=jct, tct=tct, spec=spec,
                    log=np.array(get_sino(jct, ph, spec)[1]))
    return _MAR


@pytest.mark.parametrize("method", ["li", "nmar"])
def test_mar_recon_matches_jax(method):
    c = _mar_scan()
    r_w, hu_w, d_w = j_mar.mar_recon(c["log"], c["jct"], c["spec"], 64,
                                     32.0, 0.8, method=method)
    r_g, hu_g, d_g = t_mar.mar_recon(c["log"], c["tct"], c["spec"], 64,
                                     32.0, 0.8, method=method, device="cpu")
    assert hu_g.device.type == "cpu"
    np.testing.assert_array_equal(d_g["metal_mask"].numpy(),
                                  np.asarray(d_w["metal_mask"]))
    trace_w = np.asarray(d_w["trace"])
    assert trace_w.any()
    assert (d_g["trace"].numpy() != trace_w).mean() < 1e-3
    np.testing.assert_allclose(hu_g.numpy(), np.asarray(hu_w), rtol=0,
                               atol=1.0)


def test_mar_without_metal_passes_through():
    c = _mar_scan()
    log = np.minimum(c["log"], 0.5)  # no implant-strength rays
    r, hu, diag = t_mar.mar_recon(log, c["tct"], c["spec"], 64, 32.0, 0.8,
                                  threshold_HU=1e9, device="cpu")
    assert diag["trace"] is None and not bool(diag["metal_mask"].any())


# ---------------------------------------------------------------- low dose

def test_low_dose_statistics_and_ratio():
    jct, tct = _fan()
    s = kramers_spectrum(80.0)
    assert t_ld.quantum_var_ratio(s, tct) == j_ld.quantum_var_ratio(s, jct)
    gen = torch.Generator().manual_seed(2)
    y = np.full(20000, 50.0, np.float32)
    thin = t_ld.synthesize_low_dose(gen, y, 0.3, device="cpu")
    assert thin.device.type == "cpu"
    assert torch.equal(thin, thin.round())  # binomial thinning
    se = np.sqrt(50 * 0.3 * 0.7 / 20000)
    assert abs(float(thin.mean()) - 15.0) < 5 * se
    big = t_ld.synthesize_low_dose(gen, np.full(20000, 1e7, np.float32),
                                   0.25, device="cpu")
    assert abs(float(big.std()) / np.sqrt(1e7 * 0.25 * 0.75) - 1) < 0.03
    vq = np.full(20000, 4e6, np.float32)
    comp = t_ld.synthesize_low_dose(gen, np.full(20000, 1e6, np.float32),
                                    0.5, mode="compound", var_q=vq,
                                    sigma_e=300.0, sigma_e0=100.0,
                                    device="cpu")
    var_want = 0.25 * 4e6 + 300.0 ** 2 - 0.25 * 100.0 ** 2
    assert abs(float(comp.mean()) - 5e5) < 5 * np.sqrt(var_want / 20000)
    assert abs(float(comp.var()) / var_want - 1) < 5 * np.sqrt(2 / 20000)
    with pytest.raises(ValueError, match="electronic"):
        t_ld.synthesize_low_dose(gen, y, 0.5, sigma_e=1.0, device="cpu")
    with pytest.raises(ValueError, match="var_q"):
        t_ld.synthesize_low_dose(gen, y, 0.5, mode="compound",
                                 device="cpu")
    with pytest.raises(ValueError, match="fraction"):
        t_ld.synthesize_low_dose(gen, y, 1.5, device="cpu")


# ---------------------------------------------------------------- truncation

@pytest.mark.parametrize("n_pad", [None, 16])
def test_truncation_completion_matches_jax(n_pad):
    ph = water_cylinder_phantom(N=64, dx=0.5)
    yy, xx = np.mgrid[0:64, 0:64]
    ell = (((xx - 31.5) / 28.8) ** 2 + ((yy - 31.5) / 17.9) ** 2) <= 1
    ph = dataclasses.replace(ph, labels=ell.astype(np.uint8)[None])
    jct, tct = _fan(64, 64, gamma_fan=0.42)
    s = kramers_spectrum(80.0)
    s.rescale_counts(jct.A_iso * 10.0 / jct.N_proj)
    log = np.array(get_sino(jct, ph, s)[1])
    assert t_tr.truncation_severity(log) == j_tr.truncation_severity(log)
    want, wct = j_tr.pad_truncated_sinogram(log, jct, n_pad=n_pad)
    got, gct = t_tr.pad_truncated_sinogram(log, tct, n_pad=n_pad,
                                           device="cpu")
    assert got.shape == want.shape and gct.N_channels == wct.N_channels
    assert gct.gamma_fan == wct.gamma_fan
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- aperture

def test_aperture_paths_and_counts_match_jax():
    n, dxp = 64, 0.3
    x = (np.arange(n) + 0.5 - n / 2) * dxp
    r = np.hypot(x[None, :], x[:, None])
    lab = (r <= 0.4 * n * dxp).astype(np.uint8)
    lab[np.hypot(x[None, :] - 2.0, x[:, None] - 2.0) <= 1.2] = 2
    ph = VoxelPhantom("wb", lab, MaterialTable([AIR, WATER, BONE]), dxp,
                      dxp, dxp)
    jct, tct = _fan(96, 32, eid=False)
    want = np.array(j_ap.finite_aperture_paths(ph, jct, n_sub=3))
    got = t_ap.finite_aperture_paths(ph, tct, n_sub=3, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    s = kramers_spectrum(80.0)
    s.rescale_counts(1e5)
    mu = ph.materials.mu_table(s.E).astype(np.float32)
    i0 = (s.I0 * s.bin_widths()).astype(np.float32)
    np.testing.assert_allclose(
        t_ap.aperture_counts(_t(want), mu, i0).numpy(),
        np.asarray(j_ap.aperture_counts(jnp.asarray(want), jnp.asarray(mu),
                                        jnp.asarray(i0))), rtol=1e-5)
    np.testing.assert_allclose(
        t_ap.nlpv_bias_sinogram(_t(want), mu, i0).numpy(),
        np.asarray(j_ap.nlpv_bias_sinogram(jnp.asarray(want),
                                           jnp.asarray(mu),
                                           jnp.asarray(i0))),
        rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="n_sub"):
        t_ap.finite_aperture_paths(ph, tct, n_sub=0, device="cpu")


# ---------------------------------------------------------------- denoise

def test_anticorrelated_denoise_matches_jax():
    rng = np.random.default_rng(9)
    m1, m2 = (rng.random((32, 32)).astype(np.float32) for _ in range(2))
    v1 = (1 + rng.random((32, 32))).astype(np.float32)
    v2 = (0.5 + rng.random((32, 32))).astype(np.float32)
    c12 = (-0.5 * np.sqrt(v1 * v2)).astype(np.float32)
    np.testing.assert_array_equal(t_dn.gaussian_kernel(1.7),
                                  j_dn.gaussian_kernel(1.7))
    np.testing.assert_allclose(
        t_dn.high_noise_direction(v1, v2, c12, device="cpu").numpy(),
        np.asarray(j_dn.high_noise_direction(v1, v2, c12)), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        t_dn.smooth_separable(m1, 2.0, device="cpu").numpy(),
        np.asarray(j_dn.smooth_separable(jnp.asarray(m1), 2.0)), rtol=1e-5)
    got = t_dn.anticorrelated_denoise(m1, m2, v1, v2, c12, sigma_px=2.0,
                                      device="cpu")
    want = j_dn.anticorrelated_denoise(m1, m2, v1, v2, c12, sigma_px=2.0)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    a = rng.random((8, 24, 2)).astype(np.float32)
    cov = np.zeros((8, 24, 2, 2), np.float32)
    cov[..., 0, 0], cov[..., 1, 1] = 2.0, 1.0
    cov[..., 0, 1] = cov[..., 1, 0] = -1.2
    np.testing.assert_allclose(
        t_dn.anticorrelated_denoise_sinos(a, cov, sigma_ch=1.5,
                                          device="cpu").numpy(),
        np.asarray(j_dn.anticorrelated_denoise_sinos(jnp.asarray(a),
                                                     jnp.asarray(cov),
                                                     sigma_ch=1.5)),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------ numpy input on the CPU

ENTRY_POINTS = {
    "apply_detector_mtf": lambda x: t_mtf.apply_detector_mtf(
        x, np.array([0.25, 0.5, 0.25]), device="cpu"),
    "wiener_restore_channels": lambda x: t_mtf.wiener_restore_channels(
        x, np.array([0.25, 0.5, 0.25]), device="cpu"),
    "recorded_rate": lambda x: t_pu.recorded_rate(1e-6 * x, device="cpu"),
    "true_rate": lambda x: t_pu.true_rate(1e-7 * x, device="cpu"),
    "apply_pileup_bins": lambda x: t_pu.apply_pileup_bins(
        x[:2], 1e-7, np.ones((2, 2, 2)) / 2, device="cpu"),
    "correct_pileup_bins": lambda x: t_pu.correct_pileup_bins(
        x[:2], 1e-7, np.ones((2, 2, 2)) / 2, device="cpu"),
    "apply_afterglow": lambda x: t_ag.apply_afterglow(x, [0.1], [0.5],
                                                      device="cpu"),
    "correct_afterglow": lambda x: t_ag.correct_afterglow(x, [0.1], [0.5],
                                                          device="cpu"),
    "apply_channel_gains": lambda x: t_rings.apply_channel_gains(
        x, np.ones(x.shape[-1], np.float32), device="cpu"),
    "air_calibration_gains": lambda x: t_rings.air_calibration_gains(
        x, 1e5, device="cpu"),
    "ring_correct_sinogram": lambda x: t_rings.ring_correct_sinogram(
        np.log(x), device="cpu"),
    "apply_channel_defects": lambda x: t_rings.apply_channel_defects(
        x, dead=[2], device="cpu"),
    "detect_defective_channels": lambda x:
        t_rings.detect_defective_channels(x, device="cpu"),
    "inpaint_defective_channels": lambda x:
        t_rings.inpaint_defective_channels(
            x, np.arange(x.shape[-1]) == 3, device="cpu"),
    "segment_metal": lambda x: t_mar.segment_metal(x, device="cpu"),
    "interpolate_sinogram": lambda x: t_mar.interpolate_sinogram(
        x, x > 9e4, device="cpu"),
    "pad_truncated_sinogram": lambda x: t_tr.pad_truncated_sinogram(
        np.log(x), TFan(N_channels=x.shape[-1], N_proj=x.shape[0]),
        n_pad=8, device="cpu")[0],
    "smooth_separable": lambda x: t_dn.smooth_separable(x, 1.0,
                                                        device="cpu"),
    "synthesize_low_dose": lambda x: t_ld.synthesize_low_dose(
        torch.Generator(), x, 0.5, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_numpy_input_with_cpu_device_stays_on_the_cpu(name):
    out = ENTRY_POINTS[name](_counts((12, 24)))
    assert torch.is_tensor(out) and out.device.type == "cpu"
