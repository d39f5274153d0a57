"""The port's beam-hardening correction (ops/bhc.py, plain versions on the
CPU) against the JAX package's.

The calibration fits are host float64 NumPy copied from the JAX package;
their coefficients agree to rtol 1e-12 (the same operations on the same
inputs).  The corrections and reconstructions run in float32 on the
device: the Horner evaluation to rtol 1e-6, the water- and bone-BHC images
to tests/test_torch_pipeline.py's TOL (recon_raw 1e-4 cm^-1, recon_HU 1
HU), on a water cylinder with two bone rods (tests/test_bhc.py's phantom at
64^2); the bone pass reprojects through the Fourier projector at the
JAX default n_theta = 768."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import bhc as j_bhc
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.physics.materials import AIR, BONE, MaterialTable, WATER
from dexct_tpu.pipeline import get_sino
from dexct_tpu.system import FanBeamGeometry, VoxelPhantom
from dexct_tpu_torch.ops import bhc as t_bhc
from test_torch_pipeline import REPO, _both_clis, _tiny_params

N = 64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spectrum(kind, ct):
    spec = kramers_spectrum(80.0) if kind == "80kV" else linac_spectrum()
    spec.rescale_counts(ct.A_iso * 5.0 / ct.N_proj)
    return spec


@pytest.fixture(scope="module")
def bone_scan():
    """Water cylinder (11 cm) with two bone rods, 64^2 at 0.4 cm; 96 x 96
    fan scan."""
    labels = np.zeros((N, N), np.uint8)
    yy, xx = np.mgrid[0:N, 0:N]
    labels[np.hypot(yy - 31.5, xx - 31.5) * 0.4 < 11.0] = 1
    for cx in (20, 44):
        labels[np.hypot(yy - 31.5, xx - cx) * 0.4 < 2.2] = 2
    ph = VoxelPhantom("bones", labels, MaterialTable([AIR, WATER, BONE]),
                      0.4, 0.4, 0.4)
    ct = FanBeamGeometry(N_channels=96, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    return ph, ct


@pytest.mark.parametrize("kind", ["80kV", "detunedMV"])
def test_fit_water_bhc_matches_jax(bone_scan, kind):
    _, ct = bone_scan
    spec = _spectrum(kind, ct)
    want = j_bhc.fit_water_bhc(spec, ct)
    got = t_bhc.fit_water_bhc(spec, ct)
    assert got.coeffs.shape == (7,) and got.coeffs[-1] == 0.0
    np.testing.assert_allclose(got.coeffs, want.coeffs, rtol=1e-12, atol=0)
    assert got.mu_eff == pytest.approx(want.mu_eff, rel=1e-12)
    assert got.t_max == want.t_max


def test_fit_water_bhc_from_scan_matches_jax(bone_scan):
    """The spectrum-free fit on a measured water-cylinder scan."""
    _, ct = bone_scan
    spec = _spectrum("80kV", ct)
    ph = VoxelPhantom("w", (np.hypot(*np.mgrid[0:N, 0:N] - 31.5) * 0.4
                            < 10.0).astype(np.uint8),
                      MaterialTable([AIR, WATER]), 0.4, 0.4, 0.4)
    sino = np.array(get_sino(ct, ph, spec)[1])
    want = j_bhc.fit_water_bhc_from_scan(sino, ct, 10.0)
    got = t_bhc.fit_water_bhc_from_scan(torch.as_tensor(sino), ct, 10.0)
    np.testing.assert_allclose(got.coeffs, want.coeffs, rtol=1e-12, atol=0)
    assert (got.mu_eff, got.t_max) == pytest.approx((want.mu_eff,
                                                     want.t_max), rel=1e-12)
    with pytest.raises(ValueError, match="no ray intersects"):
        t_bhc.fit_water_bhc_from_scan(sino, ct, 0.1)  # chords < t_min


def test_apply_water_bhc_matches_jax(bone_scan):
    _, ct = bone_scan
    bhc = t_bhc.fit_water_bhc(_spectrum("80kV", ct), ct)
    sino = np.random.default_rng(4).uniform(0, 8, (96, 96)).astype(
        np.float32)
    want = np.asarray(j_bhc.apply_water_bhc(
        j_bhc.WaterBhc(bhc.coeffs, bhc.mu_eff, bhc.t_max),
        jnp.asarray(sino)))
    got = t_bhc.apply_water_bhc(bhc, torch.as_tensor(sino))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["80kV", "detunedMV"])
@pytest.mark.parametrize("which", ["water", "bone"])
def test_bhc_recon_matches_jax(bone_scan, kind, which):
    ph, ct = bone_scan
    spec = _spectrum(kind, ct)
    sino = np.array(get_sino(ct, ph, spec)[1])
    j_fn = getattr(j_bhc, f"{which}_bhc_recon")
    t_fn = getattr(t_bhc, f"{which}_bhc_recon")
    want_raw, want_hu = j_fn(jnp.asarray(sino), ct, spec, N, 26.0, 0.8)
    got_raw, got_hu = t_fn(torch.as_tensor(sino), ct, spec, N, 26.0, 0.8)
    assert got_raw.shape == (N, N)
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_hu.numpy(), np.asarray(want_hu), rtol=0,
                               atol=1.0)


def test_bhc_cli_matches_jax(tmp_path):
    """--bhc on the tiny config (default path): the 12 files and the water
    and bone BHC images of both spectra, 20 files in all."""
    out = _both_clis(tmp_path, _tiny_params(tmp_path), ["--bhc"], 20)
    names = {p.name for p in (out / "tiny").rglob("*BHC*.bin")}
    assert names == {f"recon_{k}BHC_{u}_float32.bin"
                     for k in ("water", "bone") for u in ("raw", "HU")}


def test_bhc_on_a_cone_config_warns(tmp_path):
    """Cone configs warn and write no BHC files, as the JAX runner does."""
    from dexct_tpu_torch.run import main as t_main

    params = _tiny_params(tmp_path)
    cfg = dict(json.loads(params.read_text()), RUN_ID="tiny_cone",
               scanner_geometry="cone_beam", N_rows=2,
               detector_px_height=0.4, N_channels=32, N_projections=16,
               N_recon_matrix=32)
    params.write_text(json.dumps(cfg))
    with pytest.warns(UserWarning, match="ignored for cone"):
        t_main(["--params", str(params), "--output", str(tmp_path / "o"),
                "--iters", "2", "--device", "cpu", "--bhc", "--spectrum-dir",
                os.path.join(REPO, "input", "spectrum")])
    files = list((tmp_path / "o").rglob("*.bin"))
    assert len(files) == 12 and not [p for p in files if "BHC" in p.name]


def test_bowtie_bhc_is_not_ported_yet(bone_scan):
    """Once refused here, the bowtie water BHC now runs: on this file's
    96-channel fan with an 8-level bowtie its per-channel coefficients
    equal the JAX package's to rtol 1e-12 (host float64), and its Horner
    evaluation on the scan's log sinogram agrees to rtol 1e-6."""
    from dexct_tpu.ops.bowtie import design_flattening_bowtie as j_design
    from dexct_tpu_torch.ops.bowtie import (design_flattening_bowtie as
                                            t_design)
    from dexct_tpu_torch.system import FanBeamGeometry as TFan

    ph, ct = bone_scan
    tct = TFan(N_channels=96, N_proj=96, gamma_fan=0.8230337, SID=60.0,
               SDD=100.0, eid=True)
    spec = _spectrum("80kV", ct)
    jbt, tbt = j_design(ct, 11.0, n_steps=8), t_design(tct, 11.0, n_steps=8)
    want = j_bhc.fit_water_bhc_bowtie(spec, ct, jbt)
    got = t_bhc.fit_water_bhc_bowtie(spec, tct, tbt)
    np.testing.assert_allclose(got.coeffs_ch, want.coeffs_ch, rtol=1e-12,
                               atol=1e-15)
    log = np.array(get_sino(ct, ph, spec, bowtie=jbt)[1])
    np.testing.assert_allclose(got(torch.as_tensor(log)).numpy(),
                               np.asarray(want(jnp.asarray(log))),
                               rtol=1e-6, atol=1e-6)
    by_hand = t_bhc.WaterBhcBowtie(want.coeffs_ch, want.mu_eff, want.t_max)
    assert by_hand.mu_eff == got.mu_eff