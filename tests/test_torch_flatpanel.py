"""The port's flat-panel FDK (``dexct_tpu_torch.ops.flatpanel``: K13's plain
version on the CPU, the host weights, the whole reconstruction and the
stateless pipeline's flat branch) against the JAX package's.

Tolerances:

- the host tables (offset-detector weights, the panel cosine, the ramp
  spectrum): exact (atol 0), the same float64 NumPy expressions;
- ``_flat_backproject`` against both JAX layouts (``pair_mode``) and
  ``fdk_flat_reconstruct`` under each redundancy mode: rtol 2e-4 with atol
  2e-5 x max, the bar between the JAX package's own cone backprojector
  layouts (tests/test_conebeam.py:807); its flat layouts agree to 1e-6 x max
  (tests/test_flatpanel.py:336), and the port's float32 operations are the
  JAX program's in its order, but the FFT libraries (pocketfft here, XLA's
  in JAX) and the sums' order differ;
- ``flat_cone_sinogram`` and ``simulate_cone_dect`` with ``recon='flat'``
  and ``'auto'``: the JAX package's fused-vs-stateless bar
  (tests/test_conebeam.py:616-621; sino_log atol 2e-3, recon_HU atol 2 HU,
  mat_recons atol 5e-3), since the JAX tracer is its packed dominant-axis
  one and the port's K10.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import flatpanel as j_fp
from dexct_tpu.system import FlatPanelConeBeamGeometry, water_cylinder_phantom
from dexct_tpu_torch.ops import flatpanel as t_fp
from dexct_tpu_torch.system import FlatPanelConeBeamGeometry as TFlat

BP_TOL = dict(rtol=2e-4)
WHOLE_TOL = {"sino_log": dict(rtol=0.0, atol=2e-3),
             "recon_HU": dict(rtol=0.0, atol=2.0),
             "mat_recons": dict(rtol=0.0, atol=5e-3)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _geometries(**kw):
    base = dict(N_channels=48, N_proj=48, N_rows=8, gamma_fan=0.8,
                SID=60.0, SDD=100.0, h_iso=0.5)
    base.update(kw)
    return FlatPanelConeBeamGeometry(**base), TFlat(**base)


def _close(got, want, tol=BP_TOL):
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(),
                               **tol)


@pytest.mark.parametrize("offset", [10.0, -7.5])
@pytest.mark.parametrize("feather", [None, 0.1])
def test_offset_weights_equal_jax(offset, feather):
    jct, tct = _geometries(det_offset_ch=offset)
    np.testing.assert_array_equal(
        t_fp.offset_detector_weights(tct, feather=feather),
        j_fp.offset_detector_weights(jct, feather=feather))


@pytest.mark.parametrize("offset_row", [0.0, 1.5])
def test_flat_filter_tables_equal_jax(monkeypatch, offset_row):
    """The panel cosine and the windowed ramp spectrum (and its FFT length)
    are the JAX program's float32 tables, exactly: read off the JAX
    function's own FFT calls on a sinogram of ones."""
    import jax

    seen = {}

    def rfft(x, n=None, axis=-1):
        seen["w"], seen["m"] = np.asarray(x), n
        return jnp.ones(x.shape[:-1] + (n // 2 + 1,), jnp.complex64)

    def irfft(x, n=None, axis=-1):
        seen["H"] = np.asarray(x)
        return jnp.zeros(x.shape[:-1] + (n,), jnp.float32)

    monkeypatch.setattr(jax.numpy.fft, "rfft", rfft)
    monkeypatch.setattr(jax.numpy.fft, "irfft", irfft)
    monkeypatch.setattr(j_fp, "_flat_backproject", lambda *a, **k: None)
    jct, tct = _geometries(det_offset_row=offset_row)
    j_fp.fdk_flat_reconstruct(jnp.ones((48, 8, 48), jnp.float32), jct, 32,
                              20.0, 0.8)
    w, H, m = t_fp._flat_tables(tct, 0.8)
    assert m == seen["m"]
    np.testing.assert_array_equal(np.broadcast_to(w.astype(np.float32),
                                                  seen["w"].shape), seen["w"])
    assert not seen["H"].imag.any()
    np.testing.assert_array_equal(
        np.broadcast_to(H.astype(np.float32), seen["H"].shape),
        seen["H"].real)


@pytest.mark.parametrize("pair_mode", [False, True])
@pytest.mark.parametrize("n_images", [1, 4])
def test_flat_backproject_plain_matches_jax(pair_mode, n_images):
    """Random filtered stacks, an odd slice count and detector offsets,
    against the JAX program's per-slice and slice-pair layouts."""
    rng = np.random.default_rng(11)
    V, R, C = 36, 8, 48
    shape = (V, R, C) if n_images == 1 else (n_images, V, R, C)
    q = rng.standard_normal(shape).astype(np.float32)
    betas = (np.arange(V) * (2 * np.pi / V)).astype(np.float32)
    args = (60.0, 0.55, 0.5, 0.75, -0.25, R, 32, 7, 20.0, 0.45,
            2 * np.pi / V)
    want = np.asarray(j_fp._flat_backproject(
        jnp.asarray(q), jnp.asarray(betas), *args, pair_mode=pair_mode))
    got = t_fp._flat_backproject(torch.as_tensor(q), torch.as_tensor(betas),
                                 *args, pair_mode=pair_mode).numpy()
    assert got.shape == want.shape == shape[:-3] + (7, 32, 32)
    _close(got, want)


@pytest.mark.parametrize("mode", ["full", "short", "offset"])
def test_fdk_flat_reconstruct_matches_jax(mode):
    """Full orbit, a C-arm short scan (Parker weights) and an
    offset-detector scan (Wang weights, chosen by ``redundancy='auto'``),
    each on a 4-volume stack of random sinograms."""
    kw = {"full": {}, "short": dict(rotation_total=np.pi + 0.8 + 0.3),
          "offset": dict(det_offset_ch=10.0)}[mode]
    jct, tct = _geometries(**kw)
    rng = np.random.default_rng(12)
    sino = rng.uniform(0.0, 2.0, (4, 48, 8, 48)).astype(np.float32)
    want = np.asarray(j_fp.fdk_flat_reconstruct(jnp.asarray(sino), jct, 32,
                                                20.0, 0.8))
    got = t_fp.fdk_flat_reconstruct(torch.as_tensor(sino), tct, 32, 20.0,
                                    0.8).numpy()
    assert got.shape == want.shape == (4, 8, 32, 32)
    _close(got, want)
    one = t_fp.fdk_flat_reconstruct(torch.as_tensor(sino[1]), tct, 32, 20.0,
                                    0.8).numpy()
    np.testing.assert_array_equal(one, got[1])  # one pass = per volume


def test_fdk_flat_refuses_what_jax_refuses():
    _, tct = _geometries()
    sino = torch.zeros((48, 8, 48))
    from dexct_tpu_torch.system import ConeBeamGeometry

    with pytest.raises(ValueError, match="flat-panel path"):
        t_fp.fdk_flat_reconstruct(sino, ConeBeamGeometry(N_rows=8), 32,
                                  20.0, 0.8)
    with pytest.raises(ValueError, match="redundancy"):
        t_fp.fdk_flat_reconstruct(sino, tct, 32, 20.0, 0.8,
                                  redundancy="bogus")
    _, short = _geometries(det_offset_ch=10.0, rotation_total=4.5)
    with pytest.raises(ValueError, match="full 2\\*pi orbit"):
        t_fp.fdk_flat_reconstruct(sino, short, 32, 20.0, 0.8)


def _spectra(ct):
    from dexct_tpu.physics import kramers_spectrum, linac_spectrum

    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return s1, s2


def _water3d():
    ph2 = water_cylinder_phantom(N=32, dx=0.6)
    return dataclasses.replace(
        ph2, labels=np.broadcast_to(ph2.labels[0], (8, 32, 32)).copy(),
        dz=0.5)


def test_flat_cone_sinogram_matches_jax():
    """``flat_cone_sinogram``: the flat panel's rays through K10's plain
    version and the JAX tracer, then the spectral chain; the log sinogram
    at the fused-vs-stateless bar, and a seeded noisy acquisition that
    repeats with its generator."""
    jct, tct = _geometries(N_channels=40, N_proj=24, N_rows=4)
    spec = _spectra(jct)[1]
    want = j_fp.flat_cone_sinogram(_water3d(), jct, spec)
    got = t_fp.flat_cone_sinogram(_water3d(), tct, spec, device="cpu")
    assert got[0].shape == np.shape(want[0]) == (24, 4, 40)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **WHOLE_TOL["sino_log"])
    noisy = [t_fp.flat_cone_sinogram(
        _water3d(), tct, spec, device="cpu", noise="poisson",
        generator=torch.Generator().manual_seed(3))[0] for _ in (0, 1)]
    torch.testing.assert_close(noisy[0], noisy[1], rtol=0, atol=0)
    assert bool((noisy[0] != got[0]).any())


@pytest.mark.parametrize("recon", ["auto", "flat"])
def test_simulate_cone_dect_flat_matches_jax(recon):
    from dexct_tpu.ops.conebeam import simulate_cone_dect as j_sim
    from dexct_tpu_torch.ops.conebeam import simulate_cone_dect as t_sim

    jct, tct = _geometries(N_channels=40, N_proj=24, N_rows=4)
    ph3 = _water3d()
    s = _spectra(jct)
    want = j_sim(jct, ph3, *s, 24, 18.0, 0.8, n_iters=8, recon=recon)
    got = t_sim(tct, ph3, *s, 24, 18.0, 0.8, device="cpu", n_iters=8,
                recon=recon)
    for key, tol in WHOLE_TOL.items():
        for i in range(2):
            assert got[key][i].shape == np.shape(want[key][i]) \
                == ((24, 4, 40) if "sino" in key else (4, 24, 24))
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **tol)
