"""The port's Katsevich chain (``dexct_tpu_torch.ops.katsevich``: the host
tables, K14's and K15's plain versions on the CPU, the whole chain and the
stateless pipeline's Katsevich branch) against the JAX package's.

Tolerances:

- the host tables (``_plan``'s ``Wf``/``Wb``, the Hilbert spectrum, the cone
  weights, the slice grid and every static): exact (atol 0), the same
  float64 NumPy code;
- the fixed-direction derivative times the cone weight (K14's plain
  version): rtol 1e-5 with atol 1e-5 x max for the stencil (the same
  float32 operations in the same order; the JAX eager program and torch
  round alike, up to FMA contraction) and atol 2e-5 x max for the spectral
  derivative, whose FFTs are pocketfft here and XLA's in JAX (the bar
  tests/test_torch_fourier.py holds FFT paths to);
- the PI backprojection (K15's plain version, over every view) against
  the JAX program with and without its slice window, linear and cubic:
  rtol 2e-4 with atol 2e-5 x max, the JAX package's bar between its own
  backprojector layouts (tests/test_conebeam.py:807);
- the whole chain: atol 1e-4 x max (three FFT libraries and two float32
  contractions of 16 and 128 terms in another order); the JAX package's
  own bar for this reconstructor is 1-2 % of the true attenuation
  (tests/test_katsevich.py:57, :152);
- ``simulate_cone_dect(recon='katsevich')``: the JAX package's
  fused-vs-stateless bar (tests/test_conebeam.py:616-621).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import katsevich as j_k
from dexct_tpu.system import HelicalConeBeamGeometry, water_cylinder_phantom
from dexct_tpu_torch.ops import katsevich as t_k
from dexct_tpu_torch.system import HelicalConeBeamGeometry as THelix


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _geometries(**kw):
    base = dict(N_channels=48, N_proj=96, N_rows=8, gamma_fan=0.8,
                SID=60.0, SDD=100.0, h_iso=0.5, rotation_total=4 * np.pi,
                pitch=2.0)
    base.update(kw)
    return HelicalConeBeamGeometry(**base), THelix(**base)


def _rel_close(got, want, rel, rtol=0.0):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_host_tables_equal_jax(interp):
    jct, tct = _geometries()
    kw = dict(z_out=None, n_psi=64, taper=None, interp=interp,
              deriv="spectral", ramp=0.8, window="sinc")
    j_arr, j_st = j_k._host_prep((96, 8, 48), jct, 32, 20.0, view_block=8,
                                 dtype=jnp.float32, **kw)
    t_arr, t_st = t_k._host_prep((4, 96, 8, 48), tct, 32, 20.0,
                                 device="cpu", **kw)
    want = t_k.katsevich_arrays_from_numpy(
        {k: np.asarray(v) for k, v in j_arr.items()}, "cpu")
    assert set(t_arr) == set(want)
    for k in want:
        torch.testing.assert_close(t_arr[k], want[k], rtol=0, atol=0)
    j_st.pop("view_block")
    assert t_st == j_st


@pytest.mark.parametrize("deriv", ["spectral", "stencil4"])
def test_derivative_plain_matches_jax(deriv):
    """Stages 1-2 on a 4-volume stack: the JAX derivative per volume times
    the chain's cone weight."""
    rng = np.random.default_rng(21)
    g = rng.uniform(0.0, 3.0, (4, 40, 6, 48)).astype(np.float32)
    cosk = rng.uniform(0.9, 1.0, 6).astype(np.float32)
    db, dg = 4 * np.pi / 96, 0.8 / 48
    want = np.stack([np.asarray(j_k._fixed_direction_derivative(
        jnp.asarray(x), db, dg, deriv=deriv) * jnp.asarray(cosk)[None, :,
                                                                 None])
        for x in g])
    got = t_k._fixed_direction_derivative(
        torch.as_tensor(g), torch.as_tensor(cosk), db, dg,
        deriv=deriv).numpy()
    assert got.shape == want.shape
    _rel_close(got, want, 2e-5 if deriv == "spectral" else 1e-5,
               rtol=1e-5)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("slice_window", [False, True])
def test_katsevich_backproject_plain_matches_jax(interp, slice_window):
    """A 2-turn helix, 13 slices reaching past both scan ends (the JAX slice
    window is active at this length), against the JAX program per
    volume."""
    jct, _ = _geometries()
    rng = np.random.default_rng(22)
    gf = rng.standard_normal((2, 96, 8, 48)).astype(np.float32)
    db = float(jct.betas[1] - jct.betas[0])
    nz = 13
    args = (60.0, jct.dgamma, 0.5, 8, 2.0, 32, nz, 20.0, 0.5, -3.0,
            float(0.5 * jct.rotation_total), db, 0.25)
    arrs = [np.asarray(a, np.float32) for a in (jct.betas, jct.source_z)]
    want = np.stack([np.asarray(j_k._katsevich_backproject(
        jnp.asarray(x), *(jnp.asarray(a) for a in arrs), *args,
        interp=interp, slice_window=slice_window)) for x in gf])
    got = t_k._katsevich_backproject(
        torch.as_tensor(gf), *(torch.as_tensor(a) for a in arrs), *args,
        interp=interp).numpy()
    assert got.shape == want.shape == (2, nz, 32, 32)
    assert np.abs(want).max() > 0
    _rel_close(got, want, 2e-5, rtol=2e-4)


@pytest.mark.parametrize("kw", [{}, dict(interp="cubic", deriv="stencil4",
                                          n_psi=96)],
                         ids=["default", "cubic-stencil4"])
def test_katsevich_reconstruct_matches_jax(kw):
    """The whole chain on a helical water-cylinder sinogram (stacked twice,
    once scaled: one chain and one backprojection serve both)."""
    jct, tct = _geometries()
    ph2 = water_cylinder_phantom(N=40, dx=0.5)
    ph3 = dataclasses.replace(
        ph2, labels=np.broadcast_to(ph2.labels[0], (16, 40, 40)).copy(),
        dz=0.5)
    from dexct_tpu_torch.ops.conebeam import cone_material_paths

    paths = cone_material_paths(ph3, tct, device="cpu").numpy()
    sino = (paths @ np.array([0.0, 0.2], np.float32)).astype(np.float32)
    want = np.asarray(j_k.katsevich_reconstruct(jnp.asarray(sino), jct, 32,
                                                20.0, **kw))
    got = t_k.katsevich_reconstruct(
        torch.as_tensor(np.stack([sino, 2.0 * sino])), tct, 32, 20.0,
        **kw).numpy()
    assert got.shape == (2,) + want.shape
    _rel_close(got[0], want, 1e-4)
    _rel_close(got[1], 2.0 * want, 1e-4)
    # water (0.2 /cm) inside the cylinder: 5.7 % low at this coarse
    # sampling (48 views a turn, 8 rows) on both sides
    inner = np.abs(got[0][:, 12:20, 12:20].mean() / 0.2 - 1.0)
    assert inner < 0.1, inner


@pytest.mark.parametrize("change", ["pitch0", "td_window", "zffs", "short"])
def test_katsevich_refuses_what_jax_refuses(change):
    kw = {"pitch0": dict(pitch=0.0), "td_window": dict(pitch=9.0),
          "zffs": dict(ffs="z"),
          "short": dict(rotation_total=1.2 * np.pi, N_proj=32)}[change]
    jct, tct = _geometries(**kw)
    V = jct.N_proj
    with pytest.raises(ValueError) as j_err:
        j_k.katsevich_reconstruct(jnp.zeros((V, 8, 48)), jct, 32, 20.0)
    with pytest.raises(ValueError) as t_err:
        t_k.katsevich_reconstruct(torch.zeros((V, 8, 48)), tct, 32, 20.0)
    assert str(t_err.value) == str(j_err.value)


def test_simulate_cone_dect_katsevich_matches_jax():
    from dexct_tpu.ops.conebeam import simulate_cone_dect as j_sim
    from dexct_tpu.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.ops.conebeam import simulate_cone_dect as t_sim

    jct, tct = _geometries(N_channels=40, N_proj=48, N_rows=4)
    ph2 = water_cylinder_phantom(N=32, dx=0.6)
    ph3 = dataclasses.replace(
        ph2, labels=np.broadcast_to(ph2.labels[0], (8, 32, 32)).copy(),
        dz=0.5)
    s1 = linac_spectrum()
    s1.rescale_counts(jct.A_iso * 9.0 / jct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(jct.A_iso * 1.0 / jct.N_proj)
    want = j_sim(jct, ph3, s1, s2, 24, 18.0, 0.8, n_iters=8,
                 recon="katsevich")
    got = t_sim(tct, ph3, s1, s2, 24, 18.0, 0.8, device="cpu", n_iters=8,
                recon="katsevich")
    tol = {"sino_log": dict(rtol=0.0, atol=2e-3),
           "recon_HU": dict(rtol=0.0, atol=2.0),
           "mat_recons": dict(rtol=0.0, atol=5e-3)}
    for key, kw in tol.items():
        for i in range(2):
            assert got[key][i].shape == np.shape(want[key][i])
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **kw)
