"""The port's parameter sweeps (``dexct_tpu_torch.pipeline.sweep``) against
the JAX package's, on the CPU, on the 64^2 water cylinder pack of
tests/test_sweep.py fed to both through ``arrays_from_numpy``.

Noiseless sweeps are held to the JAX outputs at the tolerances of
tests/test_torch_pipeline.py (recon_HU atol 1 HU, mat_sinos and mat_recons
atol 1e-3, the other step outputs as there).  The noise draws differ by
construction (a ``torch.Generator`` per grid point against a split JAX
key), so the noisy sweep is held to tests/test_sweep.py's statistics, and
to the port's own seed convention: point i draws the same noise whatever
the length of the grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops.filters import filter_frequency_response
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline import sweep as j_sweep
from dexct_tpu.pipeline.fused import pack_dect as j_pack
from dexct_tpu.system import FanBeamGeometry, water_cylinder_phantom
from dexct_tpu_torch.pipeline import fused as t_fused
from dexct_tpu_torch.pipeline import sweep as t_sweep

TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
       "sino_log": dict(rtol=0.0, atol=1e-4),
       "mat_sinos": dict(rtol=0.0, atol=1e-3),
       "recon_raw": dict(rtol=0.0, atol=1e-4),
       "recon_HU": dict(rtol=0.0, atol=1.0),
       "mat_recons": dict(rtol=0.0, atol=1e-3)}
# small parallel grid for the 64-channel scan
PAR_KW = dict(recon_n_theta=96, recon_nt=128)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def geometry():
    """tests/test_sweep.py's scan."""
    ct = FanBeamGeometry(N_channels=64, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    ph = water_cylinder_phantom(N=64, dx=0.35)
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return ct, ph, s1, s2


def _packs(geometry, recon):
    ct, ph, s1, s2 = geometry
    kw = PAR_KW if recon == "parallel" else {}
    arrays, meta = j_pack(ct, ph, s1, s2, 64, 20.0, 0.8, n_iters=12,
                          recon=recon, **kw)
    a = t_fused.arrays_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, "cpu")
    m = t_fused.DectMeta(**{f: getattr(meta, f) for f in
                            t_fused.DectMeta._fields if hasattr(meta, f)})
    return (arrays, meta), (a, m)


@pytest.fixture(scope="module")
def packs(geometry):
    return {recon: _packs(geometry, recon) for recon in ("fan", "parallel")}


def _ramps(ct, values):
    return np.stack([filter_frequency_response(ct.N_channels, ct.dgamma, r,
                                               "sinc", "fan")[0]
                     for r in values]).astype(np.float32)


@pytest.mark.parametrize("recon", ["fan", "parallel"])
def test_dose_sweep_matches_jax(packs, recon):
    (arrays, meta), (a, m) = packs[recon]
    scales = np.array([0.5, 2.0], np.float32)
    want = j_sweep.dose_sweep(arrays, meta, jnp.asarray(scales),
                              jax.random.PRNGKey(0), noise="none")
    got = t_sweep.dose_sweep(a, m, scales, 0, noise="none")
    assert got["recon_HU"].shape == (2, 2, 64, 64)
    assert got["mat_sinos"].shape == (2, 2, 96, 64)
    for key in ("recon_HU", "mat_recons", "mat_sinos"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL[key])
    # without noise the HU images are dose-independent
    np.testing.assert_allclose(got["recon_HU"][0].numpy(),
                               got["recon_HU"][1].numpy(), atol=0.3)


@pytest.mark.parametrize("recon", ["fan", "parallel"])
def test_ramp_sweep_matches_jax(packs, geometry, recon):
    """Fan-beam FBPs whatever the pack's recon, as in the JAX function; the
    sharper ramp gives the sharper edge (tests/test_sweep.py)."""
    (arrays, meta), (a, m) = packs[recon]
    H = _ramps(geometry[0], (0.3, 1.0))
    want = np.asarray(j_sweep.ramp_sweep(arrays, meta, jnp.asarray(H)))
    got = t_sweep.ramp_sweep(a, m, H).numpy()
    assert got.shape == (2, 2, 64, 64)
    np.testing.assert_allclose(got, want, **TOL["recon_HU"])
    edge = lambda img: np.abs(np.diff(img[32])).max()
    assert edge(got[1, 1]) > 1.3 * edge(got[0, 1])


def test_slice_sweep_matches_jax(packs):
    (arrays, meta), (a, m) = packs["fan"]
    base = np.asarray(arrays["labels"])
    vol = np.stack([base, np.zeros_like(base), np.roll(base, 5, axis=1)])
    want = j_sweep.slice_sweep(arrays, meta, jnp.asarray(vol))
    got = t_sweep.slice_sweep(a, m, vol)
    assert set(got) == set(want)
    for key, tol in TOL.items():
        for i in range(2):
            assert got[key][i].shape[0] == 3
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **tol)
    # slice 0 is the single-slice step, bit for bit
    single = t_fused.dect_step(a, m)
    assert torch.equal(got["recon_HU"][0][0], single["recon_HU"][0])
    assert float(got["recon_HU"][0][1].mean()) < -900.0


def test_dose_sweep_noise_falls_with_dose(packs):
    """Compound (EID) noise: image noise falls ~1/sqrt(dose), as
    tests/test_sweep.py asks of the JAX sweep."""
    _, (a, m) = packs["fan"]
    out = t_sweep.dose_sweep(a, m, [1e-5, 16e-5], 0, noise="compound")
    clean = t_sweep.dose_sweep(a, m, [1.0], 0,
                               noise="none")["recon_HU"][0].numpy()
    hu = out["recon_HU"].numpy()
    roi = np.s_[24:40, 24:40]
    lo = (hu[0, 1] - clean[1])[roi].std()
    hi = (hu[1, 1] - clean[1])[roi].std()
    assert lo > 2.0 * hi > 0.0


@pytest.mark.parametrize("key", ["int", "generator"])
def test_point_noise_does_not_depend_on_grid_length(packs, key):
    _, (a, m) = packs["fan"]

    def run(scales):
        k = 7 if key == "int" else torch.Generator().manual_seed(7)
        return t_sweep.dose_sweep(a, m, scales, k, noise="compound")

    short = run([1e-5, 4e-5])
    long = run([1e-5, 4e-5, 16e-5])
    for name in ("mat_sinos", "recon_HU"):
        assert torch.equal(short[name], long[name][:2])
    # and the two points draw differently
    noisy = short["mat_sinos"]
    assert not torch.equal(noisy[0] / 1e-5, noisy[1] / 4e-5)


def test_sharded_entry_points_raise(packs):
    _, (a, m) = packs["fan"]
    with pytest.raises(NotImplementedError, match="item 15"):
        t_sweep.sweep_mesh(8)
    with pytest.raises(NotImplementedError, match="item 15"):
        t_sweep.sharded_dose_sweep(None, a, m, [1.0, 2.0], 0)
