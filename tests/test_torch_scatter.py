"""The port's kernel-superposition scatter model (``ops/scatter.py``)
against the JAX package's, on the CPU.

Inputs: the JAX tests' 64^2 water cylinder under a 96-channel, 128-view
fan at 80 kV (counts from the JAX package, fed to both), and a random
[6, 8, 32] cone sinogram with a row kernel.  Tolerances: the kernel equal
to the bit (the same float64 NumPy); measured and corrected counts within
1e-5 relative (float32 correlations summed in another order, over 121 and
181 taps); the scatter fraction within 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dexct_tpu.ops import scatter as jsc
from dexct_tpu.ops import spectral as j_spectral
from dexct_tpu.physics import kramers_spectrum as j_kramers
from dexct_tpu.pipeline.api import get_sino
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import water_cylinder_phantom as j_cyl
from dexct_tpu_torch.ops import scatter as tsc


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_SCAN = {}


def _scan():
    """The JAX test's 80 kV counts [128, 96] and air level."""
    if not _SCAN:
        ct = JFan(N_channels=96, N_proj=128, gamma_fan=0.8230337, SID=60.0,
                  SDD=100.0, eid=True)
        s = j_kramers(80.0)
        s.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
        raw, _ = get_sino(ct, j_cyl(N=64, dx=0.35), s)
        _SCAN["raw"] = np.asarray(raw, np.float32)
        _SCAN["air"] = float(np.sum(j_spectral.effective_fluence(s, ct)))
    return _SCAN["raw"], _SCAN["air"]


@pytest.mark.parametrize("n,sigma", [(96, 40.0), (96, 20.0), (8, 2.0),
                                     (32, 30.5)])
def test_scatter_kernel_equals_jax(n, sigma):
    got = tsc.scatter_kernel(n, sigma_ch=sigma)
    want = jsc.scatter_kernel(n, sigma_ch=sigma)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(spr=0.4), dict(spr=0.5, grid_p=1.0,
                                                    grid_s=1.0)])
def test_add_and_correct_scatter_match_jax(kw):
    """The fan scan: measured counts, the fixed-point correction at 2 and
    4 iterations, and the scatter fraction."""
    raw, air = _scan()
    k = jsc.scatter_kernel(96, sigma_ch=30.0)
    want = np.asarray(jsc.add_scatter(jnp.asarray(raw), air,
                                      jnp.asarray(k), **kw))
    got = tsc.add_scatter(torch.as_tensor(raw), air, k, **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    corr = {key: kw[key] for key in ("grid_p", "grid_s") if key in kw}
    for n_iters in (2, 4):
        cw = np.asarray(jsc.correct_scatter(jnp.asarray(want), air,
                                            jnp.asarray(k), spr=kw["spr"],
                                            n_iters=n_iters, **corr))
        cg = tsc.correct_scatter(torch.as_tensor(want), air, k,
                                 spr=kw["spr"], n_iters=n_iters, **corr)
        np.testing.assert_allclose(cg.numpy(), cw, rtol=1e-5)
    gp = kw.get("grid_p", 0.95)
    assert abs(tsc.scatter_fraction(got, torch.as_tensor(raw), gp)
               - jsc.scatter_fraction(jnp.asarray(want), jnp.asarray(raw),
                                      gp)) < 1e-5


@pytest.mark.parametrize("row_kernel", [False, True])
def test_cone_scatter_matches_jax(row_kernel):
    """[V, R, C] counts with and without the row kernel, a per-channel air
    level, and the 4-iteration round trip of the JAX test."""
    rng = np.random.default_rng(0)
    primary = rng.uniform(50.0, 900.0, (6, 8, 32)).astype(np.float32)
    air = np.full(32, 1000.0, np.float32)
    air[::5] = 1100.0
    k_c = jsc.scatter_kernel(32, sigma_ch=8.0)
    k_r = jsc.scatter_kernel(8, sigma_ch=2.0) if row_kernel else None
    want = np.asarray(jsc.add_scatter(
        jnp.asarray(primary), jnp.asarray(air), jnp.asarray(k_c), spr=0.25,
        row_kernel=None if k_r is None else jnp.asarray(k_r)))
    got = tsc.add_scatter(torch.as_tensor(primary), torch.as_tensor(air),
                          k_c, spr=0.25, row_kernel=k_r)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    back_w = np.asarray(jsc.correct_scatter(
        jnp.asarray(want), jnp.asarray(air), jnp.asarray(k_c), spr=0.25,
        n_iters=4, row_kernel=None if k_r is None else jnp.asarray(k_r)))
    back = tsc.correct_scatter(torch.as_tensor(want), torch.as_tensor(air),
                               k_c, spr=0.25, n_iters=4, row_kernel=k_r)
    np.testing.assert_allclose(back.numpy(), back_w, rtol=1e-5)
    np.testing.assert_allclose(back.numpy(), primary, rtol=0.02)


def test_correction_removes_the_modeled_scatter():
    """The JAX test's physics on the port alone: two iterations converge
    to < 1 % and land within 2 % of the true primary on average."""
    raw, air = _scan()
    k = tsc.scatter_kernel(96)
    p = torch.as_tensor(raw)
    meas = tsc.add_scatter(p, air, k, spr=0.3)
    p2 = tsc.correct_scatter(meas, air, k, spr=0.3, n_iters=2)
    p4 = tsc.correct_scatter(meas, air, k, spr=0.3, n_iters=4)
    assert float(torch.max(torch.abs(p4 - p2) / p4)) < 0.01
    assert float(torch.mean(torch.abs(p2 - p) / p)) < 0.02


def test_numpy_counts_run_on_the_requested_device():
    """NumPy counts run on ``device`` ("cpu" here) and give what CPU
    tensors give; with no ``device`` they go to the card, so without one
    they raise."""
    raw, air = _scan()
    k = tsc.scatter_kernel(96, sigma_ch=30.0)
    air_c = np.full(96, air, np.float32)
    meas = tsc.add_scatter(raw, air_c, k, spr=0.3, device="cpu")
    assert meas.device.type == "cpu"
    assert torch.equal(meas, tsc.add_scatter(torch.as_tensor(raw),
                                             torch.as_tensor(air_c), k,
                                             spr=0.3))
    fixed = tsc.correct_scatter(meas.numpy(), air_c, k, spr=0.3,
                                device="cpu")
    assert fixed.device.type == "cpu"
    assert torch.equal(fixed, tsc.correct_scatter(meas, torch.as_tensor(
        air_c), k, spr=0.3))
    assert tsc.scatter_fraction(meas.numpy(), raw, 0.95, device="cpu") \
        == tsc.scatter_fraction(meas, torch.as_tensor(raw), 0.95)
    if not torch.cuda.is_available():
        for call in (lambda: tsc.add_scatter(raw, air_c, k),
                     lambda: tsc.correct_scatter(raw, air, k),
                     lambda: tsc.scatter_fraction(raw, raw)):
            with pytest.raises((RuntimeError, AssertionError)):
                call()
