"""The port's multi-bin, multi-material decomposition (plain version on the
CPU) against the JAX package: ``gauss_newton_solve`` at (M, K) = (4, 2),
(4, 3), (6, 4), with ``method="newton"``, ``lm_damping`` and a
Poisson-MLE warm phase; ``pcd_bin_fluences``, ``decompose_multibin_grid``
and ``image_domain_decomposition``.

Inputs are the JAX tests' (tests/test_multibin.py: a 140 kV Kramers
spectrum on a photon-counting detector, bins straddling the iodine and
gadolinium K-edges, noiseless counts of uniform random area densities).
Each test states its bar; the bars are the JAX tests' own where they have
one.  The JAX solves are module-scope fixtures, shared by the tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import matdecomp as j_md
from dexct_tpu.physics import kramers_spectrum, xcom
from dexct_tpu.physics.detector import photon_counting_response
from dexct_tpu.physics.materials import BONE, TISSUE, Material
from dexct_tpu.system import FanBeamGeometry
from dexct_tpu_torch.ops import matdecomp as t_md

IODINE = Material("iodine solution", 1.1, "H(10.0)O(85.0)I(5.0)")
GD = Material("gadolinium solution", 1.05, "H(10.5)O(88.5)Gd(1.0)")
THR4 = [20.0, 34.0, 50.0, 70.0]
THR6 = [20.0, 34.0, 45.0, 52.0, 65.0, 85.0]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ct(n_channels=64, n_proj=8):
    return FanBeamGeometry(N_channels=n_channels, N_proj=n_proj,
                           gamma_fan=0.8, SID=60.0, SDD=100.0, eid=False,
                           detector=photon_counting_response())


def _spec(ct, dose):
    spec = kramers_spectrum(140.0)
    spec.rescale_counts(ct.A_iso * dose / ct.N_proj)
    return spec


def _synth(i0s, mus, a_true):
    """Noiseless counts [M, P] (float64 forward model)."""
    return (np.exp(-np.clip(a_true @ mus, -700, 700)) @ i0s.T).T.copy()


# name -> (thresholds, basis, dose, seed, pixels, ranges, solver keywords)
CASES = {
    "4bin_2mat": (THR4, (TISSUE, BONE), 10.0, 0, 300,
                  [(0, 30), (0, 8)], dict(n_iters=50)),
    "4bin_3mat": (THR4, (TISSUE, BONE, IODINE), 10.0, 1, 200,
                  [(5, 25), (0, 5), (0, 2)],
                  dict(n_iters=200, step_max=2.0)),
    "6bin_4mat": (THR6, (TISSUE, BONE, IODINE, GD), 20.0, 3, 200,
                  [(5, 25), (0, 5), (0, 2), (0, 2)],
                  dict(n_iters=200, step_max=2.0)),
    "4bin_2mat_newton": (THR4, (TISSUE, BONE), 10.0, 0, 300,
                         [(0, 30), (0, 8)],
                         dict(n_iters=30, method="newton")),
    "4bin_2mat_mle_warm": (THR4, (TISSUE, BONE), 10.0, 0, 300,
                           [(0, 30), (0, 8)], dict(n_iters=40, warm="mle")),
    # every step in float32 (polish_iters = n_iters): the damped iteration
    # is still moving after the default 4 polish steps, where it would keep
    # the bf16 warm phase's rounding instead of the solver's
    "4bin_3mat_lm": (THR4, (TISSUE, BONE, IODINE), 10.0, 1, 200,
                     [(5, 25), (0, 5), (0, 2)],
                     dict(n_iters=60, lm_damping=0.1, step_max=2.0,
                          polish_iters=60)),
    # the log step damped (M == K, all warm steps in float32)
    "2bin_2mat_lm": ([20.0, 60.0], (TISSUE, BONE), 10.0, 0, 300,
                     [(0, 30), (0, 8)],
                     dict(n_iters=40, lm_damping=0.05, polish_iters=0)),
}


def _case(name):
    thr, basis, dose, seed, n, ranges, kw = CASES[name]
    ct = _ct()
    spec = _spec(ct, dose)
    i0s = j_md.pcd_bin_fluences(ct, spec, thr)
    mus = np.stack([xcom.mixatten(m.matcomp, spec.E) for m in basis])
    rng = np.random.default_rng(seed)
    a_true = np.stack([rng.uniform(lo, hi, n) for lo, hi in ranges], -1)
    return _synth(i0s, mus, a_true), i0s, mus, a_true, kw


@pytest.fixture(scope="module")
def solves():
    """Each case's inputs, truth and JAX solution."""
    out = {}
    for name in CASES:
        counts, i0s, mus, a_true, kw = _case(name)
        want = np.asarray(j_md.gauss_newton_solve(
            *(jnp.asarray(x, jnp.float32) for x in (counts, i0s, mus)),
            **kw))
        out[name] = (counts, i0s, mus, a_true, kw, want)
    return out


def _port(counts, i0s, mus, **kw):
    return t_md.gauss_newton_solve(
        *(torch.as_tensor(x, dtype=torch.float32)
          for x in (counts, i0s, mus)), **kw).numpy()


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


@pytest.mark.parametrize("name", ["4bin_2mat", "4bin_2mat_newton",
                                  "4bin_2mat_mle_warm", "4bin_3mat_lm",
                                  "2bin_2mat_lm"])
def test_gauss_newton_matches_jax(solves, name):
    """Converged cases: the port returns JAX's solution within the JAX
    package's float32 parity bar (rel 1e-4, floor 1 g/cm^2,
    tests/test_matdecomp.py); where the solve converges to the truth
    (all but the damped cases) it meets tests/test_multibin.py's
    recovery bar (rel 1e-3) as well."""
    counts, i0s, mus, a_true, kw, want = solves[name]
    got = _port(counts, i0s, mus, **kw)
    assert got.shape == want.shape == a_true.shape
    assert _rel(got, want).max() < 1e-4
    if "lm" not in name:
        assert _rel(got, a_true).max() < 1e-3


def test_4bin_3mat_recovery_matches_jax(solves):
    """Three materials (tissue, bone, iodine) from 4 bins: the JAX test's
    bars against the truth (median error < 1e-4, max < 1e-2,
    tests/test_multibin.py:62-81) hold for the port, which agrees with
    JAX to its float32 parity bar (rel 1e-4, floor 1)."""
    counts, i0s, mus, a_true, kw, want = solves["4bin_3mat"]
    got = _port(counts, i0s, mus, **kw)
    err = np.abs(got - a_true)
    assert np.median(err) < 1e-4
    assert err.max() < 1e-2
    assert _rel(got, want).max() < 1e-4


def test_6bin_4mat_recovery_matches_jax(solves):
    """Four materials (tissue, bone, iodine, gadolinium) from 6 bins: the
    JAX test's bars (median error < 1e-3, max < 5e-2,
    tests/test_multibin.py:168-197) hold for the port; the port's and
    JAX's solutions agree within the same bars.  The 4x4 system is
    ill-conditioned, so the two float32 programs (other summation orders)
    differ on the hardest rays by more than the 2-material parity bar."""
    counts, i0s, mus, a_true, kw, want = solves["6bin_4mat"]
    got = _port(counts, i0s, mus, **kw)
    err = np.abs(got - a_true)
    assert np.median(err) < 1e-3, np.median(err, axis=0)
    assert err.max() < 5e-2, err.max(axis=0)
    d = np.abs(got - want)
    assert np.median(d) < 1e-3
    assert d.max() < 5e-2


def test_solve_spd_4x4_matches_lapack():
    """The closed-form symmetric 4x4 solve, SPD and indefinite (the full
    Newton path), against LAPACK at the JAX test's bar (rtol 2e-5, atol
    1e-7, tests/test_multibin.py:147-162), and equal to the JAX
    program's."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(128, 4, 4))
    tri = [(i, j) for i in range(4) for j in range(i, 4)]
    for shift in (0.0, 3.0):
        H = X @ X.transpose(0, 2, 1) + (0.1 - shift) * np.eye(4)
        dF = rng.normal(size=(128, 4))
        H_tri = np.stack([H[:, i, j] for i, j in tri], -1)
        x = t_md._solve_spd(torch.as_tensor(H_tri, dtype=torch.float32),
                            torch.as_tensor(dF, dtype=torch.float32),
                            4).numpy()
        xr = np.linalg.solve(H, dF[..., None])[..., 0]
        np.testing.assert_allclose(x, xr, rtol=2e-5, atol=1e-7)
        xj = np.asarray(j_md._solve_spd(jnp.asarray(H_tri, jnp.float32),
                                        jnp.asarray(dF, jnp.float32), 4))
        np.testing.assert_allclose(x, xj, rtol=2e-5, atol=1e-7)


def test_starved_bins_stay_finite_and_match_jax():
    """Zero-count bins and a fully starved ray stay finite (railed), and
    the healthy rays agree with JAX within atol 0.05, the JAX test's bar
    against the truth (tests/test_multibin.py:107-129)."""
    ct = _ct()
    spec = _spec(ct, 10.0)
    i0s = j_md.pcd_bin_fluences(ct, spec, THR4)
    mus = np.stack([xcom.mixatten(m.matcomp, spec.E)
                    for m in (TISSUE, BONE)])
    a_true = np.array([[5.7, 3.0], [3.0, 1.0], [0.0, 0.0], [20.0, 8.0]])
    counts = _synth(i0s, mus, a_true)
    counts[0, 0] = 0.0
    counts[:, 3] = 0.0
    got = _port(counts, i0s, mus, n_iters=40)
    want = np.asarray(j_md.gauss_newton_solve(
        *(jnp.asarray(x, jnp.float32) for x in (counts, i0s, mus)),
        n_iters=40))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1:3], a_true[1:3], atol=0.05)
    np.testing.assert_allclose(got[1:3], want[1:3], atol=0.05)


def test_pcd_bin_fluences_match_jax():
    """Host float64: the port's bins equal the JAX package's bit for bit
    and partition the in-band fluence (rtol 1e-12, the JAX test's)."""
    from dexct_tpu.ops.spectral import effective_fluence
    from dexct_tpu_torch.physics import kramers_spectrum as t_kramers
    from dexct_tpu_torch.physics.detector import \
        photon_counting_response as t_pcr
    from dexct_tpu_torch.system import FanBeamGeometry as TFan

    ct = _ct()
    spec = _spec(ct, 10.0)
    tct = TFan(N_channels=64, N_proj=8, gamma_fan=0.8, SID=60.0, SDD=100.0,
               eid=False, detector=t_pcr())
    tspec = t_kramers(140.0)
    tspec.rescale_counts(tct.A_iso * 10.0 / tct.N_proj)
    want = j_md.pcd_bin_fluences(ct, spec, THR4)
    got = t_md.pcd_bin_fluences(tct, tspec, THR4)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got.sum(0),
                               effective_fluence(spec, ct)
                               * (spec.E >= 20.0), rtol=1e-12)


@pytest.mark.parametrize("basis,thr,n_iters", [
    ((TISSUE, BONE), THR4, 40),
    ((TISSUE, BONE, IODINE, GD), THR6, 120)], ids=["2mat", "4mat"])
def test_decompose_multibin_grid_matches_jax(basis, thr, n_iters):
    """Sinogram-level API: the air ray is masked to 0 on both, the rest
    recovers the truth within the JAX tests' bars (atol 5e-3 at K = 2,
    2e-2 at K = 4, tests/test_multibin.py:83-101, :199-224), and the
    port's basis sinograms agree with JAX's within the same bars."""
    v, c = 4, 32
    ct = _ct(n_channels=c, n_proj=v)
    spec = _spec(ct, 20.0)
    i0s = j_md.pcd_bin_fluences(ct, spec, thr)
    mus = np.stack([xcom.mixatten(m.matcomp, spec.E) for m in basis])
    rng = np.random.default_rng(4)
    hi = [20.0, 4.0, 1.5, 1.5]
    a_true = np.stack([rng.uniform(0.0, hi[k], v * c)
                       for k in range(len(basis))], -1)
    a_true[0] = 0.0  # air ray
    counts = _synth(i0s, mus, a_true).reshape(len(thr), v, c)
    want, wmask = j_md.decompose_multibin_grid(counts, spec.E, i0s, basis,
                                               n_iters=n_iters)
    got, mask = t_md.decompose_multibin_grid(
        torch.as_tensor(counts, dtype=torch.float32), spec.E, i0s, basis,
        n_iters=n_iters)
    got, mask = got.numpy(), mask.numpy()
    assert got.shape == (len(basis), v, c)
    assert np.array_equal(mask, np.asarray(wmask))
    assert got[:, 0, 0].max() == 0.0
    atol = 5e-3 if len(basis) == 2 else 2e-2
    keep = ~mask.ravel()
    for k in range(len(basis)):
        np.testing.assert_allclose(got[k].ravel()[keep],
                                   a_true[:, k][keep], atol=atol)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


def test_image_domain_decomposition_matches_jax():
    """The per-pixel 2x2 product of the image-domain method (host float64
    mixing matrix, float32 product): rtol 1e-6 against JAX on the same
    images; a water-like pixel maps to ~(1, 0) in the (tissue, bone)
    basis, and K != 2 raises the JAX ValueError."""
    from dexct_tpu.physics import linac_spectrum
    from dexct_tpu_torch.physics import kramers_spectrum as t_kramers
    from dexct_tpu_torch.physics import linac_spectrum as t_linac
    from dexct_tpu_torch.system import FanBeamGeometry as TFan

    ct = FanBeamGeometry(N_channels=128, N_proj=128, eid=True)
    tct = TFan(N_channels=128, N_proj=128, eid=True)
    js = (linac_spectrum(), kramers_spectrum(80.0))
    ts = (t_linac(), t_kramers(80.0))
    rng = np.random.default_rng(5)
    r1 = rng.uniform(0.0, 0.3, (24, 24)).astype(np.float32)
    r2 = rng.uniform(0.0, 0.3, (24, 24)).astype(np.float32)
    want = j_md.image_domain_decomposition(r1, r2, *js, ct)
    got = t_md.image_domain_decomposition(
        torch.as_tensor(r1), torch.as_tensor(r2), *ts, tct)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-8)
    # a tissue pixel: each acquisition's effective attenuation of tissue
    from dexct_tpu_torch.ops.spectral import effective_fluence

    mu = []
    for s in ts:
        w = effective_fluence(s, tct)
        w = w / w.sum()
        mu.append(float(np.sum(w * TISSUE.mass_atten(s.E)))
                  * TISSUE.density)
    a_t, a_b = t_md.image_domain_decomposition(
        torch.tensor([mu[0]]), torch.tensor([mu[1]]), *ts, tct)
    assert abs(float(a_t) - TISSUE.density) < 1e-4
    assert abs(float(a_b)) < 1e-4
    with pytest.raises(ValueError, match="2-basis"):
        t_md.image_domain_decomposition(torch.as_tensor(r1),
                                        torch.as_tensor(r2), *ts, tct,
                                        basis=(TISSUE, BONE, IODINE))
