"""The port's one-step spectral reconstruction (``ops/onestep.py``, on the
plain versions of K7, K8, K21 and K22) against the JAX package's, on the
CPU: a 48^2 Fourier plan with n_theta = 96 and 64 x 48 rays, the
water/bone basis, two kVp spectra on their union energy grid.

Tolerances: ``spectral_forward_images`` rel 1e-5 of the largest expected
count (the FFT libraries round differently, measured 1.0e-6); the
objective's gradient (``torch.autograd`` through the Fourier chain against
``jax.grad``) rel 1e-4 of its largest value; 20 Adam iterations of
``onestep_spectral_recon`` rel 1e-4; ``adam_step`` and the Huber roughness
rel 1e-6; the motion-compensated forward (the motion resampler on the
Radon transforms) rel 1e-5 and 20 iterations of the motion fit rel 1e-4;
the motion guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import fourier as j_fo
from dexct_tpu.ops import motion as jm
from dexct_tpu.ops import onestep as j_os
from dexct_tpu.physics import xcom as j_xcom
from dexct_tpu.physics.materials import BONE as J_BONE
from dexct_tpu.physics.materials import WATER as J_WATER
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import water_cylinder_phantom as j_cyl
from dexct_tpu.utils.optim import adam_step as j_adam
from dexct_tpu_torch.ops import fourier as t_fo
from dexct_tpu_torch.ops import motion as tm
from dexct_tpu_torch.ops import onestep as t_os
from dexct_tpu_torch.ops.matdecomp import prepare_decomposition
from dexct_tpu_torch.physics import kramers_spectrum
from dexct_tpu_torch.physics.materials import BONE, WATER
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import water_cylinder_phantom as t_cyl
from dexct_tpu_torch.utils.optim import adam_step

GEOM = dict(N_channels=48, N_proj=64, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0)
VS = (64, 48)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def setup():
    """Both plans, the union-grid tables of a 140/80 kVp pair, the basis
    attenuation, the truth images, a two-step-like start and Poisson counts
    of the truth."""
    ct = TFan(**GEOM)
    jplan = j_fo.plan_fourier_projector(j_cyl(N=48, dx=0.4), JFan(**GEOM),
                                        n_theta=96)
    tplan = t_fo.plan_fourier_projector(t_cyl(N=48, dx=0.4), ct, n_theta=96,
                                        device="cpu")
    s1, s2 = kramers_spectrum(140.0), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    ee, i0, _ = prepare_decomposition(ct, s1, s2)
    mus = np.stack([j_xcom.mixatten(b.matcomp, ee)
                    for b in (J_WATER, J_BONE)]).astype(np.float32)
    truth = np.zeros((2, 48, 48), np.float32)
    lab = t_cyl(N=48, dx=0.4).labels[0]
    truth[0][lab == 1] = 1.0
    truth[1][20:26, 20:26] = 0.5
    rng = np.random.default_rng(0)
    x0 = np.clip(truth + 0.05 * rng.normal(size=truth.shape), 0.0,
                 None).astype(np.float32)
    lam = np.asarray(j_os.spectral_forward_images(
        jplan, jnp.asarray(truth), jnp.asarray(mus),
        jnp.asarray(i0, jnp.float32), VS))
    counts = rng.poisson(lam).astype(np.float32)
    return jplan, tplan, ee, i0.astype(np.float32), mus, truth, x0, counts


def test_spectral_forward_images_matches_jax(setup):
    jplan, tplan, _, i0, mus, _, x0, _ = setup
    want = np.asarray(j_os.spectral_forward_images(
        jplan, jnp.asarray(x0), jnp.asarray(mus), jnp.asarray(i0), VS))
    got = t_os.spectral_forward_images(tplan, torch.as_tensor(x0),
                                       torch.as_tensor(mus),
                                       torch.as_tensor(i0), VS).numpy()
    assert got.shape == want.shape == (2,) + VS
    assert _rel(got, want) <= 1e-5


def test_objective_gradient_matches_jax_grad(setup):
    """The gradient Adam follows: ``torch.autograd`` through the energy
    stage and the Fourier chain (backward: K22, then the FFT steps, K21)
    against ``jax.grad`` of the JAX program's objective."""
    jplan, tplan, _, i0, mus, _, x0, counts = setup
    beta, delta = 3e-3, 1e-2
    jc = jnp.asarray(counts)
    w = 1.0 / jnp.maximum(jc, 1.0)
    norm = jnp.sum(w * jc * jc)

    def j_loss(x):
        lam = j_os.spectral_forward_images(jplan, x, jnp.asarray(mus),
                                           jnp.asarray(i0), VS)
        return (0.5 * jnp.sum(w * (lam - jc) ** 2) / norm
                + beta * j_os._roughness(x, delta) / x.size)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(x0)))

    def forward(x, m, i):
        return t_os.spectral_forward_images(tplan, x, m, i, VS)

    loss = t_os._objective(forward, torch.as_tensor(counts),
                           torch.as_tensor(mus), torch.as_tensor(i0), beta,
                           delta)
    x = torch.as_tensor(x0).requires_grad_(True)
    (got,) = torch.autograd.grad(loss(x), x)
    assert float(loss(torch.as_tensor(x0))) == pytest.approx(
        float(j_loss(jnp.asarray(x0))), rel=1e-5)
    assert _rel(got.numpy(), want) <= 1e-4


def test_onestep_spectral_recon_matches_jax(setup):
    jplan, tplan, ee, i0, _, _, x0, counts = setup
    want = np.asarray(j_os.onestep_spectral_recon(
        counts, ee, i0, (J_WATER, J_BONE), jplan, VS, x0=x0, n_iters=20))
    got = t_os.onestep_spectral_recon(counts, ee, i0, (WATER, BONE), tplan,
                                      VS, x0=x0, n_iters=20)
    assert got.shape == (2, 48, 48) and got.dtype == torch.float32
    assert float(got.min()) >= 0.0
    assert np.abs(want - x0).max() > 1e-2  # the fit moved
    assert _rel(got.numpy(), want) <= 1e-4


def test_adam_step_and_roughness_match_jax():
    rng = np.random.default_rng(3)
    p, g, m = (rng.normal(size=(2, 5, 6)).astype(np.float32)
               for _ in range(3))
    v = rng.uniform(0.1, 1.0, (2, 5, 6)).astype(np.float32)
    want = j_adam(*(jnp.asarray(a) for a in (p, g, m, v)), 4.0, 2e-3)
    got = adam_step(*(torch.as_tensor(a) for a in (p, g, m, v)), 4.0, 2e-3)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) <= 1e-6
    assert float(t_os._roughness(torch.as_tensor(p), 0.3)) == pytest.approx(
        float(j_os._roughness(jnp.asarray(p), 0.3)), rel=1e-6)


def _tracks():
    j = jm.MotionProfile.breathing(VS[0], amplitude_cm=0.6, cycles=1.5,
                                   direction=(1.0, 0.4))
    return j, tm.MotionProfile(j.phi, j.disp)


def test_motion_forward_matches_jax(setup):
    """The motion-compensated forward model: each basis image's Fourier
    Radon transform resampled along the motion-transformed rays."""
    jplan, tplan, _, i0, mus, _, x0, _ = setup
    jmo, tmo = _tracks()
    want = np.asarray(j_os.spectral_forward_images(
        jplan, jnp.asarray(x0), jnp.asarray(mus), jnp.asarray(i0), VS,
        disp=jnp.asarray(jmo.disp, jnp.float32),
        resample_meta=j_os._motion_resample_meta(JFan(**GEOM), VS)))
    got = t_os.spectral_forward_images(
        tplan, torch.as_tensor(x0), torch.as_tensor(mus),
        torch.as_tensor(i0), VS,
        disp=torch.as_tensor(tmo.disp, dtype=torch.float32),
        resample_meta=tm.fan_line_coords(TFan(**GEOM), "cpu"))
    assert got.shape == want.shape == (2,) + VS
    assert _rel(got.numpy(), want) <= 1e-5
    static = t_os.spectral_forward_images(
        tplan, torch.as_tensor(x0), torch.as_tensor(mus),
        torch.as_tensor(i0), VS).numpy()
    assert _rel(got.numpy(), static) > 1e-3  # the track moves the rays


def test_motion_fit_matches_jax(setup):
    """Twenty Adam iterations of the motion-compensated fit (autograd
    through the resampler and the Fourier chain against jax.grad)."""
    jplan, tplan, ee, i0, _, _, x0, counts = setup
    jmo, tmo = _tracks()
    want = np.asarray(j_os.onestep_spectral_recon(
        counts, ee, i0, (J_WATER, J_BONE), jplan, VS, x0=x0, n_iters=20,
        motion=jmo, geometry=JFan(**GEOM)))
    got = t_os.onestep_spectral_recon(counts, ee, i0, (WATER, BONE), tplan,
                                      VS, x0=x0, n_iters=20, motion=tmo,
                                      geometry=TFan(**GEOM))
    assert got.shape == (2, 48, 48) and float(got.min()) >= 0.0
    assert np.abs(want - x0).max() > 1e-2  # the fit moved
    assert _rel(got.numpy(), want) <= 1e-4


def test_motion_guards(setup):
    _, tplan, ee, i0, _, _, x0, counts = setup
    _, tmo = _tracks()
    args = (counts, ee, i0, (WATER, BONE), tplan, VS)
    with pytest.raises(ValueError, match="needs geometry"):
        t_os.onestep_spectral_recon(*args, x0=x0, n_iters=1, motion=tmo)
    turning = tm.MotionProfile(np.full(VS[0], 0.01), tmo.disp)
    with pytest.raises(ValueError, match="phi = 0"):
        t_os.onestep_spectral_recon(*args, x0=x0, n_iters=1, motion=turning,
                                    geometry=TFan(**GEOM))
