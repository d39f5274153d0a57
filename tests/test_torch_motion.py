"""The port's rigid-motion module (``dexct_tpu_torch/ops/motion.py``, on the
plain versions of K1, K10, K30, K32, K33 and of the Fourier projector)
against the JAX package's (``dexct_tpu/ops/motion.py``), on the CPU, at
small sizes: a 64^2 contrast-rod phantom under a 96-channel, 128-view fan;
a 24^2 x 8 cone and helical scan.  Inputs from numpy seeds; the sinograms
are the JAX package's, fed to both.

Tolerances:
- the profiles, rays and host estimators: exact or rel 1e-12 (the same
  float64 NumPy);
- the motion trace (K1's plain version) against the JAX DDA: atol 1e-4 cm
  (both exact traces in float32; measured 3.1e-5); against the JAX
  default ``method='auto'`` (its packed dominant-axis trace on this even
  grid, ~4e-4 cm off its own DDA): atol 2e-3 cm; the cone trace against
  the JAX 3-D DDA: atol 1e-4 cm;
- the backprojections and reconstructions: atol 1e-5 x max |JAX| (fan) and
  1e-4 x max (cone, helical), float32 in another order (XLA contracts
  multiply-adds into FMAs, the port rounds each operation; measured
  2e-7 / 9e-8 / 6e-8 of max);
- the resampler and its gradients in radon, disp and phi: rel 1e-5 of the
  largest value (measured 7e-6 for the values, 6e-7 for phi's gradient);
- ``estimate_motion_joint`` at 5 Adam iterations: the track atol 1e-5 cm
  and the image 1e-4 x max (measured 8e-7 cm, 4e-5);
- the full joint fit is held by its result: the JAX test's bounds
  (``tests/test_motion.py``: track error below 1/2.5 of the centroid's,
  MC-FBP artifact rms below 1/4 of the uncorrected).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import fbp as j_fbp
from dexct_tpu.ops import motion as jm
from dexct_tpu.ops.conebeam import cone_material_paths as j_cone_paths
from dexct_tpu.ops.conebeam import fdk_reconstruct as j_fdk
from dexct_tpu.ops.siddon import material_path_sinogram as j_paths
from dexct_tpu.ops.siddon import mono_sinogram as j_mono
from dexct_tpu.physics.materials import AIR as J_AIR
from dexct_tpu.physics.materials import BONE as J_BONE
from dexct_tpu.physics.materials import WATER as J_WATER
from dexct_tpu.physics.materials import MaterialTable as JMT
from dexct_tpu.system import ConeBeamGeometry as JCone
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import HelicalConeBeamGeometry as JHel
from dexct_tpu.system import contrast_rods_phantom as j_rods
from dexct_tpu.system import water_cylinder_phantom as j_cyl
from dexct_tpu.system.phantom import VoxelPhantom as JVox
from dexct_tpu_torch.ops import fbp as t_fbp
from dexct_tpu_torch.ops import motion as tm
from dexct_tpu_torch.physics.materials import AIR, BONE, WATER, MaterialTable
from dexct_tpu_torch.system import ConeBeamGeometry as TCone
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import HelicalConeBeamGeometry as THel
from dexct_tpu_torch.system import contrast_rods_phantom as t_rods
from dexct_tpu_torch.system.phantom import VoxelPhantom as TVox

CPU = torch.device("cpu")
MU = np.array([0.0, 0.20, 0.21, 0.45, 0.18, 0.22])
FAN = dict(N_channels=96, N_proj=128, gamma_fan=0.8230337, SID=60.0,
           SDD=100.0)
N, FOV = 64, 64 * 0.35


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _max_rel(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tprofile(m):
    cls = tm.MotionProfile if m.disp.shape[1] == 2 else tm.MotionProfile3D
    return cls(m.phi, m.disp)


@pytest.fixture(scope="module")
def fan():
    """Both fan geometries and rod phantoms, a breathing track and the JAX
    package's moving and static sinograms (DDA)."""
    jct, tct = JFan(**FAN), TFan(**FAN)
    jph, tph = j_rods(N=N, dx=0.35), t_rods(N=N, dx=0.35)
    motion = jm.MotionProfile.breathing(128, amplitude_cm=0.8, cycles=1.5,
                                        direction=(1.0, 0.4))
    moved = np.asarray(j_mono(jm.material_path_sinogram_motion(
        jph, jct, motion, method="dda"), MU), np.float32)
    clean = np.asarray(j_mono(j_paths(jph, jct, method="dda"), MU),
                       np.float32)
    return jct, tct, jph, tph, motion, moved, clean


# --- profiles and rays ----------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.MotionProfile.static(17),
    lambda m: m.MotionProfile.breathing(40, 0.6, 2.0, (0.3, 1.0), 0.4),
    lambda m: m.MotionProfile.jerk(40, 0.3, (0.2, -0.1), 0.05),
    lambda m: m.MotionProfile.rotation_drift(40, 0.15),
    lambda m: m.MotionProfile3D.static(11),
    lambda m: m.MotionProfile3D.breathing_z(40, 0.5, 1.5, 0.2),
    lambda m: m.MotionProfile3D.from_2d(
        m.MotionProfile.breathing(40, 0.6, 1.5, (1.0, 0.4))),
], ids=["static", "breathing", "jerk", "rotation_drift", "static_3d",
        "breathing_z", "from_2d"])
def test_profiles_match_jax(make):
    got, want = make(tm), make(jm)
    assert got.n_views == want.n_views
    np.testing.assert_array_equal(got.phi, want.phi)
    np.testing.assert_array_equal(got.disp, want.disp)


def test_profiles_reject_bad_shapes():
    with pytest.raises(ValueError, match="disp"):
        tm.MotionProfile(np.zeros(4), np.zeros((4, 3)))
    with pytest.raises(ValueError, match="disp"):
        tm.MotionProfile3D(np.zeros(4), np.zeros((4, 2)))


@pytest.mark.parametrize("dim", [2, 3])
def test_rays_in_object_frame_match_jax(dim):
    rng = np.random.default_rng(7)
    src = rng.normal(size=(12, 5, dim))
    dirs = rng.normal(size=(12, 5, dim))
    phi = rng.normal(scale=0.2, size=12)
    disp = rng.normal(size=(12, dim))
    for a, b in zip(tm.rays_in_object_frame(src, dirs, phi, disp),
                    jm.rays_in_object_frame(src, dirs, phi, disp)):
        np.testing.assert_array_equal(a, b)


# --- simulation -------------------------------------------------------------

@pytest.mark.parametrize("method,atol", [("dda", 1e-4), ("auto", 2e-3)])
def test_material_paths_match_jax(fan, method, atol):
    jct, tct, jph, tph, motion, _, _ = fan
    want = np.asarray(jm.material_path_sinogram_motion(jph, jct, motion,
                                                       method=method))
    got = tm.material_path_sinogram_motion(tph, tct, _tprofile(motion),
                                           device=CPU, method=method)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_constant_rotation_is_view_roll(fan):
    """An object turned by k view spacings is the static sinogram rolled by
    k views (the JAX test's exactness witness, on the port's trace)."""
    _, tct, _, tph, _, _, _ = fan
    k, V = 5, tct.N_proj
    still = tm.material_path_sinogram_motion(tph, tct, tm.MotionProfile.
                                             static(V), device=CPU)
    turned = tm.material_path_sinogram_motion(
        tph, tct, tm.MotionProfile(np.full(V, k * 2 * np.pi / V),
                                   np.zeros((V, 2))), device=CPU)
    np.testing.assert_allclose(turned.numpy(),
                               np.roll(still.numpy(), k, axis=0), atol=1e-4)


def test_motion_guards():
    from dexct_tpu_torch.system.analytic import water_cylinder_analytic

    ct = TFan(**FAN)
    with pytest.raises(ValueError, match="voxel"):
        tm.material_path_sinogram_motion(water_cylinder_analytic(), ct,
                                         tm.MotionProfile.static(128),
                                         device=CPU)
    with pytest.raises(ValueError, match="views"):
        tm.material_path_sinogram_motion(t_rods(N=16, dx=1.0), ct,
                                         tm.MotionProfile.static(12),
                                         device=CPU)
    cone = TCone(N_channels=16, N_proj=16, N_rows=4, gamma_fan=0.8,
                 SID=60.0, SDD=100.0, h_iso=0.5, rotation_total=np.pi)
    with pytest.raises(ValueError, match="2\\*pi"):
        tm.fdk_reconstruct_motion(torch.zeros(16, 4, 16), cone, 16, 8.0,
                                  0.8, tm.MotionProfile3D.static(16))
    with pytest.raises(ValueError, match="pitch"):
        tm.helical_fdk_reconstruct_motion(
            torch.zeros(16, 4, 16), dataclasses.replace(
                cone, rotation_total=2 * np.pi), 16, 8.0, 0.8,
            tm.MotionProfile3D.static(16))


# --- motion-compensated fan FBP (K30's plain version) -----------------------

def test_fan_backproject_motion_matches_jax(fan):
    jct, _, _, _, _, _, _ = fan
    rng = np.random.default_rng(11)
    q = rng.normal(size=(128, 96)).astype(np.float32)
    phi = (0.1 * np.sin(np.linspace(0, 3, 128))).astype(np.float32)
    disp = rng.normal(scale=0.5, size=(128, 2)).astype(np.float32)
    betas = np.asarray(jct.betas, np.float32)
    want = jm.fan_backproject_motion(
        jnp.asarray(q), jnp.asarray(betas), 60.0, jct.dgamma, N, FOV,
        jnp.asarray(phi), jnp.asarray(disp))
    got = tm.fan_backproject_motion(torch.as_tensor(q),
                                    torch.as_tensor(betas), 60.0, jct.dgamma,
                                    N, FOV, phi, disp)
    assert got.shape == (N, N)
    assert _max_rel(got, want) <= 1e-5


@pytest.mark.parametrize("short", [False, True])
def test_fbp_recon_motion_matches_jax(fan, short):
    jct, tct, _, _, motion, moved, _ = fan
    tmo = _tprofile(motion)
    if short:  # a short scan takes the Parker weights
        rot = np.pi + jct.gamma_fan + 0.2
        jct = dataclasses.replace(jct, rotation_total=rot)
        tct = dataclasses.replace(tct, rotation_total=rot)
    want, want_hu = jm.fbp_recon_motion(jnp.asarray(moved), jct, N, FOV,
                                        motion, mu_water_eff=0.2)
    got, got_hu = tm.fbp_recon_motion(moved, tct, N, FOV, tmo,
                                      mu_water_eff=0.2, device=CPU)
    assert got.device == CPU
    assert _max_rel(got, want) <= 1e-5
    assert np.abs(got_hu.numpy() - np.asarray(want_hu)).max() <= 0.05


def test_true_profile_removes_artifact(fan):
    """MC-FBP with the true track cuts the artifact rms against the static
    image over 4x (the JAX test's bound), on the port's FBP."""
    _, tct, _, _, motion, moved, clean = fan
    ref, _ = t_fbp.fbp_recon(torch.as_tensor(clean), tct, N, FOV)
    bad, _ = t_fbp.fbp_recon(torch.as_tensor(moved), tct, N, FOV)
    fixed, _ = tm.fbp_recon_motion(moved, tct, N, FOV, _tprofile(motion),
                                   device=CPU)
    e_bad = float(torch.sqrt(torch.mean((bad - ref) ** 2)))
    e_fix = float(torch.sqrt(torch.mean((fixed - ref) ** 2)))
    assert e_fix < e_bad / 4.0, (e_bad, e_fix)


# --- estimation -------------------------------------------------------------

def test_estimate_translation_matches_jax(fan):
    jct, tct, _, _, _, moved, _ = fan
    np.testing.assert_array_equal(tm.cosine_motion_basis(50, 4),
                                  jm.cosine_motion_basis(50, 4))
    want, c_want = jm.estimate_translation(moved, jct, n_modes=6)
    got, c_got = tm.estimate_translation(torch.as_tensor(moved), tct,
                                         n_modes=6)
    np.testing.assert_allclose(got.disp, want.disp, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(c_got, c_want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.phi, 0.0)


def test_fan_line_coords_match_jax():
    kw = dict(FAN, det_offset_ch=0.25)
    want = jm.fan_line_coords(JFan(**kw))
    got = tm.fan_line_coords(TFan(**kw), CPU)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("with_phi", [False, True])
def test_radon_resample_fan_and_gradients_match_jax(with_phi):
    """Values and the gradients in radon, disp and phi of a weighted sum
    (autograd against jax.grad)."""
    import jax

    jct, tct = JFan(**FAN), TFan(**FAN)
    rng = np.random.default_rng(12)
    radon = rng.normal(size=(64, 256)).astype(np.float32)
    disp = rng.normal(scale=0.3, size=(128, 2)).astype(np.float32)
    phi = rng.normal(scale=0.05, size=128).astype(np.float32)
    wts = rng.normal(size=(128, 96)).astype(np.float32)
    grid = (64, 256, -25.6, 0.2)
    jth, jtw = jm.fan_line_coords(jct)
    tth, ttw = tm.fan_line_coords(tct, CPU)

    def j_loss(r, d, p):
        return jnp.sum(jnp.asarray(wts) * jm._radon_resample_fan(
            r, jth, jtw, d, *grid, phi=p if with_phi else None))

    args = (jnp.asarray(radon), jnp.asarray(disp), jnp.asarray(phi))
    want = j_loss(*args)
    wgrads = jax.grad(j_loss, argnums=(0, 1, 2) if with_phi else (0, 1))(
        *args)
    r, d, p = (torch.tensor(a, requires_grad=True)
               for a in (radon, disp, phi))
    vals = tm._radon_resample_fan(r, tth, ttw, d, *grid,
                                  phi=p if with_phi else None)
    assert vals.shape == (128, 96)
    got = torch.sum(torch.as_tensor(wts) * vals)
    ggrads = torch.autograd.grad(got, (r, d, p) if with_phi else (r, d))
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(ggrads, wgrads):
        assert _max_rel(g, w) <= 1e-5


@pytest.mark.parametrize("fit_rotation", [False, True])
def test_estimate_motion_joint_matches_jax(fan, fit_rotation):
    """Five Adam iterations from the same centroid start: the same track
    and image (the Fourier Radon transform through K7's plain version and
    autograd against the JAX chain and jax.grad)."""
    jct, tct, _, _, _, moved, _ = fan
    want, wimg = jm.estimate_motion_joint(moved, jct, N, FOV, n_iters=5,
                                          n_theta=128,
                                          fit_rotation=fit_rotation)
    got, gimg = tm.estimate_motion_joint(torch.as_tensor(moved), tct, N,
                                         FOV, n_iters=5, n_theta=128,
                                         fit_rotation=fit_rotation)
    assert gimg.shape == (N, N)
    np.testing.assert_allclose(got.disp, want.disp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.phi, want.phi, atol=1e-5, rtol=0)
    assert _max_rel(gimg, wimg) <= 1e-4


def test_joint_fit_result_meets_the_jax_bounds():
    """The full joint fit on the JAX test's case (192 views, 0.6 cm
    breathing, 500 iterations) through the port: its track below 1/2.5 of
    the centroid estimate's error and its MC-FBP artifact rms below 1/4 of
    the uncorrected image's (tests/test_motion.py:302-340)."""
    ct = TFan(**dict(FAN, N_proj=192))
    ph = t_rods(N=N, dx=0.35)
    motion = tm.MotionProfile.breathing(192, amplitude_cm=0.6, cycles=1.5,
                                        direction=(0.3, 1.0))
    from dexct_tpu_torch.ops.siddon import (material_path_sinogram,
                                            mono_sinogram)

    sino = mono_sinogram(tm.material_path_sinogram_motion(ph, ct, motion,
                                                          device=CPU), MU)
    est0, _ = tm.estimate_translation(sino, ct, n_modes=6)
    est, ximg = tm.estimate_motion_joint(sino, ct, N, FOV, n_iters=500,
                                         init=est0)
    e_init = np.sqrt(np.mean((est0.disp - motion.disp) ** 2))
    e_joint = np.sqrt(np.mean((est.disp - motion.disp) ** 2))
    assert e_joint < e_init / 2.5, (e_init, e_joint)
    clean = mono_sinogram(material_path_sinogram(ph, ct, device=CPU), MU)
    ref, _ = t_fbp.fbp_recon(clean, ct, N, FOV)
    bad, _ = t_fbp.fbp_recon(sino, ct, N, FOV)
    fixed, _ = tm.fbp_recon_motion(sino, ct, N, FOV, est)
    e_bad = float(torch.sqrt(torch.mean((bad - ref) ** 2)))
    e_fix = float(torch.sqrt(torch.mean((fixed - ref) ** 2)))
    assert e_fix < e_bad / 4.0, (e_bad, e_fix)
    assert bool(torch.isfinite(ximg).all())


# --- 3-D: cone traces, MC-FDK and MC helical gFDK ---------------------------

def _volume(nz):
    n, dx = 24, 0.5
    lab = np.broadcast_to(j_cyl(N=n, dx=dx).labels[0], (nz, n, n)).copy()
    cz = (np.arange(nz) + 0.5 - nz / 2) * dx
    cy = (np.arange(n) + 0.5 - n / 2) * dx
    Z, Y, X = np.meshgrid(cz, cy, cy, indexing="ij")
    lab[(X ** 2 + (Y - 1.0) ** 2 + Z ** 2) < 4.0] = 2
    return (JVox("zvar", lab, JMT([J_AIR, J_WATER, J_BONE]), dx, dx, dx),
            TVox("zvar", lab, MaterialTable([AIR, WATER, BONE]), dx, dx, dx))


CONE = dict(N_channels=32, N_rows=8, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0, h_iso=0.5)
MU3 = np.array([0.0, 0.2, 0.45], np.float32)


@pytest.fixture(scope="module")
def cone():
    jph, tph = _volume(8)
    jct, tct = JCone(N_proj=48, **CONE), TCone(N_proj=48, **CONE)
    motion = jm.MotionProfile3D.breathing_z(48, amplitude_cm=0.8)
    paths = np.asarray(jm.cone_material_paths_motion(jph, jct, motion,
                                                     method="dda"))
    return jct, tct, jph, tph, motion, paths


def test_cone_paths_match_jax(cone):
    jct, tct, jph, tph, motion, want = cone
    got = tm.cone_material_paths_motion(tph, tct, _tprofile(motion),
                                        device=CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_fdk_reconstruct_motion_matches_jax(cone):
    jct, tct, _, _, motion, paths = cone
    sino = (paths @ MU3).astype(np.float32)
    want = jm.fdk_reconstruct_motion(jnp.asarray(sino), jct, 24, 12.0, 0.8,
                                     motion)
    got = tm.fdk_reconstruct_motion(sino, tct, 24, 12.0, 0.8,
                                    _tprofile(motion), device=CPU)
    assert got.shape == (8, 24, 24)
    assert _max_rel(got, want) <= 1e-4
    # a stack of two goes through one backprojection
    both = tm.fdk_reconstruct_motion(torch.as_tensor(np.stack([sino,
                                                               2 * sino])),
                                     tct, 24, 12.0, 0.8, _tprofile(motion))
    torch.testing.assert_close(both[0], got, rtol=0, atol=0)


def test_zero_motion_fdk_matches_static(cone):
    """Zero motion is the static FDK on the slices whose rows stay on the
    detector for every view (the MC-FDK renormalises the rim slices by
    their coverage, where the static FDK dims them)."""
    jct, tct, jph, _, _, _ = cone
    sino = np.asarray(j_cone_paths(jph, jct, method="dda")) @ MU3
    want = np.asarray(j_fdk(jnp.asarray(sino), jct, 24, 12.0, 0.8))
    got = tm.fdk_reconstruct_motion(sino, tct, 24, 12.0, 0.8,
                                    tm.MotionProfile3D.static(48),
                                    device=CPU).numpy()
    assert np.abs(got - want)[2:-2].max() < 1e-5


def test_helical_fdk_reconstruct_motion_matches_jax():
    kw = dict(CONE, N_proj=96, pitch=2.0, rotation_total=4 * np.pi)
    jct, tct = JHel(**kw), THel(**kw)
    jph, _ = _volume(8)
    motion = jm.MotionProfile3D.breathing_z(96, amplitude_cm=1.6)
    paths = np.asarray(jm.cone_material_paths_motion(jph, jct, motion,
                                                     method="dda"))
    sino = (paths @ MU3).astype(np.float32)
    z_out = (np.arange(4) + 0.5 - 2.0) * 0.5
    want = jm.helical_fdk_reconstruct_motion(jnp.asarray(sino), jct, 24,
                                             12.0, 0.8, motion, z_out=z_out)
    got = tm.helical_fdk_reconstruct_motion(sino, tct, 24, 12.0, 0.8,
                                            _tprofile(motion), z_out=z_out,
                                            device=CPU)
    assert got.shape == (4, 24, 24)
    assert _max_rel(got, want) <= 1e-4
    # the default slice grid: the central 80 % of the source travel
    want = jm.helical_fdk_reconstruct_motion(jnp.asarray(sino), jct, 24,
                                             12.0, 0.8, motion)
    got = tm.helical_fdk_reconstruct_motion(sino, tct, 24, 12.0, 0.8,
                                            _tprofile(motion), device=CPU)
    assert got.shape == tuple(want.shape)
    assert _max_rel(got, want) <= 1e-4


@pytest.mark.parametrize("helix", [False, True])
def test_plain_motion_work_counts(helix):
    """The plain motion backprojection's count of its work (behind K32's and
    K33's bounds in chip_smoke.py): every (disc pixel, view) and (pixel,
    slice, view) for the circular FDK; for the helix the (slice, view)
    pairs inside the moving window, times the disc pixels; the taps among
    them; the output the same with and without counting."""
    from dexct_tpu_torch.ops.conebeam import _disc

    rng = np.random.default_rng(5)
    V, R, C, n, nz, dz, z0 = 48, 8, 32, 24, 4, 0.5, -0.75
    q = torch.as_tensor(rng.standard_normal((2, V, R, C)),
                        dtype=torch.float32)
    betas = torch.as_tensor(np.arange(V) * (4.0 * np.pi / V),
                            dtype=torch.float32)
    track = tm.MotionProfile3D.breathing_z(V, amplitude_cm=1.6)
    window = (np.linspace(-2.0, 2.0, V), 2.0 * np.pi, 2.0) if helix else None
    args = (q, betas, track.phi, track.disp, 60.0, 0.8230337 / C, 0.5, n,
            nz, 12.0, dz, z0, 8)
    work = {}
    got = tm._motion_backproject_plain(*args, window=window, terms=work)
    want = tm._motion_backproject_plain(*args, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    P = _disc(n, 12.0, CPU)[0].shape[0]
    if helix:
        zv = tm._z_grid(nz, dz, z0, CPU)[None, :] + torch.as_tensor(
            track.disp[:, 2:3], dtype=torch.float32)
        bc = window[1] + (2.0 * np.pi) * zv / torch.full_like(zv, window[2])
        inside = (betas[:, None] - bc).abs() <= np.pi
        assert 0 < int(inside.sum()) < V * nz
        assert work["terms"] == P * int(inside.sum())
        assert work["pixel_views"] == P * int(inside.any(1).sum())
    else:
        assert (work["pixel_views"], work["terms"]) == (V * P, V * nz * P)
    assert 0 < work["taps"] <= work["terms"]


def motion_reference():
    """The JAX package's motion-compensation ratio on the scene of
    ``chip_smoke.py``'s motion path at half its resolution, run as a script
    from the repository's root (~1 min on 2 CPU threads, < 2 GB):

        PYTHONPATH=. python tests/test_torch_motion.py

    The reference protocol (input/params.txt, both acquisitions) with its
    256^2 pelvis at 0.2 cm as every other label (128^2 at 0.4 cm), 400
    channels and 500 views, under the breathing track of tests/test_motion.py
    (0.8 cm along (1, 0.4), 1.5 cycles): the moving and the static scans
    (exact trace, counts, 50 Gauss-Newton iterations), then 256^2 images
    over 50 cm of each log and basis sinogram: the static image, the
    uncorrected FBP of the moving scan and its motion-compensated FBP with
    the true track.  Prints each image's ratio of the uncorrected rms error
    to the compensated one (the reading behind chip_smoke's
    MOTION_RATIO_REF) and the centroid and joint estimators' track errors
    over the track's rms amplitude (800 iterations): chip_smoke's
    MOTION_TRACK_REF.  Then the helical scene of its motion_3d path at half
    its in-plane resolution (see :func:`_helical_reference`)."""
    import json
    import os

    from dexct_tpu.ops.matdecomp import decompose_sinograms
    from dexct_tpu.pipeline.api import get_sino
    from dexct_tpu.pipeline.runner import (_resolve_spectrum,
                                           default_generators)
    from dexct_tpu.system.config import _build_geometry, read_parameter_file

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = os.path.join(repo, "input", "params.txt")
    base = json.loads(open(params).read())
    base["detector_filename"] = os.path.join(repo, base["detector_filename"])
    old = os.getcwd()
    os.chdir(repo)
    try:
        ref = read_parameter_file(params)[0].phantom
    finally:
        os.chdir(old)
    ph = JVox("pelvis", np.ascontiguousarray(ref.labels[:, ::2, ::2]),
              ref.materials, 0.4, 0.4, 0.4)
    ct = _build_geometry(dict(base, N_channels=400, N_projections=500))
    track = jm.MotionProfile.breathing(500, amplitude_cm=0.8, cycles=1.5,
                                       direction=(1.0, 0.4))
    spec_dir = os.path.join(repo, "input", "spectrum")
    gens = default_generators()
    specs = [_resolve_spectrum(name, dose, ct, spec_dir, gens)
             for name, dose in (("detunedMV", 9.0), ("80kV", 1.0))]
    sinos = {}
    for key, paths in (("moving", jm.material_path_sinogram_motion(
            ph, ct, track)), ("static", j_paths(ph, ct))):
        (c1, l1), (c2, l2) = (get_sino(ct, ph, s, paths=paths)
                              for s in specs)
        m1, m2 = decompose_sinograms(ct, c1, c2, *specs, n_iters=50)
        sinos[key] = (l1, l2, m1, m2)
    n, fov = 256, 50.0
    for name, mov, sta in zip(("log detunedMV", "log 80kV", "tissue",
                               "bone"), sinos["moving"], sinos["static"]):
        truth = np.asarray(j_fbp.fbp_recon(sta, ct, n, fov)[0])
        bad = np.asarray(j_fbp.fbp_recon(mov, ct, n, fov)[0])
        fix = np.asarray(jm.fbp_recon_motion(mov, ct, n, fov, track)[0])
        e_bad = np.sqrt(np.mean((bad - truth) ** 2))
        e_fix = np.sqrt(np.mean((fix - truth) ** 2))
        print("%s: rms error uncorrected %.6g, compensated %.6g, ratio "
              "%.4f" % (name, e_bad, e_fix, e_bad / e_fix))
    amp = np.sqrt(np.mean(track.disp ** 2))
    est0, _ = jm.estimate_translation(np.asarray(sinos["moving"][1]), ct)
    est, _ = jm.estimate_motion_joint(sinos["moving"][1], ct, n, fov,
                                      init=est0)
    for name, e in (("centroid", est0), ("joint", est)):
        print("%s track: err/amp %.4f" % (
            name, np.sqrt(np.mean((e.disp - track.disp) ** 2)) / amp))
    _helical_reference(base, lambda g: [
        _resolve_spectrum(name, dose, g, spec_dir, gens)
        for name, dose in (("detunedMV", 9.0), ("80kV", 1.0))],
        read_parameter_file(params)[0].ramp)


def _helical_reference(base, spectra, ramp):
    """The JAX package's readings of ``chip_smoke.py``'s helical motion_3d
    scene at half its in-plane resolution: the helical config (16 rows at
    0.25 cm, pitch 3, two turns, SID 60, SDD 100) with 128 channels and 360
    views, the pelvis_phantom_3d at 0.4 cm in-plane (128^2 x 48 at 0.2 cm
    in z) under the 1.6 cm z breathing drift; the moving and the still
    scans (exact trace, counts, 50 Gauss-Newton iterations), then 128^2
    volumes over 40 cm on the default slice grid.  Prints each image's
    ratio of the uncorrected rms error (gFDK 'full' of the moving scan) to
    the compensated one against the still scan's gFDK, and the compensated
    80 kV volume's air ROI HU at (0, -18) cm of the central slice (the
    readings behind chip_smoke's HELICAL_MOTION_REF)."""
    from dexct_tpu.ops.conebeam import helical_fdk_reconstruct
    from dexct_tpu.ops.matdecomp import decompose_sinograms
    from dexct_tpu.pipeline.api import effective_water_mu, get_sino
    from dexct_tpu.system.config import _build_geometry
    from dexct_tpu.system.phantom import pelvis_phantom_3d

    ct = _build_geometry(dict(
        base, scanner_geometry="helical_cone_beam", N_projections=360,
        rotation_angle_total=4.0 * np.pi, pitch=3.0, N_rows=16,
        detector_px_height=0.25, N_channels=128, SID=60.0, SDD=100.0,
        fan_angle_total=0.8230337))
    ph = pelvis_phantom_3d(N=128, nz=48, dx=0.4, dz=0.2)
    track = jm.MotionProfile3D.breathing_z(360, amplitude_cm=1.6)
    specs = spectra(ct)
    stacks = {}
    for key, paths in (("moving", jm.cone_material_paths_motion(ph, ct,
                                                                track)),
                       ("still", j_cone_paths(ph, ct))):
        (c1, l1), (c2, l2) = (get_sino(ct, ph, s, paths=paths)
                              for s in specs)
        m1, m2 = decompose_sinograms(ct, c1, c2, *specs, n_iters=50)
        stacks[key] = (l1, l2, m1, m2)
    n, fov = 128, 40.0
    for k, name in enumerate(("log detunedMV", "log 80kV", "tissue",
                              "bone")):
        truth = np.asarray(helical_fdk_reconstruct(stacks["still"][k], ct,
                                                   n, fov, ramp))
        bad = np.asarray(helical_fdk_reconstruct(stacks["moving"][k], ct, n,
                                                 fov, ramp))
        fix = np.asarray(jm.helical_fdk_reconstruct_motion(
            stacks["moving"][k], ct, n, fov, ramp, track))
        e_bad = np.sqrt(np.mean((bad - truth) ** 2))
        e_fix = np.sqrt(np.mean((fix - truth) ** 2))
        print("helical %s: rms error uncorrected %.6g, compensated %.6g, "
              "ratio %.4f" % (name, e_bad, e_fix, e_bad / e_fix))
        if k == 1:
            hu = j_fbp.hu_image(fix, effective_water_mu(specs[1], ct))
            px = fov / n
            iy, ix = (int(round(c / px + n / 2 - 0.5)) for c in (-18.0, 0.0))
            h = max(int(round(0.5 / px)), 1)
            air = hu[hu.shape[0] // 2, iy - h:iy + h, ix - h:ix + h].mean()
    print("helical compensated 80kV air ROI HU at (0, -18) cm, slice %d of "
          "%d: %.2f" % (fix.shape[0] // 2, fix.shape[0], air))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    motion_reference()
