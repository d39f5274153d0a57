"""The port's gated (4-D) reconstruction (``dexct_tpu_torch/pipeline/
gated.py``, on the plain version of K31) against the JAX package's
(``dexct_tpu/pipeline/gated.py``), on the CPU: the 64^2 contrast-rod and
thorax phantoms under a 96-channel fan over 2-4 rotations of 96 views.
Sinograms from the JAX package, fed to both.

Tolerances: the phases and gate weights exact (the same float64 NumPy);
the gated reconstructions and series atol 1e-5 x max |JAX| (float32 sums
over views in another order; measured 1e-6); the gate batch of one
launch against gate by gate exact; the physics bounds are the JAX tests'
(all-ones gate = single-turn FBP within 1e-4, the wide gate under 0.75x
and the thorax gate under 0.6x the ungated error, the narrow gate worse
than the wide).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import motion as jm
from dexct_tpu.ops.siddon import material_path_sinogram as j_paths
from dexct_tpu.ops.siddon import mono_sinogram as j_mono
from dexct_tpu.pipeline import gated as jg
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import contrast_rods_phantom as j_rods
from dexct_tpu.system.phantom import thorax_phantom as j_thorax
from dexct_tpu_torch.ops import fbp as t_fbp
from dexct_tpu_torch.ops import motion as tm
from dexct_tpu_torch.ops.siddon import material_path_sinogram, mono_sinogram
from dexct_tpu_torch.pipeline import gated as tg
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import contrast_rods_phantom as t_rods
from dexct_tpu_torch.system.phantom import thorax_phantom as t_thorax

CPU = torch.device("cpu")
MU = np.array([0.0, 0.20, 0.21, 0.45, 0.18, 0.22])
TURN = dict(N_channels=96, gamma_fan=0.8230337, SID=60.0, SDD=100.0)
N, FOV = 64, 64 * 0.35


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _geoms(n_rot):
    kw = dict(TURN, N_proj=n_rot * 96, rotation_total=n_rot * 2.0 * np.pi)
    return JFan(**kw), TFan(**kw)


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def moving():
    """Two rotations of the rods under a 3-cycle lateral oscillation: the
    JAX sinogram and the period."""
    jct, tct = _geoms(2)
    period = 96 * 2 / 3.0
    ph_v = jg.view_phases(jct.N_proj, period)
    disp = 0.6 * np.sin(2.0 * np.pi * ph_v)[:, None] * np.array([[1.0, 0.0]])
    motion = jm.MotionProfile(np.zeros(jct.N_proj), disp)
    sino = np.asarray(j_mono(jm.material_path_sinogram_motion(
        j_rods(N=N, dx=0.35), jct, motion), MU), np.float32)
    return jct, tct, period, sino


def test_phases_and_gate_weights_match_jax():
    for args in ((300, 76.8), (97, 33.3, 0.25)):
        np.testing.assert_array_equal(tg.view_phases(*args),
                                      jg.view_phases(*args))
    ph = jg.view_phases(300, 76.8)
    for center, width in ((0.0, 0.3), (0.25, 0.12), (0.9, 0.5)):
        np.testing.assert_array_equal(tg.gate_weights(ph, center, width),
                                      jg.gate_weights(ph, center, width))


@pytest.mark.parametrize("gate", ["ones", "wide", "narrow"])
def test_gated_fbp_recon_matches_jax(moving, gate):
    jct, tct, period, sino = moving
    ph = jg.view_phases(jct.N_proj, period)
    w = {"ones": np.ones(jct.N_proj),
         "wide": jg.gate_weights(ph, 0.25, 0.3),
         "narrow": jg.gate_weights(ph, 0.25, 0.12)}[gate]
    want = jg.gated_fbp_recon(jnp.asarray(sino), jct, N, FOV, w)
    got = tg.gated_fbp_recon(sino, tct, N, FOV, w, device=CPU)
    assert got.shape == (N, N) and got.device == CPU
    assert _max_rel(got, want) <= 1e-5


def test_gated_series_matches_jax(moving):
    jct, tct, period, sino = moving
    want = jg.gated_series(jnp.asarray(sino), jct, N, FOV, period,
                           n_gates=4, width=0.3)
    got = tg.gated_series(torch.as_tensor(sino), tct, N, FOV, period,
                          n_gates=4, width=0.3)
    assert got.shape == (4, N, N)
    assert _max_rel(got, want) <= 1e-5
    # opposite phases (poses +0.6 vs -0.6 cm) differ
    assert float(torch.sqrt(torch.mean((got[1] - got[3]) ** 2))) > 0.01


def test_gate_batch_is_gate_by_gate(moving):
    """One backprojection of G gates gives each gate's frame as its own
    call does: the gates share the geometry and nothing else."""
    jct, tct, period, sino = moving
    ph = tg.view_phases(tct.N_proj, period)
    w = np.stack([tg.gate_weights(ph, g / 5, 0.3) for g in range(5)])
    frames = tg._gated_backproject(
        t_fbp.filter_sinogram(torch.as_tensor(sino), tct),
        torch.as_tensor(tct.betas, dtype=torch.float32),
        torch.as_tensor(w, dtype=torch.float32), tct.SID, tct.dgamma, N,
        FOV)
    for g in range(5):
        one = tg.gated_fbp_recon(sino, tct, N, FOV, w[g], device=CPU)
        torch.testing.assert_close(frames[g], one, rtol=0, atol=0)


def test_all_ones_matches_single_turn_fbp():
    _, tct = _geoms(4)
    ph = t_rods(N=N, dx=0.35)
    sino = mono_sinogram(material_path_sinogram(ph, tct, device=CPU), MU)
    img = tg.gated_fbp_recon(sino, tct, N, FOV, np.ones(tct.N_proj))
    ct1 = TFan(**dict(TURN, N_proj=96))
    ref, _ = t_fbp.fbp_recon(mono_sinogram(
        material_path_sinogram(ph, ct1, device=CPU), MU), ct1, N, FOV)
    assert float((img - ref).abs().max()) < 1e-4


def _frozen_reference(ph, amp, direction, mu, fov):
    """The object frozen at the gate's pose: a single-turn static FBP."""
    ct1 = TFan(**dict(TURN, N_proj=96))
    const = tm.MotionProfile(np.zeros(96), np.broadcast_to(
        amp * np.asarray(direction), (96, 2)).copy())
    return t_fbp.fbp_recon(mono_sinogram(tm.material_path_sinogram_motion(
        ph, ct1, const, device=CPU), mu), ct1, N, fov)[0]


def _periodic_scan(ph, amp, direction, mu):
    _, tct = _geoms(4)
    period = 96 * 4 / 5.0  # 5 motion cycles over 4 rotations
    ph_v = tg.view_phases(tct.N_proj, period)
    disp = amp * np.sin(2.0 * np.pi * ph_v)[:, None] \
        * np.asarray(direction)[None, :]
    sino = mono_sinogram(tm.material_path_sinogram_motion(
        ph, tct, tm.MotionProfile(np.zeros(tct.N_proj), disp), device=CPU),
        mu)
    return tct, ph_v, sino


def test_gates_freeze_periodic_motion():
    """The JAX test's case on the port: the gate at the pose extreme (phase
    0.25) beats the ungated average, and a too narrow gate starves."""
    ph = t_rods(N=N, dx=0.35)
    dirv = np.array([1.0, 0.3]) / np.hypot(1.0, 0.3)
    tct, ph_v, sino = _periodic_scan(ph, 0.5, dirv, MU)
    ref = _frozen_reference(ph, 0.5, dirv, MU, FOV)

    def err(w):
        img = tg.gated_fbp_recon(sino, tct, N, FOV, w)
        return float(torch.sqrt(torch.mean((img - ref) ** 2)))

    e_un = err(np.ones(tct.N_proj))
    e_w = err(tg.gate_weights(ph_v, 0.25, width=0.3))
    e_n = err(tg.gate_weights(ph_v, 0.25, width=0.12))
    assert e_w < 0.75 * e_un, (e_un, e_w)
    assert e_n > e_w, (e_n, e_w)


def test_respiratory_thorax_matches_jax_and_freezes_the_lungs():
    """A breathing thorax (0.8 cm AP) over 4 rotations: the gated frame at
    the pose extreme within 1e-5 of the JAX frame, and under 0.6x the
    ungated error on the lungs."""
    ph = t_thorax(N=N, dx=0.55)
    fov = N * 0.55
    mu = ph.materials.mu_table(np.array([70.0]))[:, 0]
    ap = np.array([0.0, 1.0])
    tct, ph_v, sino = _periodic_scan(ph, 0.8, ap, mu)
    ref = _frozen_reference(ph, 0.8, ap, mu, fov)
    w = tg.gate_weights(ph_v, 0.25, width=0.3)
    gated = tg.gated_fbp_recon(sino, tct, N, fov, w)
    ungated = tg.gated_fbp_recon(sino, tct, N, fov, np.ones(tct.N_proj))
    jct, _ = _geoms(4)
    want = jg.gated_fbp_recon(jnp.asarray(sino.numpy()), jct, N, fov, w)
    assert _max_rel(gated, want) <= 1e-5
    lung = torch.as_tensor(ph.slice_labels() == 5)
    assert j_thorax(N=N, dx=0.55).slice_labels()[lung.numpy()].min() == 5
    e_un = float(torch.sqrt(torch.mean((ungated - ref)[lung] ** 2)))
    e_g = float(torch.sqrt(torch.mean((gated - ref)[lung] ** 2)))
    assert e_g < 0.6 * e_un, (e_un, e_g)


def test_gated_guards():
    q = torch.zeros(10, 8)
    with pytest.raises(ValueError, match="w must be"):
        tg._gated_backproject(q, torch.zeros(10), torch.ones(9), 60.0, 0.01,
                              8, 4.0)
