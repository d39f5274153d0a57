"""The port's Fourier-slice projector (plain versions on the CPU) against
the JAX package's: the host plan (exact), the KB sampler, the Radon
transform, the fan resample and the material paths.  Tolerances: the
sampler 1e-5 of the spectrum's largest sample (16 float32 taps, any
order); the resample atol 1e-5 (measured 2.4e-7); Radon transforms and
paths atol 1e-4 cm, because the two FFT libraries (PyTorch's pocketfft,
XLA's) round differently: measured 7.6e-6 on 20 cm and 8.1e-6 on 40 cm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import fourier as j_fo
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import water_cylinder_phantom as j_cyl
from dexct_tpu_torch.ops import fourier as t_fo
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import pelvis_phantom as t_pelvis
from dexct_tpu_torch.system import water_cylinder_phantom as t_cyl

GEOM = dict(N_channels=80, N_proj=48, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plans():
    """The same 64^2 cylinder and scan planned by both packages."""
    jplan = j_fo.plan_fourier_projector(j_cyl(N=64, dx=0.4), JFan(**GEOM),
                                        n_theta=96)
    tplan = t_fo.plan_fourier_projector(t_cyl(N=64, dx=0.4), TFan(**GEOM),
                                        n_theta=96, device="cpu")
    return jplan, tplan


def test_kb_host_math_matches_jax():
    u = np.linspace(-2.5, 2.5, 101)
    np.testing.assert_array_equal(t_fo._kb_kernel(u), j_fo._kb_kernel(u))
    np.testing.assert_array_equal(t_fo._kb_deapod_1d(48, 96),
                                  j_fo._kb_deapod_1d(48, 96))
    for g, w in zip(t_fo.radon_grid(48, 0.3, 64), j_fo.radon_grid(48, 0.3,
                                                                  64)):
        np.testing.assert_array_equal(g, w)


def test_plan_matches_jax_exactly(plans):
    jplan, tplan = plans
    for f in ("n_img", "n_materials", "dx", "n_theta", "nt", "t0", "dt",
              "grid", "scale"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    for f in ("deapod", "slice_idx", "slice_w", "phase_cos", "phase_sin",
              "fan_idx", "fan_w"):
        got, want = getattr(tplan, f).numpy(), np.asarray(getattr(jplan, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    arrs = t_fo.plan_arrays(tplan, (48, 80))
    for k, v in j_fo.plan_arrays(jplan, (48, 80)).items():
        np.testing.assert_array_equal(arrs[k].numpy(), np.asarray(v), k)


def test_plan_rejects_non_square_grids():
    ph = t_cyl(N=32, dx=0.5)
    ph.labels = ph.labels[:, :30]
    with pytest.raises(ValueError, match="square phantom"):
        t_fo.plan_fourier_projector(ph, TFan(**GEOM), device="cpu")


def test_kb_sample_matches_float64_loop(plans):
    """The sampler against the gridding sum written out tap by tap in
    float64 on a random complex spectrum."""
    _, tplan = plans
    rng = np.random.default_rng(2)
    G, M = tplan.grid, 3
    F = (rng.normal(size=(M, G, G))
         + 1j * rng.normal(size=(M, G, G))).astype(np.complex64)
    got = t_fo.kb_sample(torch.as_tensor(F), tplan.slice_idx, tplan.slice_w,
                         tplan.phase_cos, tplan.phase_sin).numpy()
    nth, nl = tplan.phase_cos.shape
    base = tplan.slice_idx.numpy().astype(np.int64)
    w = tplan.slice_w.numpy().reshape(-1, 16).astype(np.float64)
    vb, ub = base // G, base % G
    z = np.zeros((M, base.size), np.complex128)
    for i in range(4):
        for j in range(4):
            z += w[:, i * 4 + j] * F[:, (vb + j) % G, (ub + i) % G]
    ph = (tplan.phase_cos.numpy().astype(np.float64)
          + 1j * tplan.phase_sin.numpy()).reshape(-1)
    want = (z * ph).reshape(M, nth, nl)
    assert got.shape == (M, nth, nl) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("packed_table", [True, False])
def test_radon_from_images_matches_jax(plans, packed_table):
    """Random images through deapodize, FFT, the sampler and the radial
    inverse FFT; both JAX table layouts give the port's one sum."""
    jplan, tplan = plans
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
    kw = dict(n_theta=96, nt=tplan.nt, grid=tplan.grid, n_img=64)
    want = np.asarray(j_fo._radon_from_images(
        jnp.asarray(imgs), jplan.deapod, jplan.slice_idx, jplan.slice_w,
        jplan.phase_cos, jplan.phase_sin, jplan.scale,
        packed_table=packed_table, **kw))
    got = t_fo._radon_from_images(
        torch.as_tensor(imgs), tplan.deapod, tplan.slice_idx, tplan.slice_w,
        tplan.phase_cos, tplan.phase_sin, tplan.scale,
        packed_table=packed_table, **kw).numpy()
    assert got.shape == (3, 96, tplan.nt)
    assert np.abs(want).max() > 10.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resample_to_fan_matches_jax(plans):
    jplan, tplan = plans
    rng = np.random.default_rng(6)
    radon = rng.normal(size=(5, 96, tplan.nt)).astype(np.float32)
    want = np.asarray(j_fo._resample_to_fan(
        jnp.asarray(radon), jplan.fan_idx, jplan.fan_w, (48, 80, 5)))
    got = t_fo.resample_to_fan(torch.as_tensor(radon), tplan.fan_idx,
                               tplan.fan_w, (48, 80, 5)).numpy()
    assert got.shape == (48, 80, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fourier_paths_match_jax():
    """Material paths of a 6-label pelvis (96^2) at n_theta = 128 through
    both packages, and the pipeline's array-dict form."""
    from dexct_tpu.system import pelvis_phantom as j_pelvis

    jph, tph = j_pelvis(N=96, dx=0.4), t_pelvis(N=96, dx=0.4)
    jct, tct = JFan(**GEOM), TFan(**GEOM)
    jplan = j_fo.plan_fourier_projector(jph, jct, n_theta=128)
    tplan = t_fo.plan_fourier_projector(tph, tct, n_theta=128, device="cpu")
    want = np.asarray(j_fo.fourier_paths(
        jplan, jnp.asarray(jph.slice_labels().astype(np.int32)), (48, 80)))
    labels = torch.as_tensor(tph.slice_labels().astype(np.uint8))
    got = t_fo.fourier_paths(tplan, labels, (48, 80)).numpy()
    assert got.shape == (48, 80, tph.n_materials)
    assert want.max() > 5.0  # cm-scale chords
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    meta = (tplan.n_materials, tplan.n_theta, tplan.nt, tplan.grid,
            tplan.n_img, tplan.scale)
    arrs = t_fo.plan_arrays(tplan, (48, 80))
    np.testing.assert_array_equal(
        t_fo.fourier_paths_from_arrays(arrs, labels, meta).numpy(), got)


def test_onehot_ignores_out_of_range_labels():
    lab = torch.tensor([[0, 1], [2, 7]], dtype=torch.uint8)
    got = t_fo._onehot_images(lab, 3).numpy()
    want = np.asarray(j_fo._onehot_images(jnp.asarray(lab.numpy()), 3))
    np.testing.assert_array_equal(got, want)
    assert got[:, 1, 1].sum() == 0


@pytest.mark.parametrize("view", ["conj", "neg"])
def test_kernel_arguments_refuse_lazy_views(view):
    """A kernel reads the memory behind ``data_ptr()``: ``kernels.require``
    refuses a tensor whose conjugate or negation is a lazy bit (the card's
    K21 would read the unconjugated samples), and takes it resolved."""
    from dexct_tpu_torch.utils import kernels

    z = torch.complex(torch.ones(2, 3), torch.ones(2, 3))
    t = z.conj() if view == "conj" else torch._neg_view(z)
    with pytest.raises(ValueError, match="lazy"):
        kernels.require(t, "g", t.device, torch.complex64)
    res = t.resolve_conj().resolve_neg()
    assert kernels.require(res, "g", t.device, torch.complex64) is res
