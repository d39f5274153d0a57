"""The port's rebinned parallel-beam reconstruction (plain versions on the
CPU) against the JAX package's: the rebin plan (exact), the 8- and 16-tap
rebin, the parallel backprojector against JAX's plain one and against the
8-fold symmetry composition the JAX pipeline runs (3e-5 x max, the bound
of tests/test_parallel_recon.py), and parallel-beam FBP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import fbp as j_fbp
from dexct_tpu.ops import fbp_fast as j_fast
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import ParallelBeamGeometry as JPar
from dexct_tpu_torch.ops import fbp as t_fbp
from dexct_tpu_torch.ops import fbp_fast as t_fast
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import ParallelBeamGeometry as TPar

GEOM = dict(N_channels=96, N_proj=90, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_theta,nt,t_max", [(64, 128, None),
                                              (48, 96, 20.0)])
def test_parallel_rebin_plan_matches_jax(n_theta, nt, t_max):
    want = j_fast.parallel_rebin_plan(JFan(**GEOM), n_theta, nt, t_max)
    got = t_fast.parallel_rebin_plan(TFan(**GEOM), n_theta, nt, t_max)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


def test_rebin_plan_rejects_partial_and_ffs_scans():
    with pytest.raises(ValueError, match="full 2\\*pi"):
        t_fast.parallel_rebin_plan(TFan(**GEOM, rotation_total=4.0))
    with pytest.raises(ValueError) as want:  # the JAX package's refusal
        j_fast.parallel_rebin_plan(JFan(**GEOM, ffs="inplane"))
    with pytest.raises(ValueError, match="parallel_rebin_plan_ffs") as got:
        t_fast.parallel_rebin_plan(TFan(**GEOM, ffs="inplane"))
    assert str(got.value) == str(want.value)


def _rebin_inputs(taps):
    rng = np.random.default_rng(11)
    if taps == 8:
        ct = JFan(**GEOM)
        idx, w, _, _ = j_fast.parallel_rebin_plan(ct, 64, 128)
        v, c = ct.N_proj, ct.N_channels
    else:
        from dexct_tpu.ops.ffs import parallel_rebin_plan_ffs

        ct = JFan(**GEOM, ffs="inplane")
        idx, w, _, _ = parallel_rebin_plan_ffs(ct, 64, 128)
        v, c = ct.N_proj, ct.N_channels
    sinos = rng.normal(size=(4, v, c)).astype(np.float32)
    return sinos, idx, w


@pytest.mark.parametrize("taps", [8, 16])
def test_rebin_to_parallel_matches_jax(taps):
    sinos, idx, w = _rebin_inputs(taps)
    want = np.asarray(j_fast.rebin_to_parallel(
        jnp.asarray(sinos), jnp.asarray(idx), jnp.asarray(w), 128,
        taps=taps))
    got = t_fast.rebin_to_parallel(torch.as_tensor(sinos),
                                   torch.as_tensor(idx), torch.as_tensor(w),
                                   128, taps=taps).numpy()
    assert got.shape == (4, 64, 128)
    assert np.abs(want).max() > 0.1
    # the same taps summed in another order
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rebin_pair_wraps_at_the_table_end():
    """A pair whose first tap is the last element reads element 0 next,
    as the JAX program's rolled table does."""
    rng = np.random.default_rng(3)
    sinos = rng.normal(size=(2, 4, 5)).astype(np.float32)
    idx = np.tile(np.array([19, 19, 0, 0, 7, 7, 12, 12], np.int32), 8)
    w = rng.uniform(0, 1, 64).astype(np.float32)
    want = np.asarray(j_fast.rebin_to_parallel(
        jnp.asarray(sinos), jnp.asarray(idx), jnp.asarray(w), 4))
    got = t_fast.rebin_to_parallel(torch.as_tensor(sinos),
                                   torch.as_tensor(idx), torch.as_tensor(w),
                                   4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _bp_inputs(nth, tfrac):
    rng = np.random.default_rng(7)
    K, nt, fov = 4, 64, 20.0
    t_max = fov / 2 * tfrac
    dt = 2 * t_max / nt
    t0 = -t_max + dt / 2
    qs = rng.standard_normal((K, nth, nt)).astype(np.float32)
    thetas = (np.arange(nth) * (np.pi / nth)).astype(np.float32)
    return qs, thetas, t0, dt, nt, fov


@pytest.mark.parametrize("fov_mask", [True, False])
@pytest.mark.parametrize("nth,N,tfrac", [(32, 48, 1.3), (64, 45, 0.8),
                                         (48, 33, 1.0)])
def test_parallel_backproject_matches_jax(nth, N, tfrac, fov_mask):
    qs, thetas, t0, dt, nt, fov = _bp_inputs(nth, tfrac)
    args = (t0, dt, nt, N, fov, np.pi / nth)
    want = np.asarray(j_fast.parallel_backproject_multi(
        j_fast.pack_filtered(jnp.asarray(qs)), 4, jnp.asarray(thetas),
        *args, fov_mask=fov_mask))
    got = t_fast.parallel_backproject_multi(
        t_fast.pack_filtered(torch.as_tensor(qs)), 4,
        torch.as_tensor(thetas), *args, fov_mask=fov_mask).numpy()
    assert got.shape == (4, N, N)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 3e-5 * scale
    if fov_mask:
        # the JAX pipeline's single-device path: 8-fold orbit kernel plus
        # the 4-fold boundary pass
        bsel = np.array([0, nth // 4, nth // 2, 3 * nth // 4])
        th = jnp.asarray(thetas)
        sym = np.asarray(j_fast.parallel_backproject_sym8(
            j_fast.pack_filtered_sym8(jnp.asarray(qs)), 4, th[1: nth // 4],
            *args) + j_fast.parallel_backproject_sym(
            j_fast.pack_filtered_sym(jnp.asarray(qs[:, bsel])), 4,
            th[bsel[:2]], *args))
        assert np.abs(got - sym).max() < 3e-5 * scale
        c = (np.arange(N) + 0.5 - N / 2.0) * (fov / N)
        outside = np.hypot(c[None, :], c[:, None]) > fov / 2.0
        assert outside.any() and not got[:, outside].any()


@pytest.mark.parametrize("rotation", [np.pi, 2 * np.pi])
def test_parallel_fbp_matches_jax(rotation):
    """fbp_recon's parallel-beam branch (K6 with K = 1) and parallel_fbp."""
    kw = dict(N_channels=96, N_proj=90, rotation_total=rotation)
    jct, tct = JPar(**kw), TPar(**kw)
    rng = np.random.default_rng(5)
    s = (np.arange(96) + 0.5 - 48) * jct.ds
    sino = (2.0 * np.sqrt(np.clip(12.0**2 - s**2, 0, None)) * 0.2
            + 0.01 * rng.normal(size=(90, 96))).astype(np.float32)
    want_raw, want_hu = j_fbp.fbp_recon(jnp.asarray(sino), jct, 64, 30.0,
                                        mu_water_eff=0.2)
    got_raw, got_hu = t_fbp.fbp_recon(torch.as_tensor(sino), tct, 64, 30.0,
                                      mu_water_eff=0.2)
    assert float(np.asarray(want_raw).max()) > 0.1  # a non-trivial image
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw),
                               atol=1e-4)
    np.testing.assert_allclose(got_hu.numpy(), np.asarray(want_hu), atol=0.5)
    np.testing.assert_allclose(
        t_fbp.parallel_fbp(torch.as_tensor(sino), tct, 64, 30.0).numpy(),
        np.asarray(j_fbp.parallel_fbp(jnp.asarray(sino), jct, 64, 30.0)),
        atol=1e-4)
