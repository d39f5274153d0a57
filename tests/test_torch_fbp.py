"""The port's fan-beam FBP (plain versions on the CPU) against the JAX
package's: filter + packed 4-image backprojection, the one-image
composed path, and short-scan weights.  Tolerance: atol 1e-4 cm^-1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import fbp as j_fbp
from dexct_tpu.ops import fbp_fast as j_fast
from dexct_tpu.pipeline.fused import _filter_views as j_filter_views
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu_torch.ops import fbp as t_fbp
from dexct_tpu_torch.ops import fbp_fast as t_fast
from dexct_tpu_torch.ops.filters import filter_frequency_response
from dexct_tpu_torch.system import FanBeamGeometry as TFan

GEOM = dict(N_channels=96, N_proj=90, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sinos():
    """Four smooth-ish sinograms [4, 90, 96] of cm-scale line integrals."""
    rng = np.random.default_rng(0)
    v, c = np.meshgrid(np.arange(90), np.arange(96), indexing="ij")
    base = np.clip(20.0 - np.abs(c - 47.5) * 0.45, 0.0, None) * 0.2
    return np.stack([base * (1.0 + 0.1 * k) + 0.05 * rng.normal(size=v.shape)
                     for k in range(4)]).astype(np.float32)


def test_pack_filtered_matches_jax(sinos):
    np.testing.assert_array_equal(
        t_fast.pack_filtered(torch.as_tensor(sinos)).numpy(),
        np.asarray(j_fast.pack_filtered(jnp.asarray(sinos))))


def test_filter_and_4_image_backprojection_match_jax(sinos):
    ct = JFan(**GEOM)
    H, m = filter_frequency_response(ct.N_channels, ct.dgamma, 0.8, "sinc",
                                     "fan")
    cos_w = (np.cos(ct.gammas) * ct.SID).astype(np.float32)
    q_j = j_filter_views(jnp.asarray(sinos), jnp.asarray(cos_w),
                         jnp.asarray(H, jnp.float32), m, ct.dgamma)
    q_t = t_fbp.filter_views(torch.as_tensor(sinos), torch.as_tensor(cos_w),
                             torch.as_tensor(H, dtype=torch.float32), m,
                             ct.dgamma)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-3,
                               rtol=1e-5)
    betas = ct.betas.astype(np.float32)
    args = (4, ct.SID, ct.dgamma, ct.N_channels, 64, 24.0,
            2 * np.pi / ct.N_proj)
    want = np.asarray(j_fast.fan_backproject_multi(
        j_fast.pack_filtered(q_j), args[0], jnp.asarray(betas), *args[1:]))
    got = t_fast.fan_backproject_multi(
        t_fast.pack_filtered(q_t), args[0], torch.as_tensor(betas),
        *args[1:]).numpy()
    assert got.shape == (4, 64, 64)
    assert np.abs(want).max() > 0.05  # a non-trivial image
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("rotation", [2 * np.pi, np.pi + 0.9])
def test_fbp_recon_matches_jax(sinos, rotation):
    """The composed path's one-image reconstruction (K = 1), full scan and
    Parker-weighted short scan."""
    jct = JFan(**GEOM, rotation_total=rotation)
    tct = TFan(**GEOM, rotation_total=rotation)
    np.testing.assert_array_equal(t_fbp.parker_weights(tct),
                                  j_fbp.parker_weights(jct))
    want_raw, want_hu = j_fbp.fbp_recon(jnp.asarray(sinos[0]), jct, 64, 24.0,
                                        mu_water_eff=0.2)
    got_raw, got_hu = t_fbp.fbp_recon(torch.as_tensor(sinos[0]), tct, 64,
                                      24.0, mu_water_eff=0.2)
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw),
                               atol=1e-4)
    np.testing.assert_allclose(got_hu.numpy(), np.asarray(want_hu), atol=0.5)


def test_unported_geometries_raise(sinos):
    """No geometry raises any longer: a flying-focal-spot scan, once
    refused, reconstructs through the 16-tap interleaved rebin as the JAX
    package's does (tests/test_torch_ffs.py holds it at its own bar);
    parallel-beam FBP runs (tests/test_torch_parallel_recon.py)."""
    kw = dict(GEOM, N_proj=90)
    want_raw, want_hu = j_fbp.fbp_recon(jnp.asarray(sinos[0]),
                                        JFan(**kw, ffs="inplane"), 64, 24.0,
                                        mu_water_eff=0.2)
    got_raw, got_hu = t_fbp.fbp_recon(torch.as_tensor(sinos[0]),
                                      TFan(**kw, ffs="inplane"), 64, 24.0,
                                      mu_water_eff=0.2)
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw),
                               atol=1e-4)
    np.testing.assert_allclose(got_hu.numpy(), np.asarray(want_hu), atol=0.5)
