"""The port's polyenergetic forward model (plain version on the CPU)
against the JAX package's: counts rtol 1e-5, log sinogram, and noise by
its statistics (PyTorch and JAX draw different numbers from one seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import spectral as j_sp
from dexct_tpu_torch.ops import spectral as t_sp


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(0)
    paths = rng.uniform(0.0, 8.0, (40, 30, 6)).astype(np.float32)
    paths[0, 0] = 0.0  # an air ray
    mu = rng.uniform(0.01, 1.5, (6, 140)).astype(np.float32)
    i0 = rng.uniform(0.0, 1e7, 140).astype(np.float32)
    return paths, mu, i0


def test_counts_match_jax(tables):
    paths, mu, i0 = tables
    want = np.asarray(j_sp.counts_from_paths(
        jnp.asarray(paths), jnp.asarray(mu), jnp.asarray(i0)))
    got = t_sp.counts_from_paths(*(torch.as_tensor(x) for x in tables))
    assert got.shape == (40, 30)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got[0, 0].item(), i0.astype(np.float64).sum(),
                               rtol=1e-5)


def test_counts_rounding_is_the_expressions(tables):
    """The plain counts are bit for bit the float32 exponent summed in
    material order (elementwise NumPy, no BLAS), its exp in float64 and
    the energy sum taken exactly, rounded once to float32: no CPU BLAS or
    vector-math kernel, whose choice follows the host's instruction set,
    picks the rounding."""
    import math

    paths, mu, i0 = tables
    L = paths[..., :1] * mu[0]
    for m in range(1, mu.shape[0]):
        L = L + paths[..., m:m + 1] * mu[m]
    terms = np.exp(np.clip(-L, -700.0, 2.0).astype(np.float64)) \
        * i0.astype(np.float64)
    want = np.array([math.fsum(row) for row in terms.reshape(-1, 140)],
                    np.float32).reshape(40, 30)
    got = t_sp.counts_from_paths_plain(*(torch.as_tensor(x) for x in tables))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_second_table_shares_the_pass(tables):
    paths, mu, i0 = (torch.as_tensor(x) for x in tables)
    i2 = i0 * 70.0
    c, v = t_sp.counts_from_paths(paths, mu, i0, i2)
    torch.testing.assert_close(c, t_sp.counts_from_paths(paths, mu, i0))
    torch.testing.assert_close(v, t_sp.counts_from_paths(paths, mu, i2))


def test_multibin_counts_match_jax(tables):
    """A stacked [E, M] fluence table (M photon-counting bins) gives
    counts [..., M] equal to JAX's ``counts_from_paths(paths, mu,
    i0s.T)`` at K2's bar (rtol 1e-5); with a second-moment table it is
    refused by a ValueError (the check precedes the device dispatch)."""
    paths, mu, _ = tables
    rng = np.random.default_rng(9)
    i0s = rng.uniform(0.0, 1e7, (4, 140)).astype(np.float32)
    i0s[:, :20] = 0.0  # the bins start at a threshold
    want = np.asarray(j_sp.counts_from_paths(
        jnp.asarray(paths), jnp.asarray(mu), jnp.asarray(i0s.T)))
    t_i0 = torch.as_tensor(i0s.T.copy())
    got = t_sp.counts_from_paths(torch.as_tensor(paths), torch.as_tensor(mu),
                                 t_i0)
    assert got.shape == want.shape == (40, 30, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), t_sp.counts_from_paths_multibin(
            torch.as_tensor(paths), torch.as_tensor(mu), t_i0).numpy(),
        rtol=0)
    with pytest.raises(ValueError, match="second-moment"):
        t_sp.counts_from_paths(torch.as_tensor(paths), torch.as_tensor(mu),
                               t_i0, t_i0)


def test_log_sinogram_matches_jax():
    counts = np.array([[1e10, 3.5e7], [2.0, 1.0]], np.float32)
    want = np.asarray(j_sp.log_sinogram(jnp.asarray(counts), 2e10))
    got = t_sp.log_sinogram(torch.as_tensor(counts), 2e10).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a zero count floors at 1e-30; 1e-30 / air is subnormal in float32,
    # which XLA on the CPU flushes to 0 (giving inf) and PyTorch keeps
    zero = t_sp.log_sinogram(torch.zeros(1), 2e10)
    np.testing.assert_allclose(zero.numpy(), [np.log(2e10 / 1e-30)],
                               rtol=1e-4)


def test_forward_counts_matches_jax():
    from dexct_tpu.physics import kramers_spectrum as jk
    from dexct_tpu.system import FanBeamGeometry as JFan
    from dexct_tpu.system import water_cylinder_phantom as jw
    from dexct_tpu_torch.physics import kramers_spectrum as tk
    from dexct_tpu_torch.system import FanBeamGeometry as TFan
    from dexct_tpu_torch.system import water_cylinder_phantom as tw

    paths = np.random.default_rng(1).uniform(0, 20, (8, 16, 2)).astype(
        np.float32)
    raw_j, log_j = j_sp.forward_counts(jnp.asarray(paths), jw(N=16),
                                       jk(80.0), JFan(N_channels=16))
    raw_t, log_t = t_sp.forward_counts(torch.as_tensor(paths), tw(N=16),
                                       tk(80.0), TFan(N_channels=16))
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), rtol=1e-5)
    np.testing.assert_allclose(log_t.numpy(), np.asarray(log_j), atol=1e-5)


@pytest.mark.parametrize("mode", ["compound", "poisson", "gaussian"])
def test_noise_statistics_match_jax(mode):
    """Mean and variance of many draws, per model, against the JAX
    sampler's; draws themselves differ by design."""
    n = 200_000
    mean = 4.0e4 if mode == "poisson" else 1.0e8
    counts = np.full(n, mean, np.float32)
    var = np.full(n, 50.0 * mean, np.float32)
    got = t_sp.sample_noise(torch.Generator().manual_seed(0),
                            torch.as_tensor(counts), mode,
                            var=torch.as_tensor(var)).double().numpy()
    ref = np.asarray(j_sp.sample_noise(jax.random.PRNGKey(0),
                                       jnp.asarray(counts), mode,
                                       var=jnp.asarray(var)), np.float64)
    want_var = var[0] if mode == "compound" else mean
    for draws in (got, ref):
        # 5 standard errors of the mean and of the variance
        assert abs(draws.mean() - mean) < 5 * np.sqrt(want_var / n)
        assert abs(draws.var() / want_var - 1.0) < 5 * np.sqrt(2.0 / n)


def test_noise_is_seeded():
    c = torch.full((1000,), 50.0)
    a = t_sp.sample_noise(torch.Generator().manual_seed(3), c, "poisson")
    b = t_sp.sample_noise(torch.Generator().manual_seed(3), c, "poisson")
    d = t_sp.sample_noise(torch.Generator().manual_seed(4), c, "poisson")
    torch.testing.assert_close(a, b)
    assert bool((a != d).any())
    assert torch.equal(t_sp.sample_noise(None, c, "none"), c)
    with pytest.raises(ValueError, match="compound"):
        t_sp.sample_noise(torch.Generator(), c, "compound")


def _forward_counts_as_tensor(paths, phantom, spec, geometry, noise,
                              generator, bowtie, tcm, sigma_e):
    """``forward_counts`` with every host array made a tensor by
    ``torch.as_tensor`` and ``sigma_e`` by ``torch.tensor``: the reference
    for its uploads through pinned memory and ``torch.full``."""
    from dexct_tpu_torch.ops import bowtie as t_bt

    dev = paths.device
    mu = torch.as_tensor(phantom.materials.mu_table(spec.E),
                         dtype=torch.float32, device=dev)
    compound = noise == "compound"
    if bowtie is not None:
        i0_h = t_bt.bowtie_fluence(spec, geometry, bowtie)
        air = torch.as_tensor(i0_h.sum(-1), dtype=torch.float32, device=dev)
        i2_h = t_bt.bowtie_second_moment(spec, geometry, bowtie)
    else:
        i0_h = t_sp.effective_fluence(spec, geometry)
        air = float(np.sum(i0_h))
        i2_h = t_sp.second_moment_fluence(spec, geometry)
    i0 = torch.as_tensor(i0_h, dtype=torch.float32, device=dev)
    per_channel = bowtie is not None
    var = None
    if compound:
        i2 = torch.as_tensor(i2_h, dtype=torch.float32, device=dev)
        counts, var = t_sp.counts_from_paths(paths, mu, i0, i2,
                                             per_channel=per_channel)
    else:
        counts = t_sp.counts_from_paths(paths, mu, i0,
                                        per_channel=per_channel)
    if tcm is not None:
        s = torch.as_tensor(tcm, dtype=torch.float32, device=dev)
        s = s.reshape(tuple(s.shape) + (1,) * (counts.ndim - 1))
        counts, air = counts * s, air * s
        if var is not None:
            var = var * s
    if noise != "none":
        if var is not None and sigma_e:
            var = var + torch.tensor(float(sigma_e), dtype=torch.float32,
                                     device=dev) ** 2
        counts = t_sp.sample_noise(generator, counts, noise, var=var)
    return counts, t_sp.log_sinogram(counts, air)


@pytest.mark.parametrize("case", ["plain", "bowtie", "tcm", "compound"])
def test_forward_counts_uploads_keep_the_bits(case):
    """``forward_counts`` (plain; with a bowtie; with a TCM profile; in
    compound mode with ``sigma_e``, a bowtie and a TCM profile) gives on
    the CPU bit for bit what the same inputs give when made tensors with
    ``torch.as_tensor``."""
    from dexct_tpu_torch.ops.bowtie import design_flattening_bowtie
    from dexct_tpu_torch.physics import kramers_spectrum
    from dexct_tpu_torch.system import FanBeamGeometry, water_cylinder_phantom

    ct = FanBeamGeometry(N_channels=24, N_proj=10, eid=True)
    ph = water_cylinder_phantom(N=16)
    spec = kramers_spectrum(80.0)
    spec.rescale_counts(1e6)
    rng = np.random.default_rng(21)
    paths = torch.as_tensor(rng.uniform(0.0, 12.0, (10, 24, ph.n_materials)),
                            dtype=torch.float32)
    kw = dict(noise="none", bowtie=None, tcm=None, sigma_e=0.0)
    if case in ("bowtie", "compound"):
        kw["bowtie"] = design_flattening_bowtie(ct, 8.0)
    if case in ("tcm", "compound"):
        kw["tcm"] = rng.uniform(0.5, 2.0, 10)
    if case == "compound":
        kw.update(noise="compound", sigma_e=37.5)
    got = t_sp.forward_counts(paths, ph, spec, ct,
                              generator=torch.Generator().manual_seed(5),
                              **kw)
    want = _forward_counts_as_tensor(paths, ph, spec, ct,
                                     generator=torch.Generator().manual_seed(
                                         5), **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)


def test_material_path_sinogram_uploads_keep_the_bits():
    """``material_path_sinogram`` traces the labels and rays it uploads
    bit for bit as it traces the same arrays made tensors with
    ``torch.as_tensor``; ``mono_sinogram`` contracts a NumPy mu vector as
    it contracts the tensor."""
    from dexct_tpu_torch.ops import siddon
    from dexct_tpu_torch.system import FanBeamGeometry, water_cylinder_phantom

    ph = water_cylinder_phantom(N=24, dx=0.6)
    ct = FanBeamGeometry(N_channels=32, N_proj=12, eid=True)
    got = siddon.material_path_sinogram(ph, ct, device="cpu")
    src, dirs = ct.ray_geometry()
    want = siddon.trace_paths(
        torch.as_tensor(ph.slice_labels().astype(np.uint8)),
        torch.as_tensor(src, dtype=torch.float32),
        torch.as_tensor(dirs, dtype=torch.float32), float(ph.dx),
        float(ph.dy), n_materials=ph.n_materials)
    assert torch.equal(got, want)
    mu = np.linspace(0.1, 0.3, ph.n_materials)
    assert torch.equal(siddon.mono_sinogram(got, mu),
                       siddon.mono_sinogram(got, torch.as_tensor(
                           mu, dtype=torch.float32)))
