"""The port's tube-current modulation (``pipeline/tcm.py``) and
``forward_counts(tcm=, sigma_e=)`` against the JAX package's, on the CPU.

Inputs: the JAX tests' eccentric water ellipse (``tests/test_tcm.py``: 64^2
at 0.35 cm, 96 channels x 128 views, linac 2 mGy / 80 kV 0.3 mGy) with
material paths made once by the JAX package and fed to both.  Tolerances:
the profile to 1e-6 absolute (float32 means over 96 channels summed in
another order); the z profile equal (the same float64 NumPy); the
noiseless modulated scan equal to the unmodulated one to the JAX test's
bars (log sinogram atol 2e-6, counts rtol 1e-6); the whole pipeline to
tests/test_torch_pipeline.py's TOL, on the port's own trace (its tracer and
the JAX package's take other float32 steps).  Noise draws come from
``torch.Generator``s, so they are compared by their statistics: the mean
and variance of compound draws with a per-view output and an electronic
floor, over 3000 views per output level, within 5 standard errors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops.siddon import material_path_sinogram
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline import tcm as j_tcm
from dexct_tpu.system import FanBeamGeometry, water_cylinder_phantom
from dexct_tpu_torch.ops import spectral as t_sp
from dexct_tpu_torch.pipeline import tcm as t_tcm
from dexct_tpu_torch.pipeline.api import simulate_dect as t_simulate
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from test_torch_pipeline import TOL

GEO = dict(N_channels=96, N_proj=128, gamma_fan=0.8230337, SID=60.0,
           SDD=100.0, eid=True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_CASE = {}


def _case():
    if not _CASE:
        jct, tct = FanBeamGeometry(**GEO), TFan(**GEO)
        ph = water_cylinder_phantom(N=64, dx=0.35)
        yy, xx = np.mgrid[0:64, 0:64]
        ell = (((xx - 31.5) / (0.45 * 64)) ** 2
               + ((yy - 31.5) / (0.18 * 64)) ** 2) <= 1.0
        ph = dataclasses.replace(ph, labels=ell.astype(np.uint8)[None])
        s1 = linac_spectrum()
        s1.rescale_counts(jct.A_iso * 2.0 / jct.N_proj)
        s2 = kramers_spectrum(80.0)
        s2.rescale_counts(jct.A_iso * 0.3 / jct.N_proj)
        paths = np.array(material_path_sinogram(ph, jct))
        _CASE.update(jct=jct, tct=tct, ph=ph, s=(s1, s2), paths=paths)
    return _CASE


@pytest.mark.parametrize("kw", [dict(), dict(strength=0.5),
                                dict(normalize="noise"),
                                dict(channel_window=0.05, m_max=1.5)])
def test_profile_matches_jax(kw):
    c = _case()
    want, winfo = j_tcm.auto_tcm_profile(
        c["jct"], c["ph"], c["s"][0], paths=jnp.asarray(c["paths"]),
        report=True, **kw)
    got, info = t_tcm.auto_tcm_profile(
        c["tct"], c["ph"], c["s"][0], paths=torch.as_tensor(c["paths"]),
        report=True, **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for key in ("var_ratio", "dose_ratio"):
        assert info[key] == pytest.approx(winfo[key], rel=1e-5)
    np.testing.assert_allclose(info["potential"], winfo["potential"],
                               rtol=1e-5)


def test_profile_on_the_cpu_from_its_own_trace():
    c = _case()
    m = t_tcm.auto_tcm_profile(c["tct"], c["ph"], c["s"][0], device="cpu")
    assert m.device.type == "cpu"
    assert float(m.mean()) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="normalize"):
        t_tcm.auto_tcm_profile(c["tct"], c["ph"], c["s"][0], device="cpu",
                               normalize="dose")


def _host_copies(monkeypatch):
    """Put back the host copies that ``pipeline/tcm.py`` made before its
    uploads went through ``utils.devices.upload`` and ``_scalar``."""
    def as_tensor(x, like, dtype=None):
        dev = like.device if torch.is_tensor(like) else torch.device(like)
        return torch.as_tensor(x, dtype=like.dtype if dtype is None
                               else dtype, device=dev)

    monkeypatch.setattr(t_tcm, "upload", as_tensor)
    monkeypatch.setattr(t_tcm, "_scalar", lambda v, like: torch.tensor(
        v, dtype=like.dtype, device=like.device))


@pytest.mark.parametrize("kw", [dict(), dict(normalize="noise")])
def test_uploads_keep_the_host_copies_bits(monkeypatch, kw):
    """``auto_tcm_profile`` and ``normalize_counts`` (NumPy ``m``) give, on
    the CPU, the bits they gave with ``torch.as_tensor``/``torch.tensor``
    host copies."""
    c = _case()
    paths = torch.as_tensor(c["paths"])
    counts = np.random.default_rng(3).uniform(
        1e2, 1e4, (GEO["N_proj"], GEO["N_channels"])).astype(np.float32)
    m_host = np.linspace(0.5, 2.0, GEO["N_proj"])

    def run():
        m = t_tcm.auto_tcm_profile(c["tct"], c["ph"], c["s"][0],
                                   paths=paths, **kw)
        return m, t_tcm.normalize_counts(counts, m_host, device="cpu")

    got = run()
    _host_copies(monkeypatch)
    want = run()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_forward_counts_tcm_invariance_and_normalization():
    """The JAX test's identity (tests/test_tcm.py:179-197) on the port:
    counts scale by m, the log sinogram does not move, and
    ``normalize_counts`` restores the unmodulated counts."""
    c = _case()
    s = c["s"][1]
    p = torch.as_tensor(c["paths"])
    m = np.linspace(0.5, 2.0, GEO["N_proj"])
    raw0, log0 = t_sp.forward_counts(p, c["ph"], s, c["tct"])
    raw1, log1 = t_sp.forward_counts(p, c["ph"], s, c["tct"], tcm=m)
    np.testing.assert_allclose(raw1.numpy(), raw0.numpy() * m[:, None],
                               rtol=1e-6)
    np.testing.assert_allclose(log1.numpy(), log0.numpy(), rtol=0,
                               atol=2e-6)
    back = t_tcm.normalize_counts(raw1, m)
    np.testing.assert_allclose(back.numpy(), raw0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(j_tcm.normalize_counts(
            jnp.asarray(raw1.numpy()), m)), rtol=1e-6)
    # numpy counts on the CPU when asked
    assert t_tcm.normalize_counts(raw1.numpy(), m,
                                  device="cpu").device.type == "cpu"


def test_compound_draws_with_tcm_and_sigma_e_have_the_model_statistics():
    """Mean ``s(v) counts`` and variance ``s(v) var + sigma_e^2`` of
    compound draws: 3000 views at output 0.5 and 3000 at 2.0, all views
    through the same 8 rays of the phantom."""
    c = _case()
    s = c["s"][1]
    rays = torch.as_tensor(c["paths"][5, 44:52])  # 8 rays through the body
    p = rays.expand(6000, 8, rays.shape[-1]).contiguous()
    m = np.repeat([0.5, 2.0], 3000).astype(np.float32)
    mu = torch.as_tensor(c["ph"].materials.mu_table(s.E)).float()
    counts, var = t_sp.counts_from_paths(
        rays, mu, torch.as_tensor(t_sp.effective_fluence(s, c["tct"])).float(),
        torch.as_tensor(t_sp.second_moment_fluence(s, c["tct"])).float())
    sigma_e = float(2.0 * var.max().sqrt())  # comparable to quantum noise
    gen = torch.Generator().manual_seed(11)
    draws, log = t_sp.forward_counts(p, c["ph"], s, c["tct"],
                                     noise="compound", generator=gen,
                                     tcm=m, sigma_e=sigma_e)
    assert torch.isfinite(log).all()
    for lo, level in ((0, 0.5), (3000, 2.0)):
        d = draws[lo:lo + 3000].double()
        mean_want = level * counts.double()
        var_want = level * var.double() + sigma_e ** 2
        se_mean = (var_want / 3000).sqrt()
        assert torch.all((d.mean(0) - mean_want).abs() < 5 * se_mean)
        rel = (d.var(0) / var_want - 1.0).abs()
        assert float(rel.max()) < 5 * np.sqrt(2.0 / 3000)


def test_noiseless_tcm_pipeline_is_the_unmodulated_pipeline():
    """The JAX test's bars on the port's own pipeline
    (tests/test_tcm.py:51-60)."""
    c = _case()
    base = t_simulate(c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8,
                      device="cpu", n_iters=8)
    got = t_tcm.simulate_tcm_dect(c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8,
                                  n_iters=8, device="cpu")
    np.testing.assert_allclose(got.recon_raw[0].numpy(),
                               base.recon_raw[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(got.mat_sinos[0].numpy(),
                               base.mat_sinos[0].numpy(), atol=1e-4)


def test_simulate_tcm_dect_matches_jax():
    c = _case()
    want = j_tcm.simulate_tcm_dect(c["jct"], c["ph"], *c["s"], 64, 20.0, 0.8,
                                   n_iters=8)
    got = t_tcm.simulate_tcm_dect(c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8,
                                  n_iters=8, device="cpu")
    for key in ("sino_log", "mat_sinos", "recon_raw", "mat_recons"):
        for i in range(2):
            np.testing.assert_allclose(getattr(got, key)[i].numpy(),
                                       np.asarray(getattr(want, key)[i]),
                                       err_msg=f"{key}[{i}]", **TOL[key])


@pytest.mark.parametrize("sigma_e", [0.0, (1e3, 2e3)])
def test_compound_tcm_pipeline_runs_on_the_cpu(sigma_e):
    c = _case()
    gen = torch.Generator().manual_seed(4)
    res = t_tcm.simulate_tcm_dect(c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8,
                                  n_iters=4, noise="compound", generator=gen,
                                  sigma_e=sigma_e, device="cpu",
                                  do_recon=False)
    assert all(x.device.type == "cpu" and bool(torch.isfinite(x).all())
               for x in res.sino_log + res.mat_sinos)
    with pytest.raises(ValueError, match="Generator"):
        t_tcm.simulate_tcm_dect(c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8,
                                noise="compound", device="cpu")


def test_z_profile_matches_jax():
    from dexct_tpu.system import HelicalConeBeamGeometry

    ct = HelicalConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4,
                                 h_iso=0.5, rotation_total=4 * np.pi,
                                 pitch=2.0)
    ph2 = water_cylinder_phantom(N=32, dx=0.6)
    lab = np.broadcast_to(ph2.labels[0], (8, 32, 32)).copy()
    lab[:3] = 0
    ph = dataclasses.replace(ph2, labels=lab, dz=0.5)
    for spec in (None, _case()["s"][1]):
        for got, want in zip(t_tcm.z_profile_from_volume(ph, ct, spec),
                             j_tcm.z_profile_from_volume(ph, ct, spec)):
            np.testing.assert_array_equal(got, want)
