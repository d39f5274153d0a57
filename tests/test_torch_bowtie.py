"""The port's bowtie filtration (``ops/bowtie.py``), its table-indexed
counts (``counts_from_table``, the plain twin of K28), its grouped
decomposition (``gauss_newton_solve_grouped``, the plain twin of K29) and
the bowtie water BHC against the JAX package's, on the CPU.

Inputs: the JAX tests' 64-channel fan (``tests/test_bowtie.py``) through a
5 cm tissue cylinder, 80/140 kV, an 8-level bowtie; material paths made
once by the JAX package and fed to both.  Tolerances: host float64 tables
to rtol 1e-12 (the same NumPy operations); counts to rel 1e-5 (K2's bar:
float32 exponents summed in another order); the decomposition to K3's
parity of rtol/atol 1e-4 (``tests/test_torch_matdecomp.py``); the BHC
coefficients to rtol 1e-12 and their Horner evaluation to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dexct_tpu.ops import bhc as j_bhc
from dexct_tpu.ops import bowtie as jb
from dexct_tpu.ops import spectral as j_sp
from dexct_tpu.ops.siddon import material_path_sinogram
from dexct_tpu.physics import kramers_spectrum
from dexct_tpu.physics.materials import AIR, TISSUE, MaterialTable
from dexct_tpu.pipeline.api import get_sino as j_get_sino
from dexct_tpu.system import FanBeamGeometry
from dexct_tpu.system.phantom import VoxelPhantom
from dexct_tpu_torch.ops import bhc as t_bhc
from dexct_tpu_torch.ops import bowtie as tb
from dexct_tpu_torch.ops import matdecomp as t_md
from dexct_tpu_torch.ops import spectral as t_sp
from dexct_tpu_torch.pipeline.api import get_sino as t_get_sino
from dexct_tpu_torch.system import FanBeamGeometry as TFan


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


GEO = dict(N_channels=64, N_proj=24, gamma_fan=0.5, SID=40.0, SDD=70.0,
           eid=True)


def _cylinder(N=64, dx=0.2, radius=5.0):
    x = (np.arange(N) + 0.5 - N / 2.0) * dx
    labels = (x[None, :] ** 2 + x[:, None] ** 2 <= radius ** 2).astype(
        np.uint8)
    return VoxelPhantom("tissue_cyl", labels, MaterialTable([AIR, TISSUE]),
                        dx, dx, dx)


_CASE = {}


def _case():
    """(JAX geometry, port geometry, phantom, spectra, JAX and port
    bowties, paths [V, C, 2], the JAX package's raw counts pair)."""
    if not _CASE:
        jct, tct = FanBeamGeometry(**GEO), TFan(**GEO)
        ph = _cylinder()
        s1, s2 = kramers_spectrum(80.0), kramers_spectrum(140.0)
        for s in (s1, s2):
            s.rescale_counts(jct.A_iso * 5.0 / jct.N_proj)
        jbt = jb.design_flattening_bowtie(jct, 5.0, n_steps=8)
        tbt = tb.design_flattening_bowtie(tct, 5.0, n_steps=8)
        paths = np.array(material_path_sinogram(ph, jct))
        raws = [np.array(j_get_sino(jct, ph, s, paths=jnp.asarray(paths),
                                      bowtie=jbt)[0]) for s in (s1, s2)]
        _CASE.update(jct=jct, tct=tct, ph=ph, s=(s1, s2), jbt=jbt, tbt=tbt,
                     paths=paths, raws=raws)
    return _CASE


@pytest.mark.parametrize("kw", [dict(), dict(n_steps=8), dict(n_steps=0),
                                dict(t_max_cm=1.5, e_ref=70.0)])
def test_design_and_tables_match_jax(kw):
    c = _case()
    jbt = jb.design_flattening_bowtie(c["jct"], 5.0, **kw)
    tbt = tb.design_flattening_bowtie(c["tct"], 5.0, **kw)
    np.testing.assert_allclose(tbt.t_ch, jbt.t_ch, rtol=1e-12, atol=0)
    for got, want in zip(tbt.groups(), jbt.groups()):
        np.testing.assert_array_equal(got, want)
    for s in c["s"]:
        np.testing.assert_allclose(tbt.transmission(s.E),
                                   jbt.transmission(s.E), rtol=1e-12)
        np.testing.assert_allclose(tb.bowtie_fluence(s, c["tct"], tbt),
                                   jb.bowtie_fluence(s, c["jct"], jbt),
                                   rtol=1e-12)
        np.testing.assert_allclose(tb.bowtie_second_moment(s, c["tct"], tbt),
                                   jb.bowtie_second_moment(s, c["jct"], jbt),
                                   rtol=1e-12)


def test_design_rejects_what_jax_rejects():
    c = _case()
    with pytest.raises(ValueError, match="n_steps"):
        tb.design_flattening_bowtie(c["tct"], 5.0, n_steps=1)
    with pytest.raises(ValueError, match=">= 0"):
        tb.Bowtie(tb.ALUMINUM, -np.ones(4))


@pytest.mark.parametrize("shape,stride", [((5, 3, 7, 4), 1),
                                          ((5, 3, 7, 4), 7),
                                          ((6, 9, 2), 1)])
def test_counts_from_table_matches_jax_einsum(shape, stride):
    """The plain twin of K28 against the JAX einsums: per-channel
    (``"...ce,ce->...c"``, stride 1) and per-row (``"vrce,re->vrc"``,
    stride C); negative paths exercise the upper clip."""
    rng = np.random.default_rng(3)
    paths = rng.uniform(-0.5, 4.0, shape).astype(np.float32)
    m, e = shape[-1], 33
    mu = rng.uniform(0.01, 1.5, (m, e)).astype(np.float32)
    n_rows = shape[-2] if stride == 1 else shape[1]
    tab = rng.uniform(0.0, 1e6, (n_rows, e)).astype(np.float32)
    L = np.einsum("...m,me->...e", paths.astype(np.float64), mu)
    att = jnp.exp(jnp.clip(-jnp.asarray(L, jnp.float32), -700.0, 2.0))
    if stride == 1:
        want = np.asarray(j_sp.counts_from_paths(
            jnp.asarray(paths), jnp.asarray(mu), jnp.asarray(tab),
            per_channel=True))
    else:
        want = np.asarray(jnp.einsum("vrce,re->vrc", att, jnp.asarray(tab)))
    got = t_sp.counts_from_table(torch.as_tensor(paths),
                                 torch.as_tensor(mu), torch.as_tensor(tab),
                                 stride=stride)
    assert got.shape == shape[:-1] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    both = t_sp.counts_from_table(torch.as_tensor(paths),
                                  torch.as_tensor(mu), torch.as_tensor(tab),
                                  torch.as_tensor(2 * tab), stride=stride)
    assert torch.equal(both[0], got)
    np.testing.assert_allclose(both[1].numpy(), 2 * want, rtol=1e-5)


def test_per_channel_rejects_mismatched_tables():
    p = torch.zeros((4, 6, 2))
    with pytest.raises(ValueError, match="C = 5"):
        t_sp.counts_from_paths(p, torch.ones((2, 3)), torch.ones((5, 3)),
                               per_channel=True)
    with pytest.raises(ValueError, match=r"\[C, E\]"):
        t_sp.counts_from_paths(p, torch.ones((2, 3)), torch.ones(3),
                               per_channel=True)


def test_forward_counts_bowtie_matches_jax():
    """Counts and log sinogram with the per-channel fluence and air, and
    the second moment (from the same pass as the counts) against the JAX
    package's second ``counts_from_paths`` call.  The compound draws and
    sigma_e are checked in tests/test_torch_tcm.py."""
    c = _case()
    s = c["s"][0]
    jr, jl = j_sp.forward_counts(jnp.asarray(c["paths"]), c["ph"], s,
                                 c["jct"], bowtie=c["jbt"])
    tr, tl = t_sp.forward_counts(torch.as_tensor(c["paths"]), c["ph"], s,
                                 c["tct"], bowtie=c["tbt"])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    i2 = jb.bowtie_second_moment(s, c["jct"], c["jbt"])
    mu = c["ph"].materials.mu_table(s.E)
    want = np.asarray(j_sp.counts_from_paths(
        jnp.asarray(c["paths"]), jnp.asarray(mu, jnp.float32),
        jnp.asarray(i2, jnp.float32), per_channel=True))
    counts, var = t_sp.counts_from_paths(
        torch.as_tensor(c["paths"]), torch.as_tensor(mu).float(),
        torch.as_tensor(jb.bowtie_fluence(s, c["jct"], c["jbt"])).float(),
        torch.as_tensor(i2).float(), per_channel=True)
    assert torch.equal(counts, tr)
    np.testing.assert_allclose(var.numpy(), want, rtol=1e-5)


def test_get_sino_bowtie_and_tcm_match_jax():
    c = _case()
    s = c["s"][1]
    m = np.linspace(0.5, 1.5, GEO["N_proj"]).astype(np.float32)
    jr, jl = j_get_sino(c["jct"], c["ph"], s, paths=jnp.asarray(c["paths"]),
                        bowtie=c["jbt"], tcm=m)
    tr, tl = t_get_sino(c["tct"], c["ph"], s, device="cpu",
                        paths=torch.as_tensor(c["paths"]), bowtie=c["tbt"],
                        tcm=m)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("n_iters", [15, 3])
def test_decompose_sinograms_bowtie_matches_jax(n_iters):
    c = _case()
    s1, s2 = c["s"]
    want = jb.decompose_sinograms_bowtie(c["jct"], *c["raws"], s1, s2,
                                         c["jbt"], n_iters=n_iters)
    got = tb.decompose_sinograms_bowtie(
        c["tct"], *(torch.as_tensor(r) for r in c["raws"]), s1, s2,
        c["tbt"], n_iters=n_iters)
    for g, w in zip(got, want):
        assert g.shape == (GEO["N_proj"], GEO["N_channels"])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_numpy_input_with_cpu_device_stays_on_the_cpu():
    c = _case()
    s1, s2 = c["s"]
    m1, m2 = tb.decompose_sinograms_bowtie(c["tct"], *c["raws"], s1, s2,
                                           c["tbt"], n_iters=2, device="cpu")
    assert m1.device.type == "cpu" and m2.device.type == "cpu"


def test_group_layout_pads_each_group_to_whole_blocks():
    """K29's layout: every pixel lands in a slot of its own group, each
    group padded to a multiple of the block with copies of its first
    pixel (in stable order), block ids naming the group."""
    rng = np.random.default_rng(5)
    group = torch.as_tensor(rng.integers(0, 6, 1000))
    group[group == 4] = 5  # an empty group
    src, slot, block_group = t_md.group_layout(group, 6, block=32)
    n_g = np.bincount(group.numpy(), minlength=6)
    assert src.numel() == sum(-(-n // 32) * 32 for n in n_g)
    assert torch.equal(src[slot], torch.arange(1000))
    assert torch.equal(group[src],
                       torch.repeat_interleave(block_group.long(), 32))
    for g in range(6):
        mine = torch.nonzero(group == g).reshape(-1)
        if mine.numel():
            padded = src[torch.repeat_interleave(block_group.long(), 32)
                         == g]
            assert torch.equal(padded[:mine.numel()], mine)
            assert torch.all(padded[mine.numel():] == mine[0])


def test_batched_tables_are_the_per_group_tables():
    """K29's tables, built for all groups at once, equal K3's ``_tables``
    of each group bit for bit (the warm table compressed as K3's is)."""
    c = _case()
    _, i0, mus = t_md.prepare_decomposition(c["tct"], *c["s"])
    rng = np.random.default_rng(8)
    filt = np.exp(-rng.uniform(0, 2, (3, 1, i0.shape[1])))
    i0_g = torch.as_tensor(i0 * filt, dtype=torch.float32)
    mus = torch.as_tensor(mus, dtype=torch.float32)
    scales = i0_g.amax((-2, -1))
    full, warm = t_md._tables(i0_g / scales[:, None, None], mus, 50, 4, 16)
    assert warm[0].shape[1] < full[0].shape[1]  # compressed
    for g in range(3):
        f1, w1 = t_md._tables(i0_g[g] / i0_g[g].max(), mus, 50, 4, 16)
        for got, want in zip(full + warm, f1 + w1):
            assert torch.equal(got[g], want)


def test_grouped_solve_is_the_per_group_solve():
    """The plain twin of K29: each group's pixels exactly as
    ``gauss_newton_solve`` solves them with that group's i0."""
    c = _case()
    s1, s2 = c["s"]
    _, i0, mus = t_md.prepare_decomposition(c["tct"], s1, s2)
    rng = np.random.default_rng(7)
    i0_g = np.stack([i0, 0.5 * i0 * np.exp(-rng.uniform(0, 1, i0.shape))])
    counts = torch.as_tensor(np.stack(c["raws"]).reshape(2, -1))
    group = torch.as_tensor(rng.integers(0, 2, counts.shape[1]))
    kw = dict(n_iters=10)
    got = t_md.gauss_newton_solve_grouped(
        counts, group, torch.as_tensor(i0_g).float(),
        torch.as_tensor(mus).float(), **kw)
    for g in range(2):
        sel = group == g
        want = t_md.gauss_newton_solve(counts[:, sel],
                                       torch.as_tensor(i0_g[g]).float(),
                                       torch.as_tensor(mus).float(), **kw)
        assert torch.equal(got[sel], want)
    with pytest.raises(ValueError, match="group"):
        t_md.gauss_newton_solve_grouped(counts, group[1:],
                                        torch.as_tensor(i0_g).float(),
                                        torch.as_tensor(mus).float())


@pytest.mark.parametrize("spec", ["80kV", "140kV"])
def test_bowtie_water_bhc_matches_jax(spec):
    c = _case()
    s = c["s"][0 if spec == "80kV" else 1]
    want = j_bhc.fit_water_bhc_bowtie(s, c["jct"], c["jbt"])
    got = t_bhc.fit_water_bhc_bowtie(s, c["tct"], c["tbt"])
    assert got.coeffs_ch.shape == (GEO["N_channels"], 7)
    np.testing.assert_allclose(got.coeffs_ch, want.coeffs_ch, rtol=1e-12,
                               atol=1e-15)
    assert got.mu_eff == pytest.approx(want.mu_eff, rel=1e-12)
    log = np.asarray(j_get_sino(c["jct"], c["ph"], s,
                                paths=jnp.asarray(c["paths"]),
                                bowtie=c["jbt"])[1])
    np.testing.assert_allclose(got(torch.as_tensor(log)).numpy(),
                               np.asarray(want(jnp.asarray(log))),
                               rtol=1e-6, atol=1e-6)
    by_hand = t_bhc.WaterBhcBowtie(want.coeffs_ch, want.mu_eff, want.t_max)
    assert torch.equal(by_hand(torch.as_tensor(log)),
                       got(torch.as_tensor(log)))
