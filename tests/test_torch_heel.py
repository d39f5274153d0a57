"""The port's anode heel (``ops/heel.py``) and ``simulate_cone_dect(heel=)``
against the JAX package's, on the CPU.

Inputs: the tiny cone recipe of the verify notes (a 32^2 x 8 water
cylinder at 0.6 x 0.5 cm, 24 views x 4 rows x 32 channels, linac / 80 kV)
with a 10 um heel (tools/smoke_r3s5.py's setting).  Tolerances: host
float64 tables to rtol 1e-12; counts on the same paths to rel 1e-5 (K2's
bar); the row-grouped decomposition on the same counts to K3's parity of
rtol/atol 1e-4; the whole pipeline to tests/test_torch_cone.py's
whole-pipeline bars (its cone tracer and the JAX package's take other
float32 steps).  ``d0_cm = 0`` must give the heel-free result bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dexct_tpu.ops import conebeam as j_cb
from dexct_tpu.ops import heel as jh
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.system import ConeBeamGeometry, water_cylinder_phantom
from dexct_tpu_torch.ops import conebeam as t_cb
from dexct_tpu_torch.ops import heel as th
from dexct_tpu_torch.system import ConeBeamGeometry as TCone

GEO = dict(N_channels=32, N_proj=24, N_rows=4, h_iso=0.5, eid=True)
WHOLE_TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
             "sino_log": dict(rtol=0.0, atol=2e-3),
             "mat_sinos": dict(rtol=0.0, atol=5e-3),
             "recon_HU": dict(rtol=0.0, atol=2.0),
             "mat_recons": dict(rtol=0.0, atol=5e-3)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_CASE = {}


def _case():
    if not _CASE:
        jct, tct = ConeBeamGeometry(**GEO), TCone(**GEO)
        ph2 = water_cylinder_phantom(N=32, dx=0.6)
        ph = dataclasses.replace(
            ph2, labels=np.broadcast_to(ph2.labels[0], (8, 32, 32)).copy(),
            dz=0.5)
        s1 = linac_spectrum()
        s1.rescale_counts(jct.A_iso * 9.0 / jct.N_proj)
        s2 = kramers_spectrum(80.0)
        s2.rescale_counts(jct.A_iso * 1.0 / jct.N_proj)
        paths = np.array(j_cb.cone_material_paths(ph, jct))
        _CASE.update(jct=jct, tct=tct, ph=ph, s=(s1, s2), paths=paths,
                     jheel=jh.HeelEffect(d0_cm=10e-4),
                     theel=th.HeelEffect(d0_cm=10e-4))
    return _CASE


@pytest.mark.parametrize("kw", [dict(), dict(toward_positive_z=False),
                                dict(d0_cm=20e-4, anode_angle=0.15)])
def test_tables_match_jax(kw):
    c = _case()
    jheel, theel = jh.HeelEffect(**kw), th.HeelEffect(**kw)
    np.testing.assert_allclose(theel.excess_path(c["tct"]),
                               jheel.excess_path(c["jct"]), rtol=1e-12,
                               atol=1e-18)
    for s in c["s"]:
        np.testing.assert_allclose(th.heel_fluence(s, c["tct"], theel),
                                   jh.heel_fluence(s, c["jct"], jheel),
                                   rtol=1e-12)
        np.testing.assert_allclose(th.heel_second_moment(s, c["tct"], theel),
                                   jh.heel_second_moment(s, c["jct"], jheel),
                                   rtol=1e-12)


def test_rows_past_the_anode_angle_raise():
    c = _case()
    with pytest.raises(ValueError, match="anode angle"):
        th.HeelEffect(anode_angle=1e-3).excess_path(c["tct"])


def test_counts_from_paths_heel_matches_jax():
    c = _case()
    for s in c["s"]:
        mu = c["ph"].materials.mu_table(s.E).astype(np.float32)
        i0 = jh.heel_fluence(s, c["jct"], c["jheel"])
        i2 = jh.heel_second_moment(s, c["jct"], c["jheel"])
        want = np.asarray(jh.counts_from_paths_heel(
            jnp.asarray(c["paths"]), jnp.asarray(mu), i0))
        want2 = np.asarray(jh.counts_from_paths_heel(
            jnp.asarray(c["paths"]), jnp.asarray(mu), i2))
        got = th.counts_from_paths_heel(torch.as_tensor(c["paths"]),
                                        torch.as_tensor(mu), i0)
        assert got.shape == c["paths"].shape[:-1]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        both = th.counts_from_paths_heel(torch.as_tensor(c["paths"]),
                                         torch.as_tensor(mu), i0, i2)
        assert torch.equal(both[0], got)
        np.testing.assert_allclose(both[1].numpy(), want2, rtol=1e-5)


def test_cone_sinogram_heel_matches_jax_and_is_exact_at_zero_depth():
    c = _case()
    s = c["s"][1]
    jr, jl = jh.cone_sinogram_heel(c["ph"], c["jct"], s, c["jheel"])
    tr, tl = th.cone_sinogram_heel(c["ph"], c["tct"], s, c["theel"],
                                   device="cpu")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr),
                               **WHOLE_TOL["sino_raw"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **WHOLE_TOL["sino_log"])
    z = th.cone_sinogram_heel(c["ph"], c["tct"], s, th.HeelEffect(d0_cm=0.0),
                              device="cpu")
    free = t_cb.cone_sinogram(c["ph"], c["tct"], s, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(z, free))


def test_decompose_cone_sinograms_heel_matches_jax():
    c = _case()
    mus = [c["ph"].materials.mu_table(s.E).astype(np.float32)
           for s in c["s"]]
    raws = [np.array(jh.counts_from_paths_heel(
        jnp.asarray(c["paths"]), jnp.asarray(mu),
        jh.heel_fluence(s, c["jct"], c["jheel"])))
        for s, mu in zip(c["s"], mus)]
    want = jh.decompose_cone_sinograms_heel(c["jct"], *raws, *c["s"],
                                            c["jheel"], n_iters=12)
    got = th.decompose_cone_sinograms_heel(
        c["tct"], *(torch.as_tensor(r) for r in raws), *c["s"], c["theel"],
        n_iters=12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    # numpy input on the CPU when asked
    m1, _ = th.decompose_cone_sinograms_heel(c["tct"], *raws, *c["s"],
                                             c["theel"], n_iters=2,
                                             device="cpu")
    assert m1.device.type == "cpu"


def test_simulate_cone_dect_heel_matches_jax():
    c = _case()
    want = j_cb.simulate_cone_dect(c["jct"], c["ph"], *c["s"], 16, 18.0,
                                   0.8, n_iters=8, heel=c["jheel"])
    got = t_cb.simulate_cone_dect(c["tct"], c["ph"], *c["s"], 16, 18.0, 0.8,
                                  device="cpu", n_iters=8, heel=c["theel"])
    for key, tol in WHOLE_TOL.items():
        for i in range(2):
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **tol)


@pytest.mark.parametrize("noise", ["none", "compound"])
def test_zero_depth_heel_is_the_heel_free_pipeline_bit_for_bit(noise):
    c = _case()
    kw = dict(device="cpu", n_iters=4, noise=noise)
    runs = []
    for heel in (None, th.HeelEffect(d0_cm=0.0)):
        gen = torch.Generator().manual_seed(3)
        runs.append(t_cb.simulate_cone_dect(c["tct"], c["ph"], *c["s"], 16,
                                            18.0, 0.8, generator=gen,
                                            heel=heel, **kw))
    free, zero = runs
    assert all(torch.equal(a, b) for k in free
               for a, b in zip(free[k], zero[k]))


def test_heel_hardens_the_anode_side_rows():
    """The port alone, with compound noise: finite, and the anode-side row
    of the central channel measures a lower line integral than the
    cathode-side row (the JAX test's physics, tests/test_heel.py)."""
    c = _case()
    gen = torch.Generator().manual_seed(1)
    res = t_cb.simulate_cone_dect(c["tct"], c["ph"], *c["s"], 16, 18.0, 0.8,
                                  device="cpu", n_iters=4, noise="compound",
                                  generator=gen, heel=c["theel"],
                                  do_recon=False)
    assert all(bool(torch.isfinite(x).all()) for k in res for x in res[k]
               if x is not None)
    quiet = th.cone_sinogram_heel(c["ph"], c["tct"], c["s"][1], c["theel"],
                                  device="cpu")[1]
    center = quiet[:, :, GEO["N_channels"] // 2].mean(0)
    assert float(center[-1]) < float(center[0])
