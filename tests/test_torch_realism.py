"""The port's realism chain (``pipeline/realism.py``) against the JAX
package's, on the CPU.

Inputs: the JAX tests' system (``tests/test_realism_chain.py``: the 64^2
contrast-rods phantom at 0.35 cm, 384 channels x 128 views, linac 9 mGy /
80 kV 1 mGy) and its five-stage chain (MTF, scatter, pileup, gains,
afterglow) with the same gains array handed to both.  Every stage's apply
and correct runs on the same clean counts (the JAX package's) in both
packages: rel 1e-5 (float32 correlations, FFTs and recursions in another
order; the afterglow recursion runs 128 views).  The chain round trip is
held to the JAX test's bar (median rel < 0.01).  The whole pipeline, with
and without a bowtie, runs on each package's own trace, whose float32
paths differ: without the chain the two agree to 1.2e-4 in the log
sinograms and 5e-4 g/cm^2 in the basis sinograms, and the chain's
corrections amplify that to 3.6e-4 and 2.8e-3, so those two are held to
1e-3 and 5e-3 g/cm^2, the images to tests/test_torch_pipeline.py's TOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops.afterglow import decay_per_view
from dexct_tpu.ops.bowtie import design_flattening_bowtie as j_design
from dexct_tpu.ops.mtf import focal_spot_kernel
from dexct_tpu.ops.rings import sample_channel_gains
from dexct_tpu.ops.scatter import scatter_kernel
from dexct_tpu.ops.spectral import effective_fluence
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline import realism as jr
from dexct_tpu.pipeline.api import get_sino as j_get_sino
from dexct_tpu.system import FanBeamGeometry, contrast_rods_phantom
from dexct_tpu_torch.ops.bowtie import design_flattening_bowtie as t_design
from dexct_tpu_torch.pipeline import realism as tr
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from test_torch_pipeline import TOL

GEO = dict(N_channels=384, N_proj=128, gamma_fan=0.8230337, SID=60.0,
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
        ph = contrast_rods_phantom(N=64, dx=0.35)
        s1 = linac_spectrum()
        s1.rescale_counts(jct.A_iso * 9.0 / jct.N_proj)
        s2 = kramers_spectrum(80.0)
        s2.rescale_counts(jct.A_iso * 1.0 / jct.N_proj)
        clean = np.array(j_get_sino(jct, ph, s1)[0])
        gains = np.array(sample_channel_gains(3, GEO["N_channels"],
                                              sigma=0.01))
        _CASE.update(jct=jct, tct=tct, ph=ph, s=(s1, s2), clean=clean,
                     gains=gains)
    return _CASE


def _stages(mod, spec, which=None):
    """The JAX tests' chain, built by ``mod`` (either package)."""
    c = _case()
    air = float(np.sum(effective_fluence(spec, c["jct"])))
    st = {
        "mtf": lambda: mod.stage_mtf(focal_spot_kernel(c["jct"], 0.45),
                                     nsr=1e-6),
        "scatter": lambda: mod.stage_scatter(
            air, scatter_kernel(GEO["N_channels"], sigma_ch=60.0), spr=0.3),
        "pileup": lambda: mod.stage_pileup(0.2 / air),
        "pileup_paralyzable": lambda: mod.stage_pileup(0.2 / air,
                                                       "paralyzable"),
        "gains": lambda: mod.stage_gains(c["gains"], air),
        "afterglow": lambda: mod.stage_afterglow(
            [0.05, 0.02], decay_per_view([2.0, 20.0], 1.0)),
        "afterglow_cold": lambda: mod.stage_afterglow(
            [0.05], decay_per_view([3.0], 1.0), warm_start=False),
    }
    names = which or ("mtf", "scatter", "pileup", "gains", "afterglow")
    return [st[n]() for n in names]


@pytest.mark.parametrize("name", ["mtf", "scatter", "pileup",
                                  "pileup_paralyzable", "gains",
                                  "afterglow", "afterglow_cold"])
def test_each_stage_matches_jax(name):
    c = _case()
    (js,), (ts,) = (_stages(m, c["s"][0], [name]) for m in (jr, tr))
    assert ts.name == js.name
    clean = c["clean"]
    want = np.asarray(js.apply(jnp.asarray(clean)))
    got = ts.apply(torch.as_tensor(clean))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    back_w = np.asarray(js.correct(jnp.asarray(want)))
    back_g = ts.correct(torch.as_tensor(want))
    np.testing.assert_allclose(back_g.numpy(), back_w, rtol=1e-5)


@pytest.mark.parametrize("corrected", [True, False])
def test_physics_scatter_stage_matches_jax(corrected):
    rng = np.random.default_rng(0)
    primary = (1e5 * (1 + rng.random((4, 32)))).astype(np.float32)
    s = (2e3 * (1 + rng.random((4, 32)))).astype(np.float32)
    js = jr.stage_physics_scatter(jnp.asarray(s), grid_s=0.5,
                                  corrected=corrected, estimate=0.5 * s)
    ts = tr.stage_physics_scatter(s, grid_s=0.5, corrected=corrected,
                                  estimate=0.5 * s)
    want = np.asarray(jr.correct_chain(jr.apply_chain(
        jnp.asarray(primary), [js]), [js]))
    got = tr.correct_chain(tr.apply_chain(torch.as_tensor(primary), [ts]),
                           [ts])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (ts.correct is None) == (not corrected)


def test_chain_round_trip():
    """The JAX test's round trip (tests/test_realism_chain.py:50-63) on
    the port: the chain visibly distorts, its correction recovers the
    clean counts to median rel < 0.01."""
    c = _case()
    stages = _stages(tr, c["s"][0])
    clean = torch.as_tensor(c["clean"])
    meas = tr.apply_chain(clean, stages)
    assert float((meas / clean - 1.0).abs().max()) > 0.05
    back = tr.correct_chain(meas, stages)
    assert float((back / clean - 1.0).abs().median()) < 0.01


def test_chain_on_cone_shapes():
    """[V, R, C] counts through pileup, gains and afterglow round-trip to
    5e-3 (the JAX test's cone bar)."""
    rng = np.random.default_rng(0)
    air = 1e5
    clean = (air * np.exp(-rng.uniform(0.5, 3.0, (32, 4, 48)))).astype(
        np.float32)
    stages = [tr.stage_pileup(0.1 / air),
              tr.stage_gains(np.array(sample_channel_gains(1, 48,
                                                           sigma=0.01)),
                             air),
              tr.stage_afterglow([0.05], decay_per_view([3.0], 1.0))]
    back = tr.correct_chain(tr.apply_chain(torch.as_tensor(clean), stages),
                            stages)
    assert np.abs(back.numpy() / clean - 1.0).max() < 5e-3


REAL_TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
            "sino_log": dict(rtol=0.0, atol=1e-3),
            "mat_sinos": dict(rtol=0.0, atol=5e-3),
            "recon_HU": dict(rtol=0.0, atol=TOL["recon_HU"]["atol"]),
            "mat_recons": TOL["mat_recons"]}


@pytest.mark.parametrize("bowtie", [False, True])
def test_simulate_dect_realistic_matches_jax(bowtie):
    c = _case()
    jbt = j_design(c["jct"], 8.0, n_steps=8) if bowtie else None
    tbt = t_design(c["tct"], 8.0, n_steps=8) if bowtie else None
    want = jr.simulate_dect_realistic(
        c["jct"], c["ph"], *c["s"], 64, 20.0, 0.8, _stages(jr, c["s"][0]),
        _stages(jr, c["s"][1]), n_iters=15, bowtie=jbt)
    got = tr.simulate_dect_realistic(
        c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8, _stages(tr, c["s"][0]),
        _stages(tr, c["s"][1]), n_iters=15, bowtie=tbt, device="cpu")
    for key, tol in REAL_TOL.items():
        for i in range(2):
            np.testing.assert_allclose(getattr(got, key)[i].numpy(),
                                       np.asarray(getattr(want, key)[i]),
                                       err_msg=f"{key}[{i}]", **tol)


def test_compound_noise_and_uncorrected_runs():
    c = _case()
    gen = torch.Generator().manual_seed(1)
    res = tr.simulate_dect_realistic(
        c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8, _stages(tr, c["s"][0]),
        _stages(tr, c["s"][1]), n_iters=10, noise="compound", generator=gen,
        device="cpu")
    assert all(bool(torch.isfinite(x).all()) for x in res.mat_recons)
    raw = tr.simulate_dect_realistic(
        c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8, _stages(tr, c["s"][0]),
        n_iters=10, correct=False, do_recon=False, device="cpu")
    assert raw.recon_HU == (None, None)
    with pytest.raises(ValueError, match="Generator"):
        tr.simulate_dect_realistic(
            c["tct"], c["ph"], *c["s"], 64, 20.0, 0.8, [], noise="poisson",
            device="cpu")
