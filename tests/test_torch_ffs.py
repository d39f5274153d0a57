"""The port's in-plane flying-focal-spot reconstruction (ops/ffs.py, plain
versions on the CPU) and its parallel-beam and FFS run configs against the
JAX package's.

The FFS plan is host float64 NumPy copied from the JAX package: indices
exact, weights within 1e-7.  ffs_fbp_recon (16-tap rebin, parallel filter,
parallel backprojection) is held to tests/test_torch_parallel_recon.py's
bar (1e-4 cm^-1, 0.5 HU).  Both CLIs write the same files at
tests/test_torch_pipeline.py's TOL on the tiny config; the parallel-beam
config uses a 63^2 grid, for which the JAX CLI's composed path traces with
its exact DDA (an even grid selects its dominant-axis tracer, which on
parallel rays launched 100 cm out deviates from its own DDA by up to 4.5e-4
cm, beyond TOL's reach; the port's trace equals the DDA to 1e-4 cm)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import fbp as j_fbp
from dexct_tpu.ops import ffs as j_ffs
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import water_cylinder_phantom
from dexct_tpu_torch.ops import ffs as t_ffs
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from test_torch_pipeline import REPO, _both_clis, _tiny_params

GEOM = dict(N_channels=96, N_proj=90, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0, ffs="inplane")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_theta,nt", [(None, None), (64, 128)])
def test_parallel_rebin_plan_ffs_matches_jax(n_theta, nt):
    want = j_ffs.parallel_rebin_plan_ffs(JFan(**GEOM), n_theta, nt)
    got = t_ffs.parallel_rebin_plan_ffs(TFan(**GEOM), n_theta, nt)
    n_th = 45 if n_theta is None else n_theta
    n_t = 192 if nt is None else nt
    assert got[0].shape == (n_th * n_t * 16,)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-7)
    assert got[2:] == want[2:]


@pytest.mark.parametrize("geom", [dict(GEOM, ffs="none"),
                                  dict(GEOM, rotation_total=4.0)],
                         ids=["static_spot", "partial_scan"])
def test_parallel_rebin_plan_ffs_refuses_like_jax(geom):
    with pytest.raises(ValueError) as want:
        j_ffs.parallel_rebin_plan_ffs(JFan(**geom))
    with pytest.raises(ValueError) as got:
        t_ffs.parallel_rebin_plan_ffs(TFan(**geom))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("nt", [None, 160])
def test_ffs_fbp_recon_matches_jax(nt):
    """The interleaved rebin (K5's plain version at 16 taps), the parallel
    filter and K6's plain version, on a cylinder's line integrals."""
    rng = np.random.default_rng(3)
    ct = JFan(**GEOM)
    t = ct.SID * np.sin(ct.gammas)
    sino = (2.0 * np.sqrt(np.clip(12.0 ** 2 - t ** 2, 0, None)) * 0.2
            + 0.01 * rng.normal(size=(90, 96))).astype(np.float32)
    want = j_ffs.ffs_fbp_recon(jnp.asarray(sino), ct, 64, 30.0, nt=nt)
    got = t_ffs.ffs_fbp_recon(torch.as_tensor(sino), TFan(**GEOM), 64, 30.0,
                              nt=nt)
    assert float(np.asarray(want).max()) > 0.1  # a non-trivial image
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want_raw, want_hu = j_fbp.fbp_recon(jnp.asarray(sino), ct, 64, 30.0,
                                        mu_water_eff=0.2)
    from dexct_tpu_torch.ops import fbp as t_fbp

    got_raw, got_hu = t_fbp.fbp_recon(torch.as_tensor(sino), TFan(**GEOM),
                                      64, 30.0, mu_water_eff=0.2)
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw),
                               atol=1e-4)
    np.testing.assert_allclose(got_hu.numpy(), np.asarray(want_hu), atol=0.5)


def _variant(tmp_path, name, **changes):
    params = _tiny_params(tmp_path)
    cfg = dict(json.loads(params.read_text()), RUN_ID=f"tiny_{name}",
               **changes)
    path = tmp_path / f"{name}.txt"
    path.write_text(json.dumps(cfg))
    return path


def test_ffs_config_cli_matches_jax(tmp_path):
    """A fan-beam config with ``"flying_focal_spot": "inplane"`` through
    both CLIs (the composed path: trace, counts, decomposition, 16-tap
    rebin FBP of all four images)."""
    _both_clis(tmp_path, _variant(tmp_path, "ffs",
                                  flying_focal_spot="inplane"), [], 12)


def test_parallel_beam_config_cli_matches_jax(tmp_path):
    """A ``parallel_beam`` config (the reference protocol's other keys,
    a 63^2 water cylinder) through both CLIs."""
    ph = water_cylinder_phantom(N=63, dx=0.4)
    ph.to_file(str(tmp_path / "ph63.bin"), str(tmp_path / "ph63.csv"))
    params = _variant(tmp_path, "par", scanner_geometry="parallel_beam",
                      phantom_filename=str(tmp_path / "ph63.bin"),
                      matcomp_filename=str(tmp_path / "ph63.csv"), Nx=63,
                      Ny=63)
    out = _both_clis(tmp_path, params, [], 12)
    raw = np.fromfile(out / "tiny_par" / "80kV_1000uGy" /
                      "recon_raw_float32.bin", np.float32)
    assert raw.size == 64 * 64 and float(raw.max()) > 0.1


@pytest.mark.parametrize("changes", [{"flying_focal_spot": "inplane"},
                                     {"scanner_geometry": "parallel_beam"}],
                         ids=["ffs", "parallel_beam"])
def test_composed_geometries_ignore_the_fused_engine(tmp_path, changes):
    """As in the JAX runner, these configs run the composed path whatever
    the engine and the fused flags: the fused and composed engines write
    the same arrays."""
    from dexct_tpu_torch.pipeline.runner import run_config, runs_fused_2d
    from dexct_tpu_torch.system.config import read_parameter_file

    (cfg,) = read_parameter_file(_variant(tmp_path, "v", **changes))
    assert not runs_fused_2d(cfg.ct, "fused")
    kw = dict(device="cpu", n_iters=4, verbose=False,
              spectrum_dir=os.path.join(REPO, "input", "spectrum"))
    (a,) = run_config(cfg, out_dir=str(tmp_path / "a"), **kw)
    (b,) = run_config(cfg, out_dir=str(tmp_path / "b"), engine="composed",
                      projector="siddon", recon="fan", **kw)
    for key in ("sino_raw", "mat_sinos", "recon_raw", "mat_recons"):
        for i in range(2):
            torch.testing.assert_close(getattr(a.dect, key)[i],
                                       getattr(b.dect, key)[i], rtol=0,
                                       atol=0)
