"""The port's cone-parallel PI method (``ops/helical_pi.py``: the host
rebin plan, K5 at 4 taps and K20's plain versions on the CPU) against the
JAX package's.

Tolerances: the plan's tables exact (the same float64 NumPy); the
backprojector rtol 2e-4 with atol 2e-5 x max (the JAX package's bar
between its backprojector layouts, as in tests/test_torch_cone.py);
``helical_pi_reconstruct`` end to end 1e-4 x max (pocketfft here, XLA's
FFT in JAX); the refusals word for word.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import helical_pi as j_pi
from dexct_tpu.system import HelicalConeBeamGeometry, water_cylinder_phantom
from dexct_tpu_torch.ops import helical_pi as t_pi


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _geom(**kw):
    """A two-turn helix, 96 views x 8 rows x 32 channels."""
    return HelicalConeBeamGeometry(
        **{**dict(N_channels=32, N_proj=96, N_rows=8, gamma_fan=0.8230337,
                  SID=60.0, SDD=100.0, h_iso=0.5, pitch=2.0,
                  rotation_total=4.0 * np.pi), **kw})


def _port_ct(ct):
    from dexct_tpu_torch.system import geometry as t_geo

    return getattr(t_geo, type(ct).__name__)(
        **{f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)
           if f.name != "detector"})


@pytest.mark.parametrize("nt", [64, 50])
def test_rebin_plan_equals_jax(nt):
    ct = _geom()
    want = j_pi._conepar_rebin_plan(ct, nt)
    got = t_pi._conepar_rebin_plan(_port_ct(ct), nt)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nz", [1, 5])
def test_pi_backproject_plain_matches_jax(nz):
    """Random filtered lines over two turns at the plan's grid."""
    ct = _geom()
    _, _, t0, dt, thetas = j_pi._conepar_rebin_plan(ct, 64)
    rng = np.random.default_rng(3)
    par = rng.standard_normal((96, 64, 8)).astype(np.float32)
    args = (60.0, 0.5, 8, 2.0, float(np.asarray(ct.source_z)[0]))
    rest = (t0, dt, 64, 24, nz, 16.0, 0.5, -1.0,
            float(ct.rotation_total / 96))
    want = np.asarray(j_pi._pi_backproject(jnp.asarray(par), *args,
                                           jnp.asarray(thetas), *rest))
    got = t_pi._pi_backproject(torch.as_tensor(par), *args,
                               torch.as_tensor(thetas), *rest).numpy()
    assert got.shape == want.shape == (nz, 24, 24)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


def _cyl_sino(ct, N=32, dx=0.6, nz=8):
    """Line integrals (0.2 /cm) of a z-uniform water cylinder, traced by the
    port's plain 3-D Siddon."""
    from dexct_tpu_torch.ops.conebeam import trace_paths_3d

    lab = np.broadcast_to(water_cylinder_phantom(N=N, dx=dx).labels[0],
                          (nz, N, N))
    src, dirs = ct.ray_geometry_3d()
    paths = trace_paths_3d(torch.as_tensor(np.ascontiguousarray(lab)),
                           torch.as_tensor(src, dtype=torch.float32),
                           torch.as_tensor(dirs, dtype=torch.float32),
                           dx, dx, dx, n_materials=2).numpy()
    return (paths @ np.array([0.0, 0.2], np.float32)).astype(np.float32)


@pytest.mark.parametrize("z_out", [None, (-0.25, 0.25)])
def test_helical_pi_reconstruct_matches_jax(z_out):
    """The whole chain on a small helix: the default slice grid and two
    given slices."""
    ct = _geom()
    sino = _cyl_sino(ct)
    kw = {} if z_out is None else dict(z_out=np.asarray(z_out))
    want = np.asarray(j_pi.helical_pi_reconstruct(jnp.asarray(sino), ct, 32,
                                                  18.0, 0.8, **kw))
    got = t_pi.helical_pi_reconstruct(torch.as_tensor(sino), _port_ct(ct),
                                      32, 18.0, 0.8, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # water (0.2 /cm) at the centre of the central slice
    mid = got[got.shape[0] // 2]
    assert abs(mid[14:18, 14:18].mean() - 0.2) < 0.02


@pytest.mark.parametrize("case", ["pitch0", "ffs"])
def test_helical_pi_refusals(case):
    kw = dict(pitch=0.0) if case == "pitch0" else dict(ffs="z")
    ct = _geom(**kw)
    with pytest.raises(ValueError) as j_err:
        j_pi.helical_pi_reconstruct(jnp.zeros((96, 8, 32)), ct, 24, 16.0,
                                    0.8)
    with pytest.raises(ValueError) as t_err:
        t_pi.helical_pi_reconstruct(torch.zeros((96, 8, 32)), _port_ct(ct),
                                    24, 16.0, 0.8)
    assert str(t_err.value) == str(j_err.value)
