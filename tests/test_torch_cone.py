"""The port's cone-beam branch (the plain versions of K10-K12 on the CPU,
the fused cone step and the CLI's 3-D configs) against the JAX package's.

Tolerances:

- ``trace_paths_3d`` against the JAX DDA: 2e-4 cm (the bar the JAX
  package holds its 3-D DDA to, tests/test_conebeam.py:45); against the
  JAX fused pack's packed dominant-axis trace: 2e-3 cm (the JAX package's
  own bar between its two tracers, tests/test_conebeam.py:419);
- the FDK and helical backprojectors against every JAX layout
  (``pair_mode``, ``orbit4``, ``dbeta``): rtol 2e-4 with atol 2e-5 x max,
  the JAX package's bar between its own FDK layouts
  (tests/test_conebeam.py:807);
- the cone step fed the JAX step's own paths (every stage after the
  trace): the tolerances of tests/test_pipeline.py; the whole step, whose
  tracer differs from the JAX packed one: the JAX package's fused-vs-
  stateless bar (tests/test_conebeam.py:616-621: sino_log atol 2e-3,
  recon_HU atol 2 HU, mat_recons atol 5e-3);
- the trilinear resample (K16's plain version): rtol 0, atol 1e-6 x max
  (the same float32 operations; XLA may contract the weight products into
  FMAs);
- the tilted FDK's host tables (the enlarged gantry grid, the resample
  indices): exact (atol 0), read off the JAX program's own calls;
- the tilted FDK: at tilt 0 bitwise equal to the port's own
  ``fdk_reconstruct``, as in JAX; against JAX at 15 and 30 degrees, and the
  z-FFS circular and helical reconstructors against JAX: the
  backprojectors' bar above (the FFTs are pocketfft here, XLA's in JAX);
- ``cone_sinogram`` and ``simulate_cone_dect`` for each ``recon``: the
  fused-vs-stateless bar above (the JAX stateless path traces with its
  packed dominant-axis tracer, the port with K10);
- both CLIs on a tiny cone, helical, flat-panel, tilted, z-FFS (circular
  and helical) and Katsevich config: the tolerances of
  tests/test_pipeline.py, file by file (the tracers agree closely enough
  on the tiny water cylinder).
"""

import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import conebeam as j_cb
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline import cone as j_cone
from dexct_tpu.system import (ConeBeamGeometry, HelicalConeBeamGeometry,
                              TiltedConeBeamGeometry, water_cylinder_phantom)
from dexct_tpu_torch.ops import conebeam as t_cb
from dexct_tpu_torch.pipeline import cone as t_cone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
       "sino_log": dict(rtol=0.0, atol=1e-4),
       "mat_sinos": dict(rtol=0.0, atol=1e-3),
       "recon_raw": dict(rtol=0.0, atol=1e-4),
       "recon_HU": dict(rtol=0.0, atol=1.0),
       "mat_recons": dict(rtol=0.0, atol=1e-3)}
WHOLE_TOL = {"sino_log": dict(rtol=0.0, atol=2e-3),
             "recon_HU": dict(rtol=0.0, atol=2.0),
             "mat_recons": dict(rtol=0.0, atol=5e-3)}
FILE_TOL = {"sino_raw": TOL["sino_raw"], "sino_log": TOL["sino_log"],
            "recon_raw": TOL["recon_raw"], "recon_HU": TOL["recon_HU"],
            "mat1_sino": TOL["mat_sinos"], "mat2_sino": TOL["mat_sinos"],
            "mat1_recon": TOL["mat_recons"], "mat2_recon": TOL["mat_recons"]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.array(x)  # a writable host copy


# ---------------------------------------------------------------------------
# K10: the 3-D trace
# ---------------------------------------------------------------------------

def test_trace_paths_3d_matches_jax():
    """Random labels (4 materials, one label past n_materials), the rays of
    a small cone scan and random rays, some axis-parallel and some
    missing the grid."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, (6, 10, 12)).astype(np.int32)
    ct = ConeBeamGeometry(N_channels=24, N_proj=12, N_rows=4,
                          gamma_fan=0.8230337, SID=30.0, SDD=50.0,
                          h_iso=0.6)
    src, dirs = (x.reshape(-1, 3) for x in ct.ray_geometry_3d())
    rs = rng.uniform(-8, 8, (256, 3))
    rd = rng.standard_normal((256, 3))
    rd[:32, 1:] = 0.0  # along x
    rd[32:64, :2] = 0.0  # along z
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    src = np.concatenate([src, rs])
    dirs = np.concatenate([dirs, rd])
    args = (0.9, 0.8, 1.1)
    want = np.asarray(j_cb.trace_paths_3d(
        jnp.asarray(labels), jnp.asarray(src, jnp.float32),
        jnp.asarray(dirs, jnp.float32), *args, n_materials=4))
    got = t_cb.trace_paths_3d(
        torch.as_tensor(labels), torch.as_tensor(src, dtype=torch.float32),
        torch.as_tensor(dirs, dtype=torch.float32), *args,
        n_materials=4).numpy()
    assert got.shape == want.shape == (src.shape[0], 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert (want[:-256].sum(-1) > 0.0).mean() > 0.3  # the scan hits it


# ---------------------------------------------------------------------------
# K11 / K12: the backprojectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair_mode", [False, True])
@pytest.mark.parametrize("orbit4", [False, True])
def test_fdk_plain_matches_jax(pair_mode, orbit4):
    rng = np.random.default_rng(5)
    K, V, R, C = 4, 24, 8, 48
    qs = rng.normal(size=(K, V, R, C)).astype(np.float32)
    betas = (np.arange(V) * (2 * np.pi / V)).astype(np.float32)
    args = (60.0, 0.8230337 / C, 0.5, R, 32, 8, 20.0, 0.5, 2 * np.pi / V)
    want = np.asarray(j_cb._fdk_backproject_multi(
        jnp.asarray(qs), jnp.asarray(betas), *args, pair_mode=pair_mode,
        orbit4=orbit4))
    got = t_cb._fdk_backproject_multi(torch.as_tensor(qs),
                                      torch.as_tensor(betas), *args).numpy()
    assert got.shape == want.shape == (K, 8, 32, 32)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("pair_mode", [False, True])
@pytest.mark.parametrize("windowed", [False, True])
def test_helical_plain_matches_jax(pair_mode, windowed):
    """A 3-turn helix, 17 slices (odd), against the JAX program with and
    without its slice window (``dbeta``): every JAX layout gives the one
    image the port computes."""
    ct = HelicalConeBeamGeometry(
        N_channels=48, N_proj=144, N_rows=8, gamma_fan=0.8, SID=60.0,
        SDD=100.0, h_iso=0.5, rotation_total=6 * np.pi, pitch=2.0)
    db = float(ct.betas[1] - ct.betas[0])
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, 144, 8, 48)).astype(np.float32)
    nz = 17
    zv = (np.arange(nz) + 0.5) * 0.5 - nz * 0.25
    bc = (0.5 * ct.rotation_total + 2.0 * np.pi * zv / ct.pitch)
    arrs = [ct.betas, ct.source_z, np.zeros(144), bc]
    args = (60.0, ct.dgamma, 0.5, 8, 2.0, 32, nz, 20.0, 0.5, float(zv[0]))
    want = np.asarray(j_cb._helical_backproject(
        jnp.asarray(q), *(jnp.asarray(a, jnp.float32) for a in arrs),
        *args, pair_mode=pair_mode, dbeta=db if windowed else None))
    got = t_cb._helical_backproject(
        torch.as_tensor(q),
        *(torch.as_tensor(a, dtype=torch.float32) for a in arrs), *args,
        dbeta=db).numpy()
    assert got.shape == want.shape == (4, nz, 32, 32)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


WEIGHTINGS = ["full", "feather", "td", "cosz", "short", "pair"]


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("weighting", WEIGHTINGS)
def test_helical_weightings_match_jax(weighting, windowed):
    """Every gFDK view weighting on the 3-turn helix above, against the JAX
    program with and without its slice window (the port visits each
    slice's window of views; the terms it drops are exact zeros)."""
    ct = HelicalConeBeamGeometry(
        N_channels=48, N_proj=144, N_rows=8, gamma_fan=0.8, SID=60.0,
        SDD=100.0, h_iso=0.5, rotation_total=6 * np.pi, pitch=2.0)
    db = float(ct.betas[1] - ct.betas[0])
    rng = np.random.default_rng(1)
    q = rng.standard_normal((4, 144, 8, 48)).astype(np.float32)
    nz = 17
    zv = (np.arange(nz) + 0.5) * 0.5 - nz * 0.25
    bc = (0.5 * ct.rotation_total + 2.0 * np.pi * zv / ct.pitch)
    arrs = [ct.betas, ct.source_z, np.zeros(144), bc]
    args = (60.0, ct.dgamma, 0.5, 8, 2.0, 32, nz, 20.0, 0.5, float(zv[0]))
    want = np.asarray(j_cb._helical_backproject(
        jnp.asarray(q), *(jnp.asarray(a, jnp.float32) for a in arrs),
        *args, weighting=weighting, dbeta=db if windowed else None))
    got = t_cb._helical_backproject(
        torch.as_tensor(q),
        *(torch.as_tensor(a, dtype=torch.float32) for a in arrs), *args,
        dbeta=db, weighting=weighting).numpy()
    assert got.shape == want.shape == (4, nz, 32, 32)
    assert np.abs(want).max() > 0
    _bp_close(got, want)


def test_helical_other_weightings_raise():
    """A weighting outside the six raises ValueError, as the JAX
    reconstructor does."""
    from dexct_tpu_torch.system import HelicalConeBeamGeometry as THelix

    q = torch.zeros((4, 8, 4, 16))
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="unknown helical weighting"):
        t_cb._helical_backproject(q, z, z, z, torch.zeros(3), 60.0, 0.01,
                                  0.5, 4, 2.0, 16, 3, 10.0, 0.5, 0.0,
                                  dbeta=0.1, weighting="tam")
    jct = HelicalConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4,
                                  h_iso=0.5, rotation_total=4 * np.pi,
                                  pitch=2.0)
    ct = THelix(N_channels=32, N_proj=48, N_rows=4, h_iso=0.5,
                rotation_total=4 * np.pi, pitch=2.0)
    with pytest.raises(ValueError) as j_err:
        j_cb.helical_fdk_reconstruct(jnp.zeros((48, 4, 32)), jct, 16, 18.0,
                                     0.8, weighting="tam")
    with pytest.raises(ValueError) as t_err:
        t_cb.helical_fdk_reconstruct(torch.zeros((48, 4, 32)), ct, 16, 18.0,
                                     0.8, weighting="tam")
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# K16 and the stateless reconstructors
# ---------------------------------------------------------------------------

def test_trilinear_sample_plain_matches_jax():
    """Random volumes at random indices, some outside the box, some on
    integers and on the box's faces."""
    rng = np.random.default_rng(31)
    vol = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)
    zi = rng.uniform(-0.5, 4.5, (4, 9, 1)).astype(np.float32)
    yi = rng.uniform(-0.5, 5.5, (4, 9, 1)).astype(np.float32)
    xi = rng.uniform(-0.5, 6.5, (1, 1, 11)).astype(np.float32)
    zi[0, :3, 0] = [0.0, 4.0, 2.0]
    yi[0, :3, 0] = [5.0, 0.0, 3.0]
    xi[0, 0, :3] = [6.0, 0.0, 1.0]
    want = np.asarray(j_cb._trilinear_volume_sample(
        jnp.asarray(vol), *(jnp.asarray(np.broadcast_to(t, (4, 9, 11)))
                            for t in (zi, yi, xi))))
    got = t_cb._trilinear_volume_sample(
        torch.as_tensor(vol), *(torch.as_tensor(t) for t in (zi, yi, xi)))
    assert got.shape == want.shape == (3, 4, 9, 11)
    assert (want == 0).any() and (want != 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(vol).max())


def _layout_case(case):
    """Index tensors of K16's layouts, as they reach the kernel."""
    z = torch.arange(24, dtype=torch.float32)
    if case == "tilted":
        return t_cb._tilted_indices(0.26, 16, 20.0, 4, 0.5, "cpu")
    if case == "rank1":
        return z[:7], z[7:14], z[3:10]
    if case == "rank4":
        a = z.reshape(2, 3, 4, 1)
        return a, a + 1.0, z[:5]
    if case == "rank4_unmergeable":
        a = z.reshape(2, 4, 3).permute(0, 2, 1)[..., None]
        return a, a, z[:5]
    return z[0], z[1], z[2]  # scalars


@pytest.mark.parametrize("case,sizes,strides", [
    ("tilted", (1, 64, 16), ((0, 1, 0), (0, 1, 0), (0, 0, 1))),
    ("rank1", (1, 1, 7), ((0, 0, 1), (0, 0, 1), (0, 0, 1))),
    ("rank4", (1, 24, 5), ((0, 1, 0), (0, 1, 0), (0, 0, 1))),
    ("rank4_unmergeable", None, None),
    ("scalars", (1, 1, 1), ((0, 0, 0),) * 3),
])
def test_trilinear_index_layout(case, sizes, strides):
    """K16's host helper: the broadcast shape, that shape as three axes
    and each index tensor's strides along them (0 where broadcast), read
    back by ``as_strided`` as the kernel reads them; ``None`` where four
    axes stay unmerged."""
    idx = _layout_case(case)
    want_shape = torch.broadcast_shapes(*(t.shape for t in idx))
    shape, got_sizes, got_strides = t_cb._index_layout(
        tuple(t.shape for t in idx), tuple(t.stride() for t in idx))
    assert shape == tuple(want_shape)
    assert (got_sizes, got_strides) == (sizes, strides)
    if sizes is None:
        return
    for t, st in zip(idx, strides):
        seen = t.as_strided(sizes, st, t.storage_offset())
        torch.testing.assert_close(seen.reshape(shape),
                                   t.broadcast_to(shape), rtol=0, atol=0)


def test_trilinear_index_layout_refuses_shapes_that_do_not_broadcast():
    with pytest.raises(ValueError, match="do not broadcast"):
        t_cb._index_layout(((4, 3), (4, 1), (5,)), ((3, 1), (1, 1), (1,)))


def _cyl_sino(ct, nz=8, N=32, dx=0.6, radius_cm=None):
    """Monoenergetic sinogram of a water cylinder (0.2 /cm), traced by the
    port's plain 3-D Siddon: the input of both sides."""
    kw = {} if radius_cm is None else dict(radius_cm=radius_cm)
    lab = np.broadcast_to(water_cylinder_phantom(N=N, dx=dx, **kw)
                          .labels[0], (nz, N, N))
    src, dirs = ct.ray_geometry_3d()
    paths = t_cb.trace_paths_3d(
        torch.as_tensor(np.ascontiguousarray(lab)),
        torch.as_tensor(src, dtype=torch.float32),
        torch.as_tensor(dirs, dtype=torch.float32), dx, dx, dx,
        n_materials=2).numpy()
    return (paths @ np.array([0.0, 0.2], np.float32)).astype(np.float32)


def _port_ct(ct):
    """The port's twin of a JAX geometry (same dataclass fields)."""
    from dexct_tpu_torch.system import geometry as t_geo

    return getattr(t_geo, type(ct).__name__)(
        **{f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)
           if f.name != "detector"})


def _bp_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("tilt_deg", [0.0, 15.0])
def test_tilted_fdk_matches_jax(tilt_deg):
    """A tilted water cylinder, as a 2-volume stack; at tilt 0 the tilted
    FDK is the port's own circular FDK bit for bit."""
    jct = TiltedConeBeamGeometry(
        N_channels=64, N_proj=48, N_rows=8, gamma_fan=0.8230337, SID=60.0,
        SDD=100.0, h_iso=0.5, eid=True, tilt=np.deg2rad(tilt_deg))
    tct = _port_ct(jct)
    sino = _cyl_sino(jct)
    want = np.asarray(j_cb.fdk_tilted_reconstruct(
        jnp.asarray(np.stack([sino, 0.5 * sino])), jct, 32, 16.0, 0.8))
    got = t_cb.fdk_tilted_reconstruct(
        torch.as_tensor(np.stack([sino, 0.5 * sino])), tct, 32, 16.0,
        0.8).numpy()
    assert got.shape == want.shape == (2, 8, 32, 32)
    _bp_close(got, want)
    if tilt_deg == 0.0:
        one = t_cb.fdk_reconstruct(torch.as_tensor(sino), tct.untilted(), 32,
                                   16.0, 0.8).numpy()
        np.testing.assert_array_equal(got[0], one)


@pytest.mark.parametrize("tilt_deg,nz", [(15.0, 8), (30.0, 2)])
def test_tilted_host_tables_equal_jax(monkeypatch, tilt_deg, nz):
    """The enlarged gantry grid and the patient grid's gantry indices are
    the JAX program's, exactly: both are read off the JAX function's own
    calls of its backprojector and its resample."""
    seen = {}

    def bp(q, betas, sid, dgamma, row_h, n_rows, n_g, nz_g, fov_g, *a, **k):
        seen["grid"] = (n_g, fov_g, nz_g)
        return jnp.zeros((q.shape[0], nz_g, n_g, n_g), q.dtype)

    def sample(vols, zi, yi, xi):
        seen["idx"] = tuple(np.asarray(t) for t in (zi, yi, xi))
        return vols[:, :zi.shape[0], :zi.shape[1], :zi.shape[2]]

    monkeypatch.setattr(j_cb, "_fdk_backproject_multi", bp)
    monkeypatch.setattr(j_cb, "_trilinear_volume_sample", sample)
    tau = np.deg2rad(tilt_deg)
    jct = TiltedConeBeamGeometry(N_channels=32, N_proj=8, N_rows=8,
                                 h_iso=0.5, tilt=tau)
    j_cb.fdk_tilted_reconstruct(jnp.zeros((8, 8, 32)), jct, 40, 20.0, 0.8,
                                nz_out=nz, dz_out=0.5)
    assert t_cb._tilted_grid(tau, 40, 20.0, nz, 0.5) == seen["grid"]
    for got, want in zip(t_cb._tilted_indices(tau, 40, 20.0, nz, 0.5, "cpu"),
                         seen["idx"]):
        got = np.broadcast_to(got.numpy(), want.shape)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_tilted_fdk_thin_volume_matches_jax():
    """The JAX package's 30-degree, 2-slice regression config
    (tests/test_conebeam.py, test_edge_x_coverage_thin_volume): the gantry
    grid keeps the full FOV in x, so the edge pixels read water."""
    jct = TiltedConeBeamGeometry(
        N_channels=96, N_proj=48, N_rows=8, gamma_fan=0.8, SID=60.0,
        SDD=100.0, h_iso=0.5, eid=True, tilt=np.deg2rad(30.0))
    sino = _cyl_sino(jct, nz=8, N=32, dx=0.75, radius_cm=11.5)
    kw = dict(nz_out=2, dz_out=0.5)
    want = np.asarray(j_cb.fdk_tilted_reconstruct(jnp.asarray(sino), jct,
                                                  40, 20.0, 0.8, **kw))
    got = t_cb.fdk_tilted_reconstruct(torch.as_tensor(sino), _port_ct(jct),
                                      40, 20.0, 0.8, **kw).numpy()
    _bp_close(got, want)
    mid = got[0]
    c = mid[19:21, 18:22].mean()
    assert c > 0.1
    assert mid[20, 39] > 0.75 * c and mid[20, 0] > 0.75 * c


@pytest.mark.parametrize("helical", [False, True])
def test_zffs_reconstruction_matches_jax(helical):
    """z flying focal spot: per-view cone factors and nonzero row offsets
    through K12's plain version, on a circular orbit (pitch 0, the window
    centred on the orbit) and on a helix."""
    kw = dict(N_channels=64, N_proj=48, N_rows=8, gamma_fan=0.8230337,
              SID=60.0, SDD=100.0, h_iso=0.5, eid=True, ffs="z")
    if helical:
        jct = HelicalConeBeamGeometry(rotation_total=4 * np.pi, pitch=2.0,
                                      **{**kw, "N_proj": 96})
        fn_j, fn_t = j_cb.helical_fdk_reconstruct, t_cb.helical_fdk_reconstruct
    else:
        jct = ConeBeamGeometry(**kw)
        fn_j, fn_t = j_cb.fdk_reconstruct, t_cb.fdk_reconstruct
    assert np.abs(jct.ffs_view_offsets).min() > 0
    sino = _cyl_sino(jct)
    want = np.asarray(fn_j(jnp.asarray(sino), jct, 32, 16.0, 0.8))
    got = fn_t(torch.as_tensor(sino), _port_ct(jct), 32, 16.0, 0.8).numpy()
    assert got.shape == want.shape
    _bp_close(got, want)


@pytest.mark.parametrize("weighting,zffs,z_out", [
    pytest.param("td", False, None, id="td-False"),
    pytest.param("feather", False, None, id="feather-False"),
    pytest.param("feather", True, None, id="feather-True"),
    *(pytest.param(w, False, [0.0], id=f"{w}-central-slice")
      for w in t_cb.WEIGHTINGS)])
def test_helical_fdk_weighting_matches_jax(weighting, zffs, z_out):
    """``helical_fdk_reconstruct(weighting=)``: the Tam-Danielsson and
    feathered windows on a static spot, and the feathered window with a z
    flying focal spot (per-view cone factors and row offsets), on a 2-volume
    stack; and every weighting on the central slice alone (``z_out=[0.0]``,
    the crop :func:`witness` reconstructs at full size)."""
    kw = dict(N_channels=64, N_proj=96, N_rows=8, gamma_fan=0.8230337,
              SID=60.0, SDD=100.0, h_iso=0.5, eid=True,
              rotation_total=4 * np.pi, pitch=2.0)
    if zffs:
        kw["ffs"] = "z"
    jct = HelicalConeBeamGeometry(**kw)
    sino = _cyl_sino(jct)
    stack = np.stack([sino, 0.5 * sino])
    want = np.asarray(j_cb.helical_fdk_reconstruct(
        jnp.asarray(stack), jct, 32, 16.0, 0.8, z_out=z_out,
        weighting=weighting))
    got = t_cb.helical_fdk_reconstruct(
        torch.as_tensor(stack), _port_ct(jct), 32, 16.0, 0.8, z_out=z_out,
        weighting=weighting).numpy()
    assert got.shape == want.shape
    if z_out is not None:
        assert got.shape == (2, 1, 32, 32)
    _bp_close(got, want)


def _simulate_case(recon):
    """(JAX geometry, phantom) of one stateless-pipeline case, at the
    shapes of the tiny CLI configs below (so the JAX programs compile
    once for both)."""
    kw = dict(N_channels=32, N_proj=24, N_rows=4, h_iso=0.5, eid=True)
    if recon == "helical":
        ct = HelicalConeBeamGeometry(rotation_total=4 * np.pi, pitch=2.0,
                                     **{**kw, "N_proj": 48})
    elif recon == "tilted":
        ct = TiltedConeBeamGeometry(tilt=0.2, **kw)
    else:
        ct = ConeBeamGeometry(**kw)
    ph2 = water_cylinder_phantom(N=32, dx=0.6)
    ph3 = dataclasses.replace(
        ph2, labels=np.broadcast_to(ph2.labels[0], (8, 32, 32)).copy(),
        dz=0.5)
    return ct, ph3


def test_cone_sinogram_matches_jax():
    """``cone_sinogram``: K10's plain version and the JAX tracer on the
    same rays, then the spectral chain; the log sinogram at the
    fused-vs-stateless bar."""
    jct, ph3 = _simulate_case("fdk")
    spec = _spectra(jct)[1]
    want = j_cb.cone_sinogram(ph3, jct, spec)
    got = t_cb.cone_sinogram(ph3, _port_ct(jct), spec, device="cpu")
    assert got[0].shape == np.shape(want[0]) == (24, 4, 32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **WHOLE_TOL["sino_log"])


@pytest.mark.parametrize("recon", ["fdk", "helical", "tilted"])
def test_simulate_cone_dect_matches_jax(recon):
    """The stateless pipeline's circular FDK, helical gFDK and tilted FDK
    (the flat and Katsevich branches are in their own test files)."""
    from dexct_tpu_torch.ops.conebeam import simulate_cone_dect as t_sim

    jct, ph3 = _simulate_case(recon)
    s = _spectra(jct)
    want = j_cb.simulate_cone_dect(jct, ph3, *s, 32, 18.0, 0.8, n_iters=8,
                                   recon=recon)
    got = t_sim(_port_ct(jct), ph3, *s, 32, 18.0, 0.8, device="cpu",
                n_iters=8, recon=recon)
    for key, tol in WHOLE_TOL.items():
        for i in range(2):
            assert got[key][i].shape == np.shape(want[key][i])
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **tol)


@pytest.mark.parametrize("recon", ["fdk", "helical", "tilted"])
def test_reconstruct_3d_auto_is_the_geometry_reconstructor(recon):
    """``reconstruct_3d``: ``'auto'`` and the named ``recon`` give the
    geometry's own reconstructor bit for bit (the flat panel's case is in
    tests/test_torch_flatpanel.py's pipeline tests)."""
    jct, _ = _simulate_case(recon)
    ct = _port_ct(jct)
    rng = np.random.default_rng(11)
    stack = torch.as_tensor(rng.standard_normal(
        (2, ct.N_proj, ct.N_rows, ct.N_channels)).astype(np.float32))
    fn = {"fdk": t_cb.fdk_reconstruct,
          "helical": t_cb.helical_fdk_reconstruct,
          "tilted": t_cb.fdk_tilted_reconstruct}[recon]
    want = fn(stack, ct, 16, 18.0, 0.8)
    for how in ("auto", recon):
        got = t_cb.reconstruct_3d(stack, ct, 16, 18.0, 0.8, recon=how)
        assert torch.equal(got, want), how
    with pytest.raises(ValueError, match="unknown recon"):
        t_cb.reconstruct_3d(stack, ct, 16, 18.0, 0.8, recon="art")


# ---------------------------------------------------------------------------
# The fused cone step
# ---------------------------------------------------------------------------

def _spectra(ct):
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return s1, s2


def _water3d(nz):
    ph2 = water_cylinder_phantom(N=48, dx=0.5)
    lab3 = np.broadcast_to(ph2.labels[0], (nz, 48, 48)).copy()
    return dataclasses.replace(ph2, labels=lab3, dz=0.5)


SYSTEMS = {
    # tests/test_pipeline.py's circular cone scan
    "circular": lambda: ConeBeamGeometry(
        N_channels=64, N_proj=48, N_rows=8, gamma_fan=0.8230337, SID=60.0,
        SDD=100.0, h_iso=0.5),
    # tests/test_conebeam.py's TestFusedHelical._system(2 pi, 3.0)
    "helical": lambda: HelicalConeBeamGeometry(
        N_channels=64, N_proj=96, N_rows=8, gamma_fan=0.8230337, SID=60.0,
        SDD=100.0, h_iso=0.5, eid=True, rotation_total=2.0 * np.pi,
        pitch=3.0),
}


@pytest.fixture(scope="module", params=sorted(SYSTEMS))
def jax_cone_run(request):
    """The JAX fused cone step on a 16 x 48 x 48 water cylinder at 0.5 cm,
    and the port's inputs made of the same pack."""
    ct = SYSTEMS[request.param]()
    ph3 = _water3d(16)
    s1, s2 = _spectra(ct)
    arrays, meta = j_cone.pack_cone_dect(ct, ph3, s1, s2, 48, 20.0, 0.8)
    want = j_cone.make_jitted_cone_step(meta)(arrays)
    V, R, C = meta.vrc
    paths = _np(j_cone._cone_paths(arrays, meta))[_np(arrays["inv"])]
    src, dirs = ct.ray_geometry_3d()
    a = t_cone.cone_arrays_from_numpy(
        {k: _np(v) for k, v in arrays.items()}, "cpu", ph3.labels, src, dirs)
    m = t_cone.ConeDectMeta(**{f: getattr(meta, f) for f in
                               t_cone.ConeDectMeta._fields
                               if hasattr(meta, f)})
    return {"ct": ct, "ph3": ph3, "spectra": (s1, s2), "want": want,
            "paths": paths.reshape(V, R, C, -1), "a": a, "m": m,
            "meta": meta}


def test_trace_matches_jax_packed_trace(jax_cone_run):
    r = jax_cone_run
    got = t_cone.cone_paths(r["a"], r["m"]).numpy()
    np.testing.assert_allclose(got, r["paths"], rtol=0, atol=2e-3)


def test_cone_stages_match_jax_on_its_paths(jax_cone_run):
    """K2 -> GN -> mask -> filter -> FDK/gFDK -> HU fed the JAX step's own
    paths."""
    r = jax_cone_run
    got = t_cone.cone_dect_from_paths(torch.as_tensor(r["paths"]), r["a"],
                                      r["m"])
    for key, tol in TOL.items():
        for i in range(2):
            np.testing.assert_allclose(got[key][i].numpy(),
                                       _np(r["want"][key][i]),
                                       err_msg=f"{key}[{i}]", **tol)


def test_cone_dect_step_matches_jax(jax_cone_run):
    r = jax_cone_run
    got = t_cone.cone_dect_step(r["a"], r["m"])
    for key, tol in WHOLE_TOL.items():
        for i in range(2):
            assert got[key][i].shape == r["want"][key][i].shape
            np.testing.assert_allclose(got[key][i].numpy(),
                                       _np(r["want"][key][i]),
                                       err_msg=f"{key}[{i}]", **tol)


def test_make_jitted_cone_step_matches_jax(jax_cone_run):
    """The port's ``make_jitted_cone_step`` (``cone_dect_step`` closed over
    the meta) against the JAX one's step."""
    r = jax_cone_run
    got = t_cone.make_jitted_cone_step(r["m"])(r["a"])
    again = t_cone.cone_dect_step(r["a"], r["m"])
    for key, tol in WHOLE_TOL.items():
        for i in range(2):
            np.testing.assert_allclose(got[key][i].numpy(),
                                       _np(r["want"][key][i]),
                                       err_msg=f"{key}[{i}]", **tol)
    assert all(torch.equal(x, y) for k in got for x, y in
               zip(got[k], again[k]))


def test_port_pack_matches_jax_pack(jax_cone_run):
    """The port's pack gives the arrays that cone_arrays_from_numpy makes
    of the JAX pack, and the JAX meta's fields."""
    r = jax_cone_run
    a, m = t_cone.pack_cone_dect(r["ct"], r["ph3"], *r["spectra"], 48, 20.0,
                                 0.8, device="cpu")
    assert set(a) == set(r["a"])
    for k in a:
        assert a[k].dtype == r["a"][k].dtype, k
        torch.testing.assert_close(a[k], r["a"][k], rtol=0, atol=0)
    assert m == r["m"]


@pytest.mark.parametrize("system,weighting,nz_out,dz_out", [
    ("helical", "pair", 7, 0.4), ("helical", "short", None, None),
    ("circular", "full", 6, 0.4)])
def test_pack_weighting_and_grid_match_jax(system, weighting, nz_out,
                                           dz_out):
    """``pack_cone_dect(weighting=, nz_out=, dz_out=)`` and the step: the
    port's pack equals the JAX pack's arrays and meta (with
    ``helical_weighting``), the stages after the trace fed the JAX step's
    paths agree at the pipeline tolerances and the whole step at the
    fused-vs-stateless bar."""
    ct = SYSTEMS[system]()
    ph3 = _water3d(16)
    s1, s2 = _spectra(ct)
    kw = dict(nz_out=nz_out, dz_out=dz_out, weighting=weighting)
    arrays, meta = j_cone.pack_cone_dect(ct, ph3, s1, s2, 48, 20.0, 0.8,
                                         **kw)
    want = j_cone.make_jitted_cone_step(meta)(arrays)
    V, R, C = meta.vrc
    paths = _np(j_cone._cone_paths(arrays, meta))[_np(arrays["inv"])]
    src, dirs = ct.ray_geometry_3d()
    ref = t_cone.cone_arrays_from_numpy(
        {k: _np(v) for k, v in arrays.items()}, "cpu", ph3.labels, src, dirs)
    a, m = t_cone.pack_cone_dect(ct, ph3, s1, s2, 48, 20.0, 0.8,
                                 device="cpu", **kw)
    assert m == t_cone.ConeDectMeta(**{f: getattr(meta, f) for f in
                                       t_cone.ConeDectMeta._fields
                                       if hasattr(meta, f)})
    assert m.helical_weighting == weighting
    if nz_out is not None:
        assert (m.nz_out, m.dz_out) == (nz_out, dz_out)
    for k in ref:
        torch.testing.assert_close(a[k], ref[k], rtol=0, atol=0)
    staged = t_cone.cone_dect_from_paths(
        torch.as_tensor(paths.reshape(V, R, C, -1)), a, m)
    whole = t_cone.make_jitted_cone_step(m)(a)
    for got, tols in ((staged, TOL), (whole, WHOLE_TOL)):
        for key, tol in tols.items():
            for i in range(2):
                assert got[key][i].shape == want[key][i].shape
                np.testing.assert_allclose(got[key][i].numpy(),
                                           _np(want[key][i]),
                                           err_msg=f"{key}[{i}]", **tol)


def test_pack_refuses_what_the_fused_pipeline_does_not_model():
    from dexct_tpu_torch.system import (FlatPanelConeBeamGeometry,
                                        TiltedConeBeamGeometry)
    from dexct_tpu_torch.system import ConeBeamGeometry as TCone

    ph3 = _water3d(4)
    for ct in (FlatPanelConeBeamGeometry(N_rows=4),
               TiltedConeBeamGeometry(N_rows=4, tilt=0.2),
               TCone(N_rows=4, N_proj=16, ffs="z")):
        with pytest.raises(ValueError):
            t_cone.pack_cone_dect(ct, ph3, *_spectra(ct), 16, 20.0, 0.8,
                                  device="cpu")


# ---------------------------------------------------------------------------
# The CLI's 3-D configs
# ---------------------------------------------------------------------------

def _cone_params(tmp_path, kind, back_project=True):
    """A tiny cone or helical config: a 32 x 32 x 8 water cylinder and a
    24-view (48 over two turns for the helix) 4-row scan."""
    from dexct_tpu_torch.system.phantom import VoxelPhantom

    ph = water_cylinder_phantom(N=32, dx=0.6)
    lab = np.broadcast_to(ph.labels[0], (8, 32, 32)).copy()
    VoxelPhantom("w3", lab, ph.materials, 0.6, 0.6, 0.5).to_file(
        str(tmp_path / "ph.bin"), str(tmp_path / "ph.csv"))
    with open(os.path.join(REPO, "input", "params.txt")) as f:
        cfg = json.load(f)
    cfg.update({"RUN_ID": "tiny3d", "phantom_id": "water3d",
                "phantom_filename": str(tmp_path / "ph.bin"),
                "matcomp_filename": str(tmp_path / "ph.csv"),
                "Nx": 32, "Ny": 32, "Nz": 8, "dx": 0.6, "dy": 0.6,
                "dz": 0.5, "scanner_geometry": kind, "N_rows": 4,
                "detector_px_height": 0.5, "N_channels": 32,
                "N_projections": 24, "back_project": back_project,
                "detector_filename": os.path.join(REPO,
                                                  cfg["detector_filename"]),
                "N_recon_matrix": 32, "FOV_recon": 18.0})
    if kind == "helical_cone_beam":
        cfg.update({"N_projections": 48, "pitch": 2.0,
                    "rotation_angle_total": 4 * np.pi})
    path = tmp_path / f"{kind}.txt"
    path.write_text(json.dumps(cfg))
    return path


def _main_args(params, out, *extra):
    return (["--params", str(params), "--output", str(out), "--iters", "8",
             "--spectrum-dir", os.path.join(REPO, "input", "spectrum")]
            + list(extra))


# case -> (scanner_geometry, config changes, extra flags, slices out)
CLI_CASES = {
    "cone_beam": ("cone_beam", {}, [], 4),
    "helical_cone_beam": ("helical_cone_beam", {}, [], 6),
    "katsevich": ("helical_cone_beam", {}, ["--recon3d", "katsevich"], 4),
    "flat_panel_cone_beam": ("flat_panel_cone_beam", {}, [], 4),
    "tilted_cone_beam": ("tilted_cone_beam", {"gantry_tilt_rad": 0.2}, [],
                         4),
    "z_ffs": ("cone_beam", {"flying_focal_spot": "z"}, [], 4),
    "helical_z_ffs": ("helical_cone_beam", {"flying_focal_spot": "z"}, [],
                      6),
}


def _case_params(tmp_path, case):
    kind, changes, extra, nz = CLI_CASES[case]
    params = _cone_params(tmp_path, kind)
    cfg = json.loads(params.read_text())
    cfg.update(changes)
    params.write_text(json.dumps(cfg))
    return params, extra, nz


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_both_clis_write_the_same_files(tmp_path, case):
    """The fused circular and helical configs and every stateless one
    (flat panel, tilted gantry, z-FFS on both orbits, Katsevich): the 12
    files, their exact sizes (the slice count of each reconstructor's
    default grid) and values."""
    from dexct_tpu.run import main as j_main
    from dexct_tpu_torch.run import main as t_main

    params, extra, nz = _case_params(tmp_path, case)
    j_main(_main_args(params, tmp_path / "jax", *extra))
    t_main(_main_args(params, tmp_path / "torch", "--device", "cpu", *extra))
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.bin"))
    assert len(files) == 12
    assert files == sorted(p.relative_to(tmp_path / "torch")
                           for p in (tmp_path / "torch").rglob("*.bin"))
    V = 48 if "helical" in CLI_CASES[case][0] else 24
    for rel in files:
        want = np.fromfile(tmp_path / "jax" / rel, np.float32)
        got = np.fromfile(tmp_path / "torch" / rel, np.float32)
        name = rel.name[:-len("_float32.bin")]
        size = V * 4 * 32 if "sino" in name else nz * 32 * 32
        assert got.size == want.size == size, rel
        np.testing.assert_allclose(got, want, err_msg=str(rel),
                                   **FILE_TOL[name])


@pytest.mark.parametrize("kind,recon3d", [
    ("cone_beam", "helical"), ("cone_beam", "katsevich"),
    ("helical_cone_beam", "fdk")])
def test_recon3d_mismatch_raises(tmp_path, kind, recon3d):
    """The JAX runner's ValueErrors, before anything runs."""
    from dexct_tpu.run import main as j_main
    from dexct_tpu_torch.run import main as t_main

    params = _cone_params(tmp_path, kind)
    with pytest.raises(ValueError) as j_err:
        j_main(_main_args(params, tmp_path / "j", "--recon3d", recon3d))
    with pytest.raises(ValueError) as t_err:
        t_main(_main_args(params, tmp_path / "t", "--device", "cpu",
                          "--recon3d", recon3d))
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("choice", ["inplane_ffs", "weighting", "heel"])
def test_unported_3d_choices_raise(tmp_path, choice):
    """The choices the stateless branch once refused now run: the 2-D
    in-plane flying focal spot (the composed path's 16-tap FFS rebin writes
    the JAX CLI's 12 files), the generalized Feldkamp's study weightings
    (``simulate_cone_dect(recon='helical', weighting='td')`` gives the JAX
    package's volumes) and the anode heel."""
    if choice == "inplane_ffs":
        from dexct_tpu.run import main as j_main
        from dexct_tpu_torch.run import main as t_main

        params = _cone_params(tmp_path, "fan_beam")
        cfg = json.loads(params.read_text())
        cfg["flying_focal_spot"] = "inplane"
        params.write_text(json.dumps(cfg))
        j_main(_main_args(params, tmp_path / "j"))
        t_main(_main_args(params, tmp_path / "t", "--device", "cpu"))
        files = sorted(p.relative_to(tmp_path / "j")
                       for p in (tmp_path / "j").rglob("*.bin"))
        assert len(files) == 12
        assert files == sorted(p.relative_to(tmp_path / "t")
                               for p in (tmp_path / "t").rglob("*.bin"))
        for rel in files:
            np.testing.assert_allclose(
                np.fromfile(tmp_path / "t" / rel, np.float32),
                np.fromfile(tmp_path / "j" / rel, np.float32),
                err_msg=str(rel), **FILE_TOL[rel.name[:-len("_float32.bin")]])
        return
    from dexct_tpu_torch.ops.conebeam import simulate_cone_dect
    from dexct_tpu_torch.system import HelicalConeBeamGeometry as THelix

    if choice == "weighting":
        jct, ph3 = _simulate_case("helical")
        s = _spectra(jct)
        want = j_cb.simulate_cone_dect(jct, ph3, *s, 32, 18.0, 0.8,
                                       n_iters=8, recon="helical",
                                       weighting="td")
        got = simulate_cone_dect(_port_ct(jct), ph3, *s, 32, 18.0, 0.8,
                                 device="cpu", n_iters=8, recon="helical",
                                 weighting="td")
        for key, tol in WHOLE_TOL.items():
            for i in range(2):
                np.testing.assert_allclose(got[key][i].numpy(),
                                           np.asarray(want[key][i]),
                                           err_msg=f"{key}[{i}]", **tol)
        return
    # the anode heel, once refused here, now runs on the helix: finite,
    # and a zero-depth heel is the heel-free pipeline bit for bit (its
    # parity with the JAX package is tests/test_torch_heel.py's)
    from dexct_tpu_torch.ops.heel import HeelEffect

    ct = THelix(N_channels=32, N_proj=48, N_rows=4, h_iso=0.5,
                rotation_total=4 * np.pi, pitch=2.0)
    runs = [simulate_cone_dect(ct, _water3d(4), *_spectra(ct), 16, 18.0, 0.8,
                               device="cpu", n_iters=4, heel=heel)
            for heel in (HeelEffect(d0_cm=1e-3), HeelEffect(d0_cm=0.0),
                         None)]
    assert all(bool(torch.isfinite(x).all()) for k in runs[0]
               for x in runs[0][k])
    assert all(torch.equal(a, b) for k in runs[1]
               for a, b in zip(runs[1][k], runs[2][k]))


def test_back_project_false_writes_no_volumes(tmp_path):
    from dexct_tpu_torch.run import main as t_main

    params = _cone_params(tmp_path, "cone_beam", back_project=False)
    (res,) = t_main(_main_args(params, tmp_path / "t", "--device", "cpu"))
    assert res.dect.recon_raw == (None, None)
    names = sorted(p.name for p in (tmp_path / "t").rglob("*.bin"))
    assert names == sorted(["sino_raw_float32.bin", "sino_log_float32.bin"]
                           * 2 + ["mat1_sino_float32.bin",
                                  "mat2_sino_float32.bin"])


# ---------------------------------------------------------------------------
# The full-size witness of the weighted helical paths (a script, not a test)
# ---------------------------------------------------------------------------

# the weightings the card's fused step runs, and 'full' beside them
WITNESS_WEIGHTINGS = ("full", "pair", "td", "short")


def _chip_smoke():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _helical_config():
    """(JAX geometry, N, FOV, ramp) of chip_smoke.py's helical config."""
    from dexct_tpu.system.config import read_parameter_file

    chip_smoke = _chip_smoke()
    with tempfile.TemporaryDirectory() as tmp:
        path = chip_smoke.write_cone_params(
            Path(tmp), "helical", chip_smoke.CONE_CONFIGS["helical"])
        cfg = read_parameter_file(str(path))[0]
    return cfg.ct, cfg.N_matrix, cfg.FOV, cfg.ramp


def witness(npz_path):
    """The full-size witness for the readings ``chip_smoke.py`` holds its
    weighted helical paths to (``WEIGHTING_REF_HU``), run as a script:

        python3 chip_smoke.py --witness DIR                 # on the card
        PYTHONPATH=. python tests/test_torch_cone.py DIR    # with JAX

    The card writes the helical config's log sinograms (720 views x 16 rows
    x 256 channels, both spectra) and the central slice (z = 0) of its
    fused step's volumes in 'pair', 'td' and 'short'.  This reconstructs
    that slice from the same sinograms with the JAX package's
    ``helical_fdk_reconstruct(z_out=[0.0], weighting=w)`` and with the
    port's plain version, for those weightings and 'full', and prints each
    one's air (0, -18) cm and body (0, 0) cm ROIs in HU, and how far the
    port's CPU slice and the card's lie from the JAX slice."""
    chip_smoke = _chip_smoke()
    data = np.load(npz_path)
    sino, mu_w = data["sino_log"], data["mu_w"]
    jct, n, fov, ramp = _helical_config()

    def hu(vol):  # [2, N, N] cm^-1 -> HU per spectrum
        return 1000.0 * (vol - mu_w[:, None, None]) / mu_w[:, None, None]

    def rois(h):
        return ([chip_smoke.roi_mean(x[None], 0.0, -18.0, 0, fov) for x in h]
                + [chip_smoke.roi_mean(x[None], 0.0, 0.0, 0, fov) for x in h])

    for w in WITNESS_WEIGHTINGS:
        want = np.asarray(j_cb.helical_fdk_reconstruct(
            jnp.asarray(sino), jct, n, fov, ramp, z_out=[0.0],
            weighting=w))[:, 0]
        got = t_cb.helical_fdk_reconstruct(
            torch.as_tensor(sino), _port_ct(jct), n, fov, ramp, z_out=[0.0],
            weighting=w).numpy()[:, 0]
        ref = hu(want)
        row = {"jax_air_body_hu": rois(ref),
               "port_cpu_max_abs_hu": float(np.abs(hu(got) - ref).max()),
               "port_cpu_air_body_hu": rois(hu(got))}
        if f"hu_{w}" in data:
            card = data[f"hu_{w}"]
            row["card_max_abs_hu"] = float(np.abs(card - ref).max())
            row["card_air_body_hu"] = rois(card)
        print(w, json.dumps(row))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    witness(Path(sys.argv[1]) / "helical_weightings.npz")
