"""The port's dose maps (``ops/dose.py``: the plain versions of K23 and
K24) and dose reports against the JAX package's, on the CPU.

Inputs: a 48^2 water cylinder and a 48^2 air/water/bone phantom under a
64-channel, 24-view fan; a 24^2 x 8 cylinder under a 32-channel, 4-row,
16-view cone; the JAX test's helical scan (3 turns, 48 views, 4 rows)
through a 24^2 x 32 cylinder, where the z-slab window is active.
Tolerances: the dose maps 1e-4 of their maximum and ``deposited_J`` rel
1e-4 (float32 sums in another order; measured 5e-7 and 2e-7); the windowed
3-D map equals the full scan to 1e-6 of its maximum (the JAX test's bar);
the host tables and reports are equal (the same float64 NumPy); the
refusals raise the JAX package's exception types and messages; the
beam-energy bookkeeping rel 1e-5 (float32 exact-Siddon paths of two
tracers) and, on the port, the conservation law of the JAX test (the
deposited energy within 5 % of the removed energy).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dexct_tpu.ops import dose as jd
from dexct_tpu.physics import kramers_spectrum as j_kramers
from dexct_tpu.physics.materials import AIR as J_AIR
from dexct_tpu.physics.materials import BONE as J_BONE
from dexct_tpu.physics.materials import WATER as J_WATER
from dexct_tpu.physics.materials import MaterialTable as JTable
from dexct_tpu.system import geometry as j_geo
from dexct_tpu.system.phantom import VoxelPhantom as JPhantom
from dexct_tpu.system.phantom import water_cylinder_phantom as j_cyl
from dexct_tpu_torch.ops import dose as td
from dexct_tpu_torch.physics import kramers_spectrum as t_kramers
from dexct_tpu_torch.physics.materials import AIR, BONE, WATER, MaterialTable
from dexct_tpu_torch.system import geometry as t_geo
from dexct_tpu_torch.system.phantom import VoxelPhantom
from dexct_tpu_torch.system.phantom import water_cylinder_phantom as t_cyl

FAN = dict(N_channels=64, N_proj=24, gamma_fan=0.9, SID=60.0, SDD=100.0,
           h_iso=0.1, eid=True)
CONE = dict(N_channels=32, N_proj=16, N_rows=4, gamma_fan=0.8230337,
            SID=60.0, SDD=100.0, h_iso=0.25, eid=True)
HELIX = dict(N_channels=32, N_proj=48, N_rows=4, gamma_fan=0.8, SID=60.0,
             SDD=100.0, h_iso=0.4, eid=True, rotation_total=6 * np.pi,
             pitch=1.6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(kind, cls, **kw):
    """The same geometry in both packages."""
    return getattr(j_geo, cls)(**kw), getattr(t_geo, cls)(**kw)


def _spectra(kvp, total):
    out = []
    for make in (j_kramers, t_kramers):
        s = make(kvp)
        s.rescale_counts(total)
        out.append(s)
    return out


def _phantoms(kind):
    if kind == "cylinder":
        return (j_cyl(N=48, dx=0.25, radius_cm=4.0),
                t_cyl(N=48, dx=0.25, radius_cm=4.0))
    ys = (np.arange(48) + 0.5 - 24) * 0.25
    rr = np.hypot(ys[None, :], ys[:, None])
    lab = (rr <= 4.5).astype(np.uint8)
    lab[np.hypot(ys[None, :] - 1.5, ys[:, None] - 1.0) <= 1.2] = 2
    return (JPhantom("rods", lab[None], JTable([J_AIR, J_WATER, J_BONE]),
                     0.25, 0.25, 0.25),
            VoxelPhantom("rods", lab[None], MaterialTable([AIR, WATER, BONE]),
                         0.25, 0.25, 0.25))


def _cylinders_3d(n, nz, dx, dz, radius):
    jp, tp = j_cyl(N=n, dx=dx, radius_cm=radius), t_cyl(N=n, dx=dx,
                                                        radius_cm=radius)
    lab = np.broadcast_to(jp.labels[0], (nz, n, n)).copy()
    return (dataclasses.replace(jp, labels=lab, dz=dz),
            dataclasses.replace(tp, labels=lab.copy(), dz=dz))


def _close(got, want):
    d = np.asarray(got.dose_mGy)
    assert d.shape == want.dose_mGy.shape and d.dtype == np.float64
    assert np.abs(d - want.dose_mGy).max() <= 1e-4 * want.dose_mGy.max()
    assert abs(got.deposited_J - want.deposited_J) \
        <= 1e-4 * want.deposited_J


@pytest.mark.parametrize("kind,kw", [
    ("cylinder", {}),
    ("rods", {}),
    ("rods", dict(scoring="kerma", oversample=3)),
    ("rods", dict(n_energy=16, view_weights=np.linspace(0.5, 1.5, 24))),
])
def test_dose_map_matches_jax(kind, kw):
    jct, tct = _pair("fan", "FanBeamGeometry", **FAN)
    jph, tph = _phantoms(kind)
    js, ts = _spectra(120.0, jct.A_iso * 10.0 / 24)
    want = jd.dose_map(jph, jct, js, **kw)
    got = td.dose_map(tph, tct, ts, device="cpu", **kw)
    assert want.deposited_J > 0
    _close(got, want)


@pytest.mark.parametrize("config", ["cone", "helical"])
def test_dose_map_3d_matches_jax(config):
    """The 4-row cone through a 24^2 x 8 cylinder, and the JAX test's
    helical scan through a 24^2 x 32 one with the z-slab window active:
    the windowed port map also equals its own full scan."""
    if config == "cone":
        jct, tct = _pair("cone", "ConeBeamGeometry", **CONE)
        jph, tph = _cylinders_3d(24, 8, 0.5, 0.5, 5.0)
        kw = dict(oversample=2)
    else:
        jct, tct = _pair("helix", "HelicalConeBeamGeometry", **HELIX)
        jph, tph = _cylinders_3d(24, 32, 0.5, 0.25, 5.0)
        kw = dict(oversample=1)
    js, ts = _spectra(120.0, jct.A_iso * 5.0 / jct.N_proj)
    want = jd.dose_map_3d(jph, jct, js, **kw)
    got = td.dose_map_3d(tph, tct, ts, device="cpu", **kw)
    _close(got, want)
    if config == "helical":
        full = td.dose_map_3d(tph, tct, ts, device="cpu", _z_window=None,
                              **kw)
        assert np.abs(got.dose_mGy - full.dose_mGy).max() \
            <= 1e-6 * full.dose_mGy.max()
        assert abs(got.deposited_J - full.deposited_J) \
            <= 1e-6 * full.deposited_J


@pytest.mark.parametrize("config", ["cone", "helical"])
def test_k24_host_plan(config, monkeypatch):
    """K24's host-side plan against a direct NumPy count: the voxel
    centres' axes the kernel reads (``_voxel_axes``: x by column, y by row,
    z by slice) rebuild every centre ``_dose_prep_3d`` makes, and equal the
    float32 centres of the phantom's grid; a scratch of the label quads and
    five views' terms gives the C calls of blocks of five views, and a
    byte less blocks of four."""
    if config == "cone":
        _, tct = _pair("cone", "ConeBeamGeometry", **CONE)
        _, tph = _cylinders_3d(24, 8, 0.5, 0.5, 5.0)
    else:
        _, tct = _pair("helix", "HelicalConeBeamGeometry", **HELIX)
        _, tph = _cylinders_3d(24, 32, 0.5, 0.25, 5.0)
    _, ts = _spectra(120.0, 1e6)
    args, (nz, ny, nx) = td._dose_prep_3d(
        tph, tct, ts, n_gamma=None, n_t=None, n_r=None, oversample=1,
        views=None, n_energy=None, view_weights=None, scoring="removed",
        z_window="auto", device="cpu")
    vox, z_window = args[10].numpy(), args[14]
    assert (z_window is not None) == (config == "helical")
    xc, yc, zc = (a.numpy() for a in td._voxel_axes(args[10], nz, ny, nx))
    z, y, x = np.meshgrid(zc, yc, xc, indexing="ij")
    assert np.array_equal(np.stack([x, y, z], -1).reshape(-1, 3), vox)
    for got, n, d in ((xc, nx, tph.dx), (yc, ny, tph.dy), (zc, nz, tph.dz)):
        np.testing.assert_array_equal(
            got, ((np.arange(n) + 0.5 - n / 2) * d).astype(np.float32))
    n_views = args[4].shape[0]
    n_slab = (z_window or nz) * ny * nx
    quads = nz * (ny + 1) * (nx + 1) * 4
    for room, views in ((5 * n_slab * 8, 5), (5 * n_slab * 8 - 1, 4)):
        monkeypatch.setattr(td, "_SCRATCH_BYTES", quads + room)
        vb = td._view_block(n_views, n_slab * 8, quads)
        assert vb == views
        assert len(range(0, n_views, vb)) == -(-n_views // views)


def test_k24_probe_finds_its_cut_points():
    """``tools/probe_dose3d`` cuts K24's source at two marked lines: each
    is in ``csrc/dose.cu`` once; without a card the tool refuses to run."""
    from dexct_tpu_torch.tools import probe_dose3d as pd
    from dexct_tpu_torch.utils import kernels

    src = (kernels.CSRC / "dose.cu").read_text()
    assert src.count(pd._SEARCH) == 1 and src.count(pd._TERM) == 1
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            pd.main([])


def _raises_like(j_call, t_call):
    with pytest.raises(Exception) as want:
        j_call()
    with pytest.raises(type(want.value)) as got:
        t_call()
    assert str(got.value) == str(want.value)


def test_refusals_match_jax():
    js, ts = _spectra(80.0, 1e3)
    jph, tph = _cylinders_3d(16, 4, 0.5, 0.5, 3.0)
    geo = dict(N_channels=16, N_proj=4, N_rows=4, gamma_fan=0.9, SID=60.0,
               SDD=100.0, h_iso=0.25, eid=True)
    for cls, extra in (("FlatPanelConeBeamGeometry", {}),
                       ("TiltedConeBeamGeometry", dict(tilt=0.3))):
        jct, tct = _pair("cone", cls, **geo, **extra)
        _raises_like(lambda: jd.dose_map_3d(jph, jct, js),
                     lambda: td.dose_map_3d(tph, tct, ts, device="cpu"))
    jct, tct = _pair("helix", "HelicalConeBeamGeometry", **HELIX)
    _raises_like(lambda: jd.dose_map_3d(jph, jct, js, views=jct.betas[:4]),
                 lambda: td.dose_map_3d(tph, tct, ts, views=tct.betas[:4],
                                        device="cpu"))
    jfan, tfan = _pair("fan", "FanBeamGeometry", **FAN)
    jcyl, tcyl = _phantoms("cylinder")
    _raises_like(lambda: jd.dose_map(jcyl, jfan, js, scoring="exact"),
                 lambda: td.dose_map(tcyl, tfan, ts, scoring="exact",
                                     device="cpu"))
    with pytest.raises(NotImplementedError, match="item 15"):
        td.sharded_dose_map(None, tcyl, tfan, ts)


def test_host_tables_and_reports_match_jax():
    jct, tct = _pair("fan", "FanBeamGeometry", **FAN)
    jph, tph = _phantoms("rods")
    js, ts = _spectra(120.0, 1e6)
    for n_g, n_r, over in ((None, None, 2), (40, 56, 3)):
        for a, b in zip(jd._sample_grids(jct, jph, n_g, n_r, over),
                        td._sample_grids(tct, tph, n_g, n_r, over)):
            np.testing.assert_array_equal(b, a)
    for n_energy, scoring in ((None, "removed"), (12, "kerma")):
        for a, b in zip(jd._dose_energy_grid(jph, js, n_energy, scoring),
                        td._dose_energy_grid(tph, ts, n_energy, scoring)):
            np.testing.assert_array_equal(b, a)
    d = np.random.default_rng(4).uniform(0.5, 2.0, (48, 48))
    assert td.ctdi_metrics(d, 0.25, phantom_radius_cm=4.5) \
        == jd.ctdi_metrics(d, 0.25, phantom_radius_cm=4.5)
    assert td.organ_dose_report(d, tph) == jd.organ_dose_report(d, jph)
    assert td.dose_efficiency(2.5, 3.0) == jd.dose_efficiency(2.5, 3.0)
    jh, th = _pair("helix", "HelicalConeBeamGeometry", **HELIX)
    jc, tc = _pair("cone", "ConeBeamGeometry", **CONE)
    for a, b in ((jh, th), (jc, tc)):
        assert td.ctdi_vol(10.0, b) == jd.ctdi_vol(10.0, a)
    assert td.dlp(5.0, 10.0) == jd.dlp(5.0, 10.0)
    d3 = np.random.default_rng(5).uniform(0.5, 2.0, (6, 48, 48))
    np.testing.assert_array_equal(td.dose_z_profile(d3, 0.25),
                                  jd.dose_z_profile(d3, 0.25))
    for fn in (td.ctdi_metrics, jd.ctdi_metrics):
        with pytest.raises(ValueError, match="ROI contains no pixels"):
            fn(d, 0.25, roi_radius_cm=0.01)


def test_beam_energy_removed_matches_jax_and_conserves():
    """The removed-energy bookkeeping in 2-D and 3-D against the JAX
    package's, and the JAX conservation test on the port: the deposited
    energy within 5 % (6 % in 3-D) of the removed energy."""
    jct, tct = _pair("fan", "FanBeamGeometry", **FAN)
    jph, tph = _phantoms("cylinder")
    js, ts = _spectra(120.0, jct.A_iso * 50.0 / 24)
    removed = td.beam_energy_removed(tph, tct, ts, device="cpu")
    assert removed == pytest.approx(jd.beam_energy_removed(jph, jct, js),
                                    rel=1e-5)
    dep = td.dose_map(tph, tct, ts, oversample=3, device="cpu").deposited_J
    assert abs(dep - removed) / removed < 0.05
    # the JAX test's cone: 8 rows over a 32^2 x 12 cylinder at 0.25 cm
    jc, tc = _pair("cone", "ConeBeamGeometry", **dict(CONE, N_channels=64,
                                                      N_rows=8))
    jp3, tp3 = _cylinders_3d(32, 12, 0.25, 0.25, 3.0)
    js, ts = _spectra(120.0, jc.A_iso * 20.0 / jc.N_proj)
    removed = td.beam_energy_removed_3d(tp3, tc, ts, device="cpu")
    assert removed == pytest.approx(jd.beam_energy_removed_3d(jp3, jc, js),
                                    rel=1e-5)
    dep = td.dose_map_3d(tp3, tc, ts, oversample=3, device="cpu").deposited_J
    assert abs(dep - removed) / removed < 0.06


def test_tpu_layout_keywords_are_ignored():
    """``pixel_block`` and ``vox_tap_fold`` (2-D), ``pixel_block``,
    ``view_chunk`` and ``_pair`` (3-D) select TPU layouts in the JAX
    package; the port's maps with them equal the maps without, bit for
    bit."""
    _, tct = _pair("fan", "FanBeamGeometry", **FAN)
    _, tph = _phantoms("rods")
    _, ts = _spectra(100.0, 1e7)
    a = td.dose_map(tph, tct, ts, device="cpu")
    b = td.dose_map(tph, tct, ts, pixel_block=512, vox_tap_fold=False,
                    device="cpu")
    np.testing.assert_array_equal(a.dose_mGy, b.dose_mGy)
    assert a.deposited_J == b.deposited_J
    _, tc = _pair("cone", "ConeBeamGeometry", **CONE)
    _, tp3 = _cylinders_3d(16, 4, 0.75, 0.5, 4.0)
    a = td.dose_map_3d(tp3, tc, ts, device="cpu")
    b = td.dose_map_3d(tp3, tc, ts, pixel_block=100, view_chunk=3,
                       _pair=False, device="cpu")
    np.testing.assert_array_equal(a.dose_mGy, b.dose_mGy)
    assert a.deposited_J == b.deposited_J
