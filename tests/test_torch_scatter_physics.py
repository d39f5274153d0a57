"""The port's first-principles scatter (``ops/scatter_physics.py``: the
plain versions of K26 and K27) and form factors (``physics/formfactor.py``)
against the JAX package's, on the CPU.

Inputs: the JAX tests' smallest scenes — a 32^2 water cylinder (radius 6
cm, 0.5 cm voxels) under a 32-channel fan (4 views, h_iso 0.1 cm), a 32^2
air / water / bone phantom, a 50^2 grid that the coarse vertex grid pads,
a 4-row cone over 8 slices — at 120 kV and with the linac spectrum (MeV
energies: the fine exit grid and the q grid at their widest), built from
the same numpy arrays through each package's constructors.
Tolerances: the scatter sinograms 1e-4 of their maximum (float32 sums over
vertices, energies and march steps in another order; measured < 1e-5),
except with the Rayleigh term at MeV energies (the linac spectrum): there
the JAX program's float32 sinogram lies 4.3e-3 of the maximum from the
same JAX program run in float64 (jax x64 on the CPU, on the same inputs;
it forms 1 - cos(theta) as 1 - u_in . u_out, whose last bits the form
factor amplifies near the forward direction), the port's (|u_in - u_out|^2
/ 2) 1.9e-5, so the port is held to 1e-4 of the JAX program in float64 and
to 1e-2 of its float32 result (the cancellation keeps only last bits,
which no other float32 program reproduces; the cone case with the linac
spectrum, whose coarser elements see no such forward pair, agrees with
the JAX package to 1.1e-5); the host tables (form factors, Klein-Nishina, Compton energies, electron
densities, spectra and cell weights) and the host float64 Monte Carlo
references are equal to the bit, from the same seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import scatter_physics as js
from dexct_tpu.physics import formfactor as jf
from dexct_tpu.physics import kramers_spectrum as j_kramers
from dexct_tpu.physics import linac_spectrum as j_linac
from dexct_tpu.physics.materials import AIR as J_AIR
from dexct_tpu.physics.materials import BONE as J_BONE
from dexct_tpu.physics.materials import WATER as J_WATER
from dexct_tpu.physics.materials import MaterialTable as JTable
from dexct_tpu.system import geometry as j_geo
from dexct_tpu.system.phantom import VoxelPhantom as JPhantom
from dexct_tpu.system.phantom import water_cylinder_phantom as j_cyl
from dexct_tpu_torch.ops import scatter_physics as ts
from dexct_tpu_torch.physics import formfactor as tf
from dexct_tpu_torch.physics import kramers_spectrum as t_kramers
from dexct_tpu_torch.physics import linac_spectrum as t_linac
from dexct_tpu_torch.physics.materials import AIR, BONE, WATER, MaterialTable
from dexct_tpu_torch.system import geometry as t_geo
from dexct_tpu_torch.system.phantom import VoxelPhantom
from dexct_tpu_torch.system.phantom import water_cylinder_phantom as t_cyl

FAN = dict(N_channels=32, N_proj=4, gamma_fan=0.9, SID=60.0, SDD=100.0,
           h_iso=0.1, eid=True)
CONE = dict(FAN, h_iso=0.5, N_rows=4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(cls, **kw):
    return getattr(j_geo, cls)(**kw), getattr(t_geo, cls)(**kw)


def _spectra(kind, total=1e6):
    if kind == "linac":
        out = [j_linac(), t_linac()]
    else:
        out = [j_kramers(120.0), t_kramers(120.0)]
    for s in out:
        s.rescale_counts(total)
    return out


def _phantoms(kind, nz=None):
    """(JAX, port) phantoms: the water cylinder, the air / water / bone
    rods, or the 50^2 edge strip; ``nz`` slices of it for a cone."""
    if kind == "cylinder":
        jp, tp = (j_cyl(N=32, dx=0.5, radius_cm=6.0),
                  t_cyl(N=32, dx=0.5, radius_cm=6.0))
        lab, dx = jp.labels[0], 0.5
        jm, tm = jp.materials, tp.materials
    elif kind == "rods":
        ys = (np.arange(32) + 0.5 - 16) * 0.5
        lab = (np.hypot(ys[None, :], ys[:, None]) <= 6.0).astype(np.uint8)
        lab[np.hypot(ys[None, :] - 2.0, ys[:, None] - 1.0) <= 1.5] = 2
        dx = 0.5
        jm = JTable([J_AIR, J_WATER, J_BONE])
        tm = MaterialTable([AIR, WATER, BONE])
    else:  # the JAX test's odd grid: a water strip on the padded edge
        lab = np.zeros((50, 50), np.uint8)
        lab[:, -2:] = 1
        lab[20:30, 20:30] = 1
        dx = 0.4
        jm = JTable([J_AIR, J_WATER])
        tm = MaterialTable([AIR, WATER])
    lab3 = lab[None] if nz is None else np.broadcast_to(lab, (nz,) +
                                                        lab.shape)
    return (JPhantom(kind, lab3.copy(), jm, dx, dx, dx),
            VoxelPhantom(kind, lab3.copy(), tm, dx, dx, dx))


def _close_max(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    assert want.max() > 0
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# host tables: equal to the bit
# ---------------------------------------------------------------------------

def test_form_factor_tables_equal_jax():
    assert tf.CM_COEFFS == jf.CM_COEFFS
    assert tf.HC_KEV_A == jf.HC_KEV_A
    q = np.concatenate([np.linspace(0.0, 3.5, 71), [1e-6, 2.0, 2.0001]])
    # tabulated, and Thomas-Fermi scaled from a neighbour (Br, Ag, Bi)
    for sym in ("H", "O", "Ca", "I", "Pb", "Br", "Ag", "Bi"):
        assert np.array_equal(tf.atomic_form_factor(sym, q),
                              jf.atomic_form_factor(sym, q))
    e = np.array([20.0, 60.0, 140.0, 1000.0])
    ct = np.linspace(-1.0, 1.0, 9)
    assert np.array_equal(tf.momentum_transfer(e[:, None], ct),
                          jf.momentum_transfer(e[:, None], ct))
    assert np.array_equal(tf.rayleigh_differential("O", 60.0, ct),
                          jf.rayleigh_differential("O", 60.0, ct))
    assert np.array_equal(tf.coherent_cross_section("Ca", e, n_theta=256),
                          jf.coherent_cross_section("Ca", e, n_theta=256))
    for tm, jm in ((WATER, J_WATER), (BONE, J_BONE)):
        assert np.array_equal(tf.material_f2_per_volume(tm, tm.density, q),
                              jf.material_f2_per_volume(jm, jm.density, q))
    with pytest.raises(ValueError, match="unknown element"):
        tf.atomic_form_factor("Xx", q)


def test_compton_and_klein_nishina_equal_jax():
    e = np.array([[15.0], [60.0], [140.0], [6000.0]])
    c = np.linspace(-1.0, 1.0, 41)[None, :]
    assert np.array_equal(ts.compton_energy(e, c), js.compton_energy(e, c))
    assert np.array_equal(ts.klein_nishina_differential(e, c),
                          js.klein_nishina_differential(e, c))


@pytest.mark.parametrize("spectrum", ["kramers", "linac"])
def test_host_scatter_tables_equal_jax(spectrum):
    jp, tp = _phantoms("rods")
    jsp, tsp = _spectra(spectrum)
    assert np.array_equal(ts.electron_density_image(tp),
                          js.electron_density_image(jp))
    for n_energy in (1, 8, 12):
        for a, b in zip(ts._rebin_spectrum(tsp, n_energy),
                        js._rebin_spectrum(jsp, n_energy)):
            assert np.array_equal(a, b)
    e_max = float(js._rebin_spectrum(jsp, 12)[0].max())
    for a, b in zip(ts._material_f2_tables(tp.materials, e_max, 48),
                    js._material_f2_tables(jp.materials, e_max, 48)):
        assert np.array_equal(a, b)
    for coarse in (2, 3):
        assert np.array_equal(
            ts._cell_f2_weights(tp.slice_labels(), tp.materials, coarse,
                                0.7, e_max, 48),
            js._cell_f2_weights(jp.slice_labels(), jp.materials, coarse,
                                0.7, e_max, 48))


# ---------------------------------------------------------------------------
# the device programs (plain versions of K26 and K27)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phantom,spectrum,coherent,sub,kw", [
    ("cylinder", "kramers", True, 1, {}),
    ("cylinder", "kramers", False, 1, {}),
    ("cylinder", "kramers", True, 3, {}),
    ("cylinder", "kramers", False, 3, {}),
    ("rods", "linac", True, 1, {}),
    ("rods", "kramers", True, 4, dict(multiple_factor=0.25, n_q=24)),
    ("edge", "kramers", True, 1, dict(coarse=4, n_energy=1)),
])
def test_single_scatter_sinogram_matches_jax(phantom, spectrum, coherent,
                                             sub, kw, monkeypatch):
    """Compton with and without the Rayleigh term, every channel and every
    3rd (4th) channel interpolated, MeV energies, the multiple-scatter
    tail, and an odd 50^2 grid padded by the coarse vertex grid."""
    jct, tct = _pair("FanBeamGeometry", **FAN)
    jp, tp = _phantoms(phantom)
    jsp, tsp = _spectra(spectrum)
    kw = dict(dict(coarse=2, n_energy=8), **kw)
    want = js.single_scatter_sinogram(jp, jct, jsp, coherent=coherent,
                                      channel_sub=sub, **kw)
    got = ts.single_scatter_sinogram(tp, tct, tsp, coherent=coherent,
                                     channel_sub=sub, device="cpu", **kw)
    if spectrum == "linac" and coherent:
        _close_max(got, want, 1e-2)
        want64 = _jax_float64_sinogram(jp, jct, jsp, sub, kw, monkeypatch)
        _close_max(got, want64, 1e-4)
    else:
        _close_max(got, want)


def _jax_float64_sinogram(jp, jct, jsp, sub, kw, monkeypatch):
    """The JAX package's fan program run in float64 (jax x64 on the CPU)
    on the float32 inputs its host code builds: the reference of the MeV
    coherent case."""
    scan = js._scatter_scan

    def scan64(*args, **kws):
        with jax.enable_x64(True):
            args = [jnp.asarray(np.asarray(a), jnp.float64)
                    if np.asarray(a).dtype == np.float32 else a
                    for a in args]
            return np.asarray(scan(*args, **kws))

    monkeypatch.setattr(js, "_scatter_scan", scan64)
    return js.single_scatter_sinogram(jp, jct, jsp, coherent=True,
                                      channel_sub=sub, **kw)


def test_single_scatter_blocks_change_nothing():
    """The plain version's vertex and channel blocks (the JAX program's
    x_block and c_block) only regroup its sums."""
    _, tct = _pair("FanBeamGeometry", **FAN)
    _, tp = _phantoms("rods")
    _, tsp = _spectra("kramers")
    kw = dict(coarse=2, n_energy=4, device="cpu")
    a = ts.single_scatter_sinogram(tp, tct, tsp, **kw)
    b = ts.single_scatter_sinogram(tp, tct, tsp, x_block=37, c_block=5,
                                   **kw)
    _close_max(b, a, 1e-6)


@pytest.mark.parametrize("phantom,spectrum,coherent", [
    ("cylinder", "kramers", True), ("rods", "kramers", False),
    ("rods", "linac", True)])
def test_single_scatter_conebeam_matches_jax(phantom, spectrum, coherent):
    """A 4-row cone over 8 slices, every 2nd row and channel evaluated and
    the surface upsampled bilinearly."""
    jct, tct = _pair("ConeBeamGeometry", **CONE)
    jp, tp = _phantoms(phantom, nz=8)
    jsp, tsp = _spectra(spectrum)
    kw = dict(coarse=2, n_energy=4, channel_sub=2, row_sub=2,
              coherent=coherent)
    want = js.single_scatter_conebeam(jp, jct, jsp, **kw)
    got = ts.single_scatter_conebeam(tp, tct, tsp, device="cpu", **kw)
    _close_max(got, want)


def test_thin_cone_reproduces_the_fan():
    """The N_rows = 1 anchor of the JAX test on the port alone: the cone
    estimator through a z-extruded cylinder equals the fan estimator on
    its slice within a 5 % median."""
    _, tp3 = _phantoms("cylinder", nz=16)
    _, tp2 = _phantoms("cylinder")
    kw = dict(FAN, h_iso=0.5)
    spec = t_kramers(60.0)
    spec.rescale_counts(1e6)
    v = np.array([0.0])
    s3 = ts.single_scatter_conebeam(
        tp3, t_geo.ConeBeamGeometry(N_rows=1, **kw), spec, coarse=2,
        n_energy=1, channel_sub=1, row_sub=1, views=v, device="cpu")[0, 0]
    s2 = ts.single_scatter_sinogram(tp2, t_geo.FanBeamGeometry(**kw), spec,
                                    coarse=2, n_energy=1, views=v,
                                    device="cpu")[0]
    sel = s2 > 0.2 * s2.max()
    assert np.median(np.abs(s3[sel] - s2[sel]) / s2[sel]) < 0.05


def test_kernel_material_limit_and_empty_scene():
    """The kernels hold at most 16 materials in registers and refuse more;
    a scene without scatter vertices detects nothing."""
    assert ts._max_k(6) == 8 and ts._max_k(16) == 16
    with pytest.raises(ValueError, match="at most 16 materials"):
        ts._max_k(17)
    _, tct = _pair("FanBeamGeometry", **FAN)
    empty = VoxelPhantom("vac", np.zeros((1, 16, 16), np.uint8),
                         MaterialTable([dataclasses.replace(WATER,
                                                            density=0.0)]),
                         0.5, 0.5, 0.5)
    _, tsp = _spectra("kramers")
    s = ts.single_scatter_sinogram(empty, tct, tsp, coarse=2, n_energy=2,
                                   coherent=False, device="cpu")
    assert s.shape == (4, 32) and not s.any()


# ---------------------------------------------------------------------------
# host Monte Carlo references: the same numbers from the same seed
# ---------------------------------------------------------------------------

def _mc_scene():
    jct, tct = _pair("FanBeamGeometry", **FAN)
    jp, tp = (j_cyl(N=24, dx=0.5, radius_cm=5.0),
              t_cyl(N=24, dx=0.5, radius_cm=5.0))
    jsp, tsp = _spectra("kramers")
    return (jp, jct, jsp), (tp, tct, tsp)


@pytest.mark.parametrize("coherent", [True, False])
def test_mc_single_scatter_reference_equals_jax(coherent):
    jargs, targs = _mc_scene()
    a = ts.mc_single_scatter_reference(*targs, 0.3, 2000, seed=6,
                                       coherent=coherent)
    b = js.mc_single_scatter_reference(*jargs, 0.3, 2000, seed=6,
                                       coherent=coherent)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert a[0].sum() > 0


@pytest.mark.parametrize("n_rows", [None, 4])
def test_mc_second_order_reference_equals_jax(n_rows):
    jargs, targs = _mc_scene()
    a = ts.mc_second_order_reference(*targs, 0.0, 2000, seed=4,
                                     n_rows=n_rows)
    b = js.mc_second_order_reference(*jargs, 0.0, 2000, seed=4,
                                     n_rows=n_rows)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert a[0].sum() > 0


def test_mc_multi_order_reference_equals_jax():
    jargs, targs = _mc_scene()
    kw = dict(orders=3, seed=13, nee_channels=8)
    a = ts.mc_multi_order_reference(*targs, 0.0, 2000, **kw)
    b = js.mc_multi_order_reference(*jargs, 0.0, 2000, **kw)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert (a[0] > 0).all()


@pytest.mark.parametrize("orders", [2, 4])
def test_multiple_to_single_factor_equals_jax(orders):
    """Both closures, at a seed whose last-order ratio lies strictly
    between 0 and 1 (where the tail extrapolation is defined)."""
    jargs, targs = _mc_scene()
    dj, dt = {}, {}
    a = ts.multiple_to_single_factor(*targs, n_samples=2000, seed=5,
                                     orders=orders, tail_bound=dt)
    b = js.multiple_to_single_factor(*jargs, n_samples=2000, seed=5,
                                     orders=orders, tail_bound=dj)
    assert a == b and a > 0
    if orders > 2:
        assert 0.0 < dt["r_last"] < 1.0
        assert dt.keys() == dj.keys()
        for k in dt:
            assert np.array_equal(dt[k], dj[k])


# ---------------------------------------------------------------------------
# The JAX package's reading of chip_smoke.py's SPRs (a script, not a test)
# ---------------------------------------------------------------------------

def _spr_parts(s, p):
    """(mean SPR as scatter_to_primary_ratio takes it, its median over the
    same rays, the share of the mean from rays transmitting < 1 %)."""
    s, p = np.asarray(s, np.float64), np.asarray(p, np.float64)
    m = (p < 0.9 * p.max()) & (p > 1e-6 * p.max())
    r, t = s[m] / p[m], p[m] / p.max()
    return float(r.mean()), float(np.median(r)), \
        float(r[t < 0.01].sum() / r.sum())


def spr_reference():
    """The JAX package's in-object single-scatter SPRs of the scenes of
    ``chip_smoke.py``'s scatter path, at half their in-plane resolution
    (the reading its SPR_FAN and SPR_CONE bands are set around), run as a
    script from the repository's root (~1 min on 2 CPU threads, < 1 GB):

        PYTHONPATH=. python tests/test_torch_scatter_physics.py

    The fan: the reference protocol (input/params.txt, both acquisitions)
    with its 256^2 pelvis at 0.2 cm as every other label (128^2 at 0.4 cm)
    under 400 channels, on 20 views (the path's every 50th of 1000), at the
    path's vertex pitch (coarse 2), 12 energies and evaluated channel pitch
    (channel_sub 4).  The cone config at 80 kV: its pelvis_phantom_3d as 16
    slices of 128^2 at 0.4 cm under 8 rows x 128 channels of twice the
    pitch (the same collimation), on 8 views (every 45th of 360), at
    coarse 4, 8 energies, channel_sub 4 and row_sub 2.  Prints each SPR,
    its median over the same rays, and the share of the mean that rays
    transmitting under 1 % of the air level carry."""
    import json
    import os

    from dexct_tpu.ops.conebeam import cone_sinogram
    from dexct_tpu.pipeline.api import get_sino
    from dexct_tpu.pipeline.runner import (_resolve_spectrum,
                                           default_generators)
    from dexct_tpu.system.config import _build_geometry, read_parameter_file
    from dexct_tpu.system.phantom import pelvis_phantom_3d

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = os.path.join(repo, "input", "params.txt")
    spec_dir = os.path.join(repo, "input", "spectrum")
    base = json.loads(open(params).read())
    base["detector_filename"] = os.path.join(repo, base["detector_filename"])
    gens = default_generators()
    old = os.getcwd()
    os.chdir(repo)
    try:
        ref = read_parameter_file(params)[0].phantom
    finally:
        os.chdir(old)
    ph = JPhantom("pelvis", np.ascontiguousarray(ref.labels[:, ::2, ::2]),
                  ref.materials, 0.4, 0.4, 0.4)
    ct = _build_geometry(dict(base, N_channels=400, N_projections=20))
    for name, dose in (("detunedMV", 9.0), ("80kV", 1.0)):
        spec = _resolve_spectrum(name, dose, ct, spec_dir, gens)
        s = js.single_scatter_sinogram(ph, ct, spec, coarse=2, n_energy=12,
                                       channel_sub=4)
        p = np.asarray(get_sino(ct, ph, spec)[0])
        print("fan %s: SPR %.5g, median %.5g, share of rays under 1 %%: "
              "%.3f" % ((name,) + _spr_parts(s, p)))
    ct3 = _build_geometry(dict(
        base, scanner_geometry="cone_beam", N_rows=8,
        detector_px_height=0.5, N_channels=128, N_projections=8, Nz=16))
    ph3 = pelvis_phantom_3d(N=128, nz=16, dx=0.4, dz=0.4)
    spec = _resolve_spectrum("80kV", 1.0, ct3, spec_dir, gens)
    s = js.single_scatter_conebeam(ph3, ct3, spec, coarse=4, n_energy=8,
                                   channel_sub=4, row_sub=2)
    p = np.asarray(cone_sinogram(ph3, ct3, spec)[0])
    print("cone 80kV: SPR %.5g, median %.5g, share of rays under 1 %%: "
          "%.3f" % _spr_parts(s, p))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    spr_reference()
