"""The port's host layer against the JAX package's: rays, labels,
attenuation tables, spectra, fluences, decomposition tables, filter
response and the config reader.  All of it is float64 NumPy on both sides,
so the comparison is exact."""

import numpy as np
import pytest
import torch

import dexct_tpu_torch as tx
from dexct_tpu.ops import filters as j_filters
from dexct_tpu.ops import matdecomp as j_md
from dexct_tpu.ops import spectral as j_sp
from dexct_tpu.physics import kramers_spectrum as j_kramers
from dexct_tpu.physics import linac_spectrum as j_linac
from dexct_tpu.physics import xcom as j_xcom
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import pelvis_phantom as j_pelvis
from dexct_tpu.system import read_parameter_file as j_read
from dexct_tpu.system import water_cylinder_phantom as j_water
from dexct_tpu_torch.ops import filters as t_filters
from dexct_tpu_torch.ops import matdecomp as t_md
from dexct_tpu_torch.ops import spectral as t_sp
from dexct_tpu_torch.physics import kramers_spectrum as t_kramers
from dexct_tpu_torch.physics import linac_spectrum as t_linac
from dexct_tpu_torch.system import pelvis_phantom as t_pelvis


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


GEOM = dict(N_channels=96, N_proj=90, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0, eid=True,
            detector_file="input/detector/eta_eid_mv.bin")


def _pair(kramers, linac, geom):
    s1, s2 = linac(), kramers(80.0)
    s1.rescale_counts(geom.A_iso * 9.0 / geom.N_proj)
    s2.rescale_counts(geom.A_iso * 1.0 / geom.N_proj)
    return s1, s2


def test_rays_identical():
    for ffs in ("none", "inplane"):
        j = JFan(**GEOM, ffs=ffs).ray_geometry()
        t = tx.FanBeamGeometry(**GEOM, ffs=ffs).ray_geometry()
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)


def test_labels_and_mu_tables_identical():
    jp, tp = j_pelvis(N=128, dx=0.4), t_pelvis(N=128, dx=0.4)
    np.testing.assert_array_equal(jp.slice_labels(), tp.slice_labels())
    e = np.linspace(10.0, 6000.0, 97)
    np.testing.assert_array_equal(jp.materials.mu_table(e),
                                  tp.materials.mu_table(e))
    np.testing.assert_array_equal(j_xcom.mixatten("Ca(40)P(20)O(40)", e),
                                  tx.mixatten("Ca(40)P(20)O(40)", e))


def test_spectra_fluences_and_decomposition_tables_identical():
    jg, tg = JFan(**GEOM), tx.FanBeamGeometry(**GEOM)
    js, ts = _pair(j_kramers, j_linac, jg), _pair(t_kramers, t_linac, tg)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a.E, b.E)
        np.testing.assert_array_equal(a.I0, b.I0)
        np.testing.assert_array_equal(j_sp.effective_fluence(a, jg),
                                      t_sp.effective_fluence(b, tg))
        np.testing.assert_array_equal(j_sp.second_moment_fluence(a, jg),
                                      t_sp.second_moment_fluence(b, tg))
    for a, b in zip(j_md.prepare_decomposition(jg, *js),
                    t_md.prepare_decomposition(tg, *ts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["fan", "parallel"])
def test_filter_response_identical(kind):
    for a, b in zip(j_filters.filter_frequency_response(800, 1e-3, 0.8,
                                                        "sinc", kind),
                    t_filters.filter_frequency_response(800, 1e-3, 0.8,
                                                        "sinc", kind)):
        np.testing.assert_array_equal(a, b)


def test_reference_params_file_identical():
    (jc,), (tc,) = j_read("input/params.txt"), tx.read_parameter_file(
        "input/params.txt")
    assert (jc.run_id, jc.N_matrix, jc.FOV, jc.ramp) == (
        tc.run_id, tc.N_matrix, tc.FOV, tc.ramp)
    assert (jc.ct.N_proj, jc.ct.N_channels, jc.ct.SID, jc.ct.gamma_fan) == (
        tc.ct.N_proj, tc.ct.N_channels, tc.ct.SID, tc.ct.gamma_fan)
    np.testing.assert_array_equal(jc.phantom.slice_labels(),
                                  tc.phantom.slice_labels())
    np.testing.assert_array_equal(jc.ct.detector.eta, tc.ct.detector.eta)


def test_phantom_file_round_trip(tmp_path):
    ph = j_water(N=32, dx=0.5)
    ph.to_file(str(tmp_path / "p.bin"), str(tmp_path / "p.csv"))
    back = tx.VoxelPhantom.from_file(
        name="w", filename=str(tmp_path / "p.bin"),
        matcomp_csv=str(tmp_path / "p.csv"), Nx=32, Ny=32, Nz=1, dx=0.5,
        dy=0.5, dz=0.5)
    np.testing.assert_array_equal(back.slice_labels(), ph.slice_labels())
    e = np.array([30.0, 60.0, 100.0])
    np.testing.assert_array_equal(back.materials.mu_table(e),
                                  ph.materials.mu_table(e))
