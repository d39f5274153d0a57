"""The port's analytic phantoms and closed-form projector (K9's plain
version on the CPU) against the JAX package's.

Tolerances:

- ``shape_arrays`` and ``rasterize``: equal (host float64 / uint8 code);
- ``analytic_paths``: each ray's total path to 3e-5 x the largest path,
  each material's to 3e-4 x the largest path.  The port rounds every float32
  operation of the JAX function; XLA:CPU contracts each ``x * y + z`` into
  a fused multiply-add (measured: 100 % of 1e5 random cases), and the
  chord quadratic b^2 - a c cancels to ~|o|^2 ulps for rays that pass far
  from a shape's centre or graze it, so one rounding moves a material
  boundary along the ray by up to 9e-3 cm on these rays (either side is
  that far from a float64 evaluation).  A moved boundary shifts length
  between two materials and leaves the ray's total nearly unchanged;
- the fused step with ``projector='analytic'``: the tolerances of
  tests/test_pipeline.py (as tests/test_torch_pipeline.py), sino_raw and
  sino_log from the whole step, every later stage fed the JAX step's own
  inputs;
- the port's ``pack_dect``: equal to ``arrays_from_numpy`` of the JAX pack.
"""

import numpy as np
import pytest
import torch

from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.physics import materials as j_mat
from dexct_tpu.pipeline.fused import make_jitted_step
from dexct_tpu.pipeline.fused import pack_dect as j_pack
from dexct_tpu.system import FanBeamGeometry
from dexct_tpu.system import analytic as j_an
from dexct_tpu_torch.ops.fbp import hu_image
from dexct_tpu_torch.physics import materials as t_mat
from dexct_tpu_torch.pipeline import fused as t_fused
from dexct_tpu_torch.system import analytic as t_an

TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
       "sino_log": dict(rtol=0.0, atol=1e-4),
       "mat_sinos": dict(rtol=0.0, atol=1e-3),
       "recon_raw": dict(rtol=0.0, atol=1e-4),
       "recon_HU": dict(rtol=0.0, atol=1.0),
       "mat_recons": dict(rtol=0.0, atol=1e-3)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_ellipses(module, materials):
    """A random composition over an air disk (materials 0..3)."""
    rng = np.random.default_rng(7)
    shapes = [module.Ellipse(0, 0.0, 0.0, 20.0, 20.0)]
    for _ in range(9):
        shapes.append(module.Ellipse(
            int(rng.integers(1, 4)), *rng.uniform(-8, 8, 2),
            *rng.uniform(0.5, 9.0, 2), float(rng.uniform(-np.pi, np.pi))))
    mats = materials.MaterialTable([materials.AIR, materials.WATER,
                                    materials.TISSUE, materials.BONE])
    return module.AnalyticPhantom("random", shapes, mats)


PHANTOMS = {
    "pelvis": lambda m: m.pelvis_analytic(),
    "pelvis_titanium": lambda m: m.pelvis_analytic(implant="titanium"),
    "pelvis_steel": lambda m: m.pelvis_analytic(implant="steel"),
    "water": lambda m: m.water_cylinder_analytic(),
    "random": lambda m: _random_ellipses(
        m, j_mat if m is j_an else t_mat),
}


@pytest.mark.parametrize("name", sorted(PHANTOMS))
def test_host_copies_match_jax(name):
    jph, tph = PHANTOMS[name](j_an), PHANTOMS[name](t_an)
    (jp, jl), (tp, tl) = jph.shape_arrays(), tph.shape_arrays()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    assert tph.n_materials == jph.n_materials
    jr, tr = jph.rasterize(96, 0.55), tph.rasterize(96, 0.55)
    np.testing.assert_array_equal(tr.labels, jr.labels)
    assert tr.labels.dtype == jr.labels.dtype
    np.testing.assert_array_equal(tph.mu_image(70.0, 32, 1.5),
                                  jph.mu_image(70.0, 32, 1.5))


def _rays(rng):
    """Fan rays of a small scan, plus rays that miss everything, start
    inside shapes (the t >= 0 clip) or run tangent to the default water
    cylinder's circles (radii 5.12 and 6.4 cm)."""
    ct = FanBeamGeometry(N_channels=64, N_proj=48, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0)
    src, dirs = (x.reshape(-1, 2) for x in ct.ray_geometry())
    ang = rng.uniform(0, 2 * np.pi, 64)
    miss_src = 80.0 * np.stack([np.cos(ang), np.sin(ang)], -1)
    inside = rng.uniform(-3, 3, (64, 2))
    tang = np.stack([np.full(32, -50.0), np.full(32, 5.12)], -1)
    tang[8:16, 1] = -5.12
    tang[16:24, 1] = 6.4
    tang[24:, 1] = -6.4
    a2 = rng.uniform(0, 2 * np.pi, 128)
    more = np.stack([np.cos(a2), np.sin(a2)], -1)
    src = np.concatenate([src, miss_src, inside, tang])
    dirs = np.concatenate([dirs, miss_src / 80.0, more[:64],
                           np.tile([1.0, 0.0], (32, 1))])
    return src, dirs


@pytest.mark.parametrize("name", sorted(PHANTOMS))
def test_analytic_paths_match_jax(name):
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    src, dirs = _rays(rng)
    jph, tph = PHANTOMS[name](j_an), PHANTOMS[name](t_an)
    params, labels = jph.shape_arrays()
    M = jph.n_materials
    want = np.asarray(j_an.analytic_paths(
        jnp.asarray(params), jnp.asarray(labels),
        jnp.asarray(src, jnp.float32), jnp.asarray(dirs, jnp.float32),
        n_materials=M))
    got = t_an.analytic_paths(
        torch.as_tensor(params), torch.as_tensor(labels),
        torch.as_tensor(src, dtype=torch.float32),
        torch.as_tensor(dirs, dtype=torch.float32), n_materials=M).numpy()
    assert got.shape == want.shape == (src.shape[0], M)
    big = np.abs(want).max()
    np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=0,
                               atol=3e-5 * big)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4 * big)
    # the edge rays do what they are for
    n_fan = 48 * 64
    assert np.abs(got[n_fan:n_fan + 64]).max() == 0.0  # misses
    if name in ("pelvis", "water"):
        assert got[n_fan + 64:n_fan + 128].sum(-1).min() > 0.0  # inside


def test_material_path_sinogram_dispatches():
    from dexct_tpu.ops.siddon import material_path_sinogram as j_mps
    from dexct_tpu_torch.ops.siddon import material_path_sinogram as t_mps
    from dexct_tpu_torch.system import FanBeamGeometry as TFan

    kw = dict(N_channels=48, N_proj=32, gamma_fan=0.8230337, SID=60.0,
              SDD=100.0)
    want = np.asarray(j_mps(j_an.pelvis_analytic(), FanBeamGeometry(**kw)))
    got = t_mps(t_an.pelvis_analytic(), TFan(**kw), device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def analytic_de():
    """The sizes of tests/test_torch_pipeline.py's ``small_de`` with the
    analytic water cylinder of the same radius (9.6 cm)."""
    ct = FanBeamGeometry(N_channels=128, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return ct, j_an.water_cylinder_analytic(extent_cm=24.0), s1, s2


PLAN_KW = dict(recon_n_theta=64, recon_nt=256)


def _port_inputs(arrays, meta):
    a = t_fused.arrays_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, "cpu")
    m = t_fused.DectMeta(**{f: getattr(meta, f) for f in
                            t_fused.DectMeta._fields if hasattr(meta, f)})
    return a, m


@pytest.mark.parametrize("recon", ["parallel", "fan"])
def test_dect_step_analytic_matches_jax(analytic_de, recon):
    arrays, meta = j_pack(*analytic_de, 64, 24.0, 0.8, n_iters=20,
                          projector="analytic", recon=recon, **PLAN_KW)
    want = make_jitted_step(meta)(arrays)
    a, m = _port_inputs(arrays, meta)
    got = t_fused.dect_step(a, m)
    for key in ("sino_raw", "sino_log"):
        for i in range(2):
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **TOL[key])
    # the later stages on the JAX step's own inputs
    counts = [torch.as_tensor(np.array(x)) for x in want["sino_raw"]]
    mats = t_fused.decompose_counts(*counts, a, m, m.pixel_block)
    stack = torch.stack([torch.as_tensor(np.array(x)) for x in
                         (*want["sino_log"], *want["mat_sinos"])])
    imgs = t_fused.reconstruct_stack(stack, a, m)
    staged = {"mat_sinos": mats, "recon_raw": (imgs[0], imgs[1]),
              "recon_HU": (hu_image(imgs[0], m.mu_w1),
                           hu_image(imgs[1], m.mu_w2)),
              "mat_recons": (imgs[2], imgs[3])}
    for key, pair in staged.items():
        for i in range(2):
            np.testing.assert_allclose(pair[i].numpy(),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **TOL[key])


@pytest.mark.parametrize("recon", ["parallel", "fan"])
def test_port_pack_matches_jax_pack(analytic_de, recon):
    ct, _, s1, s2 = analytic_de
    arrays, meta = j_pack(*analytic_de, 64, 24.0, 0.8, n_iters=20,
                          projector="analytic", recon=recon, **PLAN_KW)
    a, m = t_fused.pack_dect(ct, t_an.water_cylinder_analytic(extent_cm=24.0),
                             s1, s2, 64, 24.0, 0.8, n_iters=20, device="cpu",
                             projector="analytic", recon=recon, **PLAN_KW)
    ref, ref_m = _port_inputs(arrays, meta)
    assert set(a) == set(ref)
    for k in a:
        assert a[k].dtype == ref[k].dtype, k
        torch.testing.assert_close(a[k], ref[k], rtol=0, atol=0)
    assert m == ref_m


def test_analytic_needs_an_analytic_phantom(analytic_de):
    from dexct_tpu_torch.system import water_cylinder_phantom

    ct, _, s1, s2 = analytic_de
    with pytest.raises(ValueError, match="AnalyticPhantom"):
        t_fused.pack_dect(ct, water_cylinder_phantom(N=32, dx=0.5), s1, s2,
                          32, 24.0, 0.8, device="cpu", projector="analytic")
    with pytest.raises(ValueError, match="AnalyticPhantom"):
        t_fused.pack_dect(ct, t_an.pelvis_analytic(), s1, s2, 32, 24.0, 0.8,
                          device="cpu", projector="siddon")
