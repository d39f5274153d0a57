"""Public names and keywords of the JAX package that the port offers too:
``pipeline.fused.make_jitted_step``, ``ops.siddon.mono_sinogram`` and
``learn.denoiser_io.save_params``, each against the JAX call
(``pipeline.cone.make_jitted_cone_step`` is held against the JAX one in
tests/test_torch_cone.py, on its fused cone runs); and the TPU-layout keywords (``view_block``, the
trace plans' ``trace_group``/``trace_bundle``/``group``, ``par_sym``,
``_ray_plan``, ``_n_zslab``), which the port accepts and ignores: each call
with them equals the call without, bit for bit, and the JAX function takes
the same keyword.

The ``compat`` module (the reference's import names): the same names and
constants, its ``get_*`` entry points and ``do_matdecomp_gn`` against the
JAX module's (each stage on the JAX stage's own inputs), and the float64
``optimize_sino_cpu`` to rtol 1e-12.

Tolerances: the steps as in tests/test_pipeline.py (sino_raw rtol 1e-4,
sino_log atol 1e-4, mat_sinos and mat_recons atol 1e-3, recon_raw atol
1e-4, recon_HU atol 1 HU); ``mono_sinogram`` rtol 1e-6; the checkpoint
byte for byte.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu import compat as j_compat
from dexct_tpu.learn import denoiser_io as j_io
from dexct_tpu.ops import siddon as j_siddon
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline import cone as j_cone
from dexct_tpu.pipeline import fused as j_fused
from dexct_tpu.system import (ConeBeamGeometry, FanBeamGeometry,
                              water_cylinder_phantom)
from dexct_tpu_torch import compat as t_compat
from dexct_tpu_torch.learn import denoiser_io as t_io
from dexct_tpu_torch.ops import siddon as t_siddon
from dexct_tpu_torch.pipeline import cone as t_cone
from dexct_tpu_torch.pipeline import fused as t_fused

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


def _spectra(ct):
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return s1, s2


def _fan():
    ct = FanBeamGeometry(N_channels=64, N_proj=48, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    return ct, water_cylinder_phantom(N=48, dx=0.5), *_spectra(ct)


def _cone():
    ct = ConeBeamGeometry(N_channels=32, N_proj=24, N_rows=4, h_iso=0.5,
                          eid=True)
    ph2 = water_cylinder_phantom(N=32, dx=0.6)
    ph3 = dataclasses.replace(
        ph2, labels=np.broadcast_to(ph2.labels[0], (8, 32, 32)).copy(),
        dz=0.5)
    return ct, ph3, *_spectra(ct)


def _close(got, want, tols):
    for key, tol in tols.items():
        for i in range(2):
            np.testing.assert_allclose(np.asarray(got[key][i]),
                                       np.asarray(want[key][i]),
                                       err_msg=f"{key}[{i}]", **tol)


def _np_outputs(out):
    return {k: tuple(x.numpy() for x in v) for k, v in out.items()}


def test_make_jitted_step_matches_jax():
    """The JAX step closed over its meta, on identical packed inputs; the
    port's is ``dect_step`` closed over the meta."""
    arrays, meta = j_fused.pack_dect(*_fan(), 48, 24.0, 0.8, n_iters=20)
    want = j_fused.make_jitted_step(meta)(arrays)
    a = t_fused.arrays_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, "cpu")
    m = t_fused.DectMeta(**{f: getattr(meta, f) for f in
                            t_fused.DectMeta._fields if hasattr(meta, f)})
    got = t_fused.make_jitted_step(m)(a)
    _close(_np_outputs(got), want, TOL)
    again = t_fused.dect_step(a, m)
    assert all(torch.equal(x, y) for k in got for x, y in
               zip(got[k], again[k]))


@pytest.mark.parametrize("shape", [(48, 64), (6, 4, 32)])
def test_mono_sinogram_matches_jax(shape):
    rng = np.random.default_rng(7)
    paths = rng.uniform(0.0, 8.0, (*shape, 3)).astype(np.float32)
    mu = np.array([0.0, 0.2, 0.45])
    want = np.asarray(j_siddon.mono_sinogram(jnp.asarray(paths), mu))
    got = t_siddon.mono_sinogram(torch.as_tensor(paths), mu).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_save_params_round_trip(tmp_path):
    """The port writes the vendored checkpoint back byte for byte on every
    key; its loader and the JAX loader read the file, and the JAX writer
    writes what the port writes."""
    model = t_io.load_default_denoiser()
    path = tmp_path / "port.npz"
    t_io.save_params(str(path), model, features=48, depth=8)
    with np.load(t_io.default_weights_path()) as ref, np.load(path) as got:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype
            assert got[k].tobytes() == ref[k].tobytes(), k
    again = t_io.load_params(str(path))
    assert all(torch.equal(x, y) for x, y in
               zip(again.state_dict().values(), model.state_dict().values()))
    _, j_params = j_io.load_params(str(path))
    j_path = tmp_path / "jax.npz"
    j_io.save_params(str(j_path), j_params, features=48, depth=8)
    with np.load(j_path) as ref, np.load(path) as got:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].tobytes() == ref[k].tobytes(), k
    with pytest.raises(ValueError, match="depth"):
        t_io.save_params(str(path), model, depth=6)


def _port(ct):
    from dexct_tpu_torch.system import geometry as t_geo

    return getattr(t_geo, type(ct).__name__)(
        **{f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)
           if f.name != "detector"})


def _keyword_case(name):
    """(JAX function, port call taking the keywords) of one case."""
    from dexct_tpu import ops as j_ops
    from dexct_tpu_torch import ops as t_ops
    from dexct_tpu_torch.system import (FlatPanelConeBeamGeometry,
                                        HelicalConeBeamGeometry,
                                        ParallelBeamGeometry,
                                        TiltedConeBeamGeometry)

    rng = np.random.default_rng(8)
    fan, ph, s1, s2 = _fan()
    cone, ph3, c1, c2 = _cone()
    q = torch.as_tensor(rng.normal(size=(48, 64)), dtype=torch.float32)
    betas = torch.as_tensor(fan.betas, dtype=torch.float32)
    sino3 = torch.as_tensor(rng.uniform(0, 2, (24, 4, 32)),
                            dtype=torch.float32)
    helix = HelicalConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4,
                                    h_iso=0.5, rotation_total=4 * np.pi,
                                    pitch=1.0)
    sino_h = torch.as_tensor(rng.uniform(0, 2, (48, 4, 32)),
                             dtype=torch.float32)
    packed = t_ops.fbp_fast.pack_filtered(q[None])
    paths = t_ops.siddon.material_path_sinogram(ph, _port(fan), device="cpu")
    counts = 1e6 * torch.exp(-q.abs()[None] * torch.tensor([[[1.0]], [[1.3]]]))
    src3, dirs3 = (torch.as_tensor(x[:2], dtype=torch.float32)
                   for x in _port(cone).ray_geometry_3d())
    fan_args = (fan.SID, fan.dgamma, 32, 24.0)
    cases = {
        "fbp.fan_backproject": lambda **kw: t_ops.fbp.fan_backproject(
            q, betas, *fan_args, **kw),
        "fbp_fast.fan_backproject_multi":
            lambda **kw: t_ops.fbp_fast.fan_backproject_multi(
                packed, 1, betas, fan.SID, fan.dgamma, 64, 32, 24.0,
                2 * np.pi / 48, **kw),
        "fbp_fast.parallel_backproject_multi":
            lambda **kw: t_ops.fbp_fast.parallel_backproject_multi(
                packed, 1, betas[:48] / 2, -16.0, 0.5, 64, 32, 24.0,
                np.pi / 48, **kw),
        "conebeam.fdk_reconstruct":
            lambda **kw: t_ops.conebeam.fdk_reconstruct(
                sino3, _port(cone), 16, 18.0, 0.8, **kw),
        "conebeam.fdk_tilted_reconstruct":
            lambda **kw: t_ops.conebeam.fdk_tilted_reconstruct(
                sino3, TiltedConeBeamGeometry(N_channels=32, N_proj=24,
                                              N_rows=4, h_iso=0.5,
                                              tilt=0.2),
                16, 18.0, 0.8, **kw),
        "conebeam.helical_fdk_reconstruct":
            lambda **kw: t_ops.conebeam.helical_fdk_reconstruct(
                sino_h, helix, 16, 18.0, 0.8, **kw),
        "conebeam.cone_material_paths":
            lambda **kw: t_ops.conebeam.cone_material_paths(
                ph3, _port(cone), device="cpu", **kw),
        "conebeam.cone_sinogram":
            lambda **kw: t_ops.conebeam.cone_sinogram(
                ph3, _port(cone), c1, device="cpu", **kw)[1],
        "flatpanel.fdk_flat_reconstruct":
            lambda **kw: t_ops.flatpanel.fdk_flat_reconstruct(
                sino3, FlatPanelConeBeamGeometry(N_channels=32, N_proj=24,
                                                 N_rows=4), 16, 18.0, 0.8,
                **kw),
        "katsevich.katsevich_reconstruct":
            lambda **kw: t_ops.katsevich.katsevich_reconstruct(
                sino_h, helix, 16, 18.0, **kw),
        "helical_pi.helical_pi_reconstruct":
            lambda **kw: t_ops.helical_pi.helical_pi_reconstruct(
                sino_h, helix, 16, 18.0, 0.8, **kw),
        "fbp.fbp_recon": lambda **kw: t_ops.fbp.fbp_recon(
            q, _port(fan), 32, 24.0, 0.8, **kw)[0],
        "fbp.filter_sinogram": lambda **kw: t_ops.fbp.filter_sinogram(
            q, _port(fan), 0.8, **kw),
        "fbp.parallel_fbp": lambda **kw: t_ops.fbp.parallel_fbp(
            q, ParallelBeamGeometry(N_channels=64, N_proj=48,
                                    detector_width=24.0), 32, 24.0, 0.8,
            **kw),
        "ffs.ffs_fbp_recon": lambda **kw: t_ops.ffs.ffs_fbp_recon(
            q, dataclasses.replace(_port(fan), ffs="inplane"), 32, 24.0,
            0.8, **kw),
        "matdecomp.decompose_sinograms":
            lambda **kw: t_ops.matdecomp.decompose_sinograms(
                _port(fan), counts[0], counts[1], s1, s2, n_iters=5,
                **kw)[0],
        "spectral.forward_counts":
            lambda **kw: t_ops.spectral.forward_counts(
                paths, ph, s1, _port(fan), **kw)[1],
        "siddon.material_path_sinogram":
            lambda **kw: t_ops.siddon.material_path_sinogram(
                ph, _port(fan), device="cpu", **kw),
        "conebeam.trace_paths_3d": lambda **kw: t_ops.conebeam.trace_paths_3d(
            torch.as_tensor(np.asarray(ph3.labels)), src3, dirs3, ph3.dx,
            ph3.dy, ph3.dz, n_materials=ph3.n_materials, **kw),
    }
    mod, fn = name.split(".")
    return getattr(getattr(j_ops, mod), fn), cases[name]


VIEW_BLOCK = ["fbp.fan_backproject", "fbp_fast.fan_backproject_multi",
              "fbp_fast.parallel_backproject_multi",
              "conebeam.fdk_reconstruct", "conebeam.fdk_tilted_reconstruct",
              "conebeam.helical_fdk_reconstruct",
              "conebeam.cone_material_paths", "conebeam.cone_sinogram",
              "flatpanel.fdk_flat_reconstruct",
              "katsevich.katsevich_reconstruct",
              "helical_pi.helical_pi_reconstruct"]


@pytest.mark.parametrize("name", VIEW_BLOCK)
def test_view_block_is_accepted_and_ignored(name):
    j_fn, call = _keyword_case(name)
    assert "view_block" in inspect.signature(j_fn).parameters
    want = call()
    got = call(view_block=3)
    assert torch.equal(got, want)


# the JAX functions' dtype= keyword, which the port takes for float32
DTYPE_KEYWORD = ["fbp.fbp_recon", "fbp.filter_sinogram", "fbp.parallel_fbp",
                 "ffs.ffs_fbp_recon", "matdecomp.decompose_sinograms",
                 "conebeam.cone_material_paths", "conebeam.cone_sinogram",
                 "spectral.forward_counts"]


@pytest.mark.parametrize("name", DTYPE_KEYWORD)
def test_dtype_keyword_takes_float32(name):
    """``dtype`` as torch's or NumPy's float32 gives the call without it,
    bit for bit; another type raises ``ValueError`` (the port computes in
    float32)."""
    j_fn, call = _keyword_case(name)
    assert "dtype" in inspect.signature(j_fn).parameters
    want = call()
    for dt in (torch.float32, np.float32, None):
        assert torch.equal(call(dtype=dt), want)
    with pytest.raises(ValueError, match="float32"):
        call(dtype=torch.float64)


@pytest.mark.parametrize("name,kw", [
    ("siddon.material_path_sinogram", dict(method="dominant")),
    ("conebeam.cone_material_paths", dict(method="dda")),
    ("conebeam.trace_paths_3d", dict(n_steps=64))],
    ids=lambda x: x if isinstance(x, str) else next(iter(x)))
def test_tracer_choice_keywords_are_accepted_and_ignored(name, kw):
    """The JAX package's tracer choices (``method``, the DDA's fixed trip
    count ``n_steps``) name TPU programs of the same exact paths; the
    port's one exact trace takes them and returns the same bits."""
    j_fn, call = _keyword_case(name)
    assert set(kw) <= set(inspect.signature(j_fn).parameters)
    assert torch.equal(call(**kw), call())


def _same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kw", [dict(trace_bundle=4), dict(trace_group=8),
                                dict(par_sym=False),
                                dict(dtype=torch.float32)],
                         ids=lambda kw: next(iter(kw)))
def test_pack_dect_layout_keywords(kw):
    assert set(kw) <= set(inspect.signature(j_fused.pack_dect).parameters)
    args = (*_fan(), 48, 24.0, 0.8)
    a, m = t_fused.pack_dect(*args, device="cpu", recon="parallel",
                             recon_n_theta=64, recon_nt=128)
    b, n = t_fused.pack_dect(*args, device="cpu", recon="parallel",
                             recon_n_theta=64, recon_nt=128, **kw)
    _same_arrays(a, b)
    assert m == n


@pytest.mark.parametrize("kw", [dict(trace_bundle=4), dict(trace_group=8)],
                         ids=lambda kw: next(iter(kw)))
def test_material_path_sinogram_layout_keywords(kw):
    assert set(kw) <= set(inspect.signature(
        j_siddon.material_path_sinogram).parameters)
    ct, ph, _, _ = _fan()
    want = t_siddon.material_path_sinogram(ph, ct, device="cpu")
    got = t_siddon.material_path_sinogram(ph, ct, device="cpu", **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(group=8), dict(trace_bundle=4),
                                dict(_ray_plan=False), dict(_n_zslab=2)],
                         ids=lambda kw: next(iter(kw)))
def test_pack_cone_dect_layout_keywords(kw):
    assert set(kw) <= set(inspect.signature(
        j_cone.pack_cone_dect).parameters)
    args = (*_cone(), 32, 18.0, 0.8)
    a, m = t_cone.pack_cone_dect(*args, device="cpu")
    b, n = t_cone.pack_cone_dect(*args, device="cpu", **kw)
    _same_arrays(a, b)
    assert m == n


def test_compat_names_match_jax():
    assert t_compat.__all__ == j_compat.__all__
    for name in ("mat1", "matcomp1", "density1", "mat2", "matcomp2",
                 "density2"):
        assert getattr(t_compat, name) == getattr(j_compat, name)


@pytest.fixture(scope="module")
def compat_scan():
    """The JAX compat entry points on the small fan: (inputs, outputs)."""
    ct, ph, s1, s2 = _fan()
    raw1, log1 = j_compat.get_sino(ct, ph, s1)
    raw2, _ = j_compat.get_sino(ct, ph, s2)
    return (ct, ph, s1, s2), {
        "raw": (np.asarray(raw1), np.asarray(raw2)),
        "log": np.asarray(log1),
        "recon": tuple(np.asarray(x) for x in j_compat.get_recon(
            log1, ct, s1, 48, 24.0, 0.8)),
        "mats": tuple(np.asarray(x) for x in j_compat.get_basismat_sinos(
            ct, raw1, raw2, s1, s2, n_iters=20)),
        "gn": j_compat.do_matdecomp_gn(ct, raw1, raw2, s1, s2, 20)}


@pytest.mark.parametrize("stage", ["get_sino", "get_recon",
                                   "get_basismat_sinos", "do_matdecomp_gn"])
def test_compat_entry_points_match_jax(compat_scan, stage):
    (ct, ph, s1, s2), want = compat_scan
    raw = [torch.as_tensor(np.array(x)) for x in want["raw"]]
    if stage == "get_sino":
        got_raw, got_log = t_compat.get_sino(ct, ph, s1, device="cpu")
        np.testing.assert_allclose(got_raw.numpy(), want["raw"][0],
                                   **TOL["sino_raw"])
        np.testing.assert_allclose(got_log.numpy(), want["log"],
                                   **TOL["sino_log"])
    elif stage == "get_recon":
        rec, hu = t_compat.get_recon(torch.as_tensor(want["log"]), ct, s1,
                                     48, 24.0, 0.8)
        np.testing.assert_allclose(rec.numpy(), want["recon"][0],
                                   **TOL["recon_raw"])
        np.testing.assert_allclose(hu.numpy(), want["recon"][1],
                                   **TOL["recon_HU"])
    elif stage == "get_basismat_sinos":
        for g, w in zip(t_compat.get_basismat_sinos(ct, *raw, s1, s2,
                                                    n_iters=20),
                        want["mats"]):
            np.testing.assert_allclose(g.numpy(), w, **TOL["mat_sinos"])
    else:
        got = t_compat.do_matdecomp_gn(ct, *raw, s1, s2, 20)
        assert isinstance(got, np.ndarray) and got.shape == (48, 64, 2)
        np.testing.assert_allclose(got, want["gn"], **TOL["mat_sinos"])


def test_optimize_sino_cpu_matches_jax(compat_scan):
    """The port's own copy of the float64 NumPy solve, to rtol 1e-12, on
    the reference's channel-tiled fluence layout [nMeas, nBins, nE]."""
    from dexct_tpu.ops.matdecomp import prepare_decomposition

    (ct, _, s1, s2), want = compat_scan
    ee, i0, mus = prepare_decomposition(ct, s1, s2)
    g = np.stack(want["raw"])[:, ::4]  # every 4th view: 12 x 64 rays
    i0_tiled = np.repeat(np.asarray(i0)[:, None, :], g.shape[2], 1)
    for fluence in (i0, i0_tiled):
        out = t_compat.optimize_sino_cpu(g, ee, fluence, mus, 10)
        ref = j_compat.optimize_sino_cpu(g, ee, fluence, mus, 10)
        assert out.shape == (12, 64, 2)
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)
