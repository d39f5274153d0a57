"""Hand-written kernels K1-K39 against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each test launches one kernel through its public wrapper on CUDA tensors,
runs the plain version on the same tensors, and compares at small shapes.
"""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops.fbp_fast import (
    fan_backproject_multi, fan_backproject_multi_plain,
    parallel_backproject_multi, parallel_backproject_multi_plain,
    rebin_to_parallel, rebin_to_parallel_plain)
from dexct_tpu_torch.ops.fourier import (kb_sample, kb_sample_plain,
                                         resample_to_fan,
                                         resample_to_fan_plain)
from dexct_tpu_torch.ops.matdecomp import (gauss_newton_solve,
                                            prepare_decomposition)
from dexct_tpu_torch.ops.siddon import trace_paths, trace_paths_plain
from dexct_tpu_torch.ops.spectral import (counts_from_paths,
                                          counts_from_paths_plain)
from dexct_tpu_torch.utils import tiny_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rays(rng, n, radius):
    ang = rng.uniform(0, 2 * np.pi, n)
    src = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    th = ang + np.pi + rng.uniform(-0.6, 0.6, n)
    dirs = np.stack([np.cos(th), np.sin(th)], -1)
    # axis-parallel rays, through cell corners and along grid lines
    src[:4] = [[-40.0, 0.0], [0.0, -40.0], [-40.0, 4.0], [2.0, 40.0]]
    dirs[:4] = [[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, -1.0]]
    return src.astype(np.float32), dirs.astype(np.float32)


@pytest.mark.parametrize("n_materials", [6, 12])
def test_siddon_trace_matches_plain(dev, n_materials):
    rng = np.random.default_rng(1)
    lab = torch.as_tensor(rng.integers(0, n_materials, (64, 64)),
                          dtype=torch.uint8, device=dev)
    src, dirs = (torch.as_tensor(x, device=dev)
                 for x in _rays(rng, 3000, 30.0))
    before = trace_paths.launches
    got = trace_paths(lab, src, dirs, 0.5, 0.5, n_materials=n_materials)
    torch.cuda.synchronize()
    assert trace_paths.launches == before + 1
    want = trace_paths_plain(lab, src, dirs, 0.5, 0.5,
                             n_materials=n_materials)
    assert got.shape == (3000, n_materials)
    # same float32 operations in the same order
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_spectral_counts_matches_plain(dev):
    rng = np.random.default_rng(2)
    paths = torch.as_tensor(rng.uniform(0, 5, (5000, 6)), dtype=torch.float32,
                            device=dev)
    mu = torch.as_tensor(rng.uniform(0.01, 2.0, (6, 141)),
                         dtype=torch.float32, device=dev)
    i0 = torch.as_tensor(rng.uniform(0, 1e6, 141), dtype=torch.float32,
                         device=dev)
    i2 = i0 * 60.0
    before = counts_from_paths.launches
    c, v = counts_from_paths(paths, mu, i0, i2)
    torch.cuda.synchronize()
    assert counts_from_paths.launches == before + 1
    torch.testing.assert_close(c, counts_from_paths_plain(paths, mu, i0),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(v, counts_from_paths_plain(paths, mu, i2),
                               rtol=1e-5, atol=0)


def test_gauss_newton_matches_plain(dev):
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.system import FanBeamGeometry

    ct = FanBeamGeometry(N_channels=64, N_proj=64, eid=True)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    _, i0, mus = prepare_decomposition(ct, s1, s2)
    rng = np.random.default_rng(3)
    a_true = np.stack([rng.uniform(0, 30, 2000), rng.uniform(0, 4, 2000)], -1)
    counts = np.exp(-a_true @ mus) @ i0.T  # float64 forward model [P, 2]
    args = [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (counts.T, i0, mus)]
    before = gauss_newton_solve.launches
    got = gauss_newton_solve(*args, n_iters=50)
    torch.cuda.synchronize()
    assert gauss_newton_solve.launches == before + 1
    want = gauss_newton_solve(*(x.cpu() for x in args), n_iters=50)
    err = (got.cpu() - want).abs() / torch.clamp_min(want.abs(), 1.0)
    assert float(err.max()) < 1e-4


def test_fan_backproject_matches_plain(dev):
    from dexct_tpu_torch.ops.fbp_fast import pack_filtered

    rng = np.random.default_rng(4)
    V, C, N = 90, 96, 64
    qs = torch.as_tensor(rng.normal(size=(4, V, C)), dtype=torch.float32,
                         device=dev)
    betas = torch.arange(V, dtype=torch.float32, device=dev) * (2 * np.pi / V)
    args = (pack_filtered(qs), 4, betas, 60.0, 0.8230337 / C, C, N, 24.0,
            2 * np.pi / V)
    before = fan_backproject_multi.launches
    got = fan_backproject_multi(*args)
    torch.cuda.synchronize()
    assert fan_backproject_multi.launches == before + 1
    want = fan_backproject_multi_plain(*args)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("taps", [8, 16])
def test_rebin_to_parallel_matches_plain(dev, taps):
    rng = np.random.default_rng(5)
    V, C, nth, nt = 90, 96, 48, 128
    sinos = torch.as_tensor(rng.normal(size=(4, V, C)), dtype=torch.float32,
                            device=dev)
    first = rng.integers(0, V * C, (nth * nt, taps // 2))
    first[:3, 0] = V * C - 1  # the pair wraps to element 0
    idx = np.repeat(first, 2, axis=1).reshape(-1).astype(np.int32)
    w = rng.uniform(0, 1, idx.size).astype(np.float32)
    args = (sinos, torch.as_tensor(idx, device=dev),
            torch.as_tensor(w, device=dev), nt)
    before = rebin_to_parallel.launches
    got = rebin_to_parallel(*args, taps=taps)
    torch.cuda.synchronize()
    assert rebin_to_parallel.launches == before + 1
    torch.testing.assert_close(got, rebin_to_parallel_plain(*args, taps=taps),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("fov_mask", [True, False])
def test_parallel_backproject_matches_plain(dev, fov_mask):
    from dexct_tpu_torch.ops.fbp_fast import pack_filtered

    rng = np.random.default_rng(6)
    nth, nt, N, fov = 64, 96, 61, 20.0
    dt = 1.2 * fov / nt
    qs = torch.as_tensor(rng.normal(size=(4, nth, nt)), dtype=torch.float32,
                         device=dev)
    th = torch.arange(nth, dtype=torch.float32, device=dev) * (np.pi / nth)
    args = (pack_filtered(qs), 4, th, -0.5 * nt * dt + 0.5 * dt, dt, nt, N,
            fov, np.pi / nth)
    before = parallel_backproject_multi.launches
    got = parallel_backproject_multi(*args, fov_mask=fov_mask)
    torch.cuda.synchronize()
    assert parallel_backproject_multi.launches == before + 1
    want = parallel_backproject_multi_plain(*args, fov_mask=fov_mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_kb_sample_matches_plain(dev):
    from dexct_tpu_torch.ops.fourier import plan_fourier_projector
    from dexct_tpu_torch.system import FanBeamGeometry, water_cylinder_phantom

    plan = plan_fourier_projector(water_cylinder_phantom(N=64, dx=0.4),
                                  FanBeamGeometry(N_channels=80, N_proj=48),
                                  n_theta=96, device=dev)
    rng = np.random.default_rng(7)
    G = plan.grid
    F = torch.complex(*(torch.as_tensor(rng.normal(size=(6, G, G)),
                                        dtype=torch.float32, device=dev)
                        for _ in range(2)))
    args = (F, plan.slice_idx, plan.slice_w, plan.phase_cos, plan.phase_sin)
    before = kb_sample.launches
    got = kb_sample(*args)
    torch.cuda.synchronize()
    assert kb_sample.launches == before + 1
    want = kb_sample_plain(*args)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_resample_to_fan_matches_plain(dev):
    rng = np.random.default_rng(8)
    M, nth, nt, V, C = 6, 64, 128, 40, 50
    radon = torch.as_tensor(rng.normal(size=(M, nth, nt)),
                            dtype=torch.float32, device=dev)
    idx = torch.as_tensor(rng.integers(0, nth * nt, (V, C * 4)),
                          dtype=torch.int32, device=dev)
    w = torch.as_tensor(rng.uniform(0, 1, (V, C * 4)), dtype=torch.float32,
                        device=dev)
    before = resample_to_fan.launches
    got = resample_to_fan(radon, idx, w, (V, C, M))
    torch.cuda.synchronize()
    assert resample_to_fan.launches == before + 1
    torch.testing.assert_close(got, resample_to_fan_plain(radon, idx, w,
                                                          (V, C, M)),
                               atol=1e-5, rtol=0)


def test_wrappers_refuse_mismatched_tensors(dev):
    """A kernel wrapper raises, and launches nothing, for a table on the
    wrong device or of the wrong dtype."""
    sinos = torch.zeros((2, 4, 8), device=dev)
    idx = torch.zeros(8 * 4, dtype=torch.int32)
    w = torch.zeros(8 * 4, device=dev)
    before = rebin_to_parallel.launches
    with pytest.raises(ValueError, match="idx is on cpu"):
        rebin_to_parallel(sinos, idx, w, 4)
    with pytest.raises(ValueError, match="dtype"):
        rebin_to_parallel(sinos, idx.to(dev, torch.int64), w, 4)
    assert rebin_to_parallel.launches == before


@pytest.mark.parametrize("projector,recon", [("siddon", "fan"),
                                             ("fourier", "parallel")])
def test_dect_step_cuda_matches_cpu(dev, projector, recon):
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.pipeline.fused import dect_step, pack_dect
    from dexct_tpu_torch.system import FanBeamGeometry, water_cylinder_phantom

    ct = FanBeamGeometry(N_channels=128, N_proj=96, eid=True)
    ph = water_cylinder_phantom(N=96, dx=0.25)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    outs = [dect_step(*pack_dect(ct, ph, s1, s2, 64, 24.0, 0.8, n_iters=20,
                                 device=d, projector=projector, recon=recon,
                                 n_theta=128, recon_n_theta=64,
                                 recon_nt=256)) for d in (dev, "cpu")]
    gpu, cpu = outs
    tol = {"sino_raw": dict(rtol=1e-4, atol=0),
           "mat_sinos": dict(rtol=0, atol=1e-3),
           "recon_raw": dict(rtol=0, atol=1e-4),
           "mat_recons": dict(rtol=0, atol=1e-3)}
    for key, kw in tol.items():
        for i in range(2):
            torch.testing.assert_close(gpu[key][i].cpu(), cpu[key][i], **kw)


@pytest.mark.parametrize("mode", ["compound", "poisson"])
def test_noise_on_the_card_is_seeded(dev, mode):
    from dexct_tpu_torch.ops.spectral import sample_noise

    c = torch.full((100_000,), 4.0e4, device=dev)
    draw = [sample_noise(torch.Generator(device=dev).manual_seed(s), c, mode,
                         var=c * 50.0) for s in (7, 7, 8)]
    torch.testing.assert_close(draw[0], draw[1])
    assert bool((draw[0] != draw[2]).any())
    want_var = 50.0 * 4.0e4 if mode == "compound" else 4.0e4
    assert abs(float(draw[0].double().var()) / want_var - 1.0) < 0.05


# ---------------------------------------------------------------------------
# K9-K12: the analytic projector and the cone-beam branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("implant", [None, "steel"])
def test_analytic_chords_match_plain(dev, implant):
    from dexct_tpu_torch.system.analytic import (analytic_paths,
                                                 analytic_paths_plain,
                                                 pelvis_analytic)

    ph = pelvis_analytic(implant=implant)
    p, lab = (torch.as_tensor(x, device=dev) for x in ph.shape_arrays())
    rng = np.random.default_rng(9)
    src, dirs = (torch.as_tensor(x, device=dev)
                 for x in _rays(rng, 4000, 60.0))
    src[-8:] = 0.0  # rays that start inside the shapes
    kw = dict(n_materials=ph.n_materials)
    before = analytic_paths.launches
    got = analytic_paths(p, lab, src, dirs, **kw)
    torch.cuda.synchronize()
    assert analytic_paths.launches == before + 1
    want = analytic_paths_plain(p, lab, src, dirs, **kw)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_siddon_trace_3d_matches_plain(dev):
    from dexct_tpu_torch.ops.conebeam import (trace_paths_3d,
                                              trace_paths_3d_plain)
    from dexct_tpu_torch.system import ConeBeamGeometry

    rng = np.random.default_rng(3)
    lab = torch.as_tensor(rng.integers(0, 6, (12, 40, 40)),
                          dtype=torch.uint8, device=dev)
    ct = ConeBeamGeometry(N_channels=48, N_proj=24, N_rows=8, SID=40.0,
                          SDD=70.0, h_iso=0.5)
    src, dirs = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in ct.ray_geometry_3d())
    before = trace_paths_3d.launches
    got = trace_paths_3d(lab, src, dirs, 0.5, 0.5, 0.5, n_materials=6)
    torch.cuda.synchronize()
    assert trace_paths_3d.launches == before + 1
    want = trace_paths_3d_plain(lab, src, dirs, 0.5, 0.5, 0.5,
                                n_materials=6)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_fdk_backproject_matches_plain(dev):
    from dexct_tpu_torch.ops.conebeam import (_fdk_backproject_multi,
                                              _fdk_backproject_multi_plain)

    rng = np.random.default_rng(5)
    qs = torch.as_tensor(rng.normal(size=(4, 48, 8, 64)),
                         dtype=torch.float32, device=dev)
    betas = torch.arange(48, dtype=torch.float32, device=dev) \
        * (2 * np.pi / 48)
    args = (60.0, 0.8230337 / 64, 0.5, 8, 40, 10, 20.0, 0.5, 2 * np.pi / 48)
    before = _fdk_backproject_multi.launches
    got = _fdk_backproject_multi(qs, betas, *args)
    torch.cuda.synchronize()
    assert _fdk_backproject_multi.launches == before + 1
    want = _fdk_backproject_multi_plain(qs, betas, *args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("n_images", [1, 4])
def test_helical_backproject_matches_plain(dev, n_images):
    from dexct_tpu_torch.ops.conebeam import (_helical_backproject,
                                              _helical_backproject_plain)
    from dexct_tpu_torch.system import HelicalConeBeamGeometry

    ct = HelicalConeBeamGeometry(N_channels=48, N_proj=144, N_rows=8,
                                 SID=60.0, SDD=100.0, h_iso=0.5,
                                 rotation_total=6 * np.pi, pitch=2.0)
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((n_images, 144, 8, 48)),
                        dtype=torch.float32, device=dev)
    nz = 17
    zv = (np.arange(nz) + 0.5) * 0.5 - nz * 0.25
    bc = 0.5 * ct.rotation_total + 2.0 * np.pi * zv / ct.pitch
    arrs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (ct.betas, ct.source_z, np.zeros(144), bc)]
    args = (60.0, ct.dgamma, 0.5, 8, 2.0, 32, nz, 20.0, 0.5, float(zv[0]))
    before = _helical_backproject.launches
    got = _helical_backproject(q, *arrs, *args,
                               dbeta=ct.rotation_total / 144)
    torch.cuda.synchronize()
    assert _helical_backproject.launches == before + 1
    want = _helical_backproject_plain(q, *arrs, *args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("pitch", [0.0, 2.0])
def test_helical_backproject_zffs_row_offsets_match_plain(dev, pitch):
    """K12 as the z flying focal spot runs it: alternating source offsets
    and nonzero per-view row offsets, on a circular orbit (pitch 0, the
    window centred on the orbit covers every view) and on a helix."""
    from dexct_tpu_torch.ops.conebeam import (_helical_backproject,
                                              _helical_backproject_plain)
    from dexct_tpu_torch.system import (ConeBeamGeometry,
                                        HelicalConeBeamGeometry)

    kw = dict(N_channels=48, N_rows=8, SID=60.0, SDD=100.0, h_iso=0.5,
              ffs="z")
    if pitch:
        ct = HelicalConeBeamGeometry(N_proj=96, rotation_total=4 * np.pi,
                                     pitch=pitch, **kw)
        nz = 9
        zv = (np.arange(nz) + 0.5) * 0.5 - nz * 0.25
        bc = 0.5 * ct.rotation_total + 2.0 * np.pi * zv / pitch
        sz = ct.source_z + ct.ffs_view_offsets
    else:
        ct = ConeBeamGeometry(N_proj=48, **kw)
        nz = 8
        zv = (np.arange(nz) + 0.5 - nz / 2.0) * 0.5
        bc = np.full(nz, 0.5 * ct.rotation_total)
        sz = ct.ffs_view_offsets
    off = ct.ffs_view_offsets
    row_off = off * ct.SID / (ct.SDD * ct.h_iso)
    assert np.abs(row_off).min() > 0
    V = ct.N_proj
    rng = np.random.default_rng(13)
    q = torch.as_tensor(rng.standard_normal((4, V, 8, 48)),
                        dtype=torch.float32, device=dev)
    arrs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (ct.betas, sz, row_off, bc)]
    args = (60.0, ct.dgamma, 0.5, 8, pitch, 32, nz, 20.0, 0.5,
            float(zv[0]))
    before = _helical_backproject.launches
    got = _helical_backproject(q, *arrs, *args,
                               dbeta=ct.rotation_total / V)
    torch.cuda.synchronize()
    assert _helical_backproject.launches == before + 1
    want = _helical_backproject_plain(q, *arrs, *args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("n_images", [1, 4])
def test_flat_backproject_matches_plain(dev, n_images):
    from dexct_tpu_torch.ops.flatpanel import (_flat_backproject,
                                               _flat_backproject_plain)

    rng = np.random.default_rng(14)
    V, R, C = 48, 8, 64
    q = torch.as_tensor(rng.normal(size=(n_images, V, R, C)),
                        dtype=torch.float32, device=dev)
    betas = torch.arange(V, dtype=torch.float32, device=dev) * (2 * np.pi / V)
    args = (60.0, 0.45, 0.5, 0.75, -0.25, R, 40, 9, 20.0, 0.45,
            2 * np.pi / V)
    before = _flat_backproject.launches
    got = _flat_backproject(q, betas, *args)
    torch.cuda.synchronize()
    assert _flat_backproject.launches == before + 1
    want = _flat_backproject_plain(q, betas, *args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("deriv", ["spectral", "stencil4"])
def test_katsevich_derivative_matches_plain(dev, deriv):
    from dexct_tpu_torch.ops.katsevich import (
        _fixed_direction_derivative, _fixed_direction_derivative_plain)

    rng = np.random.default_rng(15)
    g = torch.as_tensor(rng.uniform(0, 3, (4, 60, 8, 96)),
                        dtype=torch.float32, device=dev)
    cosk = torch.as_tensor(rng.uniform(0.9, 1.0, 8), dtype=torch.float32,
                           device=dev)
    args = (g, cosk, 4 * np.pi / 120, 0.8 / 96)
    before = _fixed_direction_derivative.launches
    got = _fixed_direction_derivative(*args, deriv=deriv)
    torch.cuda.synchronize()
    assert _fixed_direction_derivative.launches == before + 1
    want = _fixed_direction_derivative_plain(*args, deriv=deriv)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_katsevich_backproject_matches_plain(dev, interp):
    """K15, which visits per slice only the views that can reach it,
    against the plain version's scan over every view; the end slices'
    view windows are cut by both ends of the scan."""
    from dexct_tpu_torch.ops.katsevich import (_katsevich_backproject,
                                               _katsevich_backproject_plain)
    from dexct_tpu_torch.system import HelicalConeBeamGeometry

    ct = HelicalConeBeamGeometry(N_channels=48, N_proj=192, N_rows=12,
                                 gamma_fan=0.8, SID=60.0, SDD=100.0,
                                 h_iso=0.5, rotation_total=8 * np.pi,
                                 pitch=2.0)
    rng = np.random.default_rng(16)
    gf = torch.as_tensor(rng.standard_normal((4, 192, 12, 48)),
                         dtype=torch.float32, device=dev)
    arrs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (ct.betas, ct.source_z)]
    db = float(ct.betas[1] - ct.betas[0])
    args = (60.0, ct.dgamma, 0.5, 12, 2.0, 32, 17, 20.0, 0.5, -4.25,
            float(0.5 * ct.rotation_total), db, 0.25)
    before = _katsevich_backproject.launches
    got = _katsevich_backproject(gf, *arrs, *args, interp=interp)
    torch.cuda.synchronize()
    assert _katsevich_backproject.launches == before + 1
    want = _katsevich_backproject_plain(gf, *arrs, 60.0, ct.dgamma, 0.5, 12,
                                        2.0, 32, 17, 20.0, 0.5, -4.25, db,
                                        0.25, interp=interp)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_trilinear_sample_matches_plain(dev):
    from dexct_tpu_torch.ops.conebeam import (_trilinear_volume_sample,
                                              _trilinear_volume_sample_plain)

    rng = np.random.default_rng(17)
    vol = torch.as_tensor(rng.standard_normal((4, 12, 30, 34)),
                          dtype=torch.float32, device=dev)
    zi, yi, xi = (torch.as_tensor(rng.uniform(-1, n, shape),
                                  dtype=torch.float32, device=dev)
                  for n, shape in ((12, (6, 20, 1)), (30, (6, 20, 1)),
                                   (34, (1, 1, 24))))
    before = _trilinear_volume_sample.launches
    got = _trilinear_volume_sample(vol, zi, yi, xi)
    torch.cuda.synchronize()
    assert _trilinear_volume_sample.launches == before + 1
    want = _trilinear_volume_sample_plain(vol, zi, yi, xi)
    assert got.shape == (4, 6, 20, 24)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_trilinear_sample_on_tilted_indices_is_bitwise_and_copies_nothing(
        dev):
    """K16 on the tilted path's factored indices (zi, yi [nz, N, 1], xi
    [1, 1, N]): bitwise its plain version, one launch, and no memory
    beyond the output, not even for a moment (no index copy)."""
    from dexct_tpu_torch.ops.conebeam import (_tilted_grid, _tilted_indices,
                                              _trilinear_volume_sample,
                                              _trilinear_volume_sample_plain)

    n, fov, nz, dz, tau = 32, 20.0, 4, 0.5, 0.26
    n_g, _, nz_g = _tilted_grid(tau, n, fov, nz, dz)
    gen = torch.Generator(device=dev).manual_seed(3)
    vols = torch.randn((4, nz_g, n_g, n_g), generator=gen, device=dev)
    idx = _tilted_indices(tau, n, fov, nz, dz, dev)
    def requested(which):  # bytes asked of the caching allocator
        return torch.cuda.memory_stats(dev)[f"requested_bytes.all.{which}"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = requested("current")
    launches = _trilinear_volume_sample.launches
    got = _trilinear_volume_sample(vols, *idx)
    torch.cuda.synchronize()
    assert _trilinear_volume_sample.launches == launches + 1
    out_bytes = got.numel() * 4
    assert requested("current") - before == out_bytes
    assert requested("peak") - before == out_bytes
    assert got.shape == (4, nz, n, n)
    assert torch.equal(got, _trilinear_volume_sample_plain(vols, *idx))


@pytest.mark.parametrize("case", ["materialised", "rank1", "rank4",
                                  "outside", "sliced_volumes"])
def test_trilinear_sample_layouts_are_bitwise(dev, case):
    """K16 bitwise equal to its plain version on fully materialised
    indices, on a rank-1 and a rank-4 broadcast, on points all around
    and outside the box (faces, integers, beyond every face), and on a
    non-contiguous volume stack (every other x of a wider stack)."""
    from dexct_tpu_torch.ops.conebeam import (_trilinear_volume_sample,
                                              _trilinear_volume_sample_plain)

    rng = np.random.default_rng(23)
    vol = torch.as_tensor(rng.standard_normal((3, 9, 10, 11)),
                          dtype=torch.float32, device=dev)
    dims = (9, 10, 11)
    if case == "sliced_volumes":
        vol = torch.as_tensor(rng.standard_normal((3, 9, 10, 22)),
                              dtype=torch.float32, device=dev)[..., ::2]
        assert not vol.is_contiguous()
    if case in ("materialised", "sliced_volumes"):
        idx = [rng.uniform(-1, n, (5, 7, 13)) for n in dims]
    elif case == "rank1":
        idx = [rng.uniform(-1, n, (300,)) for n in dims]
    elif case == "rank4":
        idx = [rng.uniform(-1, dims[0], (2, 3, 1, 1)),
               rng.uniform(-1, dims[1], (1, 3, 4, 1)),
               rng.uniform(-1, dims[2], (1, 1, 4, 37))]
    else:
        idx = [rng.uniform(-3, n + 2, (6, 8, 40)) for n in dims]
        for t, n in zip(idx, dims):
            t[0, :, :8] = [-1e-3, 0.0, 1.0, n - 2.0, n - 1.5, n - 1.0,
                           n - 1.0 + 1e-3, n + 7.0]
    zi, yi, xi = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                  for t in idx)
    before = _trilinear_volume_sample.launches
    got = _trilinear_volume_sample(vol, zi, yi, xi)
    torch.cuda.synchronize()
    assert _trilinear_volume_sample.launches == before + 1
    want = _trilinear_volume_sample_plain(vol, zi, yi, xi)
    assert got.shape == want.shape
    assert (want == 0).any() and (want != 0).any()
    assert torch.equal(got, want)


@pytest.mark.parametrize("recon", ["flat", "tilted", "katsevich", "zffs"])
def test_simulate_cone_dect_cuda_matches_cpu(dev, recon):
    """The stateless 3-D branch on the card against the same call on the
    CPU (the plain versions)."""
    from dexct_tpu_torch.ops.conebeam import simulate_cone_dect
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.system import (ConeBeamGeometry,
                                        FlatPanelConeBeamGeometry,
                                        HelicalConeBeamGeometry,
                                        TiltedConeBeamGeometry, VoxelPhantom,
                                        water_cylinder_phantom)

    kw = dict(N_channels=64, N_proj=48, N_rows=8, h_iso=0.5, eid=True)
    ct = {"flat": lambda: FlatPanelConeBeamGeometry(**kw),
          "tilted": lambda: TiltedConeBeamGeometry(tilt=0.26, **kw),
          "katsevich": lambda: HelicalConeBeamGeometry(
              rotation_total=4 * np.pi, pitch=3.0, **{**kw, "N_proj": 96}),
          "zffs": lambda: ConeBeamGeometry(ffs="z", **kw)}[recon]()
    ph = water_cylinder_phantom(N=48, dx=0.5)
    ph3 = VoxelPhantom("w3", np.broadcast_to(ph.labels[0], (12, 48, 48))
                       .copy(), ph.materials, 0.5, 0.5, 0.5)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    r = "katsevich" if recon == "katsevich" else "auto"
    gpu, cpu = (simulate_cone_dect(ct, ph3, s1, s2, 32, 22.0, 0.8, device=d,
                                   n_iters=20, recon=r)
                for d in (dev, "cpu"))
    tol = {"sino_raw": dict(rtol=1e-4, atol=0),
           "mat_sinos": dict(rtol=0, atol=1e-3),
           "recon_raw": dict(rtol=0, atol=1e-4),
           "mat_recons": dict(rtol=0, atol=1e-3)}
    for key, t in tol.items():
        for i in range(2):
            torch.testing.assert_close(gpu[key][i].cpu(), cpu[key][i], **t)


# ---------------------------------------------------------------------------
# K17 and the 2-D paths finished with it: the z-stack, the in-plane flying
# focal spot, the denoiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nz", [1, 3, 8, 9])
@pytest.mark.parametrize("n_materials", [2, 5, 8])
def test_siddon_trace_stack_matches_plain_and_k1(dev, nz, n_materials):
    """K17 on a non-square grid with unequal cells, labels up to
    n_materials (which adds nothing): one launch for the stack, equal bit
    for bit to its plain version and, slice by slice, to K1 (chunks of
    8, 4, 2 or 1 slices, the last one padded)."""
    from dexct_tpu_torch.ops.siddon import (trace_paths_stack,
                                            trace_paths_stack_plain)

    rng = np.random.default_rng(20 + nz + n_materials)
    lab = torch.as_tensor(rng.integers(0, n_materials + 1, (nz, 48, 40)),
                          dtype=torch.uint8, device=dev)
    src, dirs = (torch.as_tensor(x, device=dev)
                 for x in _rays(rng, 3000, 30.0))
    before = trace_paths_stack.launches
    got = trace_paths_stack(lab, src, dirs, 0.5, 0.4,
                            n_materials=n_materials)
    torch.cuda.synchronize()
    assert trace_paths_stack.launches == before + 1
    assert got.shape == (nz, 3000, n_materials)
    torch.testing.assert_close(
        got, trace_paths_stack_plain(lab, src, dirs, 0.5, 0.4,
                                     n_materials=n_materials),
        rtol=0, atol=0)
    for z in range(nz):
        torch.testing.assert_close(
            got[z], trace_paths(lab[z], src, dirs, 0.5, 0.4,
                                n_materials=n_materials), rtol=0, atol=0)


def _small_system(dev_ct_kw=None):
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.system import FanBeamGeometry

    ct = FanBeamGeometry(N_channels=96, N_proj=90, eid=True,
                         **(dev_ct_kw or {}))
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return ct, s1, s2


@pytest.mark.parametrize("projector,recon", [("siddon", "parallel"),
                                             ("fourier", "fan")])
def test_zstack_cuda_matches_cpu(dev, projector, recon):
    """The z-stack on the card (K17 or the batched Fourier projector, then
    the per-slice step) against the same call on the CPU."""
    from dexct_tpu_torch.pipeline.zstack import (pack_zstack, stack_phantom,
                                                 zstack_step)
    from dexct_tpu_torch.system import contrast_rods_phantom

    ct, s1, s2 = _small_system()
    ph = stack_phantom(contrast_rods_phantom, 3, N=64, dx=0.4)
    gpu, cpu = (zstack_step(*pack_zstack(
        ct, ph, s1, s2, 64, 24.0, 0.8, device=d, n_iters=20,
        projector=projector, recon=recon, n_theta=128, recon_n_theta=64,
        recon_nt=192)) for d in (dev, "cpu"))
    tol = {"sino_raw": dict(rtol=1e-4, atol=0),
           "mat_sinos": dict(rtol=0, atol=1e-3),
           "recon_raw": dict(rtol=0, atol=1e-4),
           "mat_recons": dict(rtol=0, atol=1e-3)}
    for key, t in tol.items():
        for i in range(2):
            torch.testing.assert_close(gpu[key][i].cpu(), cpu[key][i], **t)


def test_ffs_fbp_recon_cuda_matches_cpu(dev):
    """K5 at 16 taps on the interleaved plan, then K6, against the plain
    versions."""
    from dexct_tpu_torch.ops.fbp_fast import rebin_to_parallel as k5
    from dexct_tpu_torch.ops.ffs import ffs_fbp_recon

    ct, _, _ = _small_system(dict(ffs="inplane"))
    rng = np.random.default_rng(8)
    t = ct.SID * np.sin(ct.gammas)
    sino = torch.as_tensor(
        2.0 * np.sqrt(np.clip(12.0 ** 2 - t ** 2, 0, None)) * 0.2
        + 0.01 * rng.normal(size=(90, 96)), dtype=torch.float32)
    before = k5.launches
    gpu = ffs_fbp_recon(sino.to(dev), ct, 64, 30.0)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    torch.testing.assert_close(gpu.cpu(), ffs_fbp_recon(sino, ct, 64, 30.0),
                               rtol=0, atol=1e-4)


def test_denoiser_cuda_matches_cpu(dev):
    """cuDNN's float32 convolutions with TF32 off: the card's denoised HU
    agree with the CPU's to 1e-2 HU."""
    from dexct_tpu_torch.learn.denoiser_io import denoise_hu_batch

    rng = np.random.default_rng(9)
    imgs = torch.as_tensor(rng.normal(0, 60, (3, 96, 96)),
                           dtype=torch.float32)
    prev = torch.backends.cudnn.allow_tf32
    gpu = denoise_hu_batch(imgs.to(dev))
    assert torch.backends.cudnn.allow_tf32 == prev  # restored
    cpu = denoise_hu_batch(imgs)
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-2)


@pytest.mark.parametrize("weighting", ["full", "feather", "td", "cosz",
                                       "short", "pair"])
def test_helical_backproject_weightings_match_plain(dev, weighting):
    """K12 in each gFDK weighting, on a 3-turn helix (the plain version
    scans every view; the kernel each slice's window)."""
    from dexct_tpu_torch.ops.conebeam import (_helical_backproject,
                                              _helical_backproject_plain)
    from dexct_tpu_torch.system import HelicalConeBeamGeometry

    ct = HelicalConeBeamGeometry(N_channels=48, N_proj=144, N_rows=8,
                                 SID=60.0, SDD=100.0, h_iso=0.5,
                                 rotation_total=6 * np.pi, pitch=2.0)
    rng = np.random.default_rng(21)
    q = torch.as_tensor(rng.standard_normal((4, 144, 8, 48)),
                        dtype=torch.float32, device=dev)
    nz = 17
    zv = (np.arange(nz) + 0.5) * 0.5 - nz * 0.25
    bc = 0.5 * ct.rotation_total + 2.0 * np.pi * zv / ct.pitch
    arrs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (ct.betas, ct.source_z, np.zeros(144), bc)]
    args = (60.0, ct.dgamma, 0.5, 8, 2.0, 32, nz, 20.0, 0.5, float(zv[0]))
    before = _helical_backproject.launches
    got = _helical_backproject(q, *arrs, *args, weighting=weighting,
                               dbeta=ct.rotation_total / 144)
    torch.cuda.synchronize()
    assert _helical_backproject.launches == before + 1
    want = _helical_backproject_plain(q, *arrs, *args, weighting=weighting)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def _cone_rays(dev):
    from dexct_tpu_torch.system import ConeBeamGeometry

    ct = ConeBeamGeometry(N_channels=64, N_proj=48, N_rows=8, SID=60.0,
                          SDD=100.0, h_iso=0.5)
    src, dirs = ct.ray_geometry_3d()
    return (torch.as_tensor(src, dtype=torch.float32, device=dev),
            torch.as_tensor(dirs, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("n_steps", [None, 30])
def test_project_volume_3d_matches_plain(dev, n_steps):
    """K18 against its plain version, and on a volume of per-label values
    against K10's paths times those values."""
    from dexct_tpu_torch.ops.conebeam import (project_volume_3d,
                                              project_volume_3d_plain,
                                              trace_paths_3d)

    src, dirs = _cone_rays(dev)
    rng = np.random.default_rng(22)
    vol = torch.as_tensor(rng.uniform(0, 1, (12, 40, 40)),
                          dtype=torch.float32, device=dev)
    before = project_volume_3d.launches
    got = project_volume_3d(vol, src, dirs, 0.5, 0.5, 0.5, n_steps=n_steps)
    torch.cuda.synchronize()
    assert project_volume_3d.launches == before + 1
    want = project_volume_3d_plain(vol, src, dirs, 0.5, 0.5, 0.5,
                                   n_steps=n_steps)
    assert got.shape == (48, 8, 64)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    labels = torch.as_tensor(rng.integers(0, 4, (12, 40, 40)),
                             dtype=torch.uint8, device=dev)
    mu = torch.tensor([0.0, 0.2, 0.35, 0.5], device=dev)
    ref = trace_paths_3d(labels, src, dirs, 0.5, 0.5, 0.5,
                         n_materials=4) @ mu
    got = project_volume_3d(mu[labels.long()], src, dirs, 0.5, 0.5, 0.5)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def test_project_volume_3d_adjoint_matches_plain(dev):
    """K19 against its plain version, the dot-product identity and the
    autograd gradient."""
    from dexct_tpu_torch.ops.conebeam import (
        project_volume_3d, project_volume_3d_adjoint,
        project_volume_3d_adjoint_plain)

    src, dirs = _cone_rays(dev)
    rng = np.random.default_rng(23)
    shape = (12, 40, 40)
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.normal(size=(48, 8, 64)), dtype=torch.float32,
                        device=dev)
    before = project_volume_3d_adjoint.launches
    got = project_volume_3d_adjoint(y, src, dirs, shape, 0.5, 0.5, 0.5)
    torch.cuda.synchronize()
    assert project_volume_3d_adjoint.launches == before + 1
    want = project_volume_3d_adjoint_plain(y, src, dirs, shape, 0.5, 0.5,
                                           0.5)
    # the plain version on the card adds with atomic index_add_
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    lhs = float((project_volume_3d(x, src, dirs, 0.5, 0.5, 0.5)
                 .double() * y.double()).sum())
    rhs = float((x.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)
    x.requires_grad_(True)
    (project_volume_3d(x, src, dirs, 0.5, 0.5, 0.5) * y).sum().backward()
    torch.testing.assert_close(x.grad, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))



def _k18_case(dev, case):
    """K18's inputs on the card: ``"cone"`` (``_cone_rays``: 48 views
    around, both dominances); ``"ragged"`` (50 channels, so that warps
    straddle detector rows and views of different dominance); ``"diagonal"``
    (views every 45 degrees: the central ray at |d_x| = |d_y| on the
    diagonals and along an axis on the others; a fan wider than the grid,
    so that outer rays miss it);
    ``"truncated"`` (the cone case with ``n_steps=30``).  The volume holds
    normal values, so that products of both signs and zero-length steps
    meet the sums."""
    from dexct_tpu_torch.system import ConeBeamGeometry

    shape, vox, n_steps = (12, 40, 40), (0.5, 0.5, 0.5), None
    if case in ("cone", "truncated"):
        src, dirs = _cone_rays(dev)
        n_steps = 30 if case == "truncated" else None
    else:
        kw = (dict(N_channels=50, N_proj=20, N_rows=3, h_iso=0.5)
              if case == "ragged" else
              dict(N_channels=97, N_proj=8, N_rows=4, h_iso=0.5,
                   gamma_fan=1.4))
        ct = ConeBeamGeometry(SID=60.0, SDD=100.0, **kw)
        src, dirs = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                     for x in ct.ray_geometry_3d())
    rng = np.random.default_rng(41)
    vol = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                          device=dev)
    return vol, src, dirs, vox, n_steps


@pytest.mark.parametrize("case", ["cone", "ragged", "diagonal", "truncated"])
def test_k18_is_the_cpu_plain_version_bit_for_bit(dev, case):
    """K18 equals the plain version run on the CPU bit for bit (a product
    and a sum per step, in step order), and two launches are bit-equal;
    one launch a call."""
    from dexct_tpu_torch.ops import conebeam as cb

    vol, src, dirs, vox, n_steps = _k18_case(dev, case)
    before = cb.project_volume_3d.launches
    got = cb.project_volume_3d(vol, src, dirs, *vox, n_steps=n_steps)
    again = cb.project_volume_3d(vol, src, dirs, *vox, n_steps=n_steps)
    torch.cuda.synchronize()
    assert cb.project_volume_3d.launches == before + 2
    assert got.shape == src.shape[:-1]
    assert torch.equal(got, again)
    want = cb.project_volume_3d_plain(vol.cpu(), src.cpu(), dirs.cpu(),
                                      *vox, n_steps=n_steps)
    assert torch.equal(got.cpu(), want)
    if case == "diagonal":
        assert bool((want == 0).any()) and bool((want != 0).any())


def test_k18_swapped_copy_is_the_transpose(dev):
    """K18's second layout is the volume with x and y swapped, also when
    neither is a multiple of the 32-cell tile."""
    from dexct_tpu_torch.ops import conebeam as cb

    vol = torch.randn((3, 45, 70), device=dev)
    assert torch.equal(cb._swap_xy(vol), vol.transpose(1, 2).contiguous())


def test_k18_makes_no_host_synchronisation(dev):
    """K18's call (the swapped copy and the walk) makes no synchronising
    call."""
    from dexct_tpu_torch.ops import conebeam as cb

    vol, src, dirs, vox, _ = _k18_case(dev, "cone")
    _no_sync(lambda: cb.project_volume_3d(vol, src, dirs, *vox))


def _k19_case(dev, case):
    """K19's inputs: ``"tiny"`` (48 x 8 x 64 rays through 12 x 40 x 40
    cells of 0.5 cm) or ``"cone_subset"`` (every 30th view of
    chip_smoke.py's cone config, 360 x 16 x 256 rays, through its 32 x
    256 x 256 grid of 0.2 cm)."""
    from dexct_tpu_torch.system import ConeBeamGeometry

    if case == "tiny":
        src, dirs = _cone_rays(dev)
        shape, vox = (12, 40, 40), (0.5, 0.5, 0.5)
    else:
        ct = ConeBeamGeometry(N_channels=256, N_proj=360, N_rows=16,
                              gamma_fan=0.8230337, SID=60.0, SDD=100.0,
                              h_iso=0.25)
        src, dirs = (torch.as_tensor(x[::30], dtype=torch.float32,
                                     device=dev).contiguous()
                     for x in ct.ray_geometry_3d())
        shape, vox = (32, 256, 256), (0.2, 0.2, 0.2)
    rng = np.random.default_rng(27)
    y = torch.as_tensor(rng.normal(size=src.shape[:-1]), dtype=torch.float32,
                        device=dev)
    return src, dirs, y, shape, vox


@pytest.mark.parametrize("case", ["tiny", "cone_subset"])
def test_k19_is_the_cpu_plain_version_bit_for_bit(dev, case):
    """K19 over its cached table: two launches bit-equal, each equal to the
    plain version run on the CPU (index_add_ one step after another) bit
    for bit, the dot-product identity against K18 within rel 1e-4; one
    build and one gather launch a call."""
    from dexct_tpu_torch.ops import conebeam as cb

    src, dirs, y, shape, vox = _k19_case(dev, case)
    builds, gathers = cb.cone_transpose.launches, \
        cb.project_volume_3d_adjoint.launches
    table = cb.cone_transpose(src, dirs, shape, *vox)
    got = cb.project_volume_3d_adjoint(y, src, dirs, shape, *vox, table=table)
    again = cb.project_volume_3d_adjoint(y, src, dirs, shape, *vox,
                                         table=table)
    torch.cuda.synchronize()
    assert cb.cone_transpose.launches == builds + 1
    assert cb.project_volume_3d_adjoint.launches == gathers + 2
    assert len(table.blocks) == 1 and table.nnz > 0
    assert torch.equal(got, again)
    want = cb.project_volume_3d_adjoint_plain(y.cpu(), src.cpu(), dirs.cpu(),
                                              shape, *vox)
    assert torch.equal(got.cpu(), want)
    x = torch.as_tensor(np.random.default_rng(28).normal(size=shape),
                        dtype=torch.float32, device=dev)
    lhs = float((cb.project_volume_3d(x, src, dirs, *vox).double()
                 * y.double()).sum())
    rhs = float((x.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_k19_table_is_the_plain_builders(dev):
    """The build's kernels (counting walk, filling walk, sort of each cell's
    run) give the plain builder's table, run on the CPU, field for field:
    the runs, the slices' offsets, and every slot's ray and segment (the
    padding slots zero)."""
    from dexct_tpu_torch.ops import conebeam as cb

    src, dirs, _, shape, vox = _k19_case(dev, "tiny")
    got = cb.cone_transpose(src, dirs, shape, *vox)
    want = cb.cone_transpose_plain(src.cpu(), dirs.cpu(), shape, *vox)
    assert got.nnz == want.nnz and got.slots == want.slots
    for g, w in zip(got.blocks[0][:3], want.blocks[0][:3]):
        assert torch.equal(g.cpu(), w)


def test_k19_direct_call_builds_its_table(dev):
    """Without a table K19 builds one for the call: one build, one gather,
    the same bits as with a cached table; a table of other rays' count or
    another n_steps is refused."""
    from dexct_tpu_torch.ops import conebeam as cb

    src, dirs, y, shape, vox = _k19_case(dev, "tiny")
    table = cb.cone_transpose(src, dirs, shape, *vox)
    builds, gathers = cb.cone_transpose.launches, \
        cb.project_volume_3d_adjoint.launches
    got = cb.project_volume_3d_adjoint(y, src, dirs, shape, *vox)
    assert cb.cone_transpose.launches == builds + 1
    assert cb.project_volume_3d_adjoint.launches == gathers + 1
    assert torch.equal(got, cb.project_volume_3d_adjoint(
        y, src, dirs, shape, *vox, table=table))
    with pytest.raises(ValueError, match="other rays"):
        cb.project_volume_3d_adjoint(y, src, dirs, shape, *vox, n_steps=30,
                                     table=table)
    with pytest.raises(ValueError, match="other rays"):
        cb.project_volume_3d_adjoint(y[:4], src[:4], dirs[:4], shape, *vox,
                                     table=table)


def test_k19_view_blocks_are_the_plain_blocks(dev, monkeypatch):
    """Under a table budget that splits the views into blocks, the card's
    blocks are the plain builder's, its gather equals the plain gather over
    the CPU's table bit for bit (each block's sums added in view order),
    and the plain version within 1e-5 of its largest value."""
    from dexct_tpu_torch.ops import conebeam as cb

    monkeypatch.setattr(cb, "_TABLE_BYTES", 2_000_000)
    src, dirs, y, shape, vox = _k19_case(dev, "tiny")
    table = cb.cone_transpose(src, dirs, shape, *vox)
    cpu = cb.cone_transpose_plain(src.cpu(), dirs.cpu(), shape, *vox)
    assert len(table.blocks) == len(cpu.blocks) > 1
    before = cb.project_volume_3d_adjoint.launches
    got = cb.project_volume_3d_adjoint(y, src, dirs, shape, *vox, table=table)
    assert (cb.project_volume_3d_adjoint.launches
            == before + len(table.blocks))
    assert torch.equal(got.cpu(), cb._adjoint_gather_plain(y.cpu(), cpu))
    want = cb.project_volume_3d_adjoint_plain(y.cpu(), src.cpu(), dirs.cpu(),
                                              shape, *vox)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_k19_gather_does_not_synchronise(dev):
    """With its table built, K19 runs without a host synchronisation."""
    from dexct_tpu_torch.ops import conebeam as cb

    src, dirs, y, shape, vox = _k19_case(dev, "tiny")
    table = cb.cone_transpose(src, dirs, shape, *vox)
    cb.project_volume_3d_adjoint(y, src, dirs, shape, *vox, table=table)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cb.project_volume_3d_adjoint(y, src, dirs, shape, *vox, table=table)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def test_cone_cg_recon_builds_once_and_repeats_its_bits(dev):
    """``cone_cg_recon`` on the card builds K19's table once for all its
    adjoints and gives the same bits twice."""
    from dexct_tpu_torch.ops import conebeam as cb
    from dexct_tpu_torch.system import ConeBeamGeometry

    ct = ConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4, SID=60.0,
                          SDD=100.0, h_iso=0.5)
    sino = torch.as_tensor(np.random.default_rng(29).uniform(
        0.5, 2.0, (48, 4, 32)), dtype=torch.float32, device=dev)
    runs = []
    for _ in range(2):
        builds, gathers = cb.cone_transpose.launches, \
            cb.project_volume_3d_adjoint.launches
        runs.append(cb.cone_cg_recon(sino, ct, (4, 24, 24), (1.0, 1.0, 1.0),
                                     n_iters=6))
        assert cb.cone_transpose.launches == builds + 1
        assert cb.project_volume_3d_adjoint.launches == gathers + 8
    for a, b in zip(*runs):
        assert torch.equal(a, b)

def test_pi_backproject_matches_plain(dev):
    from dexct_tpu_torch.ops.helical_pi import (_conepar_rebin_plan,
                                                _pi_backproject,
                                                _pi_backproject_plain)
    from dexct_tpu_torch.system import HelicalConeBeamGeometry

    ct = HelicalConeBeamGeometry(N_channels=32, N_proj=96, N_rows=8,
                                 SID=60.0, SDD=100.0, h_iso=0.5, pitch=2.0,
                                 rotation_total=4.0 * np.pi)
    _, _, t0, dt, thetas = _conepar_rebin_plan(ct, 64)
    rng = np.random.default_rng(24)
    par = torch.as_tensor(rng.standard_normal((96, 64, 8)),
                          dtype=torch.float32, device=dev)
    th = torch.as_tensor(thetas, device=dev)
    args = (par, 60.0, 0.5, 8, 2.0, float(ct.source_z[0]), th, t0, dt, 64,
            32, 5, 16.0, 0.5, -1.0, float(ct.rotation_total / 96))
    before = _pi_backproject.launches
    got = _pi_backproject(*args)
    torch.cuda.synchronize()
    assert _pi_backproject.launches == before + 1
    want = _pi_backproject_plain(*args)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_rebin_to_parallel_4_taps_matches_plain(dev):
    """K5 at 4 taps on the PI method's plan, the 8 detector rows as its
    images (more than the 4 of its other paths)."""
    from dexct_tpu_torch.ops.helical_pi import _conepar_rebin_plan
    from dexct_tpu_torch.system import HelicalConeBeamGeometry

    ct = HelicalConeBeamGeometry(N_channels=32, N_proj=96, N_rows=8,
                                 SID=60.0, SDD=100.0, h_iso=0.5, pitch=2.0,
                                 rotation_total=4.0 * np.pi)
    idx, w, _, _, _ = _conepar_rebin_plan(ct, 64)
    rng = np.random.default_rng(25)
    rows = torch.as_tensor(rng.standard_normal((8, 96, 32)),
                           dtype=torch.float32, device=dev)
    idx = torch.as_tensor(idx, device=dev)
    w = torch.as_tensor(w, device=dev)
    before = rebin_to_parallel.launches
    got = rebin_to_parallel(rows, idx, w, 64, taps=4)
    torch.cuda.synchronize()
    assert rebin_to_parallel.launches == before + 1
    want = rebin_to_parallel_plain(rows, idx, w, 64, taps=4)
    assert got.shape == (8, 96, 64)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("path", ["pwls", "cg", "helical_pi"])
def test_iterative_and_pi_paths_cuda_match_cpu(dev, path):
    """Tiny cone PWLS and CG (K18, K19) and the PI method (K5, K20) on the
    card against the CPU."""
    from dexct_tpu_torch.ops import conebeam, helical_pi
    from dexct_tpu_torch.system import (ConeBeamGeometry,
                                        HelicalConeBeamGeometry)

    rng = np.random.default_rng(26)
    if path == "helical_pi":
        ct = HelicalConeBeamGeometry(N_channels=32, N_proj=96, N_rows=8,
                                     SID=60.0, SDD=100.0, h_iso=0.5,
                                     pitch=2.0, rotation_total=4.0 * np.pi)
        sino = rng.uniform(0.5, 1.5, (96, 8, 32)).astype(np.float32)
        out = [helical_pi.helical_pi_reconstruct(
            torch.as_tensor(sino, device=d), ct, 32, 18.0, 0.8).cpu()
            for d in ("cpu", dev)]
        tol = 1e-4
    else:
        ct = ConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4, SID=60.0,
                              SDD=100.0, h_iso=0.5)
        sino = rng.uniform(0.5, 2.0, (48, 4, 32)).astype(np.float32)
        counts = np.maximum(1500.0 * np.exp(-sino), 1.0)
        v0 = rng.normal(size=(4, 24, 24)).astype(np.float32)
        if path == "pwls":
            out = [conebeam.cone_pwls_recon(
                sino, counts, ct, (4, 24, 24), (1.0, 1.0, 1.0), n_iters=20,
                beta=3e-2, device=d, _v0=v0).cpu() for d in ("cpu", dev)]
        else:
            out = [conebeam.cone_cg_recon(
                sino, ct, (4, 24, 24), (1.0, 1.0, 1.0), n_iters=6,
                device=d)[0].cpu() for d in ("cpu", dev)]
        tol = 1e-3
    torch.testing.assert_close(out[1], out[0], rtol=0,
                               atol=tol * float(out[0].abs().max()))


@pytest.mark.parametrize("M", [1, 2])
def test_kb_sample_adjoint_matches_plain(dev, M):
    """K21 against its plain version (index_add_), and <K7 F, g> =
    <F, K21 g> in the real pairing."""
    from dexct_tpu_torch.ops.fourier import (kb_sample_adjoint,
                                             kb_sample_adjoint_plain)

    plan = tiny_cases.fourier_plan(dev)
    rng = np.random.default_rng(30)
    G = plan.grid
    tabs = (plan.slice_idx, plan.slice_w, plan.phase_cos, plan.phase_sin)
    g = torch.complex(*(torch.as_tensor(
        rng.normal(size=(M,) + tuple(plan.phase_cos.shape)),
        dtype=torch.float32, device=dev) for _ in range(2)))
    before = kb_sample_adjoint.launches
    got = kb_sample_adjoint(g, *tabs, G)
    torch.cuda.synchronize()
    assert kb_sample_adjoint.launches == before + 1
    want = kb_sample_adjoint_plain(g, *tabs, G)
    assert got.dtype == torch.complex64 and got.shape == (M, G, G)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    F = torch.complex(*(torch.as_tensor(rng.normal(size=(M, G, G)),
                                        dtype=torch.float32, device=dev)
                        for _ in range(2)))
    lhs = float((torch.view_as_real(kb_sample(F, *tabs)).double()
                 * torch.view_as_real(g).double()).sum())
    rhs = float((torch.view_as_real(F).double()
                 * torch.view_as_real(got).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def _kb_adjoint_case(dev, M, case, seed):
    """K21's inputs: the tiny plan's tables, or a hot spot (every window
    base among four cells of a G = 64 spectrum, so each of a few dozen
    cells holds ~600 taps, over several of the warp's chunks)."""
    rng = np.random.default_rng(seed)
    if case == "plan":
        plan = tiny_cases.fourier_plan(dev)
        tabs = (plan.slice_idx, plan.slice_w, plan.phase_cos, plan.phase_sin)
        G = plan.grid
    else:
        G, nth, nl = 64, 40, 30
        base = rng.choice([0, 1, G, G + 1], size=(nth, nl))
        tabs = (torch.as_tensor(base, dtype=torch.int32, device=dev),
                torch.as_tensor(rng.uniform(0, 1, nth * nl * 16),
                                dtype=torch.float32, device=dev),
                *(torch.as_tensor(np.cos(rng.uniform(0, 6.3, (nth, nl)) + k),
                                  dtype=torch.float32, device=dev)
                  for k in (0.0, -np.pi / 2)))
    g = torch.complex(*(torch.as_tensor(
        rng.normal(size=(M,) + tuple(tabs[2].shape)), dtype=torch.float32,
        device=dev) for _ in range(2)))
    return g, tabs, G


@pytest.mark.parametrize("case", ["plan", "hot"])
@pytest.mark.parametrize("M", [1, 2, 3])
def test_kb_sample_adjoint_gathers_deterministically(dev, M, case):
    """K21 over the transposed taps: two launches give the same bits, the
    cached transpose gives what a transpose built for the call gives, and
    both equal the CPU's ``index_add_`` (the same products added into each
    cell in the same order); one launch a call at every M (beyond two
    images the kernel takes them in pairs)."""
    from dexct_tpu_torch.ops.fourier import (_kb_transpose_taps,
                                             kb_sample_adjoint,
                                             kb_sample_adjoint_plain)

    g, tabs, G = _kb_adjoint_case(dev, M, case, 50 + M)
    kb_t = _kb_transpose_taps(tabs[0], tabs[1], G)
    assert kb_t.n_long > 0
    before = kb_sample_adjoint.launches
    first = kb_sample_adjoint(g, *tabs, G, kb_t=kb_t)
    second = kb_sample_adjoint(g, *tabs, G, kb_t=kb_t)
    per_call = kb_sample_adjoint(g, *tabs, G)
    torch.cuda.synchronize()
    assert kb_sample_adjoint.launches == before + 3
    assert torch.equal(first, second) and torch.equal(first, per_call)
    want = kb_sample_adjoint_plain(g.cpu(), *(t.cpu() for t in tabs), G)
    assert torch.equal(first.cpu(), want)


def test_plan_kb_transpose_feeds_both_adjoints(dev):
    """The plan's cached sampler transpose is built at the first adjoint
    (not by the forward projector) and reused: the explicit A^T and
    autograd's backward launch K21 over it, equal K21 over a transpose
    built per call, and agree with each other within 1e-5 of the
    largest value."""
    from dexct_tpu_torch.ops import fourier, iterative

    plan = tiny_cases.fourier_plan(dev)
    vs = tiny_cases.VIEW_SHAPE
    A = iterative.make_projection_operator(plan, vs)
    x = torch.zeros((plan.n_img, plan.n_img), device=dev, requires_grad=True)
    A(x)  # the forward pass alone builds nothing
    assert plan.kb_t is None
    gen = torch.Generator(device=dev).manual_seed(6)
    y = torch.randn(vs, generator=gen, device=dev)
    explicit = iterative._projection_adjoint(plan, vs)(y)
    kb_t = plan.kb_t
    assert kb_t is not None
    before = fourier.kb_sample_adjoint.launches
    (auto,) = torch.autograd.grad(A(x), x, y)
    assert fourier.kb_sample_adjoint.launches == before + 1
    assert plan.kb_t is kb_t
    torch.testing.assert_close(auto, explicit, rtol=0,
                               atol=1e-5 * float(explicit.abs().max()))
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.randn((1, plan.n_theta, plan.grid // 2 + 1, 2),
                    generator=gen, device=dev)
    g = torch.view_as_complex(g)
    tabs = (plan.slice_idx, plan.slice_w, plan.phase_cos, plan.phase_sin)
    cached = fourier.kb_sample_adjoint(g, *tabs, plan.grid, kb_t=kb_t)
    per_call = fourier.kb_sample_adjoint(g, *tabs, plan.grid)
    assert torch.equal(cached, per_call)


def test_kb_sample_adjoint_makes_no_host_synchronisation(dev):
    """A K21 call over a cached transpose copies nothing from the host and
    reads nothing back."""
    from dexct_tpu_torch.ops.fourier import kb_sample_adjoint, kb_transpose

    plan = tiny_cases.fourier_plan(dev)
    g, tabs, G = _kb_adjoint_case(dev, 2, "plan", 60)
    kb_t = kb_transpose(plan)
    _no_sync(lambda: kb_sample_adjoint(g, *tabs, G, kb_t=kb_t))


# sha1 of K7's output on the cases of probe_kb_sample.PIN_CASES (the
# reference plan at M = 6 and 1, the one-step plan at M = 2, the motion
# plan at M = 1, a ragged 50^2 grid at M = 3 and a z-stack batch of 16
# images), from the build of K7 before it binned the samples by spectrum
# tile (NVIDIA H100 80GB HBM3, CUDA 12.8)
K7_PINNED_SHA1 = {"ref6": "b4b713a723895e71e64f1114ae5ba37bb9188861",
                  "ref1": "99d463d2d2f92073af01fb5c2dea0327309542cb",
                  "onestep2": "bd307bf83e12a36667988ba5fe46341852547000",
                  "motion1": "39e98eee5efb76e8180dbe5ae4811952da3c6cb0",
                  "ragged": "52f4ef702fc46edf6fe1b36102b83ddd4776ebb9",
                  "zstack16": "119a4b16b3b645c87e65eeaadc8e4c718b6f8fca"}


def _k7_pin_args(dev, case):
    from dexct_tpu_torch.ops import fourier
    from dexct_tpu_torch.tools.probe_kb_sample import (pin_case,
                                                       sampler_tables)

    n_img, n_theta, F = pin_case(case)
    return (torch.as_tensor(F, device=dev),
            *sampler_tables(fourier, n_img, n_theta, dev))


@pytest.mark.parametrize("case", sorted(K7_PINNED_SHA1))
def test_k7_keeps_its_pinned_bits(dev, case):
    """K7 over the binned samples gives the first K7's output bit for bit,
    two launches are equal, and it lies within 1e-5 of the plain version's
    maximum."""
    from dexct_tpu_torch.tools.probe_kb_sample import output_sha1

    args = _k7_pin_args(dev, case)
    before = kb_sample.launches
    out = kb_sample(*args)
    again = kb_sample(*args)
    torch.cuda.synchronize()
    assert kb_sample.launches == before + 2
    assert output_sha1(out) == K7_PINNED_SHA1[case]
    assert torch.equal(out, again)
    want = kb_sample_plain(*args)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_k7_builds_its_binning_once_per_table(dev):
    """A second K7 call on the same tables builds nothing, and a plan's
    projector bins its samples once."""
    from dexct_tpu_torch.ops import fourier

    args = _k7_pin_args(dev, "ragged")
    before = fourier.kb_tiles.builds
    first = kb_sample(*args)
    assert fourier.kb_tiles.builds == before + 1
    second = kb_sample(*args)
    assert fourier.kb_tiles.builds == before + 1
    assert torch.equal(first, second)
    plan = tiny_cases.fourier_plan(dev)
    imgs = torch.ones((2, plan.n_img, plan.n_img), device=dev)
    before = fourier.kb_tiles.builds
    a = fourier.fourier_radon(plan, imgs)
    b = fourier.fourier_radon(plan, imgs)
    assert fourier.kb_tiles.builds == before + 1
    assert torch.equal(a, b)


def test_k7_makes_no_host_synchronisation(dev):
    """With its tables binned, a K7 call copies nothing from the host and
    reads nothing back."""
    args = _k7_pin_args(dev, "ragged")
    _no_sync(lambda: kb_sample(*args))


def test_k7_bins_for_the_spectrum_grid(dev):
    """The same tables on a spectrum of another grid are binned anew for
    that grid, and K7 there stays within 1e-5 of the plain version's
    maximum."""
    from dexct_tpu_torch.ops import fourier

    F, *tabs = _k7_pin_args(dev, "ragged")
    G = F.shape[-1] + 2
    wider = torch.as_tensor(np.random.default_rng(77).standard_normal(
        (3, G, G, 2), dtype=np.float32), device=dev)
    wider = torch.view_as_complex(wider)
    kb_sample(F, *tabs)
    before = fourier.kb_tiles.builds
    out = kb_sample(wider, *tabs)
    assert fourier.kb_tiles.builds == before + 1
    assert fourier.kb_tiles(*tabs, G).grid == G
    want = kb_sample_plain(wider, *tabs)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_resample_to_fan_adjoint_matches_plain(dev):
    """K22 against its plain version (index_add_), and <K8 r, y> =
    <r, K22 y>."""
    from dexct_tpu_torch.ops.fourier import (resample_to_fan_adjoint,
                                             resample_to_fan_adjoint_plain)

    rng = np.random.default_rng(31)
    M, nth, nt, V, C = 3, 64, 128, 40, 50
    idx = torch.as_tensor(rng.integers(0, nth * nt, (V, C * 4)),
                          dtype=torch.int32, device=dev)
    w = torch.as_tensor(rng.uniform(0, 1, (V, C * 4)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.normal(size=(V, C, M)), dtype=torch.float32,
                        device=dev)
    before = resample_to_fan_adjoint.launches
    got = resample_to_fan_adjoint(y, idx, w, (M, nth, nt))
    torch.cuda.synchronize()
    assert resample_to_fan_adjoint.launches == before + 1
    want = resample_to_fan_adjoint_plain(y, idx, w, (M, nth, nt))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    r = torch.as_tensor(rng.normal(size=(M, nth, nt)), dtype=torch.float32,
                        device=dev)
    lhs = float((resample_to_fan(r, idx, w, (V, C, M)).double()
                 * y.double()).sum())
    rhs = float((r.double() * got.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def _fan_adjoint_case(dev, M, seed):
    rng = np.random.default_rng(seed)
    nth, nt, V, C = 48, 96, 30, 40
    idx = torch.as_tensor(rng.integers(0, nth * nt, (V, C * 4)),
                          dtype=torch.int32, device=dev)
    w = torch.as_tensor(rng.uniform(0, 1, (V, C * 4)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.normal(size=(V, C, M)), dtype=torch.float32,
                        device=dev)
    return y, idx, w, (M, nth, nt)


@pytest.mark.parametrize("M", [1, 2, 5, 8])
def test_resample_to_fan_adjoint_gathers_deterministically(dev, M):
    """K22 over the transposed taps: two launches give the same bits, the
    cached transpose gives what a transpose built for the call gives, and
    both equal the CPU's ``index_add_`` (the same products added into
    each bin in the same order); one launch a call at every M (beyond four
    images the kernel loops over groups of four)."""
    from dexct_tpu_torch.ops.fourier import (_transpose_taps,
                                             resample_to_fan_adjoint,
                                             resample_to_fan_adjoint_plain)

    y, idx, w, shape = _fan_adjoint_case(dev, M, 40 + M)
    fan_t = _transpose_taps(idx, w, shape[1] * shape[2])
    before = resample_to_fan_adjoint.launches
    first = resample_to_fan_adjoint(y, idx, w, shape, fan_t=fan_t)
    second = resample_to_fan_adjoint(y, idx, w, shape, fan_t=fan_t)
    per_call = resample_to_fan_adjoint(y, idx, w, shape)
    torch.cuda.synchronize()
    assert resample_to_fan_adjoint.launches == before + 3
    assert torch.equal(first, second) and torch.equal(first, per_call)
    want = resample_to_fan_adjoint_plain(y.cpu(), idx.cpu(), w.cpu(), shape)
    assert torch.equal(first.cpu(), want)


def test_plan_fan_transpose_feeds_both_adjoints(dev):
    """The plan's cached transpose is built at the first adjoint and
    reused: the explicit A^T and autograd's backward launch K22 over it,
    and equal K22 over a transpose built per call."""
    from dexct_tpu_torch.ops import fourier, iterative

    plan = tiny_cases.fourier_plan(dev)
    vs = tiny_cases.VIEW_SHAPE
    assert plan.fan_t is None
    gen = torch.Generator(device=dev).manual_seed(5)
    y = torch.randn(vs, generator=gen, device=dev)
    iterative._projection_adjoint(plan, vs)(y)
    fan_t = plan.fan_t
    assert fan_t is not None
    x = torch.zeros((plan.n_img, plan.n_img), device=dev, requires_grad=True)
    iterative.make_projection_operator(plan, vs)(x).backward(y)
    assert plan.fan_t is fan_t
    shape = (1, plan.n_theta, plan.nt)
    cached = fourier.resample_to_fan_adjoint(
        y[..., None], plan.fan_idx, plan.fan_w, shape, fan_t=fan_t)
    per_call = fourier.resample_to_fan_adjoint(
        y[..., None], plan.fan_idx, plan.fan_w, shape)
    assert torch.equal(cached, per_call)


@pytest.mark.parametrize("path", tiny_cases.ITERATIVE_PATHS)
def test_2d_iterative_and_onestep_cuda_match_cpu(dev, path):
    """The 2-D reconstructions and the one-step fit (K7, K8, K21, K22) on
    the card against the CPU, every input drawn once from one seed
    (``utils.tiny_cases``; cuFFT and K7/K8 round otherwise than the CPU,
    and the loops amplify it: 1e-3 of the largest value)."""
    from dexct_tpu_torch.ops.fourier import kb_sample_adjoint

    want = tiny_cases.iterative_2d(path, "cpu")
    before = kb_sample_adjoint.launches
    got = tiny_cases.iterative_2d(path, dev)
    assert kb_sample_adjoint.launches > before
    torch.testing.assert_close(
        got, want, rtol=0,
        atol=tiny_cases.ITERATIVE_TOL * float(want.abs().max()))


def test_onestep_gradient_cuda_matches_cpu(dev):
    """One gradient of the one-step objective through autograd (K7 and K8
    forward, K22 and K21 backward) on the card against the CPU: 1e-4 of
    its largest value, with no fitting loop to amplify rounding."""
    from dexct_tpu_torch.ops.fourier import (kb_sample_adjoint,
                                             resample_to_fan_adjoint)

    want = tiny_cases.onestep_gradient("cpu")
    before = (kb_sample_adjoint.launches, resample_to_fan_adjoint.launches)
    got = tiny_cases.onestep_gradient(dev)
    assert (kb_sample_adjoint.launches,
            resample_to_fan_adjoint.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert float(want.abs().max()) > 0.0
    torch.testing.assert_close(
        got, want, rtol=0,
        atol=tiny_cases.GRADIENT_TOL * float(want.abs().max()))


@pytest.mark.parametrize("kind", tiny_cases.DOSE_KINDS)
def test_dose_kernels_match_plain(dev, kind):
    """K23 (fan) and K24 (cone; helical with the z-slab window) against
    their plain versions: 1e-4 of the map's maximum, deposited energy rel
    1e-4."""
    from dexct_tpu_torch.ops import dose

    acc = dose._dose_accumulate if kind == "fan" else dose._dose_accumulate_3d
    before = acc.launches
    got = tiny_cases.dose(kind, dev)
    torch.cuda.synchronize()
    assert acc.launches > before
    want = tiny_cases.dose(kind, "cpu")
    assert np.abs(got.dose_mGy - want.dose_mGy).max() \
        <= tiny_cases.DOSE_TOL * want.dose_mGy.max()
    assert abs(got.deposited_J - want.deposited_J) \
        <= tiny_cases.DOSE_TOL * want.deposited_J


def _k24_args(dev, kind, n_materials=3):
    """K24's arguments for the tiny dose case ``kind`` on ``dev``; with
    more than three materials, its geometry through random labels of that
    many (K > 8 runs the kernel's MAXK = 16 instance)."""
    from dexct_tpu_torch.ops import dose
    from dexct_tpu_torch.physics import materials as m
    from dexct_tpu_torch.system import VoxelPhantom

    ph, ct, spec = tiny_cases.dose_inputs(kind)
    if n_materials > 3:
        mats = [m.AIR, m.WATER, m.BONE, m.TISSUE, m.MARROW, m.ADIPOSE,
                m.MUSCLE, m.BRAIN, m.CSF, m.LUNG, m.BLOOD, m.TITANIUM]
        lab = np.random.default_rng(24).integers(0, n_materials,
                                                 ph.labels.shape)
        ph = VoxelPhantom("k24", lab.astype(np.uint8),
                          m.MaterialTable(mats[:n_materials]), ph.dx, ph.dy,
                          ph.dz)
    args, _ = dose._dose_prep_3d(
        ph, ct, spec, n_gamma=None, n_t=None, n_r=None, oversample=2,
        views=None, n_energy=None, view_weights=None, scoring="removed",
        z_window="auto", device=dev)
    return list(args)


def _k24_against_plain(args, bitwise=True):
    """K24 and its plain twin on the same card tensors: the dose bit for
    bit (the same float32 operations per voxel and view, views added in
    order; else within DOSE_TOL of its maximum), the deposited energy
    within DOSE_TOL (the plain twin sums it in float32, K24 per thread in
    float64)."""
    from dexct_tpu_torch.ops import dose

    got, e = dose._dose_accumulate_3d(*args)
    want, ew = dose._dose_accumulate_3d_plain(*args)
    assert float(want.max()) > 0.0
    if bitwise:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(
            got, want, rtol=0,
            atol=tiny_cases.DOSE_TOL * float(want.max()))
    assert abs(e - ew) <= tiny_cases.DOSE_TOL * ew
    return got, e


@pytest.mark.parametrize("kind,n_materials,n_energies", [
    ("cone", 3, None), ("helical", 3, None), ("cone", 12, None),
    ("cone", 12, 700)])
def test_k24_equals_its_plain_twin_bit_for_bit(dev, kind, n_materials,
                                               n_energies):
    """K24 on the tiny cone and helical (z window) cases and with 12
    materials: one C call (all views fit one block), its dose bitwise its
    plain twin's on the card.  With 12 materials over 700 energies (random
    tables too large to share a patch block's 110 KB with T: the block
    takes the most shared memory) the plain twin's energy sum is a cuBLAS
    product whose order of terms is cuBLAS's choice: at 74-115 energies it
    equals K24's sequential sum bit for bit, at 700 it differs in the last
    bits, so DOSE_TOL there."""
    from dexct_tpu_torch.ops import dose

    args = _k24_args(dev, kind, n_materials)
    if n_energies:
        rng = np.random.default_rng(700)
        shape = (n_materials, n_energies)
        args[1], args[2] = (torch.as_tensor(rng.uniform(0.01, 1.0, shape),
                                            dtype=torch.float32, device=dev)
                            for _ in range(2))
        args[3] = torch.as_tensor(rng.uniform(0.0, 1e6, n_energies),
                                  dtype=torch.float32, device=dev)
    if kind == "helical":
        assert args[-1] is not None  # the z-slab window is on
    before = dose._dose_accumulate_3d.launches
    _k24_against_plain(args, bitwise=not n_energies)
    assert dose._dose_accumulate_3d.launches == before + 1


def test_k24_ragged_view_blocks(dev, monkeypatch):
    """A scratch of the label quads and five views' terms splits the tiny
    cone's 16 views into blocks of 5, 5, 5 and 1: four C calls, counted,
    and the same dose bit for bit (each call adds its views in order)."""
    from dexct_tpu_torch.ops import dose

    args = _k24_args(dev, "cone")
    whole, e_whole = dose._dose_accumulate_3d(*args)
    nz, ny, nx = args[0].shape
    n_slab = nz * ny * nx  # no z window: every slice
    quads = nz * (ny + 1) * (nx + 1) * 4
    monkeypatch.setattr(dose, "_SCRATCH_BYTES", quads + 5 * n_slab * 8)
    before = dose._dose_accumulate_3d.launches
    got, e = _k24_against_plain(args)
    assert dose._dose_accumulate_3d.launches == before + 4
    assert torch.equal(got, whole)
    assert abs(e - e_whole) <= 1e-12 * e_whole


def test_k24_slabs_at_the_volume_edges(dev):
    """The helix's views whose z slab starts at the volume's first slice
    or ends at its last: K24 bitwise its plain twin on those views."""
    from dexct_tpu_torch.ops import dose

    args = _k24_args(dev, "helical")
    nz = args[0].shape[0]
    k0s, depth = dose._z_slabs(args[5], args[8], args[9], args[10][0, 2],
                               torch.full((), float(args[13][3]),
                                          device=dev), nz, args[14])
    edge = (k0s == 0) | (k0s == nz - depth)
    assert bool((k0s == 0).any()) and bool((k0s == nz - depth).any())
    assert not bool(edge.all())  # the helix also has inner slabs
    for i in (4, 5, 6):  # betas, source z, view weights
        args[i] = args[i][edge].contiguous()
    _k24_against_plain(args)


def test_k24_makes_no_host_synchronisation(dev):
    """The 3-D dose wrapper's C calls make no synchronising call (scalar
    tensors filled on the card, grid steps read on the card); the whole
    call makes one, its final float64 sum."""
    import warnings

    from dexct_tpu_torch.ops import dose

    args = _k24_args(dev, "helical")
    dose._dose_accumulate_3d(*args)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, edep = dose._dose_3d_launch(*args)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert float(edep.sum()) > 0.0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            dose._dose_accumulate_3d(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    assert sum("synchroniz" in str(w.message) for w in seen) == 1


# sha1 of K23's dose and of its float64 slots on probe_dose2d's cases (the
# reference protocol's phase-3 calls and 1000-view maps of both spectra, a
# tube-current-modulated and an n_energy-compressed map, 12 random
# materials, a 45 x 37 phantom on a 100 x 77 grid, the tiny fan case),
# pinned from the build of K23 before its (voxel, view) terms (NVIDIA H100
# 80GB HBM3, CUDA 12.8); chip_smoke.py holds the same
K23_PINNED_SHA1 = {
    "ref_mv": ("e784053d5578a30847234f2ddcbb7e7f419383c8",
              "e090a6650ac22c84a0b256daa2abad9333a05f37"),
    "ref_80": ("ee66ace3b06d2f755abf47874edbf2e316818911",
              "0292b5afe7a5fd2e5600f87bdc6162d1b7739964"),
    "full_mv": ("8554d04073386a3fef1d07d37f1e01ae135a6df6",
               "34384006aa71433fba2a42bb6fda1e10e2cb5778"),
    "full_80": ("05665ced1e7cac633f233e4fad571bfe6872c0a1",
               "1809d70e5cc36e1c8c62e41d322e07f3aab9404c"),
    "tcm_80": ("7b0f6a2649fc89d48e7025ad9475d581b2dd3b3d",
              "58e4adb8ce6a47d835ae0cc89e1eb924ff45c538"),
    "ne16_80": ("17cbfd5a811ee8e5cb2031526c697b3a84241945",
               "6c23e7d89bba955553d78b1a3497bd46ec5e20e8"),
    "k12": ("9d50663ddbcef00d6253340452b154193f996349",
           "9c67d67ae8d1b44b69e2a78403c6ba550b3168ea"),
    "ragged": ("c6f5df5f613fc2469bb99207cd73d0b96522d72c",
              "d858b428eec0d77a6a5d5dc066aa8e57216a4ba6"),
    "tiny_fan": ("c2d53e8b0bae81d9b9b290b4de14239723b9c3a0",
                "fc1c510f9d6357705cd3621438e1ce824cb9b87d"),
}
# that build's C calls and deposited keV (the slots' sum) per case: where
# the calls moved, the slots group their float64 sums otherwise
K23_PINNED_ENERGY = {
    "ref_mv": (1, "16704601088485.309"),
    "ref_80": (1, "114253624593363.44"),
    "full_mv": (6, "167046272036222.12"),
    "full_80": (6, "1142542833138932.8"),
    "tcm_80": (1, "129425111530947.38"),
    "ne16_80": (1, "114249749375199.97"),
    "k12": (1, "1956009295958750.5"),
    "ragged": (1, "872841288869734.0"),
    "tiny_fan": (1, "615269373109021.5"),
}


@pytest.mark.parametrize("case", sorted(K23_PINNED_SHA1))
def test_k23_pinned_bits(dev, case):
    """K23's dose is its parent's bit for bit on every pinned case; its
    slots too where its C calls are the parent's, else their sum within
    1e-12 of the parent's."""
    from dexct_tpu_torch.ops import dose
    from dexct_tpu_torch.tools.probe_dose2d import output_sha1, pin_case

    args = pin_case(case, dev)
    before = dose._dose_accumulate.launches
    got, slots = dose._dose_2d_launch(*args)
    calls = dose._dose_accumulate.launches - before
    want_dose, want_slots = K23_PINNED_SHA1[case]
    parent_calls, keV = K23_PINNED_ENERGY[case]
    assert output_sha1(got) == want_dose
    if calls == parent_calls:
        assert output_sha1(slots) == want_slots
    assert abs(float(slots.sum()) - float(keV)) <= 1e-12 * float(keV)


def test_k23_makes_no_host_synchronisation(dev):
    """K23's C calls make no synchronising call (scalar tensors filled on
    the card, the grids' steps read on the card); the whole call makes one,
    its final float64 sum."""
    import warnings

    from dexct_tpu_torch.ops import dose
    from dexct_tpu_torch.tools.probe_dose2d import pin_case

    args = pin_case("tcm_80", dev)
    dose._dose_accumulate(*args)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, edep = dose._dose_2d_launch(*args)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert float(edep.sum()) > 0.0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            dose._dose_accumulate(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    assert sum("synchroniz" in str(w.message) for w in seen) == 1


def test_k23_blocked_calls_keep_the_dose(dev, monkeypatch):
    """A scratch of 26 views splits the 100-view 80 kV call into C calls
    of 26, 26, 26 and 22 views: four calls, counted, the pinned dose bit
    for bit (each call adds its views in order) and the deposited energy
    within 1e-12."""
    from dexct_tpu_torch.ops import dose
    from dexct_tpu_torch.tools.probe_dose2d import output_sha1, pin_case

    args = pin_case("ref_80", dev)
    ny, nx = args[0].shape
    K, n_g, n_r, n_vox = (args[1].shape[0], args[6].shape[0],
                          args[7].shape[0], args[8].shape[0])
    quads = (ny + 1) * (nx + 1) * 4
    per = n_vox * 8 + n_r * n_g * K * 4
    monkeypatch.setattr(dose, "_SCRATCH_BYTES", quads + 26 * per)
    assert dose._k23_blocks(100, n_vox, n_g, n_r, K, nx, ny) == 26
    before = dose._dose_accumulate.launches
    got, slots = dose._dose_2d_launch(*args)
    assert dose._dose_accumulate.launches == before + 4
    assert output_sha1(got) == K23_PINNED_SHA1["ref_80"][0]
    keV = float(K23_PINNED_ENERGY["ref_80"][1])
    assert abs(float(slots.sum()) - keV) <= 1e-12 * keV


def test_k23_maxk16_matches_plain(dev):
    """K23's MAXK = 16 instance (12 random materials) in one C call
    against its plain twin on the same card tensors: the dose within
    DOSE_TOL of its maximum (the twin's material sums are cuBLAS
    products), the deposited energy within DOSE_TOL."""
    from dexct_tpu_torch.ops import dose
    from dexct_tpu_torch.tools.probe_dose2d import pin_case

    args = pin_case("k12", dev)
    assert dose._max_k(args[1].shape[0]) == 16
    before = dose._dose_accumulate.launches
    got, e = dose._dose_accumulate(*args)
    assert dose._dose_accumulate.launches == before + 1
    want, ew = dose._dose_accumulate_plain(*args)
    assert float(want.max()) > 0.0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=tiny_cases.DOSE_TOL * float(want.max()))
    assert abs(e - ew) <= tiny_cases.DOSE_TOL * ew


@pytest.mark.parametrize("n_fields", [1, 3])
def test_fan_backproject_var_matches_plain(dev, n_fields):
    """K25 against its plain version on random variance fields of 96
    views x 64 channels: 1e-5 of the plain map's maximum (float32 sums
    over views in another order)."""
    from dexct_tpu_torch.ops import noisemap

    rng = np.random.default_rng(25)
    r0 = torch.as_tensor(rng.uniform(0.5, 2.0, (n_fields, 96, 64)),
                         dtype=torch.float32, device=dev)
    r1 = torch.as_tensor(rng.uniform(-0.5, 0.5, (n_fields, 96, 64)),
                         dtype=torch.float32, device=dev)
    betas = torch.linspace(0.0, 2 * np.pi, 97, device=dev)[:96]
    args = (r0, r1, betas, 60.0, 0.9 / 64, 40, 20.0)
    before = noisemap._fan_backproject_var.launches
    got = noisemap._fan_backproject_var(*args)
    assert noisemap._fan_backproject_var.launches == before + 1
    want = noisemap._fan_backproject_var_plain(*args, 2 * np.pi / 96)
    assert float(want.abs().max()) > 0.0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_noise_maps_cuda_match_cpu(dev):
    """The tiny noise maps (``utils.tiny_cases``: K1, K2, K3 and K25 with
    one and three fields) on the card against the CPU: 1e-4 of each map's
    maximum."""
    from dexct_tpu_torch.ops import noisemap

    before = noisemap._fan_backproject_var.launches
    got = tiny_cases.noise_maps(dev)
    assert noisemap._fan_backproject_var.launches == before + 2
    want = tiny_cases.noise_maps("cpu")
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0.0
        torch.testing.assert_close(
            g, w, rtol=0, atol=tiny_cases.NOISE_TOL * float(w.abs().max()))


def test_numpy_inputs_run_on_the_card(dev):
    """The scatter model and the VMI map given NumPy arrays and no
    ``device`` run on the card, and agree with the CPU within 1e-5
    relative (float32 correlations summed in another order)."""
    from dexct_tpu_torch.ops import noisemap, scatter

    rng = np.random.default_rng(8)
    p = rng.uniform(50.0, 900.0, (6, 32)).astype(np.float32)
    air = np.full(32, 1000.0, np.float32)
    k = scatter.scatter_kernel(32, sigma_ch=8.0)
    meas = scatter.add_scatter(p, air, k, spr=0.25)
    assert meas.device.type == "cuda"
    m_cpu = scatter.add_scatter(p, air, k, spr=0.25, device="cpu")
    torch.testing.assert_close(meas.cpu(), m_cpu, rtol=1e-5, atol=0)
    fixed = scatter.correct_scatter(m_cpu.numpy(), air, k, spr=0.25)
    assert fixed.device.type == "cuda"
    torch.testing.assert_close(
        fixed.cpu(), scatter.correct_scatter(m_cpu, air, k, spr=0.25),
        rtol=1e-5, atol=0)
    assert abs(scatter.scatter_fraction(m_cpu.numpy(), p, 0.95)
               - scatter.scatter_fraction(m_cpu, torch.as_tensor(p),
                                          0.95)) < 1e-5
    maps = [rng.uniform(0.5, 2.0, (8, 8)).astype(np.float32)
            for _ in range(3)]
    vmi = noisemap.vmi_variance_map(*maps, 70.0)
    assert vmi.device.type == "cuda"
    torch.testing.assert_close(
        vmi.cpu(), noisemap.vmi_variance_map(*maps, 70.0, device="cpu"),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", tiny_cases.SCATTER_KINDS)
def test_scatter_kernels_match_plain(dev, kind):
    """K26 (fan, with and without the Rayleigh term) and K27 (cone) against
    their plain versions on the CPU: 1e-4 of the sinogram's maximum; the
    kernel repeats bitwise (its block sums have a fixed order)."""
    from dexct_tpu_torch.ops import scatter_physics as sp

    scan = sp._scatter_scan_cone if kind == "cone" else sp._scatter_scan
    before = scan.launches
    got = tiny_cases.scatter(kind, dev)
    assert scan.launches == before + 1
    assert np.array_equal(tiny_cases.scatter(kind, dev), got)
    want = tiny_cases.scatter(kind, "cpu")
    assert want.max() > 0.0
    assert np.abs(got - want).max() <= tiny_cases.SCATTER_TOL * want.max()


def test_cone_scatter_one_row_is_the_fan(dev):
    """The N_rows = 1 anchor on the card: K27 on a one-row cone through a
    z-extruded cylinder against K26 on its central slice, within the JAX
    test's 5 % median (3-D vertices sample the slab at +-h/2, the fan at
    its mid-plane)."""
    from dexct_tpu_torch.ops import scatter_physics as sp
    from dexct_tpu_torch.physics import Spectrum
    from dexct_tpu_torch.system import ConeBeamGeometry, FanBeamGeometry

    ph3 = tiny_cases._three_materials(16)
    ph2 = tiny_cases._three_materials()
    kw = dict(N_channels=32, N_proj=4, gamma_fan=0.9, SID=60.0, SDD=100.0,
              h_iso=0.5, eid=True)
    spec = Spectrum(np.array([60.0]), np.array([1e6]), "mono60")
    v = np.array([0.0])
    s3 = sp.single_scatter_conebeam(ph3, ConeBeamGeometry(N_rows=1, **kw),
                                    spec, coarse=2, n_energy=1,
                                    channel_sub=1, row_sub=1, views=v,
                                    device=dev)[0, 0]
    s2 = sp.single_scatter_sinogram(ph2, FanBeamGeometry(**kw), spec,
                                    coarse=2, n_energy=1, views=v,
                                    device=dev)[0]
    sel = s2 > 0.2 * s2.max()
    assert np.median(np.abs(s3[sel] - s2[sel]) / s2[sel]) < 0.05


def _k3_golden_case():
    """A fixed K3 case: 4096 pixels of two basis materials under the tiny
    cases' linac / 80 kV pair, 50 iterations
    (``probe_gauss_newton.golden_case``)."""
    from dexct_tpu_torch.tools.probe_gauss_newton import golden_case

    return golden_case()


@pytest.mark.parametrize("layout", ["bowtie", "heel", "one_row"])
@pytest.mark.parametrize("with_t2", [False, True])
def test_table_counts_matches_plain(dev, layout, with_t2):
    """K28 in both table modes (a per-channel table, stride 1; a per-row
    table, stride C) against its plain twin, and with a one-row table
    against K2 on the same rays (its table is K2's fluence), rel 1e-5."""
    from dexct_tpu_torch.ops.spectral import (counts_from_table,
                                              counts_from_table_plain)

    rng = np.random.default_rng(30)
    V, R, C, M, E = 7, 5, 96, 6, 141
    paths = torch.as_tensor(rng.uniform(-0.2, 5, (V, R, C, M)),
                            dtype=torch.float32, device=dev)
    mu = torch.as_tensor(rng.uniform(0.01, 2.0, (M, E)), dtype=torch.float32,
                         device=dev)
    n_rows, stride = {"bowtie": (C, 1), "heel": (R, C),
                      "one_row": (1, 1)}[layout]
    tab = torch.as_tensor(rng.uniform(0, 1e6, (n_rows, E)),
                          dtype=torch.float32, device=dev)
    tab2 = tab * 60.0 if with_t2 else None
    before = counts_from_table.launches
    got = counts_from_table(paths, mu, tab, tab2, stride=stride)
    torch.cuda.synchronize()
    assert counts_from_table.launches == before + 1
    got = got if with_t2 else (got,)
    want = [counts_from_table_plain(paths, mu, t, stride=stride)
            for t in (tab, tab2) if t is not None]
    for g, w in zip(got, want):
        assert g.shape == (V, R, C)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
    if layout == "one_row":
        k2 = counts_from_paths(paths, mu, tab[0])
        torch.testing.assert_close(got[0], k2, rtol=1e-6, atol=0)


@pytest.mark.parametrize("grouping", ["bowtie", "heel"])
def test_gauss_newton_grouped_matches_plain(dev, grouping):
    """K29 against its plain twin (``gauss_newton_solve`` per group) on
    bowtie thickness groups of uneven size and on detector rows, each
    pixel's counts made with its own group's table (as an acquisition
    makes them), at K3's bar (1e-4 of max(|a|, 1))."""
    from dexct_tpu_torch.ops.matdecomp import (
        gauss_newton_solve_grouped, gauss_newton_solve_grouped_plain)

    _, i0, mus = _k3_golden_case()
    rng = np.random.default_rng(31)
    if grouping == "bowtie":
        group = np.minimum(rng.geometric(0.3, 4096) - 1, 9)
        G = 10
    else:
        group = np.arange(4096) // 256 % 16  # 16 rows of 256 channels
        G = 16
    i0_g = i0[None] * np.exp(-np.linspace(0, 3, G)[:, None, None]
                             * rng.uniform(0.2, 1.0, (1, 1, i0.shape[1])))
    a = np.stack([rng.uniform(0, 40, 4096), rng.uniform(0, 6, 4096)], -1)
    atten = np.exp(-a @ mus.astype(np.float64))  # [P, E]
    counts = np.einsum("pe,pme->mp", atten, i0_g[group]).astype(np.float32)
    args = [torch.as_tensor(x, device=dev) for x in
            (counts, group, i0_g.astype(np.float32), mus)]
    before = gauss_newton_solve_grouped.launches
    got = gauss_newton_solve_grouped(*args, n_iters=50)
    torch.cuda.synchronize()
    assert gauss_newton_solve_grouped.launches == before + 1
    want = gauss_newton_solve_grouped_plain(*args, n_iters=50)
    err = (got - want).abs() / torch.clamp_min(want.abs(), 1.0)
    assert float(err.max()) < 1e-4


def test_k29_one_group_is_k3_bit_for_bit(dev):
    """K29 and K3 share the per-pixel body and the tables: one group over
    all pixels gives K3's result bit for bit."""
    from dexct_tpu_torch.ops.matdecomp import gauss_newton_solve_grouped

    counts, i0, mus = (torch.as_tensor(x, device=dev)
                       for x in _k3_golden_case())
    k3 = gauss_newton_solve(counts, i0, mus, n_iters=50)
    one = gauss_newton_solve_grouped(
        counts, torch.zeros(counts.shape[1], dtype=torch.int64, device=dev),
        i0[None], mus, n_iters=50)
    assert torch.equal(one, k3)


# sha1 of K3's output on _k3_golden_case from the build of K3's source
# before K29 came to share its per-pixel body (NVIDIA H100 80GB HBM3,
# CUDA 12.8): the refactor left K3 bit for bit as it was
K3_GOLDEN_SHA1 = "ab01dea7e520a0199077119cd1b3db9294a9e1a9"


def test_k3_output_is_unchanged(dev):
    import hashlib

    counts, i0, mus = (torch.as_tensor(x, device=dev)
                       for x in _k3_golden_case())
    out = gauss_newton_solve(counts, i0, mus, n_iters=50).cpu().numpy()
    assert hashlib.sha1(out.tobytes()).hexdigest() == K3_GOLDEN_SHA1


# sha1 of K3's output on the cases of probe_gauss_newton.PIN_CASES (the
# exact path's 8e5 counts, the cone config's 1.47M and the helical
# config's 2.95M, each made by the port's K1 or K10 and K2; the golden
# case repeated and cut to 1, 127, 129, 384 and 4097 pixels), from the
# build of K3 before it solved several pixels a thread (NVIDIA H100 80GB
# HBM3, CUDA 12.8).  The path cases also pin K1's, K10's and K2's bits.
K3_PINNED_SHA1 = {"exact": "7d2e546bd280d86794f574d9198eb17db7364b8e",
                  "cone": "4c998d7358357825a955890223880b265030a743",
                  "helical": "c8f47a9e91f23f0d03babe7ec21deae9e9912095",
                  "n1": "75af3f7b2b0d2942233ec12b53c8e959dbb74082",
                  "n127": "e18b80b7c5f0fdf5c9244b52948688bc3daa9f37",
                  "n129": "cc18c46bb359a7c9a39ad8d8dfcf8c56c1a1bd2c",
                  "n384": "2d1d59438785ec1e2993528c07b841cb0b7bb4fa",
                  "n4097": "0dbaa8907887639190140cba8948506e2209bf88"}


@pytest.mark.parametrize("case", list(K3_PINNED_SHA1))
def test_k3_keeps_its_pinned_bits(dev, case):
    """K3 gives the first K3's output bit for bit at the paths' shapes and
    at pixel counts ragged against its groups of pixels, in one launch."""
    from dexct_tpu_torch.tools.probe_gauss_newton import (output_sha1,
                                                          pin_case)

    counts, i0, mus, kw = pin_case(case, dev)
    before = gauss_newton_solve.launches
    out = gauss_newton_solve(counts, i0, mus, **kw)
    torch.cuda.synchronize()
    assert gauss_newton_solve.launches == before + 1
    assert out.shape == (counts.shape[1], 2)
    assert output_sha1(out) == K3_PINNED_SHA1[case]


@pytest.mark.parametrize("case", ["n4097", "exact"])
def test_k3_two_launches_are_equal(dev, case):
    from dexct_tpu_torch.tools.probe_gauss_newton import pin_case

    counts, i0, mus, kw = pin_case(case, dev)
    assert torch.equal(gauss_newton_solve(counts, i0, mus, **kw),
                       gauss_newton_solve(counts, i0, mus, **kw))


@pytest.mark.parametrize("kind", tiny_cases.REALISM_KINDS)
def test_realism_paths_cuda_match_cpu(dev, kind):
    got = tiny_cases.realism(kind, dev)
    want = tiny_cases.realism(kind, "cpu")
    for g, w in zip(got, want):
        big = float(w.abs().max())
        assert float((g - w).abs().max()) <= tiny_cases.REALISM_TOL * big


def test_realism_numpy_inputs_run_on_the_card(dev):
    """The realism entry points given NumPy arrays and no ``device`` run on
    the card and agree with the CPU (the MTF blur 1e-5 relative: float32
    correlations summed in another order)."""
    from dexct_tpu_torch.ops import afterglow, mtf, rings
    from dexct_tpu_torch.pipeline.tcm import normalize_counts
    from dexct_tpu_torch.physics import pileup

    rng = np.random.default_rng(33)
    x = rng.uniform(1e3, 1e5, (16, 40)).astype(np.float32)
    k = np.array([0.2, 0.6, 0.2], np.float32)
    for fn in (lambda d: mtf.apply_detector_mtf(x, k, device=d),
               lambda d: afterglow.apply_afterglow(x, [0.1], [0.5],
                                                   device=d),
               lambda d: rings.ring_correct_sinogram(np.log(x), device=d),
               lambda d: pileup.recorded_rate(1e-6 * x, device=d),
               lambda d: normalize_counts(x, np.linspace(0.5, 2, 16),
                                          device=d)):
        on_card = fn(None)
        assert on_card.device.type == "cuda"
        torch.testing.assert_close(on_card.cpu(), fn("cpu"), rtol=1e-5,
                                   atol=0)


# --- K30-K33: motion-compensated and gated backprojections ---------------

def _k4_golden_case():
    """Two filtered sinograms [2, 180, 96] from a fixed seed and 180 view
    angles over one turn: the K4 case whose output sha1 is pinned."""
    rng = np.random.default_rng(41)
    q = rng.normal(size=(2, 180, 96)).astype(np.float32)
    betas = (np.arange(180) * (2 * np.pi / 180)).astype(np.float32)
    return q, betas


# the args after (packed, n_images, betas) of the K4 golden call
K4_GOLDEN_ARGS = (60.0, 0.8230337 / 96, 96, 64, 24.0, 2 * np.pi / 180)
# sha1 of K4's output on _k4_golden_case from the build of K4's source
# before K30 and K31 joined it in csrc/fan_backproject.cu (NVIDIA H100
# 80GB HBM3, CUDA 12.8)
K4_GOLDEN_SHA1 = "7be906e3dce180a70cd456ee0bdc2b6ff4b230d7"


def test_k4_output_is_unchanged(dev):
    import hashlib

    from dexct_tpu_torch.ops.fbp_fast import pack_filtered

    q, betas = (torch.as_tensor(x, device=dev) for x in _k4_golden_case())
    out = fan_backproject_multi(pack_filtered(q), 2, betas,
                                *K4_GOLDEN_ARGS).cpu().numpy()
    assert hashlib.sha1(out.tobytes()).hexdigest() == K4_GOLDEN_SHA1


# sha1 of K4's output on the cases of probe_fan_backproject.PIN_CASES (the
# exact path's 1000 x 800 -> 512^2 at K = 1, 3 and 4, and a ragged 70^2
# image over 90 x 96), from the build of K4 before its 16-byte loads and
# compact warp tiles (NVIDIA H100 80GB HBM3, CUDA 12.8)
K4_PINNED_SHA1 = {"k1": "0f69aa9b54f67a29a5037658f00a1b8485a1acc2",
                  "k3": "85778dafe38e3ddef2d7fd4c93ce4403dc6bc66f",
                  "k4": "34d550b204cddb6b868c1dfa4a03dfa63b95c4ec",
                  "ragged": "d4aea1441d62e45a8eb00d95c357d31abeee7bbf"}


def _k4_pin_call(dev, case):
    from dexct_tpu_torch.ops.fbp_fast import pack_filtered
    from dexct_tpu_torch.tools.probe_fan_backproject import pin_case

    q, betas, args = pin_case(case)
    packed = pack_filtered(torch.as_tensor(q, device=dev))
    b = torch.as_tensor(betas, device=dev)
    return lambda: fan_backproject_multi(packed, q.shape[0], b, *args)


@pytest.mark.parametrize("case", sorted(K4_PINNED_SHA1))
def test_k4_keeps_its_pinned_bits(dev, case):
    from dexct_tpu_torch.tools.probe_fan_backproject import output_sha1

    before = fan_backproject_multi.launches
    out = _k4_pin_call(dev, case)()
    torch.cuda.synchronize()
    assert fan_backproject_multi.launches == before + 1
    assert output_sha1(out) == K4_PINNED_SHA1[case]


@pytest.mark.parametrize("case", ["k4", "ragged"])
def test_k4_two_launches_are_equal(dev, case):
    call = _k4_pin_call(dev, case)
    assert torch.equal(call(), call())


def test_k4_makes_no_host_synchronisation(dev):
    _no_sync(_k4_pin_call(dev, "ragged"))


# sha1 of K6's output on the cases of probe_parallel_backproject.PIN_CASES
# (the default path's 512 x 1024 grid at K = 4 and 1, the FFS grid 500 x
# 1600 at K = 1, the parallel-beam 1000 x 800 at K = 1, the sweep's 512 x
# 1600 at K = 4, the default grid at K = 2 and 3, a 257^2 image from 90 x
# 96 bins, a 500^2 image, no FOV mask on 257^2, and 1100 views), from the
# build of K6 before its vector loads and compact warp tiles (NVIDIA H100
# 80GB HBM3, CUDA 12.8)
K6_PINNED_SHA1 = {"default": "8a1058eb650489d9d040e6f9257e87ec88b62082",
                  "default_k1": "0d11365c64318c7ba9e3ae4778dd7f283000a071",
                  "ffs": "a93e13097a6352640e421cfc1c743951fad6fde4",
                  "parallel": "d5296a02f23d4419304937f4999675dd1a278fe0",
                  "sweep": "dcbfffb2a56246d08ce5cae1e7cbba5b7b633994",
                  "k2": "c5130ccfafebd209c4df73fc262355086353f4a7",
                  "k3": "45f66895e70d1c79f9c050292ad0cfe429d1f409",
                  "n257": "1410b9f39f81cf8520f1293d3c95e4dd699f1192",
                  "n500": "77df4fa36c3d9f6ac381dd0d62eaf0c507e54c11",
                  "nomask": "d207ca246ded4c9c415649daa1f5fd73c1537644",
                  "views1100": "74bcdbc1934705a819c0ee128b46bef4d6f0fad9"}


@pytest.mark.parametrize("case", sorted(K6_PINNED_SHA1))
def test_k6_keeps_its_pinned_bits(dev, case):
    from dexct_tpu_torch.ops import fbp_fast
    from dexct_tpu_torch.tools.probe_parallel_backproject import (
        k6_call, output_sha1)

    before = parallel_backproject_multi.launches
    out = k6_call(fbp_fast, case, dev)()
    torch.cuda.synchronize()
    assert parallel_backproject_multi.launches == before + 1
    assert output_sha1(out) == K6_PINNED_SHA1[case]


@pytest.mark.parametrize("case", ["default", "n257", "views1100"])
def test_k6_two_launches_are_equal(dev, case):
    from dexct_tpu_torch.ops import fbp_fast
    from dexct_tpu_torch.tools.probe_parallel_backproject import k6_call

    call = k6_call(fbp_fast, case, dev)
    assert torch.equal(call(), call())


# sha1 of K10's output on the cases of probe_siddon_trace_3d.PIN_CASES (the
# cone, helical, flat-panel, tilted, z-FFS, motion_3d and K-edge rays
# through the pelvis; a 12 x 40 x 40 grid, rays along each axis, rays that
# miss, 1, 33 and 1001 rays, labels up to 255, 1, 8, 9 and 32 materials),
# from the build of K10 before it took K18's 32-bit walk and kept its sums
# in shared memory (NVIDIA H100 80GB HBM3, CUDA 12.8); chip_smoke.py holds
# the same
K10_PINNED_SHA1 = {"cone": "7031af51f51aedf0de2ba9db78379d4f9c4b1275",
                   "helical": "10663141f41bc05a2545fcef5f03cccc91818f03",
                   "flat": "1da179aeb4fdaa30b41c46aad1a35cbac9fb3227",
                   "tilted": "ff28c24268b538d31188ab6f05f9e21546b20006",
                   "zffs": "b257a7431ea94c1715cc98695ebf6aa764045873",
                   "motion_3d": "539c12aa492aca26968eda3501aeccf87fb1535b",
                   "kedge": "9472efdef71b2686aa8c94189b3aff7f8035c00a",
                   "tiny": "4faca69c156f371b5b3bf867ef99addc2052467f",
                   "axis_x": "56ab3bf49f5db9ff8dfeeb09b46bbd38741e503d",
                   "axis_y": "759930cd452519a2d2ac4c144ab6c4b801a7a28e",
                   "axis_z": "178e482297d2004f2167483ffcf8bba6e1248dfb",
                   "miss": "d31282669ed88d352b198c0afbd7a7dd53f6119c",
                   "r1": "37c19cb51cea43a8b6a922413b0014cc73474a03",
                   "r33": "e57435c182fd44a1f2b72704d0908767c0be9568",
                   "r1001": "e1bb126027a4f6e286b79d26170be39e2cab4020",
                   "labels_past": "c216b9ae0eb97299c9cbcb0561546fe2295a7978",
                   "m1": "6fab5153bf3c10f3406f4fd1f09c26aa3f743da5",
                   "m8": "7832f9824f90ea62d403d6e4001da641573928a9",
                   "m9": "8eba7ae0501539bdd28c2ca8cc1419661f24a8d5",
                   "m32": "eb4d71802c43b43eedcba1f8b883582a351df6a3"}


@pytest.mark.parametrize("case", list(K10_PINNED_SHA1))
def test_k10_keeps_its_pinned_bits(dev, case):
    """K10 gives the first K10's output bit for bit on the paths' rays and
    on the ragged cases, in one launch."""
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.tools.probe_siddon_trace_3d import (k10_call,
                                                             output_sha1,
                                                             pin_case)

    args = pin_case(case, dev)
    before = conebeam.trace_paths_3d.launches
    out = k10_call(conebeam, args)()
    torch.cuda.synchronize()
    assert conebeam.trace_paths_3d.launches == before + 1
    assert out.shape == (*args[1].shape[:-1], args[4])
    assert output_sha1(out) == K10_PINNED_SHA1[case]


@pytest.mark.parametrize("case", ["helical", "r1001", "m32"])
def test_k10_two_launches_are_equal(dev, case):
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.tools.probe_siddon_trace_3d import k10_call, pin_case

    call = k10_call(conebeam, pin_case(case, dev))
    assert torch.equal(call(), call())


# sha1 of K12's output on the cases of probe_cone_backproject.PIN_CASES
# (the helical config's seeded stacks in each of the six weightings at K =
# 4 and in `full` at K = 1, 2, 3; the z flying focal spot's call at pitch
# 0 with its row offsets; a 37^2 grid of 1085 disc pixels with one slice
# whose window runs off both ends of a 50-view helix, in each weighting,
# and 7 slices over two turns with random row offsets), from the build of
# K12 before it formed each (pixel, view)'s in-plane geometry once for a
# group of slices and read packed taps (NVIDIA H100 80GB HBM3, CUDA 12.8);
# chip_smoke.py holds the same
K12_PINNED_SHA1 = {
    "helical_full": "f8cbc7de45238c970779fb93d32b9bad07bb3558",
    "helical_feather": "ae142534b059cb049af71b59ac65d9943b8c7b94",
    "helical_td": "eed052dbc259b55b3f24c35278c83069e1c57454",
    "helical_cosz": "0aa97bfd29efc2bb8a5f11bcfc3c752f37f8e03c",
    "helical_short": "c43d03147773c79913db52934093572707ff11aa",
    "helical_pair": "c53f9fd5f8517557dba28002944e3dfa3c8b7937",
    "zffs": "92e0a1b7f66df7f0cfd0e5b97bfa4d9265edcc28",
    "k1": "e30c9a823e2bfb4dbd5c7ae605e5973445e54578",
    "k2": "da7d1d651df4300385e67e12ab4596d2feba360c",
    "k3": "819d64d98442e2c14864b84ae7a2f58c3f1abb55",
    "ragged_full": "60cce521c93173c7d83e720e9a74e586ce759070",
    "ragged_feather": "7cc0bc54700d4c9566d4cb6a9141ff5bfae36594",
    "ragged_td": "fa43c7afc850540ca7df501fff950108afe8e108",
    "ragged_cosz": "d093d98e3e8dd0919d295aeb7924947cfa0b083a",
    "ragged_short": "d5f687fccd0f4274073bf302b83c4e07973b0eb2",
    "ragged_pair": "535623a493b751249c100293f9d01532973fa4a8",
    "ragged_nz7": "eab1da458b69463270924c7e79f4621d56d60162"}


@pytest.mark.parametrize("case", list(K12_PINNED_SHA1))
def test_k12_keeps_its_pinned_bits(dev, case):
    """K12 gives the first K12's output bit for bit on the paths' shapes
    and on the ragged cases, in one launch."""
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.tools.probe_cone_backproject import (k12_call,
                                                              output_sha1,
                                                              pin_case)

    args = pin_case(case, dev)
    before = conebeam._helical_backproject.launches
    out = k12_call(conebeam, args)()
    torch.cuda.synchronize()
    assert conebeam._helical_backproject.launches == before + 1
    assert out.shape == (args[0].shape[0], args[1][10], args[1][9],
                         args[1][9])
    assert output_sha1(out) == K12_PINNED_SHA1[case]


@pytest.mark.parametrize("case", ["helical_pair", "k3", "ragged_short",
                                  "ragged_nz7"])
def test_k12_two_launches_are_equal(dev, case):
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.tools.probe_cone_backproject import (k12_call,
                                                              pin_case)

    call = k12_call(conebeam, pin_case(case, dev))
    assert torch.equal(call(), call())


@pytest.mark.parametrize("path", ["cone_reconstruct_stack",
                                  "helical_fdk_reconstruct", "zffs_fdk"])
def test_k12_makes_no_host_synchronisation(dev, path):
    """K12's wrapper reads betas[0] on the card: the fused step's helical
    reconstruction, ``helical_fdk_reconstruct`` and the z flying focal
    spot's ``fdk_reconstruct`` launch K12 with no synchronisation of the
    host with the card."""
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.physics import kramers_spectrum
    from dexct_tpu_torch.pipeline import cone
    from dexct_tpu_torch.system import (ConeBeamGeometry,
                                        HelicalConeBeamGeometry,
                                        water_cylinder_phantom)

    det = dict(N_channels=32, N_rows=4, gamma_fan=0.8230337, SID=60.0,
               SDD=100.0, h_iso=0.5)
    helix = HelicalConeBeamGeometry(N_proj=48, pitch=2.0,
                                    rotation_total=4.0 * np.pi, **det)
    rng = np.random.default_rng(27)
    sino = torch.as_tensor(rng.random((4, 48, 4, 32), np.float32),
                           device=dev)
    if path == "cone_reconstruct_stack":
        import dataclasses

        ph2 = water_cylinder_phantom(N=32, dx=0.6)
        ph = dataclasses.replace(ph2, labels=np.broadcast_to(
            ph2.labels[0], (8, 32, 32)).copy(), dz=0.5)
        spec = kramers_spectrum(80.0)
        a, meta = cone.pack_cone_dect(helix, ph, spec, spec, 32, 18.0, 0.8,
                                      device=dev, weighting="pair")

        def call():
            return cone.cone_reconstruct_stack(sino, a, meta)
    elif path == "helical_fdk_reconstruct":
        def call():
            return conebeam.helical_fdk_reconstruct(sino, helix, 32, 18.0,
                                                    0.8, weighting="td")
    else:
        ring = ConeBeamGeometry(N_proj=24, ffs="z", **det)
        flat = sino[:, :24].contiguous()

        def call():
            return conebeam.fdk_reconstruct(flat, ring, 32, 18.0, 0.8)
    before = conebeam._helical_backproject.launches
    _no_sync(call)
    assert conebeam._helical_backproject.launches == before + 2


# sha1 of K11's output on the cases of probe_cone_backproject.K11_PIN_CASES
# (the cone config's seeded stacks at K = 4, 1, 2, 3 onto 256^2 x 16; the
# tilted path's gantry grid, 258^2 x 60; cone_pwls's warm-start grid,
# 256^2 x 32 at K = 1; a 600-view orbit onto a 37^2 grid of 1085 disc
# pixels, 5 slices centred off z = 0 at K = 2 and 7 centred on it at K =
# 3), from the build of K11 before it formed each (pixel, view)'s in-plane
# geometry once for a group of slices and read packed taps (NVIDIA H100
# 80GB HBM3, CUDA 12.8); chip_smoke.py holds the same
K11_PINNED_SHA1 = {
    "cone": "fbe4f1abb08b99dbce175ae58898bb2ea33ea403",
    "k1": "021557d4b0adefebf68bf4a60fd812b9d3f9e867",
    "k2": "fe596192aa1a825019b3317bc040c238a6c8c972",
    "k3": "7d6826cc0148b4302d0148ee6039bd481e3f21bc",
    "tilted": "584cf38c60d7e092c3d4ce37ee39f198dfad7bca",
    "warm": "d32558d125da0ff77abf4d838ecbdbe14ff75b83",
    "ragged": "c30fb5b79f76c8ae0264645d9789efa5df9e62d7",
    "ragged_odd": "be7ddb5c201e8d6a53eda6ee5c9ba24edd40e221"}


@pytest.mark.parametrize("case", list(K11_PINNED_SHA1))
def test_k11_keeps_its_pinned_bits(dev, case):
    """K11 gives its parent's output bit for bit on the paths' shapes and on
    the ragged cases, in one launch."""
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.tools.probe_cone_backproject import (k11_call,
                                                              k11_case,
                                                              output_sha1)

    q, args = k11_case(case, dev)
    before = conebeam._fdk_backproject_multi.launches
    out = k11_call(conebeam, (q, args))()
    torch.cuda.synchronize()
    assert conebeam._fdk_backproject_multi.launches == before + 1
    assert out.shape == (q.shape[0], args[6], args[5], args[5])
    assert output_sha1(out) == K11_PINNED_SHA1[case]


@pytest.mark.parametrize("case", list(K11_PINNED_SHA1))
def test_k11_two_launches_are_equal(dev, case):
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.tools.probe_cone_backproject import (k11_call,
                                                              k11_case)

    call = k11_call(conebeam, k11_case(case, dev))
    assert torch.equal(call(), call())


@pytest.mark.parametrize("path", ["cone_reconstruct_stack", "fdk_reconstruct",
                                  "fdk_tilted_reconstruct"])
def test_k11_makes_no_host_synchronisation(dev, path):
    """K11's wrapper packs the stacks and reads its disc grid from the
    card: the fused step's circular reconstruction, ``fdk_reconstruct`` and
    the tilted FDK launch K11 with no synchronisation of the host with the
    card."""
    import dataclasses

    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.physics import kramers_spectrum
    from dexct_tpu_torch.pipeline import cone
    from dexct_tpu_torch.system import (ConeBeamGeometry,
                                        TiltedConeBeamGeometry,
                                        water_cylinder_phantom)

    det = dict(N_channels=32, N_proj=24, N_rows=4, gamma_fan=0.8230337,
               SID=60.0, SDD=100.0, h_iso=0.5)
    ring = ConeBeamGeometry(**det)
    rng = np.random.default_rng(28)
    sino = torch.as_tensor(rng.random((4, 24, 4, 32), np.float32),
                           device=dev)
    if path == "cone_reconstruct_stack":
        ph2 = water_cylinder_phantom(N=32, dx=0.6)
        ph = dataclasses.replace(ph2, labels=np.broadcast_to(
            ph2.labels[0], (8, 32, 32)).copy(), dz=0.5)
        spec = kramers_spectrum(80.0)
        a, meta = cone.pack_cone_dect(ring, ph, spec, spec, 32, 18.0, 0.8,
                                      device=dev)

        def call():
            return cone.cone_reconstruct_stack(sino, a, meta)
    elif path == "fdk_reconstruct":
        def call():
            return conebeam.fdk_reconstruct(sino, ring, 32, 18.0, 0.8)
    else:
        tilted = TiltedConeBeamGeometry(tilt=0.2, **det)

        def call():
            return conebeam.fdk_tilted_reconstruct(sino, tilted, 32, 18.0,
                                                   0.8)
    before = conebeam._fdk_backproject_multi.launches
    _no_sync(call)
    assert conebeam._fdk_backproject_multi.launches == before + 2


# sha1 of K32's and K33's output on probe_cone_backproject.MOTION_PIN_CASES
# (seeded stacks under seeded rigid poses: the cone config at K = 4, the
# helical config's 19 slices at K = 4, a 120-view helix onto 37^2 x 7 at K
# = 3), from their build before K33 read betas[0] on the card (NVIDIA H100
# 80GB HBM3, CUDA 12.8); chip_smoke.py holds the same
MOTION_PINNED_SHA1 = {
    "k32_cone": "54f460b3e401ffc3b372f8700ec77dae9b8cc45a",
    "k33_helical": "55ba9cc87bf45d2c77cdbc2a9609ccf1735663d3",
    "k33_ragged": "4c7223f78cef2cc2f2684744a7c3e9975d9048bb"}


@pytest.mark.parametrize("case", list(MOTION_PINNED_SHA1))
def test_motion_backprojectors_keep_their_pinned_bits(dev, case):
    """K32 and K33, which share K11's tap functions, give their pinned
    output bit for bit, and twice the same."""
    from dexct_tpu_torch.ops import motion
    from dexct_tpu_torch.tools.probe_cone_backproject import (motion_call,
                                                              motion_case,
                                                              output_sha1)

    case_ = motion_case(case, dev)
    launches = getattr(motion, case_[0])
    before = launches.launches
    call = motion_call(motion, case_)
    out = call()
    torch.cuda.synchronize()
    assert launches.launches == before + 1
    assert output_sha1(out) == MOTION_PINNED_SHA1[case]
    assert torch.equal(out, call())


# the calls of the motion backprojectors' paths that still synchronise,
# each named by the innermost function of the port that makes it: K33's
# view spacing, uniformity check and window reach are host figures, so
# view angles or displacements given only on the card are read back once
MOTION_SYNCS = {"helical_card_tensors": {
    "dexct_tpu_torch/ops/motion.py:_host_f32",
    "dexct_tpu_torch/ops/motion.py:_host64"}}


@pytest.mark.parametrize("path", ["fdk_reconstruct_motion",
                                  "helical_fdk_reconstruct_motion",
                                  "helical_card_tensors"])
def test_motion_backprojectors_make_no_host_synchronisation(dev, path):
    """``fdk_reconstruct_motion`` and ``helical_fdk_reconstruct_motion``
    (K32, K33) upload their poses and slice centres and take K33's host
    figures from the caller's host arrays: no synchronisation of the host
    with the card; K33 given its view angles and displacements as card
    tensors reads them back once, as ``MOTION_SYNCS`` names."""
    from dexct_tpu_torch.ops import motion
    from dexct_tpu_torch.system import (ConeBeamGeometry,
                                        HelicalConeBeamGeometry)

    det = dict(N_channels=32, N_rows=4, gamma_fan=0.8230337, SID=60.0,
               SDD=100.0, h_iso=0.5)
    rng = np.random.default_rng(28)
    if path == "fdk_reconstruct_motion":
        ct = ConeBeamGeometry(N_proj=24, **det)
        track = motion.MotionProfile3D.breathing_z(24, 0.5)
        sino = torch.as_tensor(rng.random((2, 24, 4, 32), np.float32),
                               device=dev)

        def call():
            return motion.fdk_reconstruct_motion(sino, ct, 24, 18.0, 0.8,
                                                 track)
        counter = motion._fdk_backproject_motion
    else:
        ct = HelicalConeBeamGeometry(N_proj=48, pitch=2.0,
                                     rotation_total=4.0 * np.pi, **det)
        track = motion.MotionProfile3D.breathing_z(48, 0.5)
        counter = motion._helical_backproject_motion
        if path == "helical_fdk_reconstruct_motion":
            sino = torch.as_tensor(rng.random((2, 48, 4, 32), np.float32),
                                   device=dev)

            def call():
                return motion.helical_fdk_reconstruct_motion(
                    sino, ct, 24, 18.0, 0.8, track)
        else:
            q = torch.as_tensor(rng.standard_normal((2, 48, 4, 32),
                                                    np.float32), device=dev)
            betas = torch.as_tensor(np.asarray(ct.betas, np.float32),
                                    device=dev)
            disp = torch.as_tensor(track.disp, dtype=torch.float32,
                                   device=dev)

            def call():
                return motion._helical_backproject_motion(
                    q, betas, np.asarray(ct.source_z), 0.5 * ct.rotation_total,
                    track.phi, disp, ct.SID, ct.dgamma, ct.h_iso, 4,
                    ct.pitch, 24, 5, 18.0, 0.5, -1.0)
    call()
    torch.cuda.synchronize()
    before = counter.launches
    syncs = _sync_functions(call)
    assert counter.launches == before + 1
    assert set(syncs) == MOTION_SYNCS.get(path, set()), syncs


@pytest.mark.parametrize("recon", ["cg", "sirt", "pwls"])
def test_2d_iterative_makes_no_host_synchronisation(dev, recon):
    """``cg_recon``, ``sirt_recon`` and ``pwls_recon`` on a plan on the card,
    their sinograms, start images, start vectors and counts given as NumPy
    arrays, upload them and run their loops with no synchronisation of the
    host with the card (the transposes of the plan's adjoints are built at
    the first call, before the check)."""
    from dexct_tpu_torch.ops import fourier, iterative
    from dexct_tpu_torch.system import FanBeamGeometry, water_cylinder_phantom

    ct = FanBeamGeometry(N_channels=48, N_proj=64, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0)
    plan = fourier.plan_fourier_projector(water_cylinder_phantom(N=48,
                                                                 dx=0.4),
                                          ct, n_theta=96, device=dev)
    rng = np.random.default_rng(28)
    vs = (64, 48)
    sino = np.abs(rng.normal(size=vs)).astype(np.float32)
    x0 = rng.uniform(0.0, 0.02, (48, 48))
    v0 = rng.normal(size=(48, 48))
    if recon == "cg":
        def call():
            return iterative.cg_recon(plan, sino, vs, n_iters=3, x0=x0)[0]
    elif recon == "sirt":
        def call():
            return iterative.sirt_recon(plan, sino, vs, n_iters=3,
                                        power_iters=3, _v0=v0)
    else:
        counts = np.maximum(rng.poisson(2e3 * np.exp(-sino)), 1)

        def call():
            return iterative.pwls_recon(plan, sino, counts, vs, n_iters=3,
                                        power_iters=3, x0=x0, _v0=v0)
    _no_sync(call)
    out = call()
    assert out.is_cuda and bool(torch.isfinite(out).all())


def test_k3_makes_no_host_synchronisation(dev):
    """K3 reads its count scale on the card: a solve copies nothing from
    the host and reads nothing back, at a pixel count ragged against its
    groups of pixels."""
    from dexct_tpu_torch.tools.probe_gauss_newton import pin_case

    counts, i0, mus, kw = pin_case("n4097", dev)
    _no_sync(lambda: gauss_newton_solve(counts, i0, mus, **kw))


def test_k35_makes_no_host_synchronisation(dev):
    """K35 reads its count scale on the card, as K3 does."""
    from dexct_tpu_torch.ops import matdecomp

    thr, n_mats, kw = K35_CASES["4x3"]
    args = [x.to(dev) for x in _multibin_case(thr, n_mats)]
    before = matdecomp._gauss_newton_general.launches
    _no_sync(lambda: gauss_newton_solve(*args, **kw))
    assert matdecomp._gauss_newton_general.launches == before + 2


@pytest.mark.parametrize("site", ["multibin_numpy", "multibin_tensor",
                                  "sinograms", "image_domain"])
def test_decomposition_uploads_do_not_synchronise(dev, site):
    """``decompose_multibin_grid`` (NumPy counts, or counts on the card),
    ``decompose_sinograms`` and ``image_domain_decomposition`` (NumPy
    reconstructions) send their host tables and arrays to the card through
    pinned memory: no host synchronisation."""
    from dexct_tpu_torch.ops import matdecomp as md
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.physics.materials import BONE, TISSUE
    from dexct_tpu_torch.system import FanBeamGeometry

    rng = np.random.default_rng(25)
    if site.startswith("multibin"):
        counts, i0, _ = (x.numpy() for x in _multibin_case(
            K35_CASES["4x2"][0], 2, n_pix=96))
        sinos = counts.reshape(4, 8, 12)
        if site.endswith("tensor"):
            sinos = torch.as_tensor(sinos, device=dev)
        ee = kramers_spectrum(140.0).E
        call = lambda: md.decompose_multibin_grid(  # noqa: E731
            sinos, ee, i0, (TISSUE, BONE), n_iters=12, device=dev)
    elif site == "sinograms":
        ct = FanBeamGeometry(N_channels=16, N_proj=8, eid=True)
        s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
        s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
        s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
        _, i0, mus = md.prepare_decomposition(ct, s1, s2)
        a = np.stack([rng.uniform(0, 30, 128), rng.uniform(0, 4, 128)], -1)
        c = torch.as_tensor((np.exp(-a @ mus) @ i0.T).T.reshape(2, 8, 16),
                            dtype=torch.float32, device=dev)
        call = lambda: md.decompose_sinograms(  # noqa: E731
            ct, c[0], c[1], s1, s2, n_iters=12)
    else:
        ct = FanBeamGeometry(N_channels=48, N_proj=48, eid=True)
        r1, r2 = rng.uniform(0.1, 0.4, (2, 16, 16)).astype(np.float32)
        call = lambda: md.image_domain_decomposition(  # noqa: E731
            r1, r2, kramers_spectrum(80.0), kramers_spectrum(140.0), ct,
            device=dev)
    _no_sync(call)


@pytest.mark.parametrize("pileup", [False, True])
def test_simulate_pcd_spectral_does_not_synchronise(dev, pileup):
    """The tiny spectral case (``tiny_cases.spectral("pcd")``'s scan):
    the trace, the bins' counts (their mu table and fluences uploaded
    through pinned memory), the pileup and its inversion, K35 and the
    FBPs make no host synchronisation."""
    from dexct_tpu_torch.physics import kramers_spectrum
    from dexct_tpu_torch.physics.detector import photon_counting_response
    from dexct_tpu_torch.physics.materials import BONE, WATER
    from dexct_tpu_torch.pipeline import spectralct
    from dexct_tpu_torch.system import FanBeamGeometry

    ct = FanBeamGeometry(N_channels=48, N_proj=48, eid=False,
                         detector=photon_counting_response(), gamma_fan=0.9,
                         SID=60.0, SDD=100.0)
    spec = kramers_spectrum(140.0)
    spec.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    ph = tiny_cases._three_materials()
    _no_sync(lambda: spectralct.simulate_pcd_spectral(
        ct, ph, spec, [20.0, 34.0, 50.0, 70.0], (WATER, BONE), 32, 20.0,
        0.8, n_iters=12, pileup_tau=1e-9 if pileup else 0.0, device=dev))


# sha1 of K35's output on the cases of K35_CASES, from the build of K35
# that took its count scale as a host float (NVIDIA H100 80GB HBM3, CUDA
# 12.8): reading it on the card left every bit as it was
K35_PINNED_SHA1 = {
    "4x2": "869b8d05d2bd6303d6ff91941004cf3286720bf5",
    "4x3": "37d57f0813b22954a3d5bf33ad0c628f053b4729",
    "6x4": "8aa0414b0c52348703bd4fd3322c09c4e3f04739",
    "4x2_newton": "117bff32e51948b48e926b73ed03d821fdb0b4fe",
    "4x3_lm": "5997fed51646ec776fe645c1fa6a88af43d40521",
    "4x2_mle_warm": "1450d2e9d1af0e68f798cbd1b99feff1c7eebd43",
    "2x2_lm": "ee0ba3eaa55139c0fd114490c8708d2868b13f0e",
    "8x4_newton": "ae2d3c8c6ec2a42f108a64e8636d66ae77d9b867",
}


@pytest.mark.parametrize("name", sorted(K35_PINNED_SHA1))
def test_k35_output_is_unchanged(dev, name):
    import hashlib

    thr, n_mats, kw = K35_CASES[name]
    args = _multibin_case(thr, n_mats)
    out = gauss_newton_solve(*(x.to(dev) for x in args), **kw)
    assert hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest() == \
        K35_PINNED_SHA1[name]


# sha1 of K35's output on probe_k35's cases: the K-edge pelvis's 8e5
# counts (M 6, K 4, 60 iterations) and the packed PCD path's (M 4, K 2, 10),
# made by the port's K1 and K34 as chip_smoke.py's phase 3 makes them; the
# exact path's DE counts at (2, 2) with K3's schedule (K1, K2); K35_CASES'
# 6x4 and 8x4_newton drawn at 1, 127, 129 and 4097 pixels.  Pinned from the
# build of K35 before its float64 table (NVIDIA H100 80GB HBM3, CUDA 12.8);
# chip_smoke.py holds the same.  The path cases also pin K1's, K2's and
# K34's bits.
K35_PATH_SHA1 = {
    "kedge": "5d9567c4c6e21c9d84619fcf74c37c42e0897b54",
    "packed": "63bd30f0758c5f552992d35ae39d94bc68c9add6",
    "de_2x2": "1cb940185a9d72da30b707407e8e5488de0bcfbe",
    "6x4_n1": "b0f07841de32f80a1f102c4c5510b9d745d94bad",
    "6x4_n127": "4c24e0d743b5f35c19aa6f7af5138eaebdf8b1f0",
    "6x4_n129": "53b7a98b09ca5d0d5e84ec82fde8d84313a4e01e",
    "6x4_n4097": "5d667ec4b2e97712366f69422d98c8b60a650e89",
    "8x4_newton_n1": "0ef186eb006502da6c895de60cc52e3d81ae4dc9",
    "8x4_newton_n127": "22243dab96a366ae3efb25af4a7cbbc859724de7",
    "8x4_newton_n129": "f7c5f088a8b5c93f07af39c4254bd56a3978c1d9",
    "8x4_newton_n4097": "3fe0917acedcde64fbdbfe505fc84c64e72db1d2",
}


@pytest.fixture(scope="module")
def k35_paths():
    """probe_k35's three path cases on the card, made once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from dexct_tpu_torch.tools.probe_k35 import path_cases

    return path_cases(torch.device("cuda"))


def _k35_case(name, dev, k35_paths):
    from dexct_tpu_torch.tools.probe_k35 import pin_case

    return k35_paths[name] if name in k35_paths else pin_case(name, dev)


@pytest.mark.parametrize("case", list(K35_PATH_SHA1))
def test_k35_keeps_its_path_bits(dev, k35_paths, case):
    """K35 gives the first K35's output bit for bit at the paths' shapes,
    at (2, 2) and at pixel counts ragged against its blocks, in one
    launch."""
    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.tools.probe_gauss_newton import output_sha1
    from dexct_tpu_torch.tools.probe_k35 import solve

    counts, i0, mus, kw = _k35_case(case, dev, k35_paths)
    before = matdecomp._gauss_newton_general.launches
    out = solve(matdecomp, case, counts, i0, mus, kw)
    torch.cuda.synchronize()
    assert matdecomp._gauss_newton_general.launches == before + 1
    assert out.shape == (counts.shape[1], mus.shape[0])
    assert output_sha1(out) == K35_PATH_SHA1[case]


@pytest.mark.parametrize("case", ["kedge", "6x4_n4097", "8x4_newton_n129"])
def test_k35_two_launches_are_equal(dev, k35_paths, case):
    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.tools.probe_k35 import solve

    args = _k35_case(case, dev, k35_paths)
    assert torch.equal(solve(matdecomp, case, *args),
                       solve(matdecomp, case, *args))


def test_k35_runs_a_table_larger_than_a_block(dev):
    """8x4_newton on the 140-bin grid: its float64 table (269 KB) exceeds
    a block's shared memory, and K35 still solves it (one phase's rows at
    a time), in one launch, within its bar of the plain version."""
    from dexct_tpu_torch.ops import matdecomp

    thr, n_mats, kw = K35_CASES["8x4_newton"]
    args = _multibin_case(thr, n_mats)
    tables = matdecomp.k35_arguments(*args, **kw)[1]
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert tables.numel() * tables.element_size() > limit
    before = matdecomp._gauss_newton_general.launches
    got = gauss_newton_solve(*(x.to(dev) for x in args), **kw)
    torch.cuda.synchronize()
    assert matdecomp._gauss_newton_general.launches == before + 1
    want = matdecomp.gauss_newton_solve_plain(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert tiny_cases.newton_agrees(got.cpu(), want)


def test_k35_streams_a_phase_larger_than_a_block(dev):
    """8x4_newton on a 280-bin grid (each bin of the 140-bin grid split in
    two): each phase's float64 rows (269 KB) exceed a block's shared
    memory, so K35 stages them in chunks in every pass; one launch, two
    launches equal, within its bar of the plain version."""
    from dexct_tpu_torch.ops import matdecomp

    thr, n_mats, kw = K35_CASES["8x4_newton"]
    counts, i0, mus = _multibin_case(thr, n_mats, n_pix=512)
    i0 = torch.repeat_interleave(i0, 2, dim=1) / 2
    mus = torch.repeat_interleave(mus, 2, dim=1)
    args = (counts, i0, mus)
    tables, _, _, M, K, newton, e_full = matdecomp.k35_arguments(
        *args, **kw)[1:8]
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert newton and e_full == 280
    assert e_full * 8 * M * (1 + K + K * (K + 1) // 2) > limit
    before = matdecomp._gauss_newton_general.launches
    got = gauss_newton_solve(*(x.to(dev) for x in args), **kw)
    again = gauss_newton_solve(*(x.to(dev) for x in args), **kw)
    torch.cuda.synchronize()
    assert matdecomp._gauss_newton_general.launches == before + 2
    assert torch.equal(got, again)
    want = matdecomp.gauss_newton_solve_plain(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert tiny_cases.newton_agrees(got.cpu(), want)


def test_k4_refuses_a_misaligned_table(dev):
    """K4 reads each packed row in 8- or 16-byte loads: a table that
    starts off a 16-byte boundary is refused, not read."""
    from dexct_tpu_torch.ops.fbp_fast import pack_filtered

    rng = np.random.default_rng(42)
    q = torch.as_tensor(rng.normal(size=(2, 12, 16)), dtype=torch.float32,
                        device=dev)
    packed = pack_filtered(q)
    buf = torch.empty(packed.numel() + 1, device=dev)
    shifted = buf[1:].view(packed.shape)
    shifted.copy_(packed)
    betas = torch.linspace(0.0, 6.0, 12, device=dev)
    before = fan_backproject_multi.launches
    with pytest.raises(ValueError, match="16-byte"):
        fan_backproject_multi(shifted, 2, betas, 60.0, 0.8230337 / 16, 16,
                              8, 24.0, 0.5)
    assert fan_backproject_multi.launches == before


def _motion_fan_case(dev, V=120, C=96, seed=30):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(V, C)), dtype=torch.float32,
                        device=dev)
    betas = torch.arange(V, dtype=torch.float32, device=dev) * (2 * np.pi / V)
    phi = 0.1 * np.sin(np.linspace(0, 3, V))
    disp = np.stack([0.8 * np.sin(np.linspace(0, 5, V)),
                     0.5 * np.cos(np.linspace(0, 4, V))], -1)
    return q, betas, phi, disp


def test_fan_backproject_motion_matches_plain(dev):
    from dexct_tpu_torch.ops.motion import (fan_backproject_motion,
                                            fan_backproject_motion_plain)

    q, betas, phi, disp = _motion_fan_case(dev)
    args = (60.0, 0.8230337 / 96, 64, 24.0, phi, disp)
    before = fan_backproject_motion.launches
    got = fan_backproject_motion(q, betas, *args, dbeta=2 * np.pi / 120)
    torch.cuda.synchronize()
    assert fan_backproject_motion.launches == before + 1
    want = fan_backproject_motion_plain(q, betas, *args, 2 * np.pi / 120)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_fan_backproject_motion_at_zero_pose_is_k4(dev):
    """K30 with phi = d = 0 forms the pixel coordinates exactly and then
    runs K4's tap and sum for one image: K4's image bit for bit."""
    from dexct_tpu_torch.ops.fbp_fast import pack_filtered
    from dexct_tpu_torch.ops.motion import fan_backproject_motion

    q, betas, _, _ = _motion_fan_case(dev, V=180)
    geo = (60.0, 0.8230337 / 96, 64, 24.0)
    got = fan_backproject_motion(q, betas, *geo, np.zeros(180),
                                 np.zeros((180, 2)), dbeta=2 * np.pi / 180)
    k4 = fan_backproject_multi(pack_filtered(q[None]), 1, betas, geo[0],
                               geo[1], 96, geo[2], geo[3], 2 * np.pi / 180)
    assert torch.equal(got, k4[0])


@pytest.mark.parametrize("n_gates", [1, 4, 6])
def test_gated_backproject_matches_plain(dev, n_gates):
    from dexct_tpu_torch.pipeline import gated

    rng = np.random.default_rng(31)
    V, C = 2 * 96, 96
    q = torch.as_tensor(rng.normal(size=(V, C)), dtype=torch.float32,
                        device=dev)
    betas = torch.arange(V, dtype=torch.float32, device=dev) * (2 * np.pi / 96)
    ph = gated.view_phases(V, 96 * 2 / 3.0)
    w = np.stack([gated.gate_weights(ph, g / n_gates, 0.3)
                  for g in range(n_gates)])
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    args = (60.0, 0.8230337 / C, 64, 24.0)
    before = gated._gated_backproject.launches
    got = gated._gated_backproject(q, betas, w, *args)
    torch.cuda.synchronize()
    assert gated._gated_backproject.launches == before + -(-n_gates // 4)
    want = gated._gated_backproject_plain(q, betas, w, *args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def _motion_cone_case(dev, V, dz_amp, seed):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(2, V, 8, 48)), dtype=torch.float32,
                        device=dev)
    s = np.linspace(0, 1, V)
    phi = 0.05 * np.sin(2 * np.pi * s)
    disp = np.stack([0.5 * np.sin(3 * s), 0.3 * np.cos(2 * s),
                     0.5 * dz_amp * (1 - np.cos(3 * np.pi * s))], -1)
    return q, phi, disp


def test_fdk_backproject_motion_matches_plain(dev):
    from dexct_tpu_torch.ops.motion import (_fdk_backproject_motion,
                                            _motion_backproject_plain)

    q, phi, disp = _motion_cone_case(dev, 48, 0.8, 32)
    betas = torch.arange(48, dtype=torch.float32, device=dev) \
        * (2 * np.pi / 48)
    args = (60.0, 0.8230337 / 48, 0.5, 40, 10, 20.0, 0.5, -2.25)
    before = _fdk_backproject_motion.launches
    got = _fdk_backproject_motion(q, betas, phi, disp, *args[:3], 8,
                                  *args[3:])
    torch.cuda.synchronize()
    assert _fdk_backproject_motion.launches == before + 1
    want = _motion_backproject_plain(q, betas, phi, disp, *args,
                                     view_block=8)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("dz_amp", [0.0, 1.6])
def test_helical_backproject_motion_matches_plain(dev, dz_amp):
    """K33 on a 3-turn helix, still and with a z drift of 1.6 cm (over
    three rows of 0.5 cm): the kernel visits only the views each slice's
    moving window can reach, the plain version every view."""
    from dexct_tpu_torch.ops.motion import (_helical_backproject_motion,
                                            _motion_backproject_plain)
    from dexct_tpu_torch.system import HelicalConeBeamGeometry

    ct = HelicalConeBeamGeometry(N_channels=48, N_proj=144, N_rows=8,
                                 SID=60.0, SDD=100.0, h_iso=0.5,
                                 rotation_total=6 * np.pi, pitch=2.0)
    q, phi, disp = _motion_cone_case(dev, 144, dz_amp, 33)
    betas = torch.as_tensor(ct.betas, dtype=torch.float32, device=dev)
    nz = 17
    z0 = 0.25 - nz * 0.25
    before = _helical_backproject_motion.launches
    got = _helical_backproject_motion(
        q, betas, ct.source_z, 3 * np.pi, phi, disp, 60.0, ct.dgamma, 0.5,
        8, 2.0, 32, nz, 20.0, 0.5, z0)
    torch.cuda.synchronize()
    assert _helical_backproject_motion.launches == before + 1
    want = _motion_backproject_plain(
        q, betas, phi, disp, 60.0, ct.dgamma, 0.5, 32, nz, 20.0, 0.5, z0,
        8, window=(ct.source_z, 3 * np.pi, 2.0))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("kind", tiny_cases.MOTION_KINDS)
def test_motion_paths_cuda_match_cpu(dev, kind):
    got = tiny_cases.motion(kind, dev)
    want = tiny_cases.motion(kind, "cpu")
    for g, w in zip(got, want):
        big = float(w.abs().max())
        assert float((g - w).abs().max()) <= tiny_cases.MOTION_TOL * big


@pytest.mark.parametrize("n_bins", [4, 6])
def test_multibin_counts_match_plain(dev, n_bins):
    """K34 (a stacked [E, M] bin table through ``counts_from_paths``)
    against its plain twin, rel 1e-5 (K2's bar); K2's counter stays put,
    and a second-moment table with a bin table is refused on the card as
    on the CPU."""
    from dexct_tpu_torch.ops.spectral import counts_from_paths_multibin

    rng = np.random.default_rng(41)
    paths = torch.as_tensor(rng.uniform(0, 5, (3000, 6)),
                            dtype=torch.float32, device=dev)
    mu = torch.as_tensor(rng.uniform(0.01, 2.0, (6, 141)),
                         dtype=torch.float32, device=dev)
    i0 = rng.uniform(0, 1e6, (141, n_bins))
    i0[:20] = 0.0
    i0 = torch.as_tensor(i0, dtype=torch.float32, device=dev)
    before = counts_from_paths_multibin.launches
    k2 = counts_from_paths.launches
    got = counts_from_paths(paths.reshape(60, 50, 6), mu, i0)
    torch.cuda.synchronize()
    assert counts_from_paths_multibin.launches == before + 1
    assert counts_from_paths.launches == k2
    assert got.shape == (60, 50, n_bins)
    torch.testing.assert_close(
        got, counts_from_paths_plain(paths.reshape(60, 50, 6), mu, i0),
        rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="second-moment"):
        counts_from_paths(paths, mu, i0, i0)


# the multi-bin scene and K35's cases (name -> (thresholds, K, solver
# keywords)) are probe_k35's, so that the probe and the pins draw the same
from dexct_tpu_torch.tools.probe_k35 import (  # noqa: E402
    K35_CASES, multibin_case as _multibin_case)


@pytest.mark.parametrize("name", list(K35_CASES))
def test_gauss_newton_general_matches_plain(dev, name):
    """K35 through ``gauss_newton_solve`` against the plain version on
    the same tensors: |d| / max(|a|, 1) <= 1e-4 (K3's bar) on every pixel
    at K <= 3 and on 99 % of them at K = 4 (``tiny_cases.newton_agrees``);
    one K35 launch, none of K3."""
    from dexct_tpu_torch.ops import matdecomp

    thr, n_mats, kw = K35_CASES[name]
    args = _multibin_case(thr, n_mats)
    before = matdecomp._gauss_newton_general.launches
    k3 = gauss_newton_solve.launches
    got = gauss_newton_solve(*(x.to(dev) for x in args), **kw)
    torch.cuda.synchronize()
    assert matdecomp._gauss_newton_general.launches == before + 1
    assert gauss_newton_solve.launches == k3
    want = matdecomp.gauss_newton_solve_plain(*args, **kw)
    assert got.shape == want.shape == (args[0].shape[1], n_mats)
    assert bool(torch.isfinite(got).all())
    assert tiny_cases.newton_agrees(got.cpu(), want), \
        tiny_cases.newton_agreement(got.cpu(), want)


def test_gauss_newton_general_at_two_materials_is_k3(dev):
    """At (M, K) = (2, 2) with K3's schedule, K35 agrees with K3 (and with
    the plain version) within K3's bar of 1e-4; the default call still
    takes K3."""
    from dexct_tpu_torch.ops import matdecomp

    counts, i0, mus = (torch.as_tensor(x, device=dev)
                       for x in _k3_golden_case())
    k3 = gauss_newton_solve(counts, i0, mus, n_iters=50)
    kw = dict(n_iters=50, eps_init=1e-6, pixel_block=65536, step_max=5.0,
              a_bounds=(-20.0, 500.0), method="gn", lm_damping=0.0,
              polish_iters=4, warm="log", warm_nodes=32)
    k35 = matdecomp._gauss_newton_general(counts, i0, mus, **kw)
    plain = matdecomp.gauss_newton_solve_plain(counts.cpu(), i0.cpu(),
                                               mus.cpu(), n_iters=50)
    for a, b in ((k35, k3), (k35.cpu(), plain)):
        rel = (a - b).abs() / b.abs().clamp_min(1.0)
        assert float(rel.max()) <= 1e-4


@pytest.mark.parametrize("kind", tiny_cases.SPECTRAL_KINDS)
def test_spectral_paths_cuda_match_cpu(dev, kind):
    got = tiny_cases.spectral(kind, dev)
    want = tiny_cases.spectral(kind, "cpu")
    for g, w in zip(got, want):
        big = float(w.abs().max())
        assert float((g - w).abs().max()) <= tiny_cases.SPECTRAL_TOL * big


# --- K36/K37: the afterglow recursion; K38/K39: the gather probe ---------

AFTERGLOW_TRAPS = {1: ([0.06], [2.0]), 2: ([0.05, 0.02], [2.0, 20.0]),
                   3: ([0.04, 0.02, 0.01], [1.0, 6.0, 40.0]),
                   8: ([0.01] * 8, [0.5, 1, 2, 4, 8, 16, 32, 64])}


def _afterglow_case(dev, k, shape, dtype, seed):
    from dexct_tpu_torch.ops.afterglow import decay_per_view

    rng = np.random.default_rng(seed)
    x = rng.uniform(1e3, 1e5, shape)
    x[shape[0] // 3:] *= 0.05  # an air -> object edge along the views
    a, tau = AFTERGLOW_TRAPS[k]
    return (torch.as_tensor(x, dtype=dtype, device=dev), a,
            decay_per_view(tau, 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1000, 96), (90, 4, 40)])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_afterglow_kernels_match_plain(dev, k, warm, shape, dtype):
    """K36 and K37 against their plain twins on the card, within 1e-6 of
    the maximum (the same operations in the same order, but torch.sum on
    the card may add three or more traps in another order; two traps, the
    JAX model's, bit for bit); the pair round-trips."""
    from dexct_tpu_torch.ops import afterglow as ag

    x, a, b = _afterglow_case(dev, k, shape, dtype, seed=k)
    n_apply, n_correct = ag.apply_afterglow.launches, \
        ag.correct_afterglow.launches
    m = ag.apply_afterglow(x, a, b, warm_start=warm)
    back = ag.correct_afterglow(m, a, b, warm_start=warm)
    torch.cuda.synchronize()
    assert (ag.apply_afterglow.launches, ag.correct_afterglow.launches) \
        == (n_apply + 1, n_correct + 1)
    assert m.dtype == dtype and m.shape == shape
    want_m = ag.apply_afterglow_plain(x, a, b, warm_start=warm)
    want_back = ag.correct_afterglow_plain(m, a, b, warm_start=warm)
    for got, want in ((m, want_m), (back, want_back)):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    if k <= 2:
        assert torch.equal(m, want_m) and torch.equal(back, want_back)
    assert float(((back - x) / x).abs().max()) <= 1e-5


def test_afterglow_plain_correction_divides_as_the_cpu(dev):
    """The plain correct_afterglow divides by a tensor gain: on the card
    it equals its CPU result bit for bit (a Python-scalar divisor would
    run as a product with its reciprocal there)."""
    from dexct_tpu_torch.ops import afterglow as ag

    x, a, b = _afterglow_case("cpu", 2, (96, 64), torch.float32, seed=7)
    m = ag.apply_afterglow_plain(x, a, b)
    want = ag.correct_afterglow_plain(m, a, b)
    got = ag.correct_afterglow_plain(m.to(dev), a, b)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("fn", ["log_sinogram", "hu_image"])
def test_log_and_hu_divide_as_the_cpu(dev, fn):
    """``log_sinogram`` and ``hu_image`` with a Python-float divisor (as
    ``dect_step`` passes ``meta.air1`` and ``meta.mu_w1``) divide by a
    tensor: ``hu_image`` on the card equals its CPU result bit for bit;
    ``log_sinogram`` equals the card's log of the CPU's quotient (the
    card's and the CPU's float32 log are other functions, each within an
    ulp, so the quotient is what the division decides)."""
    from dexct_tpu_torch.ops.fbp import hu_image
    from dexct_tpu_torch.ops.spectral import log_sinogram

    rng = np.random.default_rng(12)
    if fn == "log_sinogram":
        x = torch.as_tensor(rng.uniform(1.0, 3e6, (96, 64)),
                            dtype=torch.float32)
        air = 3187654.321
        quotient = x / torch.tensor(air)
        assert not torch.equal(quotient, x * (1.0 / air))  # the cases differ
        want = -torch.log(quotient.to(dev))
        assert torch.equal(log_sinogram(x.to(dev), air), want)
    else:
        x = torch.as_tensor(rng.uniform(0.0, 0.5, (96, 64)),
                            dtype=torch.float32)
        assert torch.equal(hu_image(x.to(dev), 0.19234567).cpu(),
                           hu_image(x, 0.19234567))


@pytest.mark.parametrize("fn", ["log_sinogram", "hu_image"])
def test_log_and_hu_divisors_do_not_synchronise(dev, fn):
    """The divisor tensor of ``log_sinogram`` and ``hu_image`` is filled on
    the card: no host copy, which would synchronise the stream (``dect_step``
    calls the two four times a step)."""
    from dexct_tpu_torch.ops.fbp import hu_image
    from dexct_tpu_torch.ops.spectral import log_sinogram

    x = torch.rand((96, 64), device=dev) + 1.0
    call = ((lambda: log_sinogram(x, 3187654.321)) if fn == "log_sinogram"
            else (lambda: hu_image(x, 0.19234567)))
    call()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _cross_scatter_case(device):
    """Two tubes' counts [48, 64] with Python-float air counts (as
    ``simulate_dualsource_dect`` passes them)."""
    rng = np.random.default_rng(15)
    a = torch.as_tensor(rng.uniform(1e2, 3e6, (48, 64)), dtype=torch.float32)
    b = torch.as_tensor(rng.uniform(1e1, 3e5, (48, 64)), dtype=torch.float32)
    return a.to(device), b.to(device), 3187654.321, 318765.4321


@pytest.mark.parametrize("fn", ["add_cross_scatter", "correct_cross_scatter"])
def test_cross_scatter_divides_as_the_cpu(dev, fn):
    """``add_cross_scatter`` and ``correct_cross_scatter`` divide by the air
    counts and clamp at their floors as the CPU does: the card's counts
    equal the CPU's bit for bit.  A one-tap kernel makes the channel spread
    exact on both devices (cuDNN and the CPU add a wider kernel's taps in
    other orders), so what is held is the divisions and the floors."""
    from dexct_tpu_torch.pipeline import dualsource as ds

    a, b, air_a, air_b = _cross_scatter_case("cpu")
    # the cases differ: a division and a product with the reciprocal
    assert not torch.equal(a / torch.tensor(air_a), a * (1.0 / air_a))
    kern = np.ones(1, np.float32)
    call = getattr(ds, fn)
    want = call(a, b, air_a, air_b, kern, cross_spr=0.7)
    got = call(a.to(dev), b.to(dev), air_a, air_b,
               torch.as_tensor(kern, device=dev), cross_spr=0.7)
    if fn == "correct_cross_scatter":
        assert bool((want[0] == np.float32(1e-6 * air_a)).any())  # floors
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("fn", ["add_cross_scatter", "correct_cross_scatter"])
def test_cross_scatter_does_not_synchronise(dev, fn):
    """The air counts' divisors and the floors are filled on the card: with
    the counts and the kernel there, neither function copies from the host
    (a copy synchronises the stream)."""
    from dexct_tpu_torch.ops.scatter import scatter_kernel
    from dexct_tpu_torch.pipeline import dualsource as ds

    a, b, air_a, air_b = _cross_scatter_case(dev)
    kern = torch.as_tensor(scatter_kernel(64, sigma_ch=8.0), device=dev)

    def call():
        return getattr(ds, fn)(a, b, air_a, air_b, kern, cross_spr=0.1)

    call()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def test_physics_scatter_correction_divides_as_the_cpu(dev):
    from dexct_tpu_torch.pipeline.realism import stage_physics_scatter

    rng = np.random.default_rng(8)
    c = torch.as_tensor(rng.uniform(1e3, 1e5, (96, 64)), dtype=torch.float32)
    s = torch.as_tensor(rng.uniform(0, 1e3, (96, 64)), dtype=torch.float32)
    stage = stage_physics_scatter(s, grid_p=0.7, grid_s=0.3)
    assert torch.equal(stage.correct(c.to(dev)).cpu(), stage.correct(c))


# the realism chain's counts and a Python-float air count, and a
# resolving time putting the counts at ~0.1 dead time
_REALISM_AIR, _REALISM_TAU = 3187654.321, 3.3333e-8


def _realism_counts():
    rng = np.random.default_rng(31)
    return torch.as_tensor(rng.uniform(1e2, 3e6, (48, 64)),
                           dtype=torch.float32)


@pytest.mark.parametrize("fn", ["add_scatter", "correct_scatter"])
def test_scatter_with_scalar_air_divides_as_the_cpu(dev, fn):
    """``add_scatter`` and ``correct_scatter`` with a Python-float air count
    (as the realism chain's scatter stage passes it) divide by it and by
    ``grid_p`` as the CPU does: bit for bit, through a one-tap kernel
    (exact on both devices; cuDNN and the CPU add a wider kernel's taps in
    other orders)."""
    from dexct_tpu_torch.ops import scatter

    c = _realism_counts()
    assert not torch.equal(c / torch.tensor(_REALISM_AIR),
                           c * (1.0 / _REALISM_AIR))
    kern = np.ones(1, np.float32)
    kw = dict(spr=0.7, grid_p=0.93, grid_s=0.3)
    call = getattr(scatter, fn)
    want = call(c, _REALISM_AIR, kern, **kw)
    got = call(c.to(dev), _REALISM_AIR, torch.as_tensor(kern, device=dev),
               **kw)
    assert torch.equal(got.cpu(), want)


def test_pileup_stage_divides_as_the_cpu(dev):
    """The realism chain's pileup stage (non-paralyzable: no exp, whose
    float32 results differ between the devices) divides by ``tau_ratio``
    as the CPU does: apply and correct bit for bit."""
    from dexct_tpu_torch.pipeline.realism import stage_pileup

    c = _realism_counts()
    stage = stage_pileup(_REALISM_TAU)
    m = c * _REALISM_TAU
    assert not torch.equal(m / torch.tensor(_REALISM_TAU),
                           m * (1.0 / _REALISM_TAU))
    want = stage.apply(c)
    assert torch.equal(stage.apply(c.to(dev)).cpu(), want)
    assert torch.equal(stage.correct(want.to(dev)).cpu(),
                       stage.correct(want))


@pytest.mark.parametrize("fn", ["apply_pileup_bins", "correct_pileup_bins"])
def test_pileup_bins_divide_as_the_cpu(dev, fn):
    """The PCD's per-bin pileup and its inversion (non-paralyzable) divide
    by ``tau_ratio`` as the CPU does: bit for bit."""
    from dexct_tpu_torch.physics import pileup

    rng = np.random.default_rng(32)
    counts = torch.as_tensor(rng.uniform(1e3, 1e5, (4, 48, 64)),
                             dtype=torch.float32)
    s = pileup.bin_sum_redistribution([20.0, 34.0, 50.0, 70.0],
                                      [27.0, 42.0, 60.0, 80.0])
    call = getattr(pileup, fn)
    want = call(counts, 1.2345e-6, s, "nonparalyzable")
    got = call(counts.to(dev), 1.2345e-6, s, "nonparalyzable")
    assert torch.equal(got.cpu(), want)


def test_nlpv_bias_divides_as_the_cpu(dev, monkeypatch):
    """``nlpv_bias_sinogram`` divides by the air counts as a 0-d tensor on
    the card: its result is the card's log of the CPU's quotients (the
    sub-ray counts fixed in place of K2's, whose rounding differs from the
    plain counts'; the two devices' float32 logs are other functions, each
    within an ulp, so the quotients are what the division decides)."""
    from dexct_tpu_torch.ops import aperture

    rng = np.random.default_rng(33)
    c = torch.as_tensor(rng.uniform(1e2, 1e6, (3, 48, 64)),
                        dtype=torch.float32)
    i0 = rng.uniform(10.0, 1e5, 40).astype(np.float32)
    monkeypatch.setattr(aperture, "_counts", lambda counts, mu, i0e: counts)
    got = aperture.nlpv_bias_sinogram(c.to(dev), None, i0)
    air = torch.as_tensor(i0).sum()
    assert not torch.equal(c / air, c * (1.0 / float(air)))
    q = torch.clamp_min(c, 1e-30) / air
    qm = torch.clamp_min(torch.mean(c.to(dev), 0), 1e-30).cpu() / air
    want = (torch.mean(-torch.log(q.to(dev)), 0)
            - -torch.log(qm.to(dev)))
    assert torch.equal(got, want)


def test_air_calibration_gains_divide_as_the_cpu(dev):
    """``air_calibration_gains`` with a scalar expected air count divides
    the card's view mean by it as the CPU divides."""
    from dexct_tpu_torch.ops.rings import air_calibration_gains

    rng = np.random.default_rng(34)
    air = torch.as_tensor(rng.uniform(2.9e6, 3.3e6, (256, 256)),
                          dtype=torch.float32, device=dev)
    got = air_calibration_gains(air, _REALISM_AIR)
    mean = torch.mean(air, 0).cpu()
    want = mean / torch.tensor(_REALISM_AIR)
    assert not torch.equal(want, mean * (1.0 / _REALISM_AIR))
    assert torch.equal(got.cpu(), want)


def _no_sync(call):
    """Run ``call`` once, then again with the host forbidden to synchronise
    with the card (a host copy of a scalar would)."""
    call()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@pytest.mark.parametrize("step", ["apply", "correct"])
@pytest.mark.parametrize("stage", ["scatter", "scatter_numpy", "pileup",
                                   "physics_scatter"])
def test_realism_stages_do_not_synchronise(dev, stage, step):
    """The scatter, pileup and physics-scatter stages with Python-float
    air, ``tau_ratio`` and ``grid_p`` fill their divisors on the card: with
    the counts there, no host copy; a scatter kernel on the card is kept, a
    NumPy one goes to the card once, at the stage's first call."""
    from dexct_tpu_torch.ops.scatter import scatter_kernel
    from dexct_tpu_torch.pipeline import realism

    c = _realism_counts().to(dev)
    if stage.startswith("scatter"):
        k = scatter_kernel(64, sigma_ch=8.0)
        st = realism.stage_scatter(_REALISM_AIR, k if stage.endswith("numpy")
                                   else torch.as_tensor(k, device=dev))
    elif stage == "pileup":
        st = realism.stage_pileup(_REALISM_TAU)
    else:
        st = realism.stage_physics_scatter(c * 0.01, grid_p=0.7, grid_s=0.3)
    _no_sync(lambda: getattr(st, step)(c))


@pytest.mark.parametrize("site", [
    "helical_z", "view_geometry_fan", "view_geometry_cone", "low_dose",
    "low_dose_compound", "march_plain", "scatter_energies", "pileup_bins",
    "aperture_counts", "scatter_kernel", "pwls_weights", "auto_tcm_profile",
    "normalize_counts", "cone_operator", "fbp_recon", "fbp_recon_short",
    "parallel_fbp", "parallel_backproject_mask", "forward_counts",
    "forward_counts_bowtie", "forward_counts_tcm", "forward_counts_compound",
    "material_path_sinogram"])
def test_scalar_uploads_do_not_synchronise(dev, site):
    """The scalars of ``_helical_z`` (z0), ``_view_geometry`` (sid),
    ``synthesize_low_dose`` (the dose fraction; Poisson thinning and the
    compound mode's electronic noise), the plain scatter march (the cell
    sizes), ``pwls_weights`` (sigma_e, the variance ratio) and
    ``auto_tcm_profile`` (the count floor) are filled on the card, not
    copied from the host; NumPy inputs (K26's energy grid, the bin
    pileup's sum routing, the aperture's mu table and fluences, a scatter
    kernel, the tcm profile's mu table and fluence, ``normalize_counts``'
    modulation, the cone operator's rays, the fan and parallel FBPs'
    channel angles, filter responses, view angles and Parker weights;
    ``forward_counts``' mu table, fluences, second moment, bowtie air
    levels and tcm profile; ``material_path_sinogram``'s labels and rays)
    go to the card through pinned memory, without a synchronisation, and
    ``forward_counts``' sigma_e is filled there; K6's FOV mask goes up once
    and is kept."""
    from dexct_tpu_torch.ops import (aperture, conebeam, iterative, lowdose,
                                     scatter, scatter_physics)
    from dexct_tpu_torch.physics import pileup

    if site == "helical_z":
        call = lambda: conebeam._helical_z(19, 0.2, -1.8, dev)  # noqa: E731
    elif site.startswith("view_geometry"):
        cone = site.endswith("cone")
        betas = torch.linspace(0.0, 6.0, 20, device=dev)
        g = torch.linspace(-0.4, 0.4, 33, device=dev)
        det = torch.stack([g, g * 0.1], -1) if cone else g
        call = lambda: scatter_physics._view_geometry(  # noqa: E731
            betas, det, 60.0, 100.0, cone)
    elif site.startswith("low_dose"):
        gen = torch.Generator(device=dev).manual_seed(35)
        c = _realism_counts().to(dev)
        kw = (dict(mode="compound", var_q=c, sigma_e=3.0, sigma_e0=1.5)
              if site.endswith("compound") else {})
        call = lambda: lowdose.synthesize_low_dose(  # noqa: E731
            gen, c, 0.37, **kw)
    elif site == "march_plain":
        rng = np.random.default_rng(36)
        labels = torch.as_tensor(rng.integers(0, 3, (1, 24, 24)),
                                 dtype=torch.uint8, device=dev)
        p0, p1 = (torch.as_tensor(rng.uniform(-6.0, 6.0, (40, 2)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2))
        call = lambda: scatter_physics._march_plain(  # noqa: E731
            labels, p0, p1, 16, (0.4, 0.4), 3)
    elif site == "scatter_energies":
        from dexct_tpu_torch.physics import kramers_spectrum
        from dexct_tpu_torch.system import FanBeamGeometry

        spec = kramers_spectrum(120.0)
        spec.rescale_counts(1e6)
        ct = FanBeamGeometry(N_channels=32, N_proj=4, gamma_fan=0.9,
                             SID=60.0, SDD=100.0, h_iso=0.1, eid=True)
        args, kw, _ = scatter_physics._sinogram_prep(
            tiny_cases._three_materials(), ct, spec, coarse=2, n_energy=8,
            n_fine=96, s_in=None, s_out=None, views=np.array([0.0, 2.0]),
            channel_sub=1, z_index=None, coherent=True, n_q=48, device=dev)
        call = lambda: scatter_physics._scatter_scan(  # noqa: E731
            *args, **kw)
    elif site == "pileup_bins":
        c = _realism_counts().to(dev)[None].expand(3, -1, -1).contiguous()
        route = pileup.bin_sum_redistribution([20.0, 40.0, 60.0],
                                              [30.0, 50.0, 70.0])

        def call():
            rec = pileup.apply_pileup_bins(c, 0.05, route)
            return pileup.correct_pileup_bins(rec, 0.05, route)
    elif site == "aperture_counts":
        rng = np.random.default_rng(37)
        paths = torch.as_tensor(rng.uniform(0.0, 3.0, (2, 16, 24, 3)),
                                dtype=torch.float32, device=dev)
        mu = rng.uniform(0.1, 0.5, (3, 40))
        i0 = rng.uniform(10.0, 1e4, 40)
        call = lambda: aperture.aperture_counts(paths, mu, i0)  # noqa: E731
    elif site == "scatter_kernel":
        c = _realism_counts().to(dev)
        k = scatter.scatter_kernel(64, sigma_ch=8.0)
        call = lambda: scatter.add_scatter(c, _REALISM_AIR, k)  # noqa: E731
    elif site == "auto_tcm_profile":
        from dexct_tpu_torch.physics import kramers_spectrum
        from dexct_tpu_torch.pipeline import tcm
        from dexct_tpu_torch.system import (FanBeamGeometry,
                                            water_cylinder_phantom)

        ph = water_cylinder_phantom(N=32, dx=0.6)
        ct = FanBeamGeometry(N_channels=32, N_proj=16, gamma_fan=0.9,
                             SID=60.0, SDD=100.0, eid=True)
        spec = kramers_spectrum(80.0)
        spec.rescale_counts(1e6)
        paths = torch.rand((16, 32, ph.n_materials), device=dev)
        call = lambda: tcm.auto_tcm_profile(  # noqa: E731
            ct, ph, spec, paths=paths)
    elif site == "normalize_counts":
        from dexct_tpu_torch.pipeline import tcm

        c = _realism_counts().to(dev)
        m = np.linspace(0.5, 2.0, c.shape[0])
        call = lambda: tcm.normalize_counts(c, m)  # noqa: E731
    elif site == "cone_operator":
        from dexct_tpu_torch.system import ConeBeamGeometry

        ct = ConeBeamGeometry(N_channels=32, N_proj=12, N_rows=4, SID=60.0,
                              SDD=100.0, h_iso=0.5)
        call = lambda: conebeam._cone_operator(  # noqa: E731
            ct, (8, 24, 24), (0.5, 0.5, 0.5), dev)
    elif site.startswith("fbp_recon"):
        from dexct_tpu_torch.ops import fbp
        from dexct_tpu_torch.system import FanBeamGeometry

        rot = 4.2 if site.endswith("short") else 2.0 * np.pi
        ct = FanBeamGeometry(N_channels=64, N_proj=72, SID=60.0, SDD=100.0,
                             rotation_total=rot)
        sino = torch.as_tensor(np.random.default_rng(39).uniform(
            0.0, 4.0, (72, 64)), dtype=torch.float32, device=dev)
        call = lambda: fbp.fbp_recon(sino, ct, 40, 24.0)  # noqa: E731
    elif site == "parallel_fbp":
        from dexct_tpu_torch.ops import fbp
        from dexct_tpu_torch.system import ParallelBeamGeometry

        ct = ParallelBeamGeometry(N_channels=64, N_proj=60)
        sino = torch.as_tensor(np.random.default_rng(39).uniform(
            0.0, 4.0, (60, 64)), dtype=torch.float32, device=dev)
        call = lambda: fbp.parallel_fbp(sino, ct, 40, 3.5)  # noqa: E731
    elif site == "parallel_backproject_mask":
        rng = np.random.default_rng(38)
        packed = torch.as_tensor(rng.normal(size=(48 * 128, 2)),
                                 dtype=torch.float32, device=dev)
        th = torch.arange(48, dtype=torch.float32, device=dev) * (np.pi / 48)
        call = lambda: parallel_backproject_multi(  # noqa: E731
            packed, 1, th, -20.0, 40.0 / 128, 128, 64, 24.0, np.pi / 48)
    elif site.startswith("forward_counts"):
        from dexct_tpu_torch.ops.bowtie import design_flattening_bowtie
        from dexct_tpu_torch.ops.spectral import forward_counts
        from dexct_tpu_torch.physics import kramers_spectrum
        from dexct_tpu_torch.system import (FanBeamGeometry,
                                            water_cylinder_phantom)

        ct = FanBeamGeometry(N_channels=24, N_proj=10, eid=True)
        ph = water_cylinder_phantom(N=16)
        spec = kramers_spectrum(80.0)
        spec.rescale_counts(1e6)
        rng = np.random.default_rng(40)
        paths = torch.as_tensor(rng.uniform(0.0, 12.0, (10, 24, 2)),
                                dtype=torch.float32, device=dev)
        kw = {}
        if site.endswith(("bowtie", "compound")):
            kw["bowtie"] = design_flattening_bowtie(ct, 8.0)
        if site.endswith(("tcm", "compound")):
            kw["tcm"] = rng.uniform(0.5, 2.0, 10)
        if site.endswith("compound"):
            kw.update(noise="compound", sigma_e=37.5,
                      generator=torch.Generator(device=dev).manual_seed(41))
        call = lambda: forward_counts(paths, ph, spec, ct,  # noqa: E731
                                      **kw)
    elif site == "material_path_sinogram":
        from dexct_tpu_torch.ops.siddon import material_path_sinogram
        from dexct_tpu_torch.system import (FanBeamGeometry,
                                            water_cylinder_phantom)

        ph = water_cylinder_phantom(N=24, dx=0.6)
        ct = FanBeamGeometry(N_channels=32, N_proj=12, eid=True)
        call = lambda: material_path_sinogram(  # noqa: E731
            ph, ct, device=dev)
    else:
        c = _realism_counts().to(dev)
        call = lambda: iterative.pwls_weights(  # noqa: E731
            c, sigma_e=2.5, var_ratio=1.3)
    _no_sync(call)

@pytest.mark.parametrize("n_tab,dtype", [(800, torch.float32),
                                         (512 * 512, torch.int32),
                                         (12288, torch.float32)])
def test_gather_kernels_match_plain_bit_for_bit(dev, n_tab, dtype):
    from dexct_tpu_torch.tools import bench_gather as bg

    gen = torch.Generator(device=dev).manual_seed(n_tab)
    if dtype == torch.int32:
        tab = torch.randint(0, 6, (n_tab,), generator=gen, device=dev,
                            dtype=torch.int32)
    else:
        tab = torch.randn(n_tab, generator=gen, device=dev)
    idx = torch.randint(0, n_tab, (1 << 20,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:2] = torch.tensor([0, n_tab - 1], device=dev)
    want = bg.gather_plain(tab, idx)
    fns = [bg.gather_take] + ([bg.gather_vmem]
                              if n_tab <= bg.MAX_VMEM_WORDS else [])
    for fn in fns:
        before = fn.launches
        got = fn(tab, idx)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("kind", tiny_cases.SWEEP_KINDS)
def test_sweeps_cuda_match_cpu(dev, kind):
    got = tiny_cases.sweep(kind, dev)
    want = tiny_cases.sweep(kind, "cpu")
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= tiny_cases.SWEEP_TOL[name], name


# ---------------------------------------------------------------------------
# K2 in CUDA C++, bit for bit its Triton parent; the counts' host uploads
# ---------------------------------------------------------------------------

# sha1 of K2's output (the counts, then the second moment where there is
# one) on probe_k2's cases: both spectra of the exact path's 8e5 rays (K1),
# the cone config's 1.47M and the helical config's 2.95M (K10), with and
# without i2; seeded rays at 1, 127, 129 and 4097 rays, M in {1, 2, 6, 8,
# 12}, E in {1, 63, 64, 65, 100, 140, 200}, and rays past both clamps and
# into float32's subnormal exps.  Pinned from K2's Triton parent, the first
# K2 (NVIDIA H100 80GB HBM3, CUDA 12.8, Triton 3.6.0); chip_smoke.py holds
# the same.
K2_PINNED_SHA1 = {
    "exact_s1": "8ce7dbe69c7942c92d1803692a7897eef1cf33a4",
    "exact_s1_i2": "8be99adc386b7e1b197ec7a5067186ac91f66f20",
    "exact_s2": "b5aa23477c5716442a835c0a163c4a66529b8f20",
    "exact_s2_i2": "5cb3a14065b4b56054aaeabde5addd982e2c5b4c",
    "cone_s1": "a34521c0e429547ed34a2358ffc991922c212809",
    "cone_s1_i2": "dcd8a878ad76ddbbd73f136829dca34461c1eb51",
    "cone_s2": "cecc9d7eb0f50436310b48d7fa2ac5ce96a70a32",
    "cone_s2_i2": "6667b90163e92954214d49c2a6e1b98e2b179e39",
    "helical_s1": "f153c5f68f2cdc4ffc1547d4cc4be0fa23cc0d6c",
    "helical_s1_i2": "bc010dac9030878e83bebbd538a2ef80fa9b568b",
    "helical_s2": "d0da4ab54e33a7ceed9a1765cc73d83f6234b97a",
    "helical_s2_i2": "10868c08e19567a4ed05d7794bb0503ae375c081",
    "r4097_m6_e1_i2": "0cb50dd3746bb27e3a96edc20be321993f130e83",
    "r4097_m6_e63_i2": "88c84e71ec4735ec311a6295662fa199112ab048",
    "r4097_m6_e64_i2": "11e9e272da52fc049940e2d838eec524c53abc4d",
    "r4097_m6_e65_i2": "91c410296577e5df87dea0b0032712e9c8531e75",
    "r4097_m6_e100_i2": "e758481ee95077b36c6d5e8d9df94b5fc387d852",
    "r4097_m6_e140_i2": "6f74b79964d6464ab1516e2f88a3925af0c70513",
    "r4097_m6_e200_i2": "90cbd09ff2ad9b1eaa2873f5f8be81ccbb2b68ce",
    "r129_m1_e140": "d096aa71aaa0b8fcdf2e74d1a09796de8da24575",
    "r129_m2_e140": "d58e3c223ad0a532a60ee94997174db46a663353",
    "r129_m8_e140": "834e9965c84b21b6376c32144dd02a7d34960ac8",
    "r129_m12_e100_i2": "2e4e0e10e9a7c6b39ed950bd5c98d60dff4daff3",
    "r1_m2_e65": "db7551cac988ee24cf2e5e557e56ccc1ff34cdb2",
    "r1_m2_e65_i2": "0772430b6fed1214624463076df15b9012adba7f",
    "r127_m2_e65": "71c73ff433476d6cc19e7fb995d74a8b0cbd8a2b",
    "r127_m2_e65_i2": "fe5f9bf2904078adb718cf4d37b9723401c8e823",
    "r129_m2_e65": "1d9ae1f75f3b0e566532961cbfc26d736d515ac0",
    "r129_m2_e65_i2": "b7d51942dd0ed3c7c58cb6ea18d5990c899b9395",
    "r4097_m8_e200": "a83b8994232a2c08c0c759bbf363c0514fadfbc5",
    "clamp_r4097_m6_e140_i2": "5019049e7e71ea6160d8f8a943a13f7ec9edc708",
}


@pytest.fixture(scope="module")
def k2_paths():
    """probe_k2's path cases on the card, traced once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from dexct_tpu_torch.tools.probe_k2 import path_cases

    return path_cases(torch.device("cuda"))


def _k2_case(name, dev, k2_paths):
    from dexct_tpu_torch.tools.probe_k2 import pin_case

    return k2_paths[name] if name in k2_paths else pin_case(name, dev)


@pytest.mark.parametrize("case", list(K2_PINNED_SHA1))
def test_k2_keeps_its_pinned_bits(dev, k2_paths, case):
    """K2 gives its Triton parent's output bit for bit at the paths' shapes
    and on the seeded cases, in one launch."""
    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.tools.probe_k2 import counts, output_sha1

    paths, mu, i0, i2 = _k2_case(case, dev, k2_paths)
    before = counts_from_paths.launches
    out = counts(spectral, paths, mu, i0, i2)
    torch.cuda.synchronize()
    assert counts_from_paths.launches == before + 1
    assert output_sha1(out) == K2_PINNED_SHA1[case]


@pytest.mark.parametrize("case", ["exact_s2_i2", "helical_s1",
                                  "r4097_m6_e65_i2", "r129_m12_e100_i2"])
def test_k2_two_launches_are_equal(dev, k2_paths, case):
    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.tools.probe_k2 import counts

    args = _k2_case(case, dev, k2_paths)
    a, b = counts(spectral, *args), counts(spectral, *args)
    if args[3] is None:
        a, b = (a,), (b,)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("with_i2", [False, True])
def test_k2_makes_no_host_synchronisation(dev, with_i2):
    """K2's call on tensors on the card copies nothing from the host and
    reads nothing back."""
    from dexct_tpu_torch.tools.probe_k2 import pin_case

    paths, mu, i0, i2 = pin_case("clamp_r4097_m6_e140_i2", dev)
    args = (paths, mu, i0) + ((i2,) if with_i2 else ())
    before = counts_from_paths.launches
    _no_sync(lambda: counts_from_paths(*args))
    assert counts_from_paths.launches == before + 2


def test_k2_is_not_triton(dev):
    """K2 is the nvcc library's ``dexct_spectral_counts``: the Triton
    kernel and its tiles are gone, and a process that runs K2 imports no
    Triton."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.utils import kernels

    for name in ("_counts_kernel", "_BLOCK_R", "_BLOCK_E"):
        assert not hasattr(spectral, name), name
    assert "spectral_counts.cu" in kernels.SOURCES
    assert hasattr(kernels.library(), "dexct_spectral_counts")
    code = ("import sys, torch\n"
            "from dexct_tpu_torch.ops.spectral import counts_from_paths\n"
            "d = torch.device('cuda')\n"
            "c = counts_from_paths(torch.ones((5, 6), device=d),\n"
            "                      torch.ones((6, 70), device=d),\n"
            "                      torch.ones(70, device=d))\n"
            "torch.cuda.synchronize()\n"
            "assert counts_from_paths.launches == 1\n"
            "print('triton' in sys.modules)\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


def _counts_uploads():
    """``tests/test_torch_counts_uploads.py`` as a module: its tiny cases
    of the repaired upload sites."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).with_name("test_torch_counts_uploads.py")
    spec = importlib.util.spec_from_file_location("_counts_uploads", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync_functions(call):
    """The calls of ``call()`` that synchronise the host with the card:
    {"file:function" of the innermost frame of the port: count}."""
    import collections
    import traceback
    import warnings
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sites = collections.Counter()
    on = []

    def show(message, category, filename, lineno, file=None, line=None):
        if on and "synchroniz" in str(message):
            port = [f for f in traceback.extract_stack()[:-1]
                    if "dexct_tpu_torch" in f.filename]
            f = port[-1] if port else traceback.extract_stack()[-2]
            try:
                name = Path(f.filename).resolve().relative_to(root)
            except ValueError:
                name = f.filename
            sites[f"{name}:{f.name}"] += 1

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        on.append(True)
        try:
            call()
        finally:
            on.clear()
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return dict(sites)


COUNTS_UPLOAD_SITES = (
    "cone_sinogram", "flat_cone_sinogram", "simulate_cone_dect_flat",
    "simulate_cone_dect_heel", "cone_sinogram_heel", "counts_from_paths_heel",
    "decompose_cone_sinograms_heel", "decompose_sinograms_bowtie",
    "simulate_dect_realistic")
# the calls of those sites that still synchronise for reasons of their own,
# each named by the innermost function of the port that makes it: K29's
# pixel layout sizes its arrays from the groups' pixel counts, which it
# counts on the card and reads back (bincount, sum, repeat_interleave)
COUNTS_UPLOAD_SYNCS = {
    site: {"dexct_tpu_torch/ops/matdecomp.py:group_layout"}
    for site in ("simulate_cone_dect_heel", "decompose_cone_sinograms_heel",
                 "decompose_sinograms_bowtie", "simulate_dect_realistic")}


@pytest.mark.parametrize("site", COUNTS_UPLOAD_SITES)
def test_counts_uploads_do_not_synchronise(dev, site):
    """The stateless 3-D branch, the heel's and the bowtie's counts and
    decompositions and the realistic pipeline send their host tables and
    sinograms to the card through pinned memory: none of them synchronises
    the host with the card, apart from the calls
    ``COUNTS_UPLOAD_SYNCS`` names."""
    call = _counts_uploads().site_call(site, dev)
    call()
    torch.cuda.synchronize()
    syncs = _sync_functions(call)
    assert set(syncs) <= COUNTS_UPLOAD_SYNCS.get(site, set()), syncs
