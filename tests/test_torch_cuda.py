"""Hand-written kernels K1-K4 against their plain PyTorch versions, on the
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

from dexct_tpu_torch.ops.fbp_fast import (fan_backproject_multi,
                                          fan_backproject_multi_plain)
from dexct_tpu_torch.ops.matdecomp import (gauss_newton_solve,
                                            prepare_decomposition)
from dexct_tpu_torch.ops.siddon import trace_paths, trace_paths_plain
from dexct_tpu_torch.ops.spectral import (counts_from_paths,
                                          counts_from_paths_plain)

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


def test_dect_step_cuda_matches_cpu(dev):
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.pipeline.fused import dect_step, pack_dect
    from dexct_tpu_torch.system import FanBeamGeometry, water_cylinder_phantom

    ct = FanBeamGeometry(N_channels=128, N_proj=96, eid=True)
    ph = water_cylinder_phantom(N=96, dx=0.25)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    outs = [dect_step(*pack_dect(ct, ph, s1, s2, 64, 24.0, 0.8, n_iters=20,
                                 device=d)) for d in (dev, "cpu")]
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
