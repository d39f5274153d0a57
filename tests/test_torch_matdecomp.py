"""The port's Gauss-Newton decomposition (plain version on the CPU) against
the JAX package's solver and the float64 oracle.  Tolerance: relative error
< 1e-4 with a floor of 1 g/cm^2, the JAX package's own parity bar."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops.matdecomp import gauss_newton_solve as j_solve
from dexct_tpu.ops.matdecomp import prepare_decomposition as j_prepare
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.system import FanBeamGeometry
from dexct_tpu.utils.testing import gauss_newton_decompose_numpy
from dexct_tpu_torch.ops import matdecomp as t_md


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def de_tables():
    """The reference protocol's pair on the shipped EID detector: union
    grid of detunedMV and 80 kV (> 64 bins, so the warm phase runs on the
    compressed table)."""
    ct = FanBeamGeometry(N_channels=800, N_proj=1000, eid=True,
                         detector_file="input/detector/eta_eid_mv.bin")
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    _, i0, mus = j_prepare(ct, s1, s2)
    assert i0.shape[1] > 64
    return i0, mus


def _counts(i0, mus, a_true):
    return (np.exp(-a_true @ mus) @ i0.T).T  # float64 forward model [2, P]


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


def test_matches_jax_and_float64_oracle(de_tables):
    i0, mus = de_tables
    rng = np.random.default_rng(1)
    a_true = np.stack([rng.uniform(0, 40, 500), rng.uniform(0, 12, 500)], -1)
    counts = _counts(i0, mus, a_true)
    got = t_md.gauss_newton_solve(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (counts, i0, mus)),
        n_iters=50).numpy()
    want = np.asarray(j_solve(jnp.asarray(counts, jnp.float32),
                              jnp.asarray(i0, jnp.float32),
                              jnp.asarray(mus, jnp.float32), n_iters=50))
    oracle = gauss_newton_decompose_numpy(counts, i0, mus, 50)
    assert _rel(got, want).max() < 1e-4
    assert _rel(got, oracle).max() < 1e-4
    assert _rel(got, a_true).max() < 1e-4


@pytest.mark.parametrize("n_iters,warm_nodes", [(20, 32), (3, 32), (50, 0)])
def test_schedule_variants_match_jax(de_tables, n_iters, warm_nodes):
    """Fewer iterations than the polish (no warm phase), the default
    compressed warm table, and the uncompressed one."""
    i0, mus = de_tables
    rng = np.random.default_rng(2)
    a_true = np.stack([rng.uniform(0, 30, 300), rng.uniform(0, 5, 300)], -1)
    counts = _counts(i0, mus, a_true)
    got = t_md.gauss_newton_solve(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (counts, i0, mus)),
        n_iters=n_iters, warm_nodes=warm_nodes, pixel_block=128).numpy()
    want = np.asarray(j_solve(jnp.asarray(counts, jnp.float32),
                              jnp.asarray(i0, jnp.float32),
                              jnp.asarray(mus, jnp.float32), n_iters=n_iters,
                              warm_nodes=warm_nodes, pixel_block=128))
    assert _rel(got, want).max() < 1e-4


def test_starved_and_air_pixels_stay_finite(de_tables):
    i0, mus = de_tables
    counts = np.array([[0.0, 1e-20, i0[0].sum()], [0.0, 0.0, i0[1].sum()]])
    got = t_md.gauss_newton_solve(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (counts, i0, mus)),
        n_iters=50).numpy()
    want = np.asarray(j_solve(jnp.asarray(counts, jnp.float32),
                              jnp.asarray(i0, jnp.float32),
                              jnp.asarray(mus, jnp.float32), n_iters=50))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_warm_products_round_once(de_tables):
    """The warm phase's bfloat16 products are the float32 sums of the exact
    products of the bfloat16-rounded operands, rounded once to bfloat16
    (the JAX program's rounding), bit for bit, whatever the CPU's bf16
    GEMM backend would do."""
    i0, mus = de_tables
    rng = np.random.default_rng(4)
    a = torch.as_tensor(np.concatenate([
        rng.uniform(-1.0, 60.0, (4000, 2)),
        rng.uniform(0.0, 1e-3, (96, 2))]), dtype=torch.float32)
    musT = torch.as_tensor(np.asarray(mus).T, dtype=torch.float32)
    got = t_md._bf16_products(a, musT)
    ab = a.to(torch.bfloat16).double().numpy()
    mb = musT.to(torch.bfloat16).double().numpy()
    exact = ab[:, :1] * mb[:, 0] + ab[:, 1:] * mb[:, 1]  # exact in float64
    want = torch.as_tensor(exact.astype(np.float32)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


_HOST_PROBE = """
import hashlib, sys
import numpy as np, torch
from dexct_tpu_torch.ops import matdecomp, spectral
torch.set_num_threads(int(sys.argv[2]))
d = np.load(sys.argv[1])
paths, i0, mus = (torch.as_tensor(d[k]) for k in ("paths", "i0", "mus"))
counts = torch.stack([spectral.counts_from_paths_plain(paths, mus, i0[k])
                      for k in range(2)])
ab = matdecomp.gauss_newton_solve_plain(counts, i0, mus, n_iters=50)
print(hashlib.sha1(counts.numpy().tobytes() + ab.numpy().tobytes())
      .hexdigest())
"""


def test_plain_rounding_does_not_follow_the_host(de_tables, tmp_path):
    """The plain counts and Gauss-Newton solve give the same bits whatever
    instruction set the CPU's BLAS and vector-math kernels are held to
    (MKL's, where PyTorch uses it; ATen's own) and whatever the thread
    count: their float32 exp, log, sqrt and matrix products would not."""
    import os
    import subprocess
    import sys

    i0, mus = de_tables
    rng = np.random.default_rng(6)
    paths = np.stack([rng.uniform(0, 40, 3000), rng.uniform(0, 12, 3000)],
                     -1)
    np.savez(tmp_path / "in.npz", paths=paths.astype(np.float32),
             i0=np.asarray(i0, np.float32), mus=np.asarray(mus, np.float32))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    digests = set()
    for env, threads in (({}, 2), ({"MKL_ENABLE_INSTRUCTIONS": "SSE4_2"}, 2),
                         ({"MKL_ENABLE_INSTRUCTIONS": "AVX2"}, 1),
                         ({"ATEN_CPU_CAPABILITY": "default"}, 4)):
        out = subprocess.run(
            [sys.executable, "-c", _HOST_PROBE, str(tmp_path / "in.npz"),
             str(threads)], cwd=repo, env={**os.environ, **env},
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        digests.add(out.stdout.strip())
    assert len(digests) == 1, digests


def test_material_count_checks(de_tables):
    """K > M raises the JAX ValueError, K = 5 the JAX
    NotImplementedError of the closed-form solve, and more measurements
    than the kernel's MAX_BINS a ValueError naming the limit (the same
    checks on both devices: they run before the dispatch)."""
    i0, mus = (torch.as_tensor(x, dtype=torch.float32) for x in de_tables)
    with pytest.raises(ValueError, match="measurements"):
        t_md.gauss_newton_solve(torch.ones((2, 4)), i0,
                                torch.cat([mus, mus[:1]]))
    mus5 = torch.cat([mus, mus, mus[:1]])
    with pytest.raises(NotImplementedError, match="2-4 materials"):
        t_md.gauss_newton_solve(torch.ones((5, 4)),
                                torch.cat([i0, i0, i0[:1]]), mus5)
    n = t_md.MAX_BINS + 1
    with pytest.raises(ValueError, match=f"at most {t_md.MAX_BINS}"):
        t_md.gauss_newton_solve(torch.ones((n, 4)), i0[:1].expand(n, -1),
                                mus)


def test_decompose_sinograms_matches_jax():
    from dexct_tpu.ops.matdecomp import decompose_sinograms as j_dec
    from dexct_tpu_torch.physics import kramers_spectrum as tk
    from dexct_tpu_torch.physics import linac_spectrum as tl
    from dexct_tpu_torch.system import FanBeamGeometry as TFan

    jct, tct = FanBeamGeometry(N_channels=16), TFan(N_channels=16)
    js = (linac_spectrum(), kramers_spectrum(80.0))
    ts = (tl(), tk(80.0))
    _, i0, mus = j_prepare(jct, *js)
    rng = np.random.default_rng(3)
    a_true = np.stack([rng.uniform(0, 20, 96), rng.uniform(0, 3, 96)], -1)
    a_true[:5] = 0.0  # air rays: masked to zero
    sino = _counts(i0, mus, a_true).astype(np.float32).reshape(2, 6, 16)
    want = j_dec(jct, jnp.asarray(sino[0]), jnp.asarray(sino[1]), *js,
                 n_iters=30)
    got = t_md.decompose_sinograms(tct, torch.as_tensor(sino[0]),
                                   torch.as_tensor(sino[1]), *ts, n_iters=30)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)
    assert float(got[0].reshape(-1)[:5].abs().max()) == 0.0


@pytest.mark.parametrize("n_pix", [1, 127, 129, 4097])
def test_ragged_pixel_counts_match_jax(n_pix):
    """The plain version against the JAX package's solver at pixel counts
    ragged against any group of 128 x P pixels (the card kernel's tails):
    the card tests' golden case (``probe_gauss_newton.golden_case``)
    repeated and cut to ``n_pix`` pixels, 50 iterations."""
    from dexct_tpu_torch.tools.probe_gauss_newton import golden_case

    counts, i0, mus = golden_case()
    counts = np.tile(counts, (1, -(-n_pix // counts.shape[1])))[:, :n_pix]
    got = t_md.gauss_newton_solve(
        *(torch.as_tensor(np.ascontiguousarray(x)) for x in (counts, i0,
                                                            mus)),
        n_iters=50).numpy()
    want = np.asarray(j_solve(jnp.asarray(counts), jnp.asarray(i0),
                              jnp.asarray(mus), n_iters=50))
    assert got.shape == want.shape == (n_pix, 2)
    assert _rel(got, want).max() < 1e-4
