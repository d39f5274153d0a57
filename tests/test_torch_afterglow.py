"""The afterglow pair's plain twins (the CPU side of kernels K36 and K37)
against the JAX package's ``apply_afterglow`` / ``correct_afterglow``, on
the CPU: one to three traps, cold and warm start, [V, C] and [V, R, C]
counts, float32 and float64 inputs: the lagged counts at rtol 1e-6, as
tests/test_torch_artifacts.py holds the chain's afterglow stage (the JAX
program runs in float32, so float64 inputs agree to its rounding), the
correction at 1e-6 of its maximum (see the test).  The
wrappers run the plain twins on CPU tensors, and both refuse more than
``MAX_TRAPS`` traps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import afterglow as j_ag
from dexct_tpu_torch.ops import afterglow as t_ag

TRAPS = {1: ([0.06], [2.0]), 2: ([0.05, 0.02], [2.0, 20.0]),
         3: ([0.04, 0.02, 0.01], [1.0, 6.0, 40.0])}


def _case(k, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(1e3, 1e5, shape).astype(dtype)
    x[shape[0] // 3:] *= 0.05  # an air -> object edge along the views
    a, tau = TRAPS[k]
    return x, a, t_ag.decay_per_view(tau, 1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(120, 48), (90, 4, 24)])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_afterglow_matches_jax(k, warm, shape, dtype):
    x, a, b = _case(k, shape, dtype, seed=10 * k + len(shape))
    want = np.asarray(j_ag.apply_afterglow(jnp.asarray(x), a, b,
                                           warm_start=warm))
    got = t_ag.apply_afterglow(torch.as_tensor(x), a, b, warm_start=warm)
    assert got.dtype == torch.as_tensor(x).dtype and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.equal(got, t_ag.apply_afterglow_plain(
        torch.as_tensor(x), a, b, warm_start=warm))
    # the correction on identical inputs, to 1e-6 of its maximum: after
    # the 20x edge each view subtracts trap terms 20x its own size, so a
    # last-bit difference there (XLA:CPU contracts products into FMAs)
    # reaches 4.3e-6 of the small values themselves
    want_back = np.asarray(j_ag.correct_afterglow(jnp.asarray(got.numpy()),
                                                  a, b, warm_start=warm))
    back = t_ag.correct_afterglow(got, a, b, warm_start=warm)
    np.testing.assert_allclose(back.numpy(), want_back, rtol=0,
                               atol=1e-6 * np.abs(want_back).max())
    assert torch.equal(back, t_ag.correct_afterglow_plain(
        got, a, b, warm_start=warm))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5)


def test_numpy_counts_on_the_cpu_device():
    x, a, b = _case(2, (40, 16), np.float32, seed=5)
    got = t_ag.apply_afterglow(x, a, b, warm_start=True, device="cpu")
    want = np.asarray(j_ag.apply_afterglow(jnp.asarray(x), a, b,
                                           warm_start=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("fn", ["apply_afterglow", "correct_afterglow",
                                "apply_afterglow_plain",
                                "correct_afterglow_plain"])
def test_more_traps_than_max_traps_raise(fn):
    k = t_ag.MAX_TRAPS + 1
    x = torch.ones((4, 3))
    with pytest.raises(ValueError, match=f"MAX_TRAPS = {t_ag.MAX_TRAPS}"):
        getattr(t_ag, fn)(x, [0.01] * k, [0.5] * k)
    # the limit itself runs
    out = getattr(t_ag, fn)(x, [0.01] * (k - 1), [0.5] * (k - 1),
                            warm_start=True)
    torch.testing.assert_close(out, x)
