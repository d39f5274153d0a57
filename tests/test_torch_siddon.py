"""The port's exact Siddon trace (plain version on the CPU) against the JAX
package's DDA and the float64 alpha-merging oracle.  Tolerance: atol 2e-3
cm, the JAX package's own bar for its tracers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops.siddon import trace_paths as j_trace
from dexct_tpu.utils.testing import siddon_paths_numpy
from dexct_tpu_torch.ops.siddon import (material_path_sinogram,
                                        trace_paths)
from dexct_tpu_torch.system import FanBeamGeometry, pelvis_phantom


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    src = np.stack([30 * np.cos(ang), 30 * np.sin(ang)], -1) \
        + rng.normal(0, 3, (n, 2))
    th = ang + np.pi + rng.uniform(-0.5, 0.5, n)
    return src, np.stack([np.cos(th), np.sin(th)], -1)


def _port(labels, src, dirs, dx, dy, m):
    return trace_paths(torch.as_tensor(labels), torch.as_tensor(src),
                       torch.as_tensor(dirs), dx, dy, n_materials=m).numpy()


@pytest.mark.parametrize("shape,cell", [((64, 64), (0.5, 0.5)),
                                        ((48, 64), (0.7, 0.45))])
def test_random_labels_match_jax_and_oracle(shape, cell):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, shape).astype(np.int32)
    src, dirs = _rays(500, seed=1)
    src32, dirs32 = src.astype(np.float32), dirs.astype(np.float32)
    got = _port(labels, src32, dirs32, *cell, 5)
    jax_ = np.asarray(j_trace(jnp.asarray(labels), jnp.asarray(src32),
                              jnp.asarray(dirs32), *cell, n_materials=5))
    oracle = siddon_paths_numpy(labels, src, dirs, *cell, 5)
    np.testing.assert_allclose(got, jax_, atol=2e-3)
    np.testing.assert_allclose(got, oracle, atol=2e-3)


def test_axis_aligned_and_corner_rays():
    labels = np.zeros((32, 32), np.int32)
    labels[:, 16:] = 1
    src = np.array([[-50.0, 0.5], [0.5, -50.0], [-50.0, -50.0],
                    [-50.0, 16.0], [-50.0, 0.0]], np.float32)
    d = np.sqrt(0.5)
    dirs = np.array([[1.0, 0.0], [0.0, 1.0], [d, d], [1.0, 0.0],
                     [1.0, 0.0]], np.float32)
    got = _port(labels, src, dirs, 1.0, 1.0, 2)
    np.testing.assert_allclose(got[0], [16.0, 16.0], atol=1e-4)  # x sweep
    np.testing.assert_allclose(got[1], [0.0, 32.0], atol=1e-4)  # column
    # the diagonal through cell corners: half the chord in each material
    np.testing.assert_allclose(got[2], [16 * np.sqrt(2)] * 2, atol=1e-3)
    np.testing.assert_allclose(got[3], [16.0, 16.0], atol=1e-4)  # on edge
    # along an interior grid line: the JAX tie rule picks one side
    jax_ = np.asarray(j_trace(jnp.asarray(labels), jnp.asarray(src),
                              jnp.asarray(dirs), 1.0, 1.0, n_materials=2))
    np.testing.assert_allclose(got, jax_, atol=1e-5)


def test_miss_and_labels_beyond_n_materials():
    labels = np.full((16, 16), 3, np.int32)
    labels[:8] = 0
    src = np.array([[-40.0, 20.0], [-40.0, -4.0], [-40.0, 4.0]], np.float32)
    dirs = np.array([[1.0, 0.0]] * 3, np.float32)
    got = _port(labels, src, dirs, 1.0, 1.0, 2)
    np.testing.assert_array_equal(got[0], [0.0, 0.0])  # misses the grid
    np.testing.assert_allclose(got[1], [16.0, 0.0], atol=1e-5)
    # label 3 >= n_materials contributes nothing, as in the JAX one-hot
    np.testing.assert_array_equal(got[2], [0.0, 0.0])


def test_material_path_sinogram_matches_jax():
    from dexct_tpu.ops.siddon import material_path_sinogram as j_mps
    from dexct_tpu.system import FanBeamGeometry as JFan
    from dexct_tpu.system import pelvis_phantom as j_pelvis

    kw = dict(N_channels=64, N_proj=40)
    got = material_path_sinogram(pelvis_phantom(N=64, dx=0.8),
                                 FanBeamGeometry(**kw), device="cpu")
    want = np.asarray(j_mps(j_pelvis(N=64, dx=0.8), JFan(**kw),
                            method="dda"))
    assert got.shape == (40, 64, want.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_wrapper_rejects_unsupported_inputs():
    lab = torch.zeros((4, 4), dtype=torch.uint8)
    src = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="n_materials"):
        trace_paths(lab, src, src, 1.0, 1.0, n_materials=33)
    with pytest.raises(ValueError, match="unsupported device"):
        trace_paths(lab, src.to("meta"), src.to("meta"), 1.0, 1.0,
                    n_materials=2)
