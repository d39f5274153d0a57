"""The port's z-stack (pipeline/zstack.py, plain versions on the CPU)
against the JAX package's, on tests/test_zstack.py's system: 64 channels x
96 views through a 4-slice stack_phantom of contrast_rods_phantom (64^2 at
0.4 cm), 8 Gauss-Newton iterations.  Whole-step outputs are held to
tests/test_torch_pipeline.py's TOL (the bars of tests/test_pipeline.py).

The slice-batched trace (K17's plain version) is held bitwise to the
single-slice trace on every slice, within 1e-4 cm to the JAX package's
exact DDA, and within the JAX package's own tracer bar (2e-3 cm) to its
slice-paired dominant-axis trace, which deviates from its own DDA by
~4e-4 cm on these rays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops.siddon import trace_paths as j_trace
from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline.fused import make_jitted_step
from dexct_tpu.pipeline.fused import pack_dect as j_pack
from dexct_tpu.pipeline.zstack import _inject_pair_paths
from dexct_tpu.pipeline.zstack import make_jitted_zstack_step as j_make
from dexct_tpu.pipeline.zstack import pack_zstack as j_pack_z
from dexct_tpu.pipeline.zstack import stack_phantom as j_stack
from dexct_tpu.system import FanBeamGeometry, contrast_rods_phantom
from dexct_tpu_torch.ops.siddon import (labels_stack_tensor,
                                        trace_paths_plain, trace_paths_stack,
                                        trace_paths_stack_plain)
from dexct_tpu_torch.pipeline import fused as t_fused
from dexct_tpu_torch.pipeline import zstack as t_z
from dexct_tpu_torch.system import phantom as t_phantom

TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
       "sino_log": dict(rtol=0.0, atol=1e-4),
       "mat_sinos": dict(rtol=0.0, atol=1e-3),
       "recon_raw": dict(rtol=0.0, atol=1e-4),
       "recon_HU": dict(rtol=0.0, atol=1.0),
       "mat_recons": dict(rtol=0.0, atol=1e-3)}
NZ = 4
KW = dict(n_iters=8, recon_n_theta=64, recon_nt=128, n_theta=128)
CHOICES = [("siddon", "fan"), ("siddon_dominant", "parallel"),
           ("fourier", "parallel")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    ct = FanBeamGeometry(N_channels=64, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    ph = j_stack(contrast_rods_phantom, NZ, N=64, dx=0.4)
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return ct, ph, s1, s2


def _assert_close(got, want, keys=TOL, index=None):
    for key in keys:
        for i in range(2):
            w = np.asarray(want[key][i])
            np.testing.assert_allclose(
                got[key][i].numpy(), w if index is None else w[index],
                err_msg=f"{key}[{i}]", **TOL[key])


def _rays(ct):
    src, dirs = ct.ray_geometry()
    return (torch.as_tensor(src, dtype=torch.float32),
            torch.as_tensor(dirs, dtype=torch.float32))


def test_stack_phantom_matches_jax(system):
    _, ph, _, _ = system
    got = t_z.stack_phantom(t_phantom.contrast_rods_phantom, NZ, N=64,
                            dx=0.4)
    assert got.name == ph.name and got.labels.shape == (NZ, 64, 64)
    np.testing.assert_array_equal(got.labels, ph.labels)
    assert (got.dx, got.dy, got.dz) == (ph.dx, ph.dy, ph.dz)


@pytest.mark.parametrize("projector,recon", CHOICES)
def test_zstack_matches_jax(system, projector, recon):
    """Every output of every slice, all three projector/recon pairs."""
    kw = dict(KW, projector=projector, recon=recon)
    arrays, meta, axes = j_pack_z(*system, 64, 20.0, 0.8, **kw)
    want = j_make(meta, axes)(arrays)
    a, m, ax = t_z.pack_zstack(*system, 64, 20.0, 0.8, device="cpu", **kw)
    got = t_z.make_jitted_zstack_step(m, ax)(a)
    assert got["recon_HU"][0].shape == (NZ, 64, 64)
    assert got["mat_sinos"][0].shape == (NZ, 96, 64)
    _assert_close(got, want)


@pytest.mark.parametrize("projector,recon", CHOICES)
def test_zstack_shared_and_stacked_split(system, projector, recon):
    """The JAX split: labels stacked, the geometry, spectra, plans and
    rebin tables shared; the shared arrays are the single-slice pack's."""
    kw = dict(KW, projector=projector, recon=recon)
    _, j_axes = j_pack_z(*system, 64, 20.0, 0.8, **kw)[1:]
    a, m, ax = t_z.pack_zstack(*system, 64, 20.0, 0.8, device="cpu", **kw)
    assert ax["labels"] == 0 and tuple(a["labels"].shape) == (NZ, 64, 64)
    assert a["labels"].dtype == torch.uint8
    for k, v in ax.items():
        assert v == j_axes[k], k
    ct, ph, s1, s2 = system
    one, m1 = t_fused.pack_dect(ct, ph, s1, s2, 64, 20.0, 0.8, device="cpu",
                                **kw)
    assert m == m1
    assert set(a) == set(one)
    for k in a:
        if ax[k] is None:
            torch.testing.assert_close(a[k], one[k], rtol=0, atol=0)


def test_zstack_layout_options_are_accepted(system):
    """trace_pairs and trace_bundle choose TPU layouts: accepted, ignored."""
    kw = dict(KW, n_iters=2, projector="siddon_dominant", recon="fan")
    a, m, ax = t_z.pack_zstack(*system, 64, 20.0, 0.8, device="cpu", **kw)
    b, mb, bx = t_z.pack_zstack(*system, 64, 20.0, 0.8, device="cpu",
                                trace_pairs=False, trace_bundle=8, **kw)
    assert m == mb and ax == bx
    out_a = t_z.zstack_step(a, m, ax)
    out_b = t_z.zstack_step(b, mb, bx)
    torch.testing.assert_close(out_a["sino_raw"][0], out_b["sino_raw"][0],
                               rtol=0, atol=0)


def test_zstack_chunked_matches_full(system):
    a, m, ax = t_z.pack_zstack(*system, 64, 20.0, 0.8, device="cpu",
                               n_iters=6, projector="siddon", recon="fan")
    full = t_z.make_jitted_zstack_step(m, ax)(a)
    chunked = t_z.make_jitted_zstack_step(m, ax, z_chunk=2)(a)
    for key in full:
        for i in range(2):
            torch.testing.assert_close(chunked[key][i], full[key][i],
                                       rtol=0, atol=0)
    with pytest.raises(ValueError, match="divisible"):
        t_z.make_jitted_zstack_step(m, ax, z_chunk=3)(a)


@pytest.mark.parametrize("z_indices", [[1, 3], [0, 1, 2]],
                         ids=["subset", "odd"])
def test_zstack_z_indices(system, z_indices):
    """Subsets and odd counts: each slice equals its single-slice run,
    in the port and in the JAX package."""
    kw = dict(KW, projector="siddon_dominant", recon="parallel")
    a, m, ax = t_z.pack_zstack(*system, 64, 20.0, 0.8, device="cpu",
                               z_indices=z_indices, **kw)
    got = t_z.zstack_step(a, m, ax)
    assert got["recon_HU"][0].shape[0] == len(z_indices)
    ja, jm, jax_ = j_pack_z(*system, 64, 20.0, 0.8, z_indices=z_indices,
                            **kw)
    _assert_close(got, j_make(jm, jax_)(ja))
    ct, ph, s1, s2 = system
    pos, z = len(z_indices) - 1, z_indices[-1]
    a1, m1 = t_fused.pack_dect(ct, dataclasses.replace(ph, z_index=z), s1,
                               s2, 64, 20.0, 0.8, device="cpu", **kw)
    ref = t_fused.dect_step(a1, m1)
    for key in ref:
        for i in range(2):
            torch.testing.assert_close(got[key][i][pos], ref[key][i],
                                       rtol=0, atol=0)


def test_zstack_noise_is_per_slice(system):
    """One generator per slice, seeded from (seed, z): identical slices
    get different draws, a rerun the same ones, and the noise's relative
    spread matches the JAX z-stack's (statistics, not draws)."""
    ct, ph, s1, s2 = system
    same = dataclasses.replace(
        ph, labels=np.broadcast_to(ph.labels[0], ph.labels.shape).copy())
    kw = dict(n_iters=4, projector="siddon", recon="fan", noise="compound",
              seed=7)
    a, m, ax = t_z.pack_zstack(ct, same, s1, s2, 64, 20.0, 0.8,
                               device="cpu", **kw)
    assert ax["noise_seed"] == 0
    assert [int(s) for s in a["noise_seed"]] == [
        t_z.slice_seed(7, z) for z in range(NZ)]
    out = t_z.zstack_step(a, m, ax)
    raw = out["sino_raw"][1]
    for z in range(1, NZ):
        assert not torch.equal(raw[z], raw[0])
    torch.testing.assert_close(t_z.zstack_step(a, m, ax)["sino_raw"][1], raw,
                               rtol=0, atol=0)
    clean = t_z.zstack_step(a, m._replace(noise="none"), ax)["sino_raw"][1]
    ja, jm, jax_ = j_pack_z(ct, same, s1, s2, 64, 20.0, 0.8, **kw)
    j_raw = np.asarray(j_make(jm, jax_)(ja)["sino_raw"][1])
    got_rel = (raw / clean - 1.0).numpy()
    want_rel = j_raw / clean.numpy() - 1.0
    assert abs(float(got_rel.mean())) < 0.2 * float(got_rel.std())
    assert abs(float(want_rel.mean())) < 0.2 * float(want_rel.std())
    # 4 x 6144 draws each: the spreads agree to a few percent
    np.testing.assert_allclose(got_rel.std(), want_rel.std(), rtol=0.1)


def test_zstack_air_mask_is_per_slice(system):
    """Slices whose count maxima differ: the rods phantom in air (air rays
    set its maximum) and a slice filled with water, seen through a fan
    (0.4 rad, 11.7 cm at the isocentre) that lies inside the grid's
    inscribed circle, so every ray crosses >= 10 cm of water and the
    slice's maximum is lower (0.55 x on the MV spectrum).  Each slice masks against its own
    maximum, as the JAX step does under its vmap."""
    _, ph, s1, s2 = system
    ct = FanBeamGeometry(N_channels=64, N_proj=96, gamma_fan=0.4, SID=60.0,
                         SDD=100.0, eid=True)
    lab = np.array(ph.labels)
    lab[1] = 1  # every cell water (material 1 of the rods phantom)
    stack = dataclasses.replace(ph, labels=lab)
    kw = dict(n_iters=8, projector="siddon", recon="fan")
    a, m, ax = t_z.pack_zstack(ct, stack, s1, s2, 64, 20.0, 0.8,
                               device="cpu", **kw)
    got = t_z.zstack_step(a, m, ax)
    ja, jm, jax_ = j_pack_z(ct, stack, s1, s2, 64, 20.0, 0.8, **kw)
    _assert_close(got, j_make(jm, jax_)(ja))
    c1 = got["sino_raw"][0]
    maxima = c1.reshape(NZ, -1).max(1).values
    assert float(maxima[1]) < 0.9 * float(maxima[0])
    own = c1[1] >= m.mask_thresh * maxima[1]
    assert bool(own.any())  # masked against its own maximum ...
    assert not bool((c1[1] >= m.mask_thresh * maxima.max()).any())
    assert bool((got["mat_sinos"][0][1][own] == 0).all())
    assert bool((got["mat_sinos"][0][1][~own] != 0).all())


def test_trace_paths_stack_plain_matches_per_slice(system):
    """Slice z of the stacked trace is the single-slice trace, bit for bit,
    and within 1e-4 cm of the JAX package's exact DDA on that slice."""
    ct, ph, _, _ = system
    src, dirs = _rays(ct)
    labels = torch.as_tensor(ph.labels.astype(np.uint8))
    got = trace_paths_stack(labels, src, dirs, ph.dx, ph.dy,
                            n_materials=ph.n_materials)
    assert got.shape == (NZ, 96, 64, ph.n_materials)
    torch.testing.assert_close(
        got, trace_paths_stack_plain(labels, src, dirs, ph.dx, ph.dy,
                                     n_materials=ph.n_materials),
        rtol=0, atol=0)
    for z in range(NZ):
        one = trace_paths_plain(labels[z], src, dirs, ph.dx, ph.dy,
                                n_materials=ph.n_materials)
        torch.testing.assert_close(got[z], one, rtol=0, atol=0)
        want = np.asarray(j_trace(jnp.asarray(ph.labels[z]),
                                  jnp.asarray(src.numpy()),
                                  jnp.asarray(dirs.numpy()), ph.dx, ph.dy,
                                  n_materials=ph.n_materials))
        np.testing.assert_allclose(got[z].numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("z_indices", [None, [0, 1, 2]],
                         ids=["even", "odd"])
def test_trace_paths_stack_matches_jax_pair_trace(system, z_indices):
    """The JAX z-stack's slice-paired dominant-axis trace
    (_inject_pair_paths), inverse-permuted from its ray plan to [V, C]."""
    ct, ph, s1, s2 = system
    arrays, meta, axes = j_pack_z(
        ct, ph, s1, s2, 64, 20.0, 0.8, n_iters=2,
        projector="siddon_dominant", recon="fan", z_indices=z_indices)
    nz = NZ if z_indices is None else len(z_indices)
    a, _ = _inject_pair_paths(arrays, meta, axes, nz)
    want = np.asarray(a["paths"])[:, np.asarray(a["dom_inv"])].reshape(
        nz, 96, 64, -1)
    src, dirs = _rays(ct)
    zs = list(range(NZ)) if z_indices is None else z_indices
    got = trace_paths_stack(torch.as_tensor(ph.labels[zs].astype(np.uint8)),
                            src, dirs, ph.dx, ph.dy,
                            n_materials=ph.n_materials)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_trace_paths_stack_rejects_bad_inputs(system):
    ct, ph, _, _ = system
    src, dirs = _rays(ct)
    with pytest.raises(ValueError, match="Nz, Ny, Nx"):
        trace_paths_stack(torch.zeros((64, 64), dtype=torch.uint8), src,
                          dirs, 0.4, 0.4, n_materials=2)
    with pytest.raises(ValueError, match="n_materials"):
        trace_paths_stack(torch.zeros((2, 64, 64), dtype=torch.uint8), src,
                          dirs, 0.4, 0.4, n_materials=33)
    with pytest.raises(ValueError, match="0..255"):
        labels_stack_tensor(np.full((2, 8, 8), 300), "cpu")
    with pytest.raises(ValueError, match="empty"):
        t_z.pack_zstack(*system, 64, 20.0, 0.8, device="cpu", z_indices=[])


def test_zstack_single_slice_matches_jax_step(system):
    """A one-slice stack is the JAX single-slice step (and keeps its seed)."""
    ct, ph, s1, s2 = system
    kw = dict(KW, projector="fourier", recon="parallel")
    a, m, ax = t_z.pack_zstack(ct, ph, s1, s2, 64, 20.0, 0.8, device="cpu",
                               z_indices=[2], **kw)
    got = t_z.zstack_step(a, m, ax)
    arrays, meta = j_pack(ct, dataclasses.replace(ph, z_index=2), s1, s2, 64,
                          20.0, 0.8, **kw)
    want = jax.tree.map(lambda x: np.asarray(x)[None],
                        make_jitted_step(meta)(arrays))
    _assert_close(got, want)
