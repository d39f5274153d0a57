"""The port's Fourier-slice projector (plain versions on the CPU) against
the JAX package's: the host plan (exact), the KB sampler, the Radon
transform, the fan resample and the material paths.  Tolerances: the
sampler 1e-5 of the spectrum's largest sample (16 float32 taps, any
order); the resample atol 1e-5 (measured 2.4e-7); Radon transforms and
paths atol 1e-4 cm, because the two FFT libraries (PyTorch's pocketfft,
XLA's) round differently: measured 7.6e-6 on 20 cm and 8.1e-6 on 40 cm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import fourier as j_fo
from dexct_tpu.system import FanBeamGeometry as JFan
from dexct_tpu.system import water_cylinder_phantom as j_cyl
from dexct_tpu_torch.ops import fourier as t_fo
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import pelvis_phantom as t_pelvis
from dexct_tpu_torch.system import water_cylinder_phantom as t_cyl

GEOM = dict(N_channels=80, N_proj=48, gamma_fan=0.8230337, SID=60.0,
            SDD=100.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plans():
    """The same 64^2 cylinder and scan planned by both packages."""
    jplan = j_fo.plan_fourier_projector(j_cyl(N=64, dx=0.4), JFan(**GEOM),
                                        n_theta=96)
    tplan = t_fo.plan_fourier_projector(t_cyl(N=64, dx=0.4), TFan(**GEOM),
                                        n_theta=96, device="cpu")
    return jplan, tplan


def test_kb_host_math_matches_jax():
    u = np.linspace(-2.5, 2.5, 101)
    np.testing.assert_array_equal(t_fo._kb_kernel(u), j_fo._kb_kernel(u))
    np.testing.assert_array_equal(t_fo._kb_deapod_1d(48, 96),
                                  j_fo._kb_deapod_1d(48, 96))
    for g, w in zip(t_fo.radon_grid(48, 0.3, 64), j_fo.radon_grid(48, 0.3,
                                                                  64)):
        np.testing.assert_array_equal(g, w)


def test_plan_matches_jax_exactly(plans):
    jplan, tplan = plans
    for f in ("n_img", "n_materials", "dx", "n_theta", "nt", "t0", "dt",
              "grid", "scale"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    for f in ("deapod", "slice_idx", "slice_w", "phase_cos", "phase_sin",
              "fan_idx", "fan_w"):
        got, want = getattr(tplan, f).numpy(), np.asarray(getattr(jplan, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    arrs = t_fo.plan_arrays(tplan, (48, 80))
    for k, v in j_fo.plan_arrays(jplan, (48, 80)).items():
        np.testing.assert_array_equal(arrs[k].numpy(), np.asarray(v), k)


def test_plan_rejects_non_square_grids():
    ph = t_cyl(N=32, dx=0.5)
    ph.labels = ph.labels[:, :30]
    with pytest.raises(ValueError, match="square phantom"):
        t_fo.plan_fourier_projector(ph, TFan(**GEOM), device="cpu")


def test_kb_sample_matches_float64_loop(plans):
    """The sampler against the gridding sum written out tap by tap in
    float64 on a random complex spectrum."""
    _, tplan = plans
    rng = np.random.default_rng(2)
    G, M = tplan.grid, 3
    F = (rng.normal(size=(M, G, G))
         + 1j * rng.normal(size=(M, G, G))).astype(np.complex64)
    got = t_fo.kb_sample(torch.as_tensor(F), tplan.slice_idx, tplan.slice_w,
                         tplan.phase_cos, tplan.phase_sin).numpy()
    nth, nl = tplan.phase_cos.shape
    base = tplan.slice_idx.numpy().astype(np.int64)
    w = tplan.slice_w.numpy().reshape(-1, 16).astype(np.float64)
    vb, ub = base // G, base % G
    z = np.zeros((M, base.size), np.complex128)
    for i in range(4):
        for j in range(4):
            z += w[:, i * 4 + j] * F[:, (vb + j) % G, (ub + i) % G]
    ph = (tplan.phase_cos.numpy().astype(np.float64)
          + 1j * tplan.phase_sin.numpy()).reshape(-1)
    want = (z * ph).reshape(M, nth, nl)
    assert got.shape == (M, nth, nl) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("packed_table", [True, False])
def test_radon_from_images_matches_jax(plans, packed_table):
    """Random images through deapodize, FFT, the sampler and the radial
    inverse FFT; both JAX table layouts give the port's one sum."""
    jplan, tplan = plans
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
    kw = dict(n_theta=96, nt=tplan.nt, grid=tplan.grid, n_img=64)
    want = np.asarray(j_fo._radon_from_images(
        jnp.asarray(imgs), jplan.deapod, jplan.slice_idx, jplan.slice_w,
        jplan.phase_cos, jplan.phase_sin, jplan.scale,
        packed_table=packed_table, **kw))
    got = t_fo._radon_from_images(
        torch.as_tensor(imgs), tplan.deapod, tplan.slice_idx, tplan.slice_w,
        tplan.phase_cos, tplan.phase_sin, tplan.scale,
        packed_table=packed_table, **kw).numpy()
    assert got.shape == (3, 96, tplan.nt)
    assert np.abs(want).max() > 10.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resample_to_fan_matches_jax(plans):
    jplan, tplan = plans
    rng = np.random.default_rng(6)
    radon = rng.normal(size=(5, 96, tplan.nt)).astype(np.float32)
    want = np.asarray(j_fo._resample_to_fan(
        jnp.asarray(radon), jplan.fan_idx, jplan.fan_w, (48, 80, 5)))
    got = t_fo.resample_to_fan(torch.as_tensor(radon), tplan.fan_idx,
                               tplan.fan_w, (48, 80, 5)).numpy()
    assert got.shape == (48, 80, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _fan_values(tplan, m, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(tplan.fan_idx.shape[0], m)).astype(np.float32)


def test_fan_transpose_product_matches_plain_and_jax(plans):
    """K22's table: the plan's taps transposed (``fan_transpose``), as a
    CSR product, against the plain adjoint (``index_add_``, the same
    products added in the same order: 1e-6 of the largest value) and
    against ``jax.linear_transpose`` of the JAX resample (the resample's
    1e-5)."""
    import jax

    jplan, tplan = plans
    m, n_bins = 2, tplan.n_theta * tplan.nt
    radon_shape = (m, tplan.n_theta, tplan.nt)
    y = _fan_values(tplan, m, 8)
    row_ptr, ray, w = t_fo.fan_transpose(tplan)
    assert t_fo.fan_transpose(tplan)[0] is row_ptr  # built once, kept
    n_rays = tplan.fan_idx.shape[0]
    csr = torch.sparse_csr_tensor(row_ptr.long(), ray.long(), w,
                                  (n_bins, n_rays))
    got = (csr @ torch.as_tensor(y)).T.reshape(radon_shape)
    plain = t_fo.resample_to_fan_adjoint_plain(
        torch.as_tensor(y), tplan.fan_idx, tplan.fan_w, radon_shape)
    big = float(plain.abs().max())
    assert big > 0.0
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-6 * big)
    (want,) = jax.linear_transpose(
        lambda r: j_fo._resample_to_fan(r, jplan.fan_idx, jplan.fan_w,
                                        (n_rays, m)),
        jnp.zeros(radon_shape, jnp.float32))(jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["plan", "clamped"])
def test_fan_transpose_rows_are_in_stable_tap_order(plans, case):
    """Each bin's taps run in the stable (bin, ray * 4 + tap) order, the
    order in which ``index_add_`` on the CPU visits them; indices outside
    the bins are clamped as K8 clamps them."""
    _, tplan = plans
    if case == "plan":
        fan_idx, fan_w = tplan.fan_idx, tplan.fan_w
        n_bins = tplan.n_theta * tplan.nt
    else:
        rng = np.random.default_rng(9)
        n_bins = 12
        fan_idx = torch.as_tensor(rng.integers(-3, n_bins + 3, (40, 4)),
                                  dtype=torch.int32)
        fan_w = torch.as_tensor(rng.uniform(0, 1, (40, 4)),
                                dtype=torch.float32)
    row_ptr, ray, w = t_fo._transpose_taps(fan_idx, fan_w, n_bins)
    bins = np.clip(fan_idx.numpy().reshape(-1), 0, n_bins - 1)
    order = np.argsort(bins, kind="stable")
    assert row_ptr.dtype == ray.dtype == torch.int32
    np.testing.assert_array_equal(
        row_ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(bins,
                                                   minlength=n_bins))]))
    np.testing.assert_array_equal(ray.numpy(), order // 4)
    np.testing.assert_array_equal(w.numpy(), fan_w.numpy().reshape(-1)[order])


def _spec_grad(tplan, m, seed):
    rng = np.random.default_rng(seed)
    shape = (m,) + tuple(tplan.phase_cos.shape)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _conj_phase(tplan, g_re, g_im):
    """Each sample times the conjugate phase, as the plain adjoint forms
    it: [2M, S], re rows first."""
    s = tplan.phase_cos.numel()
    g_re, g_im = (torch.as_tensor(a).reshape(-1, s) for a in (g_re, g_im))
    pc, ps = (t.reshape(1, s) for t in (tplan.phase_cos, tplan.phase_sin))
    return torch.cat([g_re * pc + g_im * ps, g_im * pc - g_re * ps])


def test_kb_transpose_product_matches_plain_and_jax(plans):
    """K21's table: the plan's 16 sampler taps transposed
    (``kb_transpose``, built once and kept on the plan), as a CSR product
    with the conjugate-phased samples, against the plain adjoint
    (``index_add_``: 1e-6 of the largest value) and against
    ``jax.linear_transpose`` of the JAX sampler (``dexct_tpu/ops/
    fourier.py:_radon_from_images``' gather and tap sum, as a real map of
    (re, im); the sampler's 1e-5 of the largest value)."""
    import jax

    jplan, tplan = plans
    m, G = 2, tplan.grid
    g_re, g_im = _spec_grad(tplan, m, 12)
    assert tplan.kb_t is None
    kb_t = t_fo.kb_transpose(tplan)
    assert t_fo.kb_transpose(tplan) is kb_t and tplan.kb_t is kb_t
    csr = torch.sparse_csr_tensor(kb_t.row_ptr.long(), kb_t.sample.long(),
                                  kb_t.weight,
                                  (G * G, tplan.phase_cos.numel()))
    z = _conj_phase(tplan, g_re, g_im)
    prod = (csr @ z.T).T  # [2M, G^2]
    got = torch.complex(prod[:m], prod[m:]).reshape(m, G, G)
    g = torch.complex(torch.as_tensor(g_re), torch.as_tensor(g_im))
    plain = t_fo.kb_sample_adjoint_plain(g, tplan.slice_idx, tplan.slice_w,
                                         tplan.phase_cos, tplan.phase_sin, G)
    big = float(plain.abs().max())
    assert big > 0.0
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-6 * big)

    base = jnp.asarray(jplan.slice_idx).reshape(-1)
    offs = jnp.arange(4, dtype=base.dtype)
    vb, ub = (base // G)[:, None, None], (base % G)[:, None, None]
    idx16 = (jnp.mod(vb + offs[None, None, :], G) * G
             + jnp.mod(ub + offs[None, :, None], G)).reshape(-1)
    w = jnp.asarray(jplan.slice_w).reshape(-1, 16)
    pc = jnp.asarray(jplan.phase_cos).reshape(-1)
    ps = jnp.asarray(jplan.phase_sin).reshape(-1)

    def sampler(f_re, f_im):
        rows = jnp.concatenate([f_re, f_im]).reshape(2 * m, G * G)[:, idx16]
        s = jnp.einsum("sk,csk->cs", w, rows.reshape(2 * m, -1, 16),
                       precision=jax.lax.Precision.HIGHEST)
        z_re, z_im = s[:m], s[m:]
        return z_re * pc - z_im * ps, z_re * ps + z_im * pc

    zero = jnp.zeros((m, G, G), jnp.float32)
    want_re, want_im = jax.linear_transpose(sampler, zero, zero)(
        (jnp.asarray(g_re.reshape(m, -1)), jnp.asarray(g_im.reshape(m, -1))))
    np.testing.assert_allclose(got.real.numpy(), np.asarray(want_re), rtol=0,
                               atol=1e-5 * big)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(want_im), rtol=0,
                               atol=1e-5 * big)


@pytest.mark.parametrize("case", ["plan", "clamped"])
def test_kb_transpose_rows_are_in_stable_tap_order(plans, case):
    """Each cell's taps run in the stable (cell, s * 16 + k) order, the
    order in which ``index_add_`` on the CPU adds them; row_ptr is the
    cells' bincount summed; samples are p // 16 and weights slice_w[p];
    the rows are listed by decreasing count of ``KB_BATCH``-tap batches
    (stable), those over ``KB_WARP_ROW`` taps first; the short rows' taps
    stand again in the sliced ELLPACK, row i's tap j at ell_offset[i // 32]
    + 32 j + i % 32; window bases outside the spectrum are clamped as K7
    clamps them."""
    _, tplan = plans
    if case == "plan":
        slice_idx, slice_w, G = tplan.slice_idx, tplan.slice_w, tplan.grid
    else:
        rng = np.random.default_rng(13)
        G = 8
        slice_idx = torch.as_tensor(rng.integers(-20, G * G + 20, (6, 7)),
                                    dtype=torch.int32)
        slice_w = torch.as_tensor(rng.uniform(0, 1, 6 * 7 * 16),
                                  dtype=torch.float32)
    kb_t = t_fo._kb_transpose_taps(slice_idx, slice_w, G)
    base = np.clip(slice_idx.numpy().reshape(-1), 0, G * G - 1)
    offs = np.arange(4)
    cells = (np.mod(base[:, None, None] // G + offs[None, None, :], G) * G
             + np.mod(base[:, None, None] % G + offs[None, :, None], G))
    cells = cells.reshape(-1)
    order = np.argsort(cells, kind="stable")
    length = np.bincount(cells, minlength=G * G)
    assert kb_t.row_ptr.dtype == kb_t.entries.dtype == torch.int32
    assert kb_t.rows.dtype == torch.int32
    np.testing.assert_array_equal(kb_t.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(length)]))
    np.testing.assert_array_equal(kb_t.sample.numpy(), order // 16)
    np.testing.assert_array_equal(kb_t.weight.numpy(),
                                  slice_w.numpy().reshape(-1)[order])
    batches = -(-length // t_fo.KB_BATCH)
    rows = np.argsort(-batches, kind="stable")
    np.testing.assert_array_equal(kb_t.rows.numpy(), rows)
    n_long = int((length > t_fo.KB_WARP_ROW).sum())
    assert kb_t.n_long == n_long
    assert (length[rows[:n_long]] > t_fo.KB_WARP_ROW).all()
    if case == "plan":
        assert n_long > 0
    ell, off = kb_t.ell.numpy(), kb_t.ell_offset.numpy()
    assert off.shape == (-(-(G * G - n_long) // 32) + 1,) and off[0] == 0
    entries, row_ptr = kb_t.entries.numpy(), kb_t.row_ptr.numpy()
    for i, c in enumerate(rows[n_long:]):
        at = off[i // 32] + 32 * np.arange(length[c]) + i % 32
        np.testing.assert_array_equal(ell[at],
                                      entries[row_ptr[c]:row_ptr[c + 1]])


def test_kb_transpose_in_order_sum_is_index_add(plans):
    """Each cell's products summed from 0 in the table's order, as K21 sums
    them on the card, give the plain adjoint's ``index_add_`` bit for
    bit."""
    _, tplan = plans
    m, G = 2, tplan.grid
    g_re, g_im = _spec_grad(tplan, m, 14)
    kb_t = t_fo._kb_transpose_taps(tplan.slice_idx, tplan.slice_w, G)
    prod = _conj_phase(tplan, g_re, g_im)[:, kb_t.sample.long()] * kb_t.weight
    length = kb_t.row_ptr[1:] - kb_t.row_ptr[:-1]
    start = kb_t.row_ptr[:-1].long()
    acc = torch.zeros(2 * m, G * G)
    for j in range(int(length.max())):
        act = torch.nonzero(length > j).squeeze(1)
        acc[:, act] = acc[:, act] + prod[:, start[act] + j]
    got = torch.complex(acc[:m], acc[m:]).reshape(m, G, G)
    g = torch.complex(torch.as_tensor(g_re), torch.as_tensor(g_im))
    want = t_fo.kb_sample_adjoint_plain(g, tplan.slice_idx, tplan.slice_w,
                                        tplan.phase_cos, tplan.phase_sin, G)
    assert torch.equal(got, want)


def test_cpu_adjoints_build_no_kb_transpose(monkeypatch):
    """On the CPU the plain adjoint needs no table: neither autograd's
    backward through ``fourier_project_images`` nor the explicit A^T
    (``_projection_adjoint``) builds one."""
    from dexct_tpu_torch.ops import iterative

    def refuse(*args):
        raise AssertionError("a transpose was built on the CPU")

    monkeypatch.setattr(t_fo, "_kb_transpose_taps", refuse)
    tplan = t_fo.plan_fourier_projector(t_cyl(N=32, dx=0.8), TFan(**GEOM),
                                        n_theta=48, device="cpu")
    vs = (GEOM["N_proj"], GEOM["N_channels"])
    x = torch.zeros((1, 32, 32), requires_grad=True)
    t_fo.fourier_project_images(tplan, x, vs).sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0.0
    y = torch.ones(vs)
    assert float(iterative._projection_adjoint(tplan, vs)(y).abs().max()) > 0
    assert tplan.kb_t is None


def test_fourier_paths_match_jax():
    """Material paths of a 6-label pelvis (96^2) at n_theta = 128 through
    both packages, and the pipeline's array-dict form."""
    from dexct_tpu.system import pelvis_phantom as j_pelvis

    jph, tph = j_pelvis(N=96, dx=0.4), t_pelvis(N=96, dx=0.4)
    jct, tct = JFan(**GEOM), TFan(**GEOM)
    jplan = j_fo.plan_fourier_projector(jph, jct, n_theta=128)
    tplan = t_fo.plan_fourier_projector(tph, tct, n_theta=128, device="cpu")
    want = np.asarray(j_fo.fourier_paths(
        jplan, jnp.asarray(jph.slice_labels().astype(np.int32)), (48, 80)))
    labels = torch.as_tensor(tph.slice_labels().astype(np.uint8))
    got = t_fo.fourier_paths(tplan, labels, (48, 80)).numpy()
    assert got.shape == (48, 80, tph.n_materials)
    assert want.max() > 5.0  # cm-scale chords
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    meta = (tplan.n_materials, tplan.n_theta, tplan.nt, tplan.grid,
            tplan.n_img, tplan.scale)
    arrs = t_fo.plan_arrays(tplan, (48, 80))
    np.testing.assert_array_equal(
        t_fo.fourier_paths_from_arrays(arrs, labels, meta).numpy(), got)


def test_onehot_ignores_out_of_range_labels():
    lab = torch.tensor([[0, 1], [2, 7]], dtype=torch.uint8)
    got = t_fo._onehot_images(lab, 3).numpy()
    want = np.asarray(j_fo._onehot_images(jnp.asarray(lab.numpy()), 3))
    np.testing.assert_array_equal(got, want)
    assert got[:, 1, 1].sum() == 0


@pytest.mark.parametrize("view", ["conj", "neg"])
def test_kernel_arguments_refuse_lazy_views(view):
    """A kernel reads the memory behind ``data_ptr()``: ``kernels.require``
    refuses a tensor whose conjugate or negation is a lazy bit (the card's
    K21 would read the unconjugated samples), and takes it resolved."""
    from dexct_tpu_torch.utils import kernels

    z = torch.complex(torch.ones(2, 3), torch.ones(2, 3))
    t = z.conj() if view == "conj" else torch._neg_view(z)
    with pytest.raises(ValueError, match="lazy"):
        kernels.require(t, "g", t.device, torch.complex64)
    res = t.resolve_conj().resolve_neg()
    assert kernels.require(res, "g", t.device, torch.complex64) is res
