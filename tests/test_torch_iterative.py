"""The port's exact 3-D projector (the plain versions of K18 and K19), the
Fourier-slice projector's adjoint (the plain versions of K21 and K22) and
the iterative reconstructions on them against the JAX package's, on the
CPU.

Tolerances:

- ``project_volume_3d`` against the JAX program: rel 1e-5 of the largest
  line integral (the same walk; the sums are taken in another order);
- its adjoint against ``jax.linear_transpose`` of the JAX program: rel
  1e-5 of the largest value; the dot-product identity <A x, y> =
  <x, A^T y>: rel 1e-5 in float64 and 1e-4 in float32 (the JAX package's
  own test holds 1e-3, tests/test_conebeam.py:356-377); autograd's
  gradient equals the adjoint bit for bit (it is the adjoint);
- ``pwls_weights``: rel 5e-6 of the largest weight against JAX, whose
  float32 mean of the test's 6144 weights lies 2.2e-6 off the float64
  mean, and rel 1e-6 against the float64 weights (the port's mean lies
  2e-7 off); the Huber penalty gradient: exact (clamps of float32
  differences);
- ``cone_cg_recon``: volume and residual history rel 1e-4 of their largest
  values, over the first 8 iterations: float32 CG amplifies the rounding
  of its dot products once the residual has fallen four orders (at 25
  iterations the two runs' final residuals differ by ~30 %, while both
  recover the cylinder, below);
- ``cone_pwls_recon`` fed the JAX power iteration's start vector
  (``jax.random.normal(PRNGKey(0))``): rel 1e-4 of the largest value;
- the JAX tests' physics checks, on the port: CG recovers the water
  cylinder within 5 % and drops its residual three orders; PWLS on a
  low-dose scan reads water within 5 % with noise below 0.6 x FDK's;
- 2-D, on a 48^2 Fourier plan with n_theta = 96 and 64 x 48 rays: the
  explicit A^T against ``jax.linear_transpose`` of the JAX projector and
  against ``torch.autograd`` of the port's: 1e-5 of the largest value;
  <A x, y> = <x, A^T y>: rel 1e-5 in float32 (1e-10 in float64); the two
  autograd Functions (sampler and fan resample) pass ``gradcheck`` in
  float64; ``cg_recon``, ``sirt_recon`` and ``pwls_recon`` over 8
  iterations (the power iterations fed the JAX draw): rel 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu.ops import conebeam as j_cb
from dexct_tpu.ops import fourier as j_fo
from dexct_tpu.ops import iterative as j_it
from dexct_tpu.ops.siddon import material_path_sinogram, mono_sinogram
from dexct_tpu.system import (ConeBeamGeometry, FanBeamGeometry,
                              water_cylinder_phantom)
from dexct_tpu_torch.ops import conebeam as t_cb
from dexct_tpu_torch.ops import fourier as t_fo
from dexct_tpu_torch.ops import iterative as t_it
from dexct_tpu_torch.system import FanBeamGeometry as TFan
from dexct_tpu_torch.system import water_cylinder_phantom as t_cyl

VOL = (4, 24, 24)
VOX = (1.0, 1.0, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _geom():
    """tests/test_conebeam.py's TestIterative3D geometry."""
    return ConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4,
                            gamma_fan=0.8230337, SID=60.0, SDD=100.0,
                            h_iso=0.5)


def _port_ct(ct):
    from dexct_tpu_torch.system import geometry as t_geo

    return getattr(t_geo, type(ct).__name__)(
        **{f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)
           if f.name != "detector"})


def _rays(ct, dtype=torch.float32):
    src, dirs = ct.ray_geometry_3d()
    return (torch.as_tensor(src, dtype=dtype),
            torch.as_tensor(dirs, dtype=dtype),
            jnp.asarray(src, jnp.float32), jnp.asarray(dirs, jnp.float32))


def _cylinder():
    """The 24^2 x 4 water cylinder at 1 cm and its mu at 60 keV."""
    ph2 = water_cylinder_phantom(N=24, dx=1.0)
    lab3 = np.broadcast_to(ph2.labels[0], VOL).copy()
    mu = ph2.materials.mu_table(np.array([60.0]))[:, 0]
    return ph2, lab3, mu


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("n_steps", [None, 20])
def test_project_volume_3d_matches_jax(n_steps):
    """The water cylinder and a random volume, with the default walk and a
    truncated one (20 of 54 steps)."""
    ct = _geom()
    s, d, js, jd = _rays(ct)
    _, lab3, mu = _cylinder()
    rng = np.random.default_rng(2)
    for vol in (mu.astype(np.float32)[lab3],
                rng.normal(size=VOL).astype(np.float32)):
        want = np.asarray(j_cb.project_volume_3d(
            jnp.asarray(vol), js, jd, *VOX, n_steps=n_steps))
        got = t_cb.project_volume_3d(torch.as_tensor(vol), s, d, *VOX,
                                     n_steps=n_steps).numpy()
        assert got.shape == want.shape == (48, 4, 32)
        assert _rel(got, want) <= 1e-5


def test_projector_matches_material_paths():
    """The projector of mu[labels] equals the trace's paths times mu (the
    JAX package's test_projector_matches_material_paths, on the port)."""
    ct = _geom()
    s, d, _, _ = _rays(ct)
    _, lab3, mu = _cylinder()
    paths = t_cb.trace_paths_3d(torch.as_tensor(lab3), s, d, *VOX,
                                n_materials=len(mu)).numpy()
    ref = paths @ mu.astype(np.float32)
    got = t_cb.project_volume_3d(
        torch.as_tensor(mu.astype(np.float32)[lab3]), s, d, *VOX).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("n_steps", [None, 20])
def test_adjoint_matches_jax_linear_transpose(n_steps):
    ct = _geom()
    s, d, js, jd = _rays(ct)
    rng = np.random.default_rng(3)
    x = rng.normal(size=VOL).astype(np.float32)
    y = rng.normal(size=(48, 4, 32)).astype(np.float32)

    def A(v):
        return j_cb.project_volume_3d(v, js, jd, *VOX, n_steps=n_steps)

    want = np.asarray(jax.linear_transpose(A, jnp.asarray(x))(
        jnp.asarray(y))[0])
    got = t_cb.project_volume_3d_adjoint(torch.as_tensor(y), s, d, VOL, *VOX,
                                         n_steps=n_steps).numpy()
    assert got.shape == want.shape == VOL
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-5),
                                       (torch.float32, 1e-4)])
def test_adjoint_dot_product(dtype, tol):
    """<A x, y> = <x, A^T y> for random x and y."""
    ct = _geom()
    s, d, _, _ = _rays(ct, dtype)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=VOL), dtype=dtype)
    y = torch.as_tensor(rng.normal(size=(48, 4, 32)), dtype=dtype)
    ax = t_cb.project_volume_3d(x, s, d, *VOX)
    aty = t_cb.project_volume_3d_adjoint(y, s, d, VOL, *VOX)
    assert ax.dtype == aty.dtype == dtype
    lhs, rhs = float((ax * y).sum()), float((x * aty).sum())
    assert abs(lhs - rhs) <= tol * max(abs(lhs), 1.0)


def test_autograd_gradient_is_the_adjoint():
    ct = _geom()
    s, d, _, _ = _rays(ct)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=VOL), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(48, 4, 32)), dtype=torch.float32)
    x.requires_grad_(True)
    (t_cb.project_volume_3d(x, s, d, *VOX) * y).sum().backward()
    assert torch.equal(x.grad,
                       t_cb.project_volume_3d_adjoint(y, s, d, VOL, *VOX))


def test_pwls_weights_match_jax():
    rng = np.random.default_rng(5)
    counts = np.maximum(rng.poisson(1500.0, size=(48, 4, 32)), 1)
    c = counts.astype(np.float64)
    for kw in ({}, dict(sigma_e=3.0, var_ratio=1.3)):
        want = np.asarray(j_it.pwls_weights(counts, **kw))
        got = t_it.pwls_weights(torch.as_tensor(counts), **kw).numpy()
        assert got.dtype == want.dtype == np.float32
        assert _rel(got, want) <= 5e-6
        w64 = c * c / (kw.get("var_ratio", 1.0) * c
                       + kw.get("sigma_e", 0.0) ** 2)
        assert _rel(got, w64 / w64.mean()) <= 1e-6


@pytest.mark.parametrize("shape", [(9, 11), (4, 6, 7)])
def test_neighbor_penalty_grad_matches_jax(shape):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = np.asarray(j_it._neighbor_penalty_grad(jnp.asarray(x), 0.3))
    got = t_it._neighbor_penalty_grad(torch.as_tensor(x), 0.3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("loop", ["cg", "pwls"])
def test_generic_loops_match_jax(loop):
    """``_cg`` with the Laplacian penalty and ``_pwls_fista`` on a dense
    random operator of 12 x 12 images, given its transpose as the adjoint
    (the JAX loops take it by ``jax.linear_transpose``); the PWLS power
    iteration fed the JAX draw."""
    rng = np.random.default_rng(9)
    m = rng.normal(size=(300, 144)).astype(np.float32) / 12.0
    b = rng.normal(size=300).astype(np.float32)
    x0 = np.zeros((12, 12), np.float32)

    def j_apply(x):
        return jnp.asarray(m) @ x.reshape(-1)

    def t_apply(x):
        return torch.as_tensor(m) @ x.reshape(-1)

    def t_adjoint(z):
        return (torch.as_tensor(m).T @ z).reshape(x0.shape)

    if loop == "cg":
        want = j_it._cg(j_apply, jnp.asarray(b), jnp.asarray(x0), 10, 0.3)
        got = t_it._cg(t_apply, torch.as_tensor(b), torch.as_tensor(x0), 10,
                       0.3, adjoint=t_adjoint)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= 1e-4
        return
    w8 = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (12, 12)))
    args = (8, 1e-2, 5e-3, True, 6)
    want = j_it._pwls_fista(j_apply, jnp.asarray(b), jnp.asarray(w8),
                            jnp.asarray(x0), *args)
    got = t_it._pwls_fista(t_apply, torch.as_tensor(b), torch.as_tensor(w8),
                           torch.as_tensor(x0), *args, adjoint=t_adjoint,
                           _v0=v0)
    assert _rel(got.numpy(), want) <= 1e-4


def _cyl_sino(ct):
    _, _, js, jd = _rays(ct)
    _, lab3, mu = _cylinder()
    vol = jnp.asarray(mu, jnp.float32)[lab3]
    return np.array(j_cb.project_volume_3d(vol, js, jd, *VOX)), float(mu[1])


def test_cone_cg_recon_matches_jax():
    ct = _geom()
    sino, _ = _cyl_sino(ct)
    vol_j, hist_j = j_cb.cone_cg_recon(sino, ct, VOL, VOX, n_iters=8)
    vol, hist = t_cb.cone_cg_recon(torch.as_tensor(sino), _port_ct(ct), VOL,
                                   VOX, n_iters=8)
    assert hist.shape == (8,) and vol.shape == VOL
    assert _rel(vol.numpy(), vol_j) <= 1e-4
    assert _rel(hist.numpy(), hist_j) <= 1e-4


def test_cg_recovers_cylinder():
    """tests/test_conebeam.py's test_cg_recovers_cylinder on the port."""
    ct = _geom()
    sino, mu_w = _cyl_sino(ct)
    vol, hist = t_cb.cone_cg_recon(torch.as_tensor(sino), _port_ct(ct), VOL,
                                   VOX, n_iters=25)
    center = float(vol[1:3, 10:14, 10:14].mean())
    assert abs(center - mu_w) < 0.05 * mu_w
    assert float(hist[-1]) < float(hist[0]) * 1e-3


def _low_dose(ct, sino, n0=1500.0):
    rng = np.random.default_rng(5)
    counts = np.maximum(rng.poisson(n0 * np.exp(-sino)), 1)
    return (-np.log(counts / n0)).astype(np.float32), counts


def test_cone_pwls_recon_matches_jax():
    """PWLS from zeros and warm-started, fed the JAX start vector of its
    power iteration."""
    ct = _geom()
    sino, _ = _cyl_sino(ct)
    y, counts = _low_dose(ct, sino)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), VOL))
    x0 = np.full(VOL, 0.1, np.float32)
    for kw in (dict(n_iters=30, beta=3e-2),
               dict(n_iters=10, beta=1e-2, x0=x0, nonneg=False)):
        want = np.asarray(j_cb.cone_pwls_recon(y, counts, ct, VOL, VOX, **kw))
        got = t_cb.cone_pwls_recon(torch.as_tensor(y), counts, _port_ct(ct),
                                   VOL, VOX, _v0=v0, **kw).numpy()
        assert got.shape == want.shape == VOL
        assert _rel(got, want) <= 1e-4


def test_cone_pwls_low_dose():
    """tests/test_conebeam.py's test_cone_pwls_low_dose on the port (its
    own power-iteration draw): 96 views x 8 rows x 64 channels through the
    48^2 x 8 water cylinder at 0.5 cm, FDK warm start, 60 iterations."""
    ct = ConeBeamGeometry(N_channels=64, N_proj=96, N_rows=8,
                          gamma_fan=0.8230337, SID=60.0, SDD=100.0,
                          h_iso=0.5)
    tct = _port_ct(ct)
    ph2 = water_cylinder_phantom(N=48, dx=0.5)
    lab3 = np.broadcast_to(ph2.labels[0], (8, 48, 48)).copy()
    mu = ph2.materials.mu_table(np.array([60.0]))[:, 0].astype(np.float32)
    src, dirs = ct.ray_geometry_3d()
    paths = t_cb.trace_paths_3d(
        torch.as_tensor(lab3), torch.as_tensor(src, dtype=torch.float32),
        torch.as_tensor(dirs, dtype=torch.float32), 0.5, 0.5, 0.5,
        n_materials=len(mu)).numpy()
    y, counts = _low_dose(ct, paths @ mu)
    fdk = t_cb.fdk_reconstruct(torch.as_tensor(y), tct, 48, 20.0, 0.8,
                               nz_out=8, dz_out=0.5)
    x = t_cb.cone_pwls_recon(torch.as_tensor(y), counts, tct, (8, 48, 48),
                             (0.5, 0.5, 0.5), n_iters=60, beta=3e-2,
                             x0=torch.clamp_min(fdk, 0.0)).numpy()
    flat = (4, slice(26, 36), slice(26, 36))
    mu_w = float(mu[1])
    assert abs(x[flat].mean() - mu_w) / mu_w < 0.05
    assert x[flat].std() < 0.6 * fdk.numpy()[flat].std()


# ---------------------------------------------------------------------------
# 2-D: the Fourier-slice projector's adjoint and the 2-D entry points
# ---------------------------------------------------------------------------

GEOM_2D = dict(N_channels=48, N_proj=64, gamma_fan=0.8230337, SID=60.0,
               SDD=100.0)
VS = (64, 48)


@pytest.fixture(scope="module")
def plans_2d():
    """The 48^2 cylinder's Fourier plan (n_theta = 96, 64 x 48 rays) in both
    packages, and the exact 60 keV sinogram of the cylinder."""
    ph, ct = water_cylinder_phantom(N=48, dx=0.4), FanBeamGeometry(**GEOM_2D)
    jplan = j_fo.plan_fourier_projector(ph, ct, n_theta=96)
    tplan = t_fo.plan_fourier_projector(t_cyl(N=48, dx=0.4), TFan(**GEOM_2D),
                                        n_theta=96, device="cpu")
    mu = ph.materials.mu_table(np.array([60.0]))[:, 0]
    sino = np.array(mono_sinogram(material_path_sinogram(ph, ct), mu),
                    np.float32)
    return jplan, tplan, sino


def test_fourier_adjoint_matches_jax_and_autograd(plans_2d):
    jplan, tplan, _ = plans_2d
    rng = np.random.default_rng(11)
    x = rng.normal(size=(48, 48)).astype(np.float32)
    y = rng.normal(size=VS).astype(np.float32)
    jA = j_it.make_projection_operator(jplan, VS)
    want_ax = np.asarray(jA(jnp.asarray(x)))
    want = np.asarray(jax.linear_transpose(jA, jnp.asarray(x))(
        jnp.asarray(y))[0])
    A = t_it.make_projection_operator(tplan, VS)
    got = t_it._projection_adjoint(tplan, VS)(torch.as_tensor(y)).numpy()
    xt = torch.as_tensor(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(A(xt), xt, torch.as_tensor(y))
    assert got.shape == want.shape == (48, 48)
    np.testing.assert_allclose(A(torch.as_tensor(x)).numpy(), want_ax,
                               atol=1e-4)
    assert _rel(got, want) <= 1e-5
    assert _rel(grad.numpy(), got) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_fourier_adjoint_dot_product(plans_2d, dtype, tol):
    """<A x, y> = <x, A^T y> through the whole chain (K7, K8 and their
    adjoints K21, K22 in their plain versions)."""
    _, tplan, _ = plans_2d
    rng = np.random.default_rng(12)
    x = torch.as_tensor(rng.normal(size=(48, 48)), dtype=dtype)
    y = torch.as_tensor(rng.normal(size=VS), dtype=dtype)
    ax = t_it.make_projection_operator(tplan, VS)(x)
    aty = t_it._projection_adjoint(tplan, VS)(y)
    assert ax.dtype == aty.dtype == dtype
    lhs = float((ax.double() * y.double()).sum())
    rhs = float((x.double() * aty.double()).sum())
    assert abs(lhs - rhs) <= tol * abs(lhs)


def test_fourier_functions_gradcheck():
    """The sampler's and the fan resample's autograd Functions (backward:
    K21, K22 in their plain versions) and the whole projector, by
    ``gradcheck`` in float64 on an 8^2 plan with n_theta = 8."""
    tplan = t_fo.plan_fourier_projector(
        t_cyl(N=8, dx=2.0), TFan(N_channels=12, N_proj=10,
                                 gamma_fan=0.8230337, SID=60.0, SDD=100.0),
        n_theta=8, device="cpu")
    rng = np.random.default_rng(13)
    G, nt = tplan.grid, tplan.nt
    F = torch.as_tensor(rng.normal(size=(1, G, G))
                        + 1j * rng.normal(size=(1, G, G)),
                        dtype=torch.complex128).requires_grad_(True)
    tabs = (tplan.slice_idx, tplan.slice_w, tplan.phase_cos, tplan.phase_sin)
    assert torch.autograd.gradcheck(
        lambda f: t_fo._KBSample.apply(f, *tabs), (F,))
    radon = torch.as_tensor(rng.normal(size=(2, 8, nt)),
                            dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda r: t_fo._ResampleToFan.apply(r, tplan, (10, 12, 2)),
        (radon,))
    img = torch.as_tensor(rng.normal(size=(1, 8, 8)),
                          dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda im: t_fo.fourier_project_images(tplan, im, (10, 12)), (img,))


@pytest.mark.parametrize("recon", ["cg", "cg_cylinder", "sirt", "pwls"])
def test_2d_recons_match_jax(plans_2d, recon):
    """Each 2-D reconstruction against JAX, the power iterations fed the
    JAX start vector: SIRT (8 iterations) on the cylinder's exact sinogram,
    PWLS (8) on its Poisson counts at 2e3 per ray, CG (with the Laplacian
    penalty) at the iterative path's lam = 0.05 on the cylinder's sinogram
    for 4 iterations (its residual falls 3.2 orders; by 8 it has fallen
    four and float32 CG amplifies the two FFT libraries' rounding, the
    images ending 2.6e-3 apart while the histories agree to 1e-4), and for
    8 iterations at lam = 5.0 on a random sinogram."""
    jplan, tplan, sino = plans_2d
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (48, 48)))
    if recon.startswith("cg"):
        if recon == "cg":
            b, n, lam = (np.random.default_rng(15).normal(size=VS).astype(
                np.float32), 8, 5.0)
        else:
            b, n, lam = sino, 4, 0.05
        want, want_h = j_it.cg_recon(jplan, b, VS, n_iters=n, lam=lam)
        got, hist = t_it.cg_recon(tplan, torch.as_tensor(b), VS, n_iters=n,
                                  lam=lam)
        assert hist.shape == (n,)
        assert _rel(hist.numpy(), want_h) <= 1e-4
    elif recon == "sirt":
        want = j_it.sirt_recon(jplan, sino, VS, n_iters=8)
        got = t_it.sirt_recon(tplan, torch.as_tensor(sino), VS, n_iters=8,
                              _v0=v0)
    else:
        rng = np.random.default_rng(14)
        counts = np.maximum(rng.poisson(2e3 * np.exp(-sino)), 1)
        y = (-np.log(counts / 2e3)).astype(np.float32)
        want = j_it.pwls_recon(jplan, y, counts, VS, n_iters=8, beta=3e-2)
        got = t_it.pwls_recon(tplan, torch.as_tensor(y), counts, VS,
                              n_iters=8, beta=3e-2, _v0=v0)
    assert got.shape == (48, 48)
    assert _rel(got.numpy(), want) <= 1e-4
