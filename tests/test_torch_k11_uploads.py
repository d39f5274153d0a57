"""The host copies on K11's siblings' paths go up through
``utils.devices.upload`` (pinned memory, an asynchronous copy) and keep
their bits: the rigid poses of K30, K32 and K33 (``_pose``), the motion
backprojectors' slice centres (``_z_grid``) and view angles, displacements
and source heights, K33's host figures (its view spacing and the reach of
its window, from the caller's host arrays), and the 2-D iterative
reconstructions' sinograms, start images, start vectors and counts.

On the CPU each repaired site must give bit for bit what it gave when its
host arrays were made tensors with ``torch.as_tensor``: every case runs the
function as it is, then again with ``upload`` replaced by
``torch.as_tensor(x, dtype=, device=)`` in the module that holds the site
and in ``utils.devices`` (whose ``as_float`` the sites call), and the two
results must be equal, dtype included (the replaced ``upload`` must have
been called at least as often as the site copies).  On the card
the paths are held by ``tests/test_torch_cuda.py``
(``test_motion_backprojectors_make_no_host_synchronisation``,
``test_2d_iterative_makes_no_host_synchronisation``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py \\
        tests/test_torch_k11_uploads.py

Also on the CPU: K11's refusal of a stack too large for its 32-bit
offsets, and K13's slice centres, kept per grid.
"""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import conebeam, fourier, iterative, motion
from dexct_tpu_torch.system import (ConeBeamGeometry, FanBeamGeometry,
                                    HelicalConeBeamGeometry,
                                    water_cylinder_phantom)
from dexct_tpu_torch.utils import devices

CONE = dict(N_channels=32, N_proj=24, N_rows=4, gamma_fan=0.8230337,
            SID=60.0, SDD=100.0, h_iso=0.5)
HELIX = dict(N_channels=32, N_proj=96, N_rows=8, gamma_fan=0.8230337,
             SID=60.0, SDD=100.0, h_iso=0.5, pitch=2.0,
             rotation_total=4.0 * np.pi)
FAN_2D = dict(N_channels=48, N_proj=64, gamma_fan=0.8230337, SID=60.0,
              SDD=100.0)
VS = (64, 48)

# site -> (the module whose ``upload`` the site reads, the copies it makes
# at least)
SITES = {"pose": (motion, 2), "z_grid": (motion, 1),
         "fdk_backproject_motion": (motion, 3),
         "helical_backproject_motion": (motion, 5),
         "cg_recon": (iterative, 2), "sirt_recon": (iterative, 2),
         "pwls_recon": (iterative, 4)}


def _as_tensor_upload(calls):
    """``upload`` as the sites were before it: ``torch.as_tensor``."""
    def up(x, like, dtype=None):
        calls.append(type(x).__name__)
        if isinstance(like, torch.Tensor):
            device = like.device
            dtype = like.dtype if dtype is None else dtype
        else:
            device = torch.device(like)
        return torch.as_tensor(x, dtype=dtype, device=device)
    return up


def _stack(shape, seed):
    """Seeded filtered stacks [K, V, R, C], float32 on the CPU."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape, np.float32))


_PLAN = {}


def _plan_2d():
    """The 48^2 cylinder's Fourier plan (n_theta = 96, 64 x 48 rays) of
    ``tests/test_torch_iterative.py``, built once."""
    if not _PLAN:
        _PLAN["plan"] = fourier.plan_fourier_projector(
            water_cylinder_phantom(N=48, dx=0.4), FanBeamGeometry(**FAN_2D),
            n_theta=96, device="cpu")
    return _PLAN["plan"]


def site_call(site):
    """The site on a small case on the CPU, its host arrays NumPy, as a
    thunk returning a tuple of tensors."""
    rng = np.random.default_rng(sorted(SITES).index(site) + 28)
    if site == "pose":
        phi, disp = rng.uniform(-0.03, 0.03, 24), rng.uniform(-1, 1, (24, 3))
        return lambda: motion._pose(phi, disp, "cpu")
    if site == "z_grid":
        return lambda: (motion._z_grid(7, 0.45, -1.35, "cpu"),)
    if site == "fdk_backproject_motion":
        ct = ConeBeamGeometry(**CONE)
        q = _stack((2, 24, 4, 32), 1)
        betas = torch.as_tensor(np.asarray(ct.betas, np.float32))
        phi, disp = rng.uniform(-0.03, 0.03, 24), rng.uniform(-0.4, 0.4,
                                                             (24, 3))
        return lambda: (motion._fdk_backproject_motion(
            q, betas, phi, disp, ct.SID, ct.dgamma, ct.h_iso, 4, 24, 4,
            20.0, 0.5, -0.75),)
    if site == "helical_backproject_motion":
        ct = HelicalConeBeamGeometry(**HELIX)
        q = _stack((2, 96, 8, 32), 2)
        phi, disp = rng.uniform(-0.03, 0.03, 96), rng.uniform(-0.4, 0.4,
                                                             (96, 3))
        z_out, dz = conebeam.helical_slices(ct, None)
        return lambda: (motion._helical_backproject_motion(
            q, np.asarray(ct.betas, np.float64),
            np.asarray(ct.source_z, np.float64), 0.5 * ct.rotation_total,
            phi, disp, ct.SID, ct.dgamma, ct.h_iso, 8, ct.pitch, 24,
            len(z_out), 18.0, dz, float(z_out[0])),)
    plan = _plan_2d()
    sino = rng.normal(size=VS).astype(np.float32)
    x0 = rng.uniform(0.0, 0.02, (48, 48))
    v0 = rng.normal(size=(48, 48))
    if site == "cg_recon":
        return lambda: iterative.cg_recon(plan, sino, VS, n_iters=3,
                                          lam=0.05, x0=x0)
    if site == "sirt_recon":
        return lambda: (iterative.sirt_recon(plan, sino, VS, n_iters=3,
                                             power_iters=3, _v0=v0),)
    counts = np.maximum(rng.poisson(2e3 * np.exp(-np.abs(sino))), 1)
    return lambda: (iterative.pwls_recon(plan, np.abs(sino), counts, VS,
                                         n_iters=3, power_iters=3, x0=x0,
                                         _v0=v0),)


@pytest.mark.parametrize("site", sorted(SITES))
def test_uploads_keep_the_bits(site, monkeypatch):
    call = site_call(site)
    got = call()
    module, copies = SITES[site]
    calls = []
    with monkeypatch.context() as m:
        m.setattr(module, "upload", _as_tensor_upload(calls))
        m.setattr(devices, "upload", _as_tensor_upload(calls))
        want = call()
    assert len(calls) >= copies, f"{site} copies {calls} through upload"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("given", ["float64", "float32", "tensor"])
def test_k33_host_figures_are_the_float32_views(given):
    """K33's view spacing comes from the float32 view angles as the card
    holds them, read on the host from whatever the caller gave: a float64
    or float32 array, or a float32 tensor (on the card a read-back)."""
    betas = np.asarray(HelicalConeBeamGeometry(**HELIX).betas, np.float64)
    want = torch.as_tensor(betas, dtype=torch.float32).double().numpy()
    x = {"float64": betas, "float32": betas.astype(np.float32),
         "tensor": torch.as_tensor(betas, dtype=torch.float32)}[given]
    got = motion._host_f32(x)
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


def test_pose_shapes_are_read_without_a_copy():
    """``_check_pose`` reads the shapes of arrays and tensors alike, with no
    copy (a meta tensor holds no data to copy)."""
    phi, disp = torch.empty(24, device="meta"), torch.empty((24, 3),
                                                            device="meta")
    motion._check_pose(phi, disp, 24, 3)
    motion._check_pose(np.zeros(24), np.zeros((24, 3)), 24, 3)
    with pytest.raises(ValueError, match="phi must be"):
        motion._check_pose(phi, disp, 24, 2)
    with pytest.raises(ValueError, match="phi must be"):
        motion._check_pose(np.zeros(23), np.zeros((24, 3)), 24, 3)


def test_k11_refuses_stacks_past_32_bit_offsets():
    """A packed stack of 2^31 floats or more cannot be addressed with K11's
    32-bit offsets: the pack refuses it before any copy (shapes of a meta
    tensor)."""
    q = torch.empty((3, 4096, 64, 2048), device="meta")
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        conebeam._pack_images(q)


def test_flat_slices_are_uploaded_once_per_grid():
    """K13's slice centres are the JAX grid's (float64, then float32), one
    tensor per (grid, device): its wrapper then copies nothing from the
    host, so that a CUDA graph can capture it."""
    from dexct_tpu_torch.ops.flatpanel import _flat_z

    got = _flat_z(16, 0.25, "cpu")
    assert got is _flat_z(16, 0.25, torch.device("cpu"))
    want = ((np.arange(16) + 0.5 - 8.0) * 0.25).astype(np.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.as_tensor(want))
