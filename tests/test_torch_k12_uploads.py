"""The host copies around K12's siblings go up through
``utils.devices.upload`` (pinned memory, an asynchronous copy) and keep
their bits: the 2-D motion trace's object-frame rays, the view angles of
the motion-compensated FBP, FDK and helical FDK, the gated FBP's and gated
series' view angles and gate weights, and the PI method's rebin taps and
line angles.

On the CPU each repaired site must give bit for bit what it gave when its
host arrays were made tensors with ``torch.as_tensor``: every case runs the
function as it is, then again with ``upload`` replaced by
``torch.as_tensor(x, dtype=, device=)`` in the module that holds the site,
and the two results must be equal, dtype included (the replaced ``upload``
must have been called at least as often as the site copies).  On the card
(skipped here) no synchronising call of the host with the card comes from
the repaired functions themselves:

    python -m pytest --noconftest -m cuda tests/test_torch_k12_uploads.py

Also on the CPU: K12's packed copy of the stacks, and the disc pixels the
cone backprojectors keep per grid.
"""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import helical_pi, motion
from dexct_tpu_torch.pipeline import gated
from dexct_tpu_torch.system import (ConeBeamGeometry, FanBeamGeometry,
                                    HelicalConeBeamGeometry,
                                    water_cylinder_phantom)

FAN = dict(N_channels=48, N_proj=36, gamma_fan=0.8230337, SID=60.0,
           SDD=100.0)
CONE = dict(N_channels=32, N_proj=24, N_rows=4, gamma_fan=0.8230337,
            SID=60.0, SDD=100.0, h_iso=0.5)
HELIX = dict(N_channels=32, N_proj=96, N_rows=8, gamma_fan=0.8230337,
             SID=60.0, SDD=100.0, h_iso=0.5, pitch=2.0,
             rotation_total=4.0 * np.pi)

# site -> (the module whose ``upload`` the site reads, the copies it
# makes, the function of the port that holds it)
SITES = {"material_path_sinogram_motion": (motion, 2,
                                           "ops/motion.py:"
                                           "material_path_sinogram_motion"),
         "fbp_recon_motion": (motion, 1, "ops/motion.py:fbp_recon_motion"),
         "fdk_reconstruct_motion": (motion, 1,
                                    "ops/motion.py:fdk_reconstruct_motion"),
         "helical_fdk_reconstruct_motion": (
             motion, 1, "ops/motion.py:helical_fdk_reconstruct_motion"),
         "gated_fbp_recon": (gated, 2, "pipeline/gated.py:gated_fbp_recon"),
         "gated_series": (gated, 2, "pipeline/gated.py:gated_series"),
         "helical_pi_reconstruct": (helical_pi, 3,
                                    "ops/helical_pi.py:"
                                    "helical_pi_reconstruct")}


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


def _sino(shape, seed):
    """A seeded, smooth-ish log sinogram (float64 on the host)."""
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal(shape)).cumsum(-1) / shape[-1]


def site_call(site, device="cpu"):
    """The site on a small case on ``device``, as a thunk (its inputs made
    once, outside it; sinograms as tensors on ``device``)."""
    def on(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    if site == "material_path_sinogram_motion":
        ct = FanBeamGeometry(**FAN)
        track = motion.MotionProfile.breathing(FAN["N_proj"], 0.8)
        ph = water_cylinder_phantom(N=32, dx=0.6)
        return lambda: motion.material_path_sinogram_motion(
            ph, ct, track, device=device)
    if site == "fbp_recon_motion":
        ct = FanBeamGeometry(**FAN)
        track = motion.MotionProfile.breathing(FAN["N_proj"], 0.8)
        sino = on(_sino((FAN["N_proj"], FAN["N_channels"]), 1))
        return lambda: motion.fbp_recon_motion(sino, ct, 32, 20.0, track)[0]
    if site == "fdk_reconstruct_motion":
        ct = ConeBeamGeometry(**CONE)
        track = motion.MotionProfile3D.breathing_z(CONE["N_proj"], 0.5)
        sino = on(_sino((CONE["N_proj"], CONE["N_rows"],
                         CONE["N_channels"]), 2))
        return lambda: motion.fdk_reconstruct_motion(sino, ct, 24, 20.0, 0.8,
                                                     track)
    if site == "helical_fdk_reconstruct_motion":
        ct = HelicalConeBeamGeometry(**HELIX)
        track = motion.MotionProfile3D.breathing_z(HELIX["N_proj"], 0.5)
        sino = on(_sino((HELIX["N_proj"], HELIX["N_rows"],
                         HELIX["N_channels"]), 3))
        return lambda: motion.helical_fdk_reconstruct_motion(
            sino, ct, 24, 18.0, 0.8, track)
    if site in ("gated_fbp_recon", "gated_series"):
        ct = FanBeamGeometry(**{**FAN, "N_proj": 72,
                                "rotation_total": 4.0 * np.pi})
        sino = on(_sino((72, FAN["N_channels"]), 4))
        if site == "gated_series":
            return lambda: gated.gated_series(sino, ct, 24, 20.0, 48.0,
                                              n_gates=3)
        w = gated.gate_weights(gated.view_phases(72, 48.0), 0.25, 0.3)
        return lambda: gated.gated_fbp_recon(sino, ct, 24, 20.0, w)
    ct = HelicalConeBeamGeometry(**HELIX)
    sino = on(_sino((HELIX["N_proj"], HELIX["N_rows"], HELIX["N_channels"]),
                    5))
    return lambda: helical_pi.helical_pi_reconstruct(sino, ct, 24, 18.0, 0.8)


@pytest.mark.parametrize("site", sorted(SITES))
def test_uploads_keep_the_bits(site, monkeypatch):
    call = site_call(site)
    got = call()
    module, copies, _ = SITES[site]
    calls = []
    with monkeypatch.context() as m:
        m.setattr(module, "upload", _as_tensor_upload(calls))
        want = call()
    assert len(calls) >= copies, f"{site} copies {calls} through upload"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_k12_packs_the_images_innermost(K):
    """K12's packed copy of [K, V, R, C] stacks is [V, R, C, KP] with image
    k at [..., k] (KP = 4 at K = 3, the fourth image zero), contiguous."""
    from dexct_tpu_torch.ops.conebeam import _pack_images

    q = torch.as_tensor(np.random.default_rng(K).standard_normal(
        (K, 5, 3, 7), np.float32))
    packed = _pack_images(q)
    width = 4 if K == 3 else K
    assert packed.shape == (5, 3, 7, width) and packed.is_contiguous()
    assert torch.equal(packed[..., :K], q.permute(1, 2, 3, 0))
    assert not packed[..., K:].any()


def test_disc_is_uploaded_once_per_grid():
    """The backprojectors' disc pixels are ``_disc_host``'s, one set of
    tensors per (grid, device)."""
    from dexct_tpu_torch.ops.conebeam import _disc, _disc_host

    got = _disc(37, 18.0, "cpu")
    assert got is _disc(37, 18, torch.device("cpu"))
    for g, want in zip(got, _disc_host(37, 18.0)):
        assert torch.equal(g, torch.as_tensor(want))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sync_functions(call):
    """``tests/test_torch_cuda.py``'s count of the calls of ``call()`` that
    synchronise the host with the card, by the innermost function of the
    port: {"file:function": count}."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).with_name("test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("_torch_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._sync_functions(call)


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(SITES))
def test_repaired_sites_make_no_host_synchronisation(dev, site):
    """No call of a repaired function synchronises the host with the card
    from the function itself (its kernels' wrappers may, for reasons of
    their own: they are listed in the message)."""
    call = site_call(site, dev)
    out = call()
    torch.cuda.synchronize()
    syncs = _sync_functions(call)
    assert f"dexct_tpu_torch/{SITES[site][2]}" not in syncs, syncs
    assert out.is_cuda and bool(torch.isfinite(out).all())
