"""The host copies on K6's paths go up through ``utils.devices.upload``
(pinned memory, an asynchronous copy) and keep their bits; K6's wrapper
refuses a table its 32-bit offsets or its vector loads cannot take.

On the CPU each repaired entry point must give bit for bit what it gave
when its host arrays were made tensors with ``torch.as_tensor``: every
case runs the function as it is, then again with ``upload`` replaced by
``torch.as_tensor(x, dtype=, device=)`` where the site finds it, and the
two results must be equal (the replaced ``upload`` must have been called
at least as often as the site copies).  On the card (skipped here) the
same calls, and K6's wrapper, make no host synchronisation:

    python -m pytest --noconftest -m cuda tests/test_torch_k6_uploads.py
"""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import fbp_fast, ffs
from dexct_tpu_torch.pipeline import sweep
from dexct_tpu_torch.system import FanBeamGeometry, analytic
from dexct_tpu_torch.utils import devices

# site -> (the module whose ``upload`` the site reads, the copies it makes)
SITES = {"ffs_fbp_recon": (devices, 4),
         "material_path_sinogram_analytic": (analytic, 4),
         "ramp_sweep": (sweep, 1)}


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


def _ramp_case(device):
    """``utils/tiny_cases.py``'s ramp sweep scan (96 views x 64 channels
    through a 64^2 water cylinder, 64^2 images over 20 cm), packed, and
    its two sinc ramps as a NumPy stack."""
    from dexct_tpu_torch.ops.filters import filter_frequency_response
    from dexct_tpu_torch.pipeline.fused import pack_dect
    from dexct_tpu_torch.system import water_cylinder_phantom
    from dexct_tpu_torch.utils import tiny_cases

    ct = FanBeamGeometry(N_channels=64, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    ph = water_cylinder_phantom(N=64, dx=0.35)
    s1, s2 = tiny_cases._realism_spectra(ct)
    arrays, meta = pack_dect(ct, ph, s1, s2, 64, 20.0, 0.8, device=device,
                             n_iters=12)
    H = np.stack([filter_frequency_response(ct.N_channels, ct.dgamma, r,
                                            "sinc", "fan")[0]
                  for r in (0.3, 1.0)])
    return arrays, meta, H


def site_call(site, device="cpu"):
    """The entry point of ``site`` on a small case on ``device``, as a
    thunk (its inputs made once, outside it)."""
    if site == "ffs_fbp_recon":
        ct = FanBeamGeometry(N_channels=32, N_proj=48, gamma_fan=0.8230337,
                             SID=60.0, SDD=100.0, ffs="inplane")
        sino = torch.as_tensor(np.random.default_rng(271).uniform(
            0.0, 4.0, (48, 32)), dtype=torch.float32, device=device)
        return lambda: ffs.ffs_fbp_recon(sino, ct, 24, 20.0)
    if site == "material_path_sinogram_analytic":
        ct = FanBeamGeometry(N_channels=40, N_proj=24, gamma_fan=0.8230337,
                             SID=60.0, SDD=100.0)
        ph = analytic.pelvis_analytic()
        return lambda: analytic.material_path_sinogram_analytic(
            ph, ct, device=device)
    arrays, meta, H = _ramp_case(device)
    return lambda: sweep.ramp_sweep(arrays, meta, H)


@pytest.mark.parametrize("site", sorted(SITES))
def test_uploads_keep_the_bits(site, monkeypatch):
    call = site_call(site)
    got = call()
    module, copies = SITES[site]
    calls = []
    with monkeypatch.context() as m:
        m.setattr(module, "upload", _as_tensor_upload(calls))
        want = call()
    assert len(calls) >= copies, f"{site} copies {calls} through upload"
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_pin_cases_sit_on_the_paths_grids():
    """K6's pinned cases take t0 and dt as the default path's, the sweep's
    and the FFS path's plans make them at the reference protocol."""
    from dexct_tpu_torch.tools.probe_parallel_backproject import pin_case

    kw = dict(N_channels=800, N_proj=1000, gamma_fan=0.8230337, SID=60.0,
              SDD=100.0, rotation_total=6.283185)
    for case, nt in (("default", 1024), ("sweep", 1600)):
        _, _, t0, dt = fbp_fast.parallel_rebin_plan(FanBeamGeometry(**kw), 2,
                                                    nt)
        assert pin_case(case)[2][:3] == (t0, dt, nt)
    _, _, t0, dt = ffs.parallel_rebin_plan_ffs(
        FanBeamGeometry(ffs="inplane", **kw), 2)
    assert pin_case("ffs")[2][:3] == (t0, dt, 1600)


@pytest.mark.parametrize("floats,ok", [(2 ** 31 - 8, True), (2 ** 31, False)])
def test_k6_table_limit(floats, ok):
    """K6's table of 2^31 floats or more is refused, naming K6: its row
    offsets are 32-bit.  Shape only (a meta tensor holds no data)."""
    rows = floats // 8
    packed = torch.empty((rows, 8), device="meta")
    if ok:
        fbp_fast._check_table(packed, 4, rows, 1, "K6")
    else:
        with pytest.raises(ValueError, match="K6 takes at most"):
            fbp_fast._check_table(packed, 4, rows, 1, "K6")


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_k6_table_alignment(device):
    """A table 4 bytes off a 16-byte boundary is refused: K6 reads each row
    in 8- or 16-byte loads."""
    packed = torch.empty(8 * 96 + 1, device=device)[1:].view(96, 8)
    with pytest.raises(ValueError, match="K6's packed table must be 16-byte"):
        fbp_fast._check_table(packed, 4, 12, 8, "K6")


def test_k6_table_shape_is_checked():
    with pytest.raises(ValueError, match="K6's packed table must be"):
        fbp_fast._check_table(torch.empty((96, 6), device="meta"), 4, 12, 8,
                              "K6")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _no_sync(call):
    """Run ``call`` once, then again with the host forbidden to synchronise
    with the card (a host copy or a read-back would)."""
    call()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n257", "nomask", "views1100"])
def test_k6_makes_no_host_synchronisation(dev, case):
    from dexct_tpu_torch.tools.probe_parallel_backproject import k6_call

    before = fbp_fast.parallel_backproject_multi.launches
    _no_sync(k6_call(fbp_fast, case, dev))
    assert fbp_fast.parallel_backproject_multi.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(SITES))
def test_k6_paths_do_not_synchronise(dev, site):
    """The FFS FBP, the analytic paths and the ramp sweep send their host
    tables to the card through pinned memory and read nothing back."""
    _no_sync(site_call(site, dev))
