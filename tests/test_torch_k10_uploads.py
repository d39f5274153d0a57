"""The host copies on K10's paths go up through ``utils.devices.upload``
(pinned memory, an asynchronous copy) and keep their bits.

On the CPU each repaired site must give bit for bit what it gave when its
host arrays were made tensors with ``torch.as_tensor``: every case runs the
function as it is, then again with ``upload`` replaced by
``torch.as_tensor(x, dtype=, device=)`` in the modules that call it, and
the two results must be equal, dtype included (the replaced ``upload``
must have been called at least as often as the site copies).  On the card
(skipped here) the cone pack and trace and the motion trace make no host
synchronisation, and ``labels_u8`` reads a card tensor of another dtype
back once:

    python -m pytest --noconftest -m cuda tests/test_torch_k10_uploads.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import conebeam, motion
from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
from dexct_tpu_torch.pipeline import cone
from dexct_tpu_torch.system import ConeBeamGeometry, water_cylinder_phantom

CONE = dict(N_channels=32, N_proj=24, N_rows=4, gamma_fan=0.8230337,
            SID=60.0, SDD=100.0, h_iso=0.5)

# site -> (the modules whose ``upload`` the site reads, the copies it
# makes): the pack's nine tables, labels and rays; the numpy arrays' tables
# (the keys present), labels and rays; the labels; the labels and the two
# ray arrays; the three index arrays
SITES = {"pack_cone_dect": ((cone, conebeam), 12),
         "cone_arrays_from_numpy": ((cone, conebeam), 12),
         "labels_u8": ((conebeam,), 1),
         "cone_material_paths_motion": ((motion, conebeam), 3),
         "tilted_indices": ((conebeam,), 3)}


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


def _phantom():
    """A 32^2 x 6 water cylinder at 0.6 x 0.5 cm, an air channel through
    it."""
    ph2 = water_cylinder_phantom(N=32, dx=0.6)
    lab = np.broadcast_to(ph2.labels[0], (6, 32, 32)).copy()
    lab[:, 14:18, 10:13] = 0
    return dataclasses.replace(ph2, labels=lab, dz=0.5)


def _spectra(ct):
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return s1, s2


def site_call(site, device="cpu"):
    """The site on a small case on ``device``, as a thunk (its inputs made
    once, outside it)."""
    ct, ph = ConeBeamGeometry(**CONE), _phantom()
    if site == "pack_cone_dect":
        s1, s2 = _spectra(ct)

        def pack_and_trace():
            a, meta = cone.pack_cone_dect(ct, ph, s1, s2, 32, 20.0, 0.8,
                                          device=device, n_iters=4,
                                          noise="compound")
            return {**a, "paths": cone.cone_paths(a, meta)}
        return pack_and_trace
    if site == "cone_arrays_from_numpy":
        a, _ = cone.pack_cone_dect(ct, ph, *_spectra(ct), 32, 20.0, 0.8,
                                   device="cpu", n_iters=4, noise="compound")
        host = {k: v.numpy().astype(np.float64) for k, v in a.items()
                if k not in ("labels", "src", "dirs")}
        src, dirs = ct.ray_geometry_3d()
        return lambda: cone.cone_arrays_from_numpy(host, device, ph.labels,
                                                   src, dirs)
    if site == "labels_u8":
        lab = torch.as_tensor(ph.labels.astype(np.int64))
        return lambda: conebeam.labels_u8(lab, device)
    if site == "cone_material_paths_motion":
        track = motion.MotionProfile3D.breathing_z(CONE["N_proj"],
                                                   amplitude_cm=0.8)
        return lambda: motion.cone_material_paths_motion(ph, ct, track,
                                                         device=device)
    return lambda: conebeam._tilted_indices(0.2618, 24, 20.0, 6, 0.5,
                                            device)


def _assert_same(got, want):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _assert_same(got[k], want[k])
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("site", sorted(SITES))
def test_uploads_keep_the_bits(site, monkeypatch):
    call = site_call(site)
    got = call()
    modules, copies = SITES[site]
    calls = []
    with monkeypatch.context() as m:
        for mod in modules:
            m.setattr(mod, "upload", _as_tensor_upload(calls))
        want = call()
    assert len(calls) >= copies, f"{site} copies {calls} through upload"
    _assert_same(got, want)


def test_labels_u8_of_a_host_tensor_is_checked_on_the_host():
    """A CPU tensor of labels is range-checked and cast on the host, with
    the same bits as an array of the same labels."""
    lab = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    got = conebeam.labels_u8(lab, "cpu")
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert torch.equal(got, conebeam.labels_u8(lab.numpy(), "cpu"))
    with pytest.raises(ValueError, match="0..255"):
        conebeam.labels_u8(lab + 250, "cpu")
    with pytest.raises(ValueError, match="0..255"):
        conebeam.labels_u8(lab - 1, "cpu")
    view = lab.to(torch.uint8).flip(1)
    assert torch.equal(conebeam.labels_u8(view, "cpu"), view.contiguous())


def test_k10_refuses_a_volume_past_2_31_cells():
    """K10 walks with 32-bit cell offsets, as K18 does: its wrapper refuses
    a label volume past 2^31 - 1 cells before it touches the card.  Shape
    only (a meta tensor holds no data)."""
    labels = torch.empty((2048, 1024, 1024), dtype=torch.uint8,
                         device="meta")
    rays = torch.zeros((4, 3))
    with pytest.raises(ValueError, match=r"at most 2\^31 - 1"):
        conebeam._trace_paths_3d_cuda(labels, rays, rays, 0.2, 0.2, 0.2, 7)


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


# the calls that still synchronise, by site: a card tensor of labels that
# is not uint8 is range-checked by one read-back of its aminmax
K10_UPLOAD_SYNCS = {
    "labels_u8_card_int64": {"dexct_tpu_torch/ops/conebeam.py:labels_u8": 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["pack_cone_dect",
                                  "cone_material_paths_motion",
                                  "labels_u8_card_uint8",
                                  "labels_u8_card_int64"])
def test_k10_makes_no_host_synchronisation(dev, site):
    """The cone pack and its trace (K10), the motion trace and ``labels_u8``
    of card tensors synchronise the host with the card only where
    ``K10_UPLOAD_SYNCS`` says."""
    before = conebeam.trace_paths_3d.launches
    if site.startswith("labels_u8_card"):
        dtype = torch.uint8 if site.endswith("uint8") else torch.int64
        lab = torch.as_tensor(_phantom().labels, dtype=dtype, device=dev)

        def call():
            return conebeam.labels_u8(lab, dev)
    else:
        call = site_call(site, dev)
    out = call()
    torch.cuda.synchronize()
    assert _sync_functions(call) == K10_UPLOAD_SYNCS.get(site, {})
    if site.startswith("labels_u8_card"):
        assert out.dtype == torch.uint8 and torch.equal(out.long(),
                                                        lab.long())
        assert (out.data_ptr() == lab.data_ptr()) == site.endswith("uint8")
    else:
        assert conebeam.trace_paths_3d.launches == before + 2
