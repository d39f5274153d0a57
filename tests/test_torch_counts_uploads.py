"""The counts' host inputs on the stateless 3-D, heel, bowtie and realism
paths go up through ``utils.devices.upload`` (pinned memory, an
asynchronous copy) and keep their bits.

On the CPU each repaired entry point must give bit for bit what it gave
when its host arrays were made tensors with ``torch.as_tensor``: every
case runs the function as it is, then again with ``upload`` replaced by
``torch.as_tensor(x, dtype=, device=)`` in the modules that call it, and
the two results must be equal, dtype and device included (the replaced
``upload`` must have been called: the site goes through it).  The card
tests (``tests/test_torch_cuda.py``) show that the same calls make no host
synchronisation there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import bowtie as tb
from dexct_tpu_torch.ops import conebeam as tcb
from dexct_tpu_torch.ops import flatpanel as tfp
from dexct_tpu_torch.ops import heel as th
from dexct_tpu_torch.ops import spectral as sp
from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
from dexct_tpu_torch.pipeline import api
from dexct_tpu_torch.pipeline import realism as tr
from dexct_tpu_torch.system import (ConeBeamGeometry, FanBeamGeometry,
                                    FlatPanelConeBeamGeometry, VoxelPhantom,
                                    water_cylinder_phantom)
from dexct_tpu_torch.utils import devices

# the modules whose host arrays go up through ``upload`` on these paths
MODULES = (devices, tcb, th, tb, tr)
CONE = dict(N_channels=32, N_proj=24, N_rows=4, h_iso=0.5, eid=True)
FAN = dict(N_channels=64, N_proj=24, gamma_fan=0.5, SID=40.0, SDD=70.0,
           eid=True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _assert_same(got, want, where="out"):
    """Equal bit for bit, dtype and device included, through tuples,
    lists, dicts and dataclasses."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and got.device == want.device, where
        assert got.shape == want.shape, where
        assert torch.equal(got, want), where
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name),
                         f"{where}.{f.name}")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


_CASE = {}


def _case():
    """The tiny cone recipe of the verify notes (a 32^2 x 8 water cylinder
    at 0.6 x 0.5 cm, 24 views x 4 rows x 32 channels, linac / 80 kV), its
    flat-panel twin, a 10 um heel, and the bowtie tests' 64-channel fan
    with a flattening bowtie over a tissue cylinder."""
    if not _CASE:
        ph2 = water_cylinder_phantom(N=32, dx=0.6)
        ph = dataclasses.replace(
            ph2, labels=np.broadcast_to(ph2.labels[0], (8, 32, 32)).copy(),
            dz=0.5)
        ct = ConeBeamGeometry(**CONE)
        s1 = linac_spectrum()
        s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
        s2 = kramers_spectrum(80.0)
        s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
        fan = FanBeamGeometry(**FAN)
        x = (np.arange(64) + 0.5 - 32.0) * 0.2
        cyl = VoxelPhantom(
            "tissue_cyl",
            (x[None, :] ** 2 + x[:, None] ** 2 <= 25.0).astype(np.uint8),
            ph2.materials, 0.2, 0.2, 0.2)
        fs = (kramers_spectrum(80.0), kramers_spectrum(140.0))
        for s in fs:
            s.rescale_counts(fan.A_iso * 5.0 / fan.N_proj)
        bt = tb.design_flattening_bowtie(fan, 5.0, n_steps=8)
        _CASE.update(ph=ph, ct=ct, flat=FlatPanelConeBeamGeometry(**CONE),
                     s=(s1, s2), heel=th.HeelEffect(d0_cm=10e-4), fan=fan,
                     cyl=cyl, fs=fs, bt=bt)
    return _CASE


def _heel_counts():
    """The heel's raw counts pair [V, R, C] (NumPy) of the tiny cone."""
    c = _case()
    if "heel_raws" not in c:
        c["heel_raws"] = [th.cone_sinogram_heel(
            c["ph"], c["ct"], s, c["heel"], device="cpu")[0].numpy()
            for s in c["s"]]
    return c["heel_raws"]


def _bowtie_raws():
    """The bowtie fan's raw counts pair [V, C] (NumPy)."""
    c = _case()
    if "bt_raws" not in c:
        c["bt_raws"] = [api.get_sino(c["fan"], c["cyl"], s, device="cpu",
                                     bowtie=c["bt"])[0].numpy()
                        for s in c["fs"]]
    return c["bt_raws"]


def _realism_stages(spec):
    c = _case()
    air = float(np.sum(sp.effective_fluence(spec, c["fan"])))
    return [tr.stage_pileup(0.2 / air),
            tr.stage_gains(np.linspace(0.95, 1.05, FAN["N_channels"]), air)]


def site_call(site, device="cpu"):
    """The entry point of ``site`` on its tiny inputs on ``device``, as a
    thunk: host (NumPy) tables and sinograms, tensors the call does not
    upload itself already on ``device``.  The card tests run the same
    thunks."""
    c = _case()
    s1, s2 = c["s"]
    if site == "cone_sinogram":
        return lambda: tcb.cone_sinogram(c["ph"], c["ct"], s1, device=device)
    if site == "flat_cone_sinogram":
        return lambda: tfp.flat_cone_sinogram(c["ph"], c["flat"], s2,
                                              device=device)
    if site.startswith("simulate_cone_dect"):
        heel = c["heel"] if site.endswith("heel") else None
        ct = c["ct"] if heel is not None else c["flat"]
        return lambda: tcb.simulate_cone_dect(
            ct, c["ph"], s1, s2, 32, 18.0, 0.8, device=device, n_iters=8,
            noise="compound" if heel is None else "none",
            generator=torch.Generator(device=device).manual_seed(3),
            heel=heel)
    if site == "cone_sinogram_heel":
        return lambda: th.cone_sinogram_heel(c["ph"], c["ct"], s1,
                                             c["heel"], device=device)
    if site == "counts_from_paths_heel":
        paths = tcb.cone_material_paths(c["ph"], c["ct"], device=device)
        mu = torch.as_tensor(c["ph"].materials.mu_table(s2.E),
                             dtype=torch.float32, device=device)
        return lambda: th.counts_from_paths_heel(
            paths, mu, th.heel_fluence(s2, c["ct"], c["heel"]),
            th.heel_second_moment(s2, c["ct"], c["heel"]))
    if site == "decompose_cone_sinograms_heel":
        raws = _heel_counts()
        return lambda: th.decompose_cone_sinograms_heel(
            c["ct"], *raws, s1, s2, c["heel"], n_iters=8, device=device)
    if site == "decompose_sinograms_bowtie":
        raws = _bowtie_raws()
        return lambda: tb.decompose_sinograms_bowtie(
            c["fan"], *raws, *c["fs"], c["bt"], n_iters=8, device=device)
    if site == "simulate_dect_realistic":
        return lambda: tr.simulate_dect_realistic(
            c["fan"], c["cyl"], *c["fs"], 32, 14.0, 0.8,
            _realism_stages(c["fs"][0]), _realism_stages(c["fs"][1]),
            n_iters=8, bowtie=c["bt"], device=device)
    raise ValueError(site)


SITES = ("cone_sinogram", "flat_cone_sinogram", "simulate_cone_dect_flat",
         "simulate_cone_dect_heel", "cone_sinogram_heel",
         "counts_from_paths_heel", "decompose_cone_sinograms_heel",
         "decompose_sinograms_bowtie", "simulate_dect_realistic")


@pytest.mark.parametrize("site", SITES)
def test_uploads_keep_the_bits(site, monkeypatch):
    call = site_call(site)
    got = call()
    calls = []
    with monkeypatch.context() as m:
        for mod in MODULES:
            m.setattr(mod, "upload", _as_tensor_upload(calls))
        want = call()
    assert calls, f"{site} sends nothing through upload"
    _assert_same(got, want, site)


@pytest.mark.parametrize("x", [
    np.linspace(0.0, 1.0, 7), [1.5, 2.5, -3.0], 2.75,
    np.arange(12, dtype=np.int64).reshape(3, 4), np.float32(1.0 / 3.0)],
    ids=["float64", "list", "scalar", "int64", "numpy_scalar"])
def test_as_float_keeps_the_bits(x, monkeypatch):
    """``as_float`` of host data: float32, bit for bit what
    ``torch.as_tensor(np.asarray(x, np.float32))`` gives, through
    ``upload``."""
    got = devices.as_float(x, "cpu")
    calls = []
    monkeypatch.setattr(devices, "upload", _as_tensor_upload(calls))
    want = devices.as_float(x, "cpu")
    assert calls == ["ndarray"]
    _assert_same(got, want)
    _assert_same(got, torch.as_tensor(np.asarray(x, np.float32)))


def test_as_float_keeps_a_tensor():
    """A tensor on the device passes through: a floating one as it is, an
    integer one as float32."""
    t = torch.arange(5, dtype=torch.float64)
    assert devices.as_float(t, "cpu") is t
    i = torch.arange(5)
    _assert_same(devices.as_float(i, "cpu"), i.to(torch.float32))


def test_labels_u8_checks_host_labels():
    """Host labels are checked and converted on the host: values past
    0..255 raise, others keep their bits as uint8."""
    lab = np.arange(24, dtype=np.int64).reshape(2, 3, 4)
    got = tcb.labels_u8(lab, "cpu")
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert torch.equal(got, torch.as_tensor(lab).to(torch.uint8))
    with pytest.raises(ValueError, match="0..255"):
        tcb.labels_u8(lab + 250, "cpu")
    with pytest.raises(ValueError, match="0..255"):
        tcb.labels_u8(lab - 1, "cpu")
    view = np.asarray(lab[:, ::-1], np.uint8)
    assert torch.equal(tcb.labels_u8(view, "cpu"),
                       torch.as_tensor(view.copy()))
