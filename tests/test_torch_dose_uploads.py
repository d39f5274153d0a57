"""The dose paths' host inputs go up through ``utils.devices.upload``
(pinned memory, an asynchronous copy) and keep their bits.

On the CPU each repaired entry point must give bit for bit what it gave
when its host arrays were made tensors with ``torch.as_tensor``: every
case runs the function as it is, then again with ``upload`` replaced by
``torch.as_tensor(x, dtype=, device=)`` in the modules that call it, and
the two results must be equal (the replaced ``upload`` must have been
called: the site goes through it).  The card tests
(``tests/test_torch_cuda.py``) show that K23's C calls make no host
synchronisation there and its wrapper one.
"""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import conebeam as tcb
from dexct_tpu_torch.ops import dose
from dexct_tpu_torch.ops import siddon
from dexct_tpu_torch.utils import devices, tiny_cases

# the modules whose host arrays go up through ``upload`` on these paths
MODULES = (devices, dose, tcb)


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


def _same(got, want):
    """Equal bit for bit: dose maps (NumPy) and deposited or removed
    energies (floats)."""
    if isinstance(want, dose.DoseResult):
        assert got.dose_mGy.dtype == want.dose_mGy.dtype
        assert np.array_equal(got.dose_mGy, want.dose_mGy)
        assert got.deposited_J == want.deposited_J
    else:
        assert isinstance(got, float) and got == want


def _paths(kind):
    """The exact material paths of the tiny dose case ``kind`` as a NumPy
    array (the fan's K1 plain trace, the cone's K10)."""
    ph, ct, _ = tiny_cases.dose_inputs(kind)
    if kind == "fan":
        return siddon.material_path_sinogram(ph, ct, device="cpu").numpy()
    return tcb.cone_material_paths(ph, ct, device="cpu").numpy()


def site_call(site, device="cpu"):
    """The entry point of ``site`` on the tiny dose cases on ``device``, as
    a thunk: the maps of ``tiny_cases.dose_inputs``, the removed energies
    traced (``traced``) or over host paths (``host_paths``)."""
    kind = {"dose_map": "fan", "dose_map_3d_cone": "cone",
            "dose_map_3d_helical": "helical"}.get(site)
    if kind is not None:
        return lambda: tiny_cases.dose(kind, device)
    three_d = site.startswith("beam_energy_removed_3d")
    kind = "cone" if three_d else "fan"
    ph, ct, spec = tiny_cases.dose_inputs(kind)
    fn = dose.beam_energy_removed_3d if three_d else dose.beam_energy_removed
    paths = _paths(kind) if site.endswith("host_paths") else None
    return lambda: fn(ph, ct, spec, paths=paths, device=device)


SITES = ("dose_map", "dose_map_3d_cone", "dose_map_3d_helical",
         "beam_energy_removed_traced", "beam_energy_removed_host_paths",
         "beam_energy_removed_3d_traced",
         "beam_energy_removed_3d_host_paths")


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
    _same(got, want)


@pytest.mark.parametrize("x,dtype", [
    (np.linspace(0.0, 2.0, 9), torch.float32),
    (np.linspace(0.0, 2.0, 9).reshape(3, 3).T, torch.float32),
    (np.arange(6, dtype=np.int64), torch.float64)],
    ids=["float64", "strided", "int64"])
def test_f32_keeps_the_bits(x, dtype, monkeypatch):
    """``_f32`` of host data: float32, bit for bit what
    ``torch.as_tensor(np.ascontiguousarray(x), dtype=float32)`` gives, and
    contiguous; ``upload`` with a float64 dtype as ``torch.as_tensor``."""
    got = dose._f32(x, "cpu")
    want = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)
    up = devices.upload(x, "cpu", dtype)
    assert up.dtype == dtype
    assert torch.equal(up, torch.as_tensor(x, dtype=dtype))
