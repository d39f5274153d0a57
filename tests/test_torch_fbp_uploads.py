"""The fan and parallel FBPs' host tables go up through ``upload`` and K6's
FOV mask is kept on its device; on the CPU the images keep their bits.
K4's wrapper refuses a table its 32-bit offsets cannot address.

Each FBP is held bit for bit against the same steps run on tables copied
with ``torch.as_tensor`` (the form before ``upload``)."""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import fbp, fbp_fast
from dexct_tpu_torch.ops.filters import filter_frequency_response
from dexct_tpu_torch.system import FanBeamGeometry, ParallelBeamGeometry


def _sino(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.0, 4.0, shape), dtype=torch.float32)


def _fbp_recon_by_copies(sino, ct, n, fov):
    """``fbp_recon``'s fan branch with its tables copied by
    ``torch.as_tensor``."""
    if ct.rotation_total < 2.0 * np.pi - 1e-6:
        sino = sino * torch.as_tensor(fbp.parker_weights(ct),
                                      dtype=torch.float32)
    H, m = filter_frequency_response(ct.N_channels, ct.dgamma, 0.8, "sinc",
                                     "fan")
    w = torch.cos(torch.as_tensor(ct.gammas, dtype=torch.float32)) * ct.SID
    q = fbp.filter_views(sino, w, torch.as_tensor(H, dtype=torch.float32), m,
                         ct.dgamma)
    return fbp.fan_backproject(
        q, torch.as_tensor(ct.betas, dtype=torch.float32), ct.SID, ct.dgamma,
        n, fov, dbeta=ct.rotation_total / ct.N_proj)


@pytest.mark.parametrize("rotation", [2.0 * np.pi, 4.2])
def test_fbp_recon_keeps_its_bits(rotation):
    ct = FanBeamGeometry(N_channels=64, N_proj=72, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, rotation_total=rotation)
    sino = _sino((72, 64), 190)
    got, _ = fbp.fbp_recon(sino, ct, 40, 24.0)
    assert torch.equal(got, _fbp_recon_by_copies(sino, ct, 40, 24.0))


def test_parallel_fbp_keeps_its_bits():
    ct = ParallelBeamGeometry(N_channels=64, N_proj=60)
    sino = _sino((60, 64), 191)
    got = fbp.parallel_fbp(sino, ct, 40, 3.5)
    H, m = filter_frequency_response(64, ct.ds, 0.8, "sinc", "parallel")
    q = fbp.filter_views(sino[None], torch.ones(64),
                         torch.as_tensor(H, dtype=torch.float32), m, ct.ds)
    want = fbp_fast.parallel_backproject_multi(
        fbp_fast.pack_filtered(q), 1,
        torch.as_tensor(ct.betas, dtype=torch.float32),
        float(ct.s_positions[0]), float(ct.ds), 64, 40, 3.5,
        ct.rotation_total / ct.N_proj * (np.pi / ct.rotation_total))[0]
    assert torch.equal(got, want)


def test_fov_mask_is_uploaded_once():
    first = fbp_fast._fov_disc_mask_on(48, 20.0, torch.device("cpu"))
    assert first is fbp_fast._fov_disc_mask_on(48, 20.0, torch.device("cpu"))
    assert first.dtype == torch.uint8
    np.testing.assert_array_equal(first.numpy(),
                                  fbp_fast._fov_disc_mask(48, 20.0))


@pytest.mark.parametrize("floats,ok", [(2 ** 31 - 8, True), (2 ** 31, False)])
def test_k4_table_limit(floats, ok):
    """A table of 2^31 floats or more is refused: K4's row offsets are
    32-bit.  Shape only (a meta tensor holds no data)."""
    rows = floats // 8
    packed = torch.empty((rows, 8), device="meta")
    if ok:
        fbp_fast._check_table(packed, 4, rows, 1, "K4")
    else:
        with pytest.raises(ValueError, match="at most"):
            fbp_fast._check_table(packed, 4, rows, 1, "K4")


def test_k4_table_shape_is_checked():
    with pytest.raises(ValueError, match="must be"):
        fbp_fast._check_table(torch.empty((96, 6), device="meta"), 4, 12, 8,
                               "K4")
