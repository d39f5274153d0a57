"""K18's host-side pieces, on the CPU.

The card's exact 3-D projector addresses the volume with 32-bit cell
indices, so its wrapper refuses a volume past 2^31 - 1 cells before it
touches the card.  Shape-only (``meta``) tensors stand in for volumes of
that size; the kernel itself is held to the plain version in
tests/test_torch_cuda.py.
"""

import pytest
import torch

from dexct_tpu_torch.ops import conebeam as cb


@pytest.mark.parametrize("shape", [(1024, 1024, 2047), (1, 1, 2 ** 31 - 1)])
def test_volumes_up_to_2_31_cells_pass(shape):
    cb._check_int32_cells(torch.empty(shape, device="meta").shape)


@pytest.mark.parametrize("shape", [(2048, 1024, 1024), (1, 1, 2 ** 31)])
def test_wrapper_refuses_a_volume_past_2_31_cells(shape):
    vol = torch.empty(shape, device="meta")
    rays = torch.zeros((4, 3))
    with pytest.raises(ValueError, match=r"at most 2\^31 - 1"):
        cb._project_cuda(vol, rays, rays, 0.2, 0.2, 0.2, 8)
