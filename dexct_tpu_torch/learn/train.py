"""The denoiser's inference wrapper (port of :mod:`dexct_tpu.learn.train`;
the training loop is not ported yet).

Units: the network is dimensionless; :func:`apply_denoiser` normalizes HU
images by ``scale`` (default 1000: soft tissue spans ~[-1000, +2000] HU, so
inputs sit O(1)).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["HU_SCALE", "apply_denoiser", "full_float32_convolutions"]

HU_SCALE = 1000.0


@contextlib.contextmanager
def full_float32_convolutions():
    """Run cuDNN's float32 convolutions in full float32: by default PyTorch
    lets them round their inputs to TF32 (a 10-bit mantissa) on the card.
    TF32 is a speed choice, left for a later change with its error."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def apply_denoiser(model, img, scale=HU_SCALE):
    """Denoise HU image(s) on the device of ``img``: [H, W] or [S, H, W]
    -> same shape and units, in one forward pass (the model moves to that
    device)."""
    x = torch.as_tensor(img).to(torch.float32)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    model = model.to(x.device)
    with torch.no_grad(), full_float32_convolutions():
        out = model(x[..., None] / scale)[..., 0] * scale
    return out[0] if squeeze else out
