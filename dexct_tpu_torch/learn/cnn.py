"""Residual CNN denoiser (the DLIR-class image restorer).

Port of :mod:`dexct_tpu.learn.cnn`: a DnCNN-style plain residual network
(Zhang et al. 2017), ``depth`` 3x3 convolutions with ReLU predicting the
noise residual, which is subtracted from the input; no normalization
layers; the residual head is zero-initialized, so a fresh network is the
identity.  The convolutions are ``torch.nn.Conv2d`` (cuDNN on the card):
the JAX package computes them with XLA's convolution, in no hand-shaped
program, so there is no hand kernel here.

The module keeps the JAX package's channels-last interface, [N, H, W, C]
in and out, and runs its convolutions channels-first.  It is
dimensionless: callers normalize (HU / ``scale``, see
:func:`dexct_tpu_torch.learn.train.apply_denoiser`).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["DnCNN"]


class DnCNN(nn.Module):
    """Plain residual denoiser: ``y = x - f(x)`` with f a conv stack.

    ``features`` channels in the hidden convs, ``depth`` conv layers in
    all (>= 2), one channel in and out (a CT image); ``convs[i]`` holds the
    JAX model's ``Conv_i``.
    """

    def __init__(self, features=32, depth=6):
        super().__init__()
        if depth < 2:
            raise ValueError(f"depth must be >= 2, got {depth}")
        self.features, self.depth = int(features), int(depth)
        widths = [1] + [self.features] * (self.depth - 1) + [1]
        self.convs = nn.ModuleList(
            nn.Conv2d(w_in, w_out, 3, padding=1)
            for w_in, w_out in zip(widths[:-1], widths[1:]))
        # zero-init the residual head: exact identity at initialization
        nn.init.zeros_(self.convs[-1].weight)
        nn.init.zeros_(self.convs[-1].bias)

    def forward(self, x):
        """x: [batch, H, W, C] normalized images -> denoised, same shape."""
        if x.dim() != 4:
            raise ValueError(f"expected [N, H, W, C] input, got "
                             f"{tuple(x.shape)}")
        h = x.permute(0, 3, 1, 2)
        for conv in self.convs[:-1]:
            h = torch.relu(conv(h))
        residual = self.convs[-1](h).permute(0, 2, 3, 1)
        return (x - residual).to(torch.float32)
