"""Where an entry point of the port runs, and its array inputs as tensors.

An entry point runs on the device of its first array when that is a
tensor, else on its ``device=`` argument, and by default on the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_of", "as_float", "upload", "check_float32"]


def device_of(x, device):
    """The device of ``x`` when it is a tensor, else ``device`` (default:
    the card)."""
    if torch.is_tensor(x):
        return x.device
    return torch.device("cuda" if device is None else device)


def as_float(x, device):
    """``x`` as a tensor on ``device``: a floating tensor keeps its dtype;
    an integer tensor and anything else (NumPy arrays, lists, scalars)
    become float32, the JAX package's working type."""
    if torch.is_tensor(x):
        x = x.to(device)
        return x if x.is_floating_point() else x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _scalar(v, like):
    """A Python or NumPy scalar ``v`` as a 0-d tensor of ``like``'s dtype
    on its device, filled there (``torch.full``; a host copy would
    synchronise the stream); a tensor passes through.  On CUDA, PyTorch
    divides by a Python scalar as a product with its reciprocal, which
    rounds differently from the CPU's division."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def upload(x, like, dtype=None):
    """``x`` (a tensor, NumPy array, list or scalar) as a tensor of
    ``dtype`` (default ``like``'s) on ``like``'s device.  A tensor already
    there is kept (cast there if need be); host data bound for the card is
    staged in pinned memory and copied asynchronously, so the stream is not
    synchronised, as ``torch.as_tensor(..., device=cuda)`` would."""
    dtype = like.dtype if dtype is None else dtype
    if torch.is_tensor(x) and x.device == like.device:
        return x.to(dtype)
    t = torch.as_tensor(x, dtype=dtype)
    if like.device.type != "cuda" or t.device.type != "cpu":
        return t.to(like.device)
    return t.pin_memory().to(like.device, non_blocking=True)


def check_float32(dtype):
    """Accept the JAX signatures' ``dtype=`` keyword where the port works
    in float32 only: ``None`` and float32 (torch's or NumPy's) pass,
    anything else raises ``ValueError``."""
    if dtype is None or dtype is torch.float32:
        return
    try:
        ok = np.dtype(dtype) == np.float32
    except TypeError:
        ok = False
    if not ok:
        raise ValueError(f"this port computes in float32; dtype={dtype!r} "
                         "is not supported")
