"""Packed multi-image fan-beam backprojection.

Port of the fan-beam half of :mod:`dexct_tpu.ops.fbp_fast`.  All
sinograms of a DE study (two log sinograms, two basis-material sinograms)
share one backprojection geometry, so the channel coordinate of each
(view, pixel) is computed once and one packed table row serves both
linear-interpolation taps of all K images.

:func:`fan_backproject_multi` dispatches on the device of its tensors: CUDA
tensors go to the hand-written kernel K4 (``csrc/fan_backproject.cu``, one
thread per pixel over all views), CPU tensors to
:func:`fan_backproject_multi_plain`, the JAX package's view-block loop in
torch.  The rebinned parallel-beam reconstruction of the JAX module is not
ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import torch

from ..utils import kernels

__all__ = ["pack_filtered", "fan_backproject_multi",
           "fan_backproject_multi_plain"]

MAX_IMAGES = 4


def pack_filtered(qs):
    """[K, V, C] filtered sinograms -> packed [V*C, 2K] tap table: row
    (v, c) = (q_0[c], .., q_{K-1}[c], q_0[c+1], .., q_{K-1}[c+1]), with
    q[C-1] repeated in the last channel's second half."""
    K, V, C = qs.shape
    q_next = torch.cat([qs[..., 1:], qs[..., -1:]], dim=-1)
    packed = torch.cat([qs, q_next], dim=0)  # [2K, V, C]
    return packed.permute(1, 2, 0).reshape(V * C, 2 * K)


def _pixel_coords(n_matrix, fov, dtype, device):
    px_size = fov / n_matrix
    half = n_matrix / 2.0
    coord = (torch.arange(n_matrix, dtype=dtype, device=device) + 0.5
             - half) * px_size
    X = coord[None, :].expand(n_matrix, n_matrix).reshape(-1)
    Y = coord[:, None].expand(n_matrix, n_matrix).reshape(-1)
    return X, Y


def fan_backproject_multi_plain(packed, n_images, betas, sid, dgamma,
                                n_channels, n_matrix, fov, dbeta, *,
                                view_block=32):
    """``dexct_tpu.ops.fbp_fast.fan_backproject_multi`` in torch: blocks of
    ``view_block`` views, every pixel at once."""
    K, C = n_images, n_channels
    dtype, dev = packed.dtype, packed.device
    X, Y = _pixel_coords(n_matrix, fov, dtype, dev)
    betas = betas.to(device=dev, dtype=dtype)
    acc = torch.zeros((K, n_matrix * n_matrix), dtype=dtype, device=dev)
    for v0 in range(0, betas.shape[0], view_block):
        beta = betas[v0:v0 + view_block]
        cb, sb = torch.cos(beta)[:, None], torch.sin(beta)[:, None]
        vr = X[None, :] * cb + Y[None, :] * sb - sid
        vt = -X[None, :] * sb + Y[None, :] * cb
        gamma = torch.atan2(-vt, -vr)
        inv_l2 = 1.0 / (vr * vr + vt * vt)
        c = gamma / torch.full_like(gamma, dgamma) - 0.5 + C / 2.0
        c0 = torch.clamp(torch.floor(c), 0, C - 2)
        f = torch.clamp(c - c0, 0.0, 1.0)
        inside = (c >= 0.0) & (c <= C - 1.0)
        w = torch.where(inside, inv_l2, torch.zeros_like(inv_l2))
        vo = torch.arange(v0, v0 + beta.shape[0], device=dev)[:, None] * C
        idx = vo + c0.to(torch.int64)  # [B, P]
        rows = packed[idx.reshape(-1)].reshape(*idx.shape, 2 * K)
        taps = rows[..., :K] * (1.0 - f)[..., None] \
            + rows[..., K:] * f[..., None]  # [B, P, K]
        acc += torch.einsum("bp,bpk->kp", w, taps)
    return (acc * dbeta).reshape(K, n_matrix, n_matrix)


def _fan_backproject_cuda(packed, n_images, betas, sid, dgamma, n_channels,
                          n_matrix, fov, dbeta):
    dev = packed.device
    packed = packed.to(torch.float32).contiguous()
    betas = betas.to(device=dev, dtype=torch.float32)
    cos_b = torch.cos(betas).contiguous()
    sin_b = torch.sin(betas).contiguous()
    V = betas.shape[0]
    if packed.shape != (V * n_channels, 2 * n_images):
        raise ValueError(f"packed table must be [{V * n_channels}, "
                         f"{2 * n_images}], got {tuple(packed.shape)}")
    out = torch.empty((n_images, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_fan_backproject(
        packed.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
        out.data_ptr(), n_images, V, n_channels, n_matrix,
        fov / n_matrix, n_matrix / 2.0, sid, dgamma, dbeta,
        kernels.stream_ptr(dev))
    kernels.check(rc, "fan_backproject")
    fan_backproject_multi.launches += 1
    return out


def fan_backproject_multi(packed, n_images, betas, sid, dgamma, n_channels,
                          n_matrix, fov, dbeta):
    """Backproject K images from a packed tap table.

    packed: [V*C, 2K] from :func:`pack_filtered`; betas: [V] view angles.
    Returns [K, n_matrix, n_matrix] in the phantom index convention
    (image[iy, ix] at x = (ix + 0.5 - N/2) px, y = (iy + 0.5 - N/2) px),
    times ``dbeta``.  CUDA tensors run kernel K4 (counted in
    ``fan_backproject_multi.launches``); CPU tensors run
    :func:`fan_backproject_multi_plain`.
    """
    if not 1 <= n_images <= MAX_IMAGES:
        raise ValueError(f"n_images must be in 1..{MAX_IMAGES}")
    if n_channels < 2:
        raise ValueError("fan backprojection needs at least 2 channels")
    args = (packed, int(n_images), betas, float(sid), float(dgamma),
            int(n_channels), int(n_matrix), float(fov), float(dbeta))
    if packed.is_cuda:
        return _fan_backproject_cuda(*args)
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    return fan_backproject_multi_plain(*args)


fan_backproject_multi.launches = 0
