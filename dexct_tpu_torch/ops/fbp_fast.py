"""Packed multi-image backprojection, fan-beam and rebinned parallel-beam.

Port of :mod:`dexct_tpu.ops.fbp_fast`.  All sinograms of a DE study (two
log sinograms, two basis-material sinograms) share one backprojection
geometry, so the channel coordinate of each (view, pixel) is computed once
and one packed table row serves both linear-interpolation taps of all K
images.

Three kernels, each behind a wrapper that dispatches on the device of its
tensors (CUDA tensors launch the kernel, CPU tensors run the plain PyTorch
version beside it):

- :func:`fan_backproject_multi`: K4 (``csrc/fan_backproject.cu``), direct
  fan-beam backprojection, one thread per pixel over all views, each
  packed row read in 16- or 8-byte loads at a 32-bit offset;
- :func:`rebin_to_parallel`: K5 (``csrc/gather_taps.cu``), the fan data
  resampled onto a (theta, t) parallel grid, one thread per parallel bin;
- :func:`parallel_backproject_multi`: K6
  (``csrc/parallel_backproject.cu``), parallel-beam backprojection over the
  FOV disc, one thread per pixel (two at K = 4) over all views, each
  packed row read in 16- or 8-byte loads at a 32-bit offset, several
  views' rows in flight.

The JAX module's symmetry-packed backprojectors (``pack_filtered_sym*``,
``parallel_backproject_sym*``) and its ``quad`` rebin are TPU gather-count
layouts of the same arithmetic; K6 computes the image they compute.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import upload

__all__ = ["pack_filtered", "fan_backproject_multi",
           "fan_backproject_multi_plain", "parallel_rebin_plan",
           "rebin_to_parallel", "rebin_to_parallel_plain",
           "parallel_backproject_multi", "parallel_backproject_multi_plain"]

MAX_IMAGES = 4


def pack_filtered(qs):
    """[K, V, C] filtered sinograms -> packed [V*C, 2K] tap table: row
    (v, c) = (q_0[c], .., q_{K-1}[c], q_0[c+1], .., q_{K-1}[c+1]), with
    q[C-1] repeated in the last channel's second half.  Contiguous, so one
    row is one fetch."""
    K, V, C = qs.shape
    q_next = torch.cat([qs[..., 1:], qs[..., -1:]], dim=-1)
    packed = torch.cat([qs, q_next], dim=0)  # [2K, V, C]
    return packed.permute(1, 2, 0).contiguous().reshape(V * C, 2 * K)


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


# K4 and K6 address their packed tables in 32-bit offsets
MAX_TABLE_FLOATS = 2 ** 31 - 1


def _check_table(packed, n_images, n_views, n_channels, kernel):
    """Raise ``ValueError`` unless ``packed`` can be the table of
    ``kernel`` (K4 or K6): shape [V*C, 2K], at most ``MAX_TABLE_FLOATS``
    floats (the kernel's row offsets are 32-bit) and 16-byte aligned (it
    reads each row in 8- or 16-byte loads; a PyTorch allocation is).  Reads
    only the shape and the address."""
    if tuple(packed.shape) != (n_views * n_channels, 2 * n_images):
        raise ValueError(f"{kernel}'s packed table must be "
                         f"[{n_views * n_channels}, {2 * n_images}], got "
                         f"{tuple(packed.shape)}")
    if packed.numel() > MAX_TABLE_FLOATS:
        raise ValueError(f"packed table holds {packed.numel()} floats; "
                         f"{kernel} takes at most {MAX_TABLE_FLOATS}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{kernel}'s packed table must be 16-byte aligned")


def _fan_backproject_cuda(packed, n_images, betas, sid, dgamma, n_channels,
                          n_matrix, fov, dbeta):
    dev = packed.device
    packed = packed.to(torch.float32).contiguous()
    betas = betas.to(device=dev, dtype=torch.float32)
    cos_b = torch.cos(betas).contiguous()
    sin_b = torch.sin(betas).contiguous()
    V = betas.shape[0]
    _check_table(packed, n_images, V, n_channels, "K4")
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
                          n_matrix, fov, dbeta, *, view_block=None):
    """Backproject K images from a packed tap table.

    packed: [V*C, 2K] from :func:`pack_filtered`; betas: [V] view angles.
    Returns [K, n_matrix, n_matrix] in the phantom index convention
    (image[iy, ix] at x = (ix + 0.5 - N/2) px, y = (iy + 0.5 - N/2) px),
    times ``dbeta``.  CUDA tensors run kernel K4 (counted in
    ``fan_backproject_multi.launches``; the table 16-byte aligned and
    under 2^31 floats, else ``ValueError``); CPU tensors run
    :func:`fan_backproject_multi_plain`.  ``view_block`` (a TPU view-block
    layout) is accepted and ignored.
    """
    del view_block
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


# ---------------------------------------------------------------------------
# Rebinned parallel-beam reconstruction
# ---------------------------------------------------------------------------
#
# A full 2π equiangular fan acquisition samples every line twice; rebinning
# to parallel coordinates (θ = β + γ - π/2 ∈ [0, π), t = SID sin γ) halves
# the backprojected views and averages the redundant copies, and the
# parallel channel coordinate is affine in the pixel coordinates.


def parallel_rebin_plan(geometry, n_theta=512, nt=1024, t_max=None):
    """Host tables mapping a fan sinogram onto a (θ, t) parallel grid.

    Returns (idx [nθ*nt*8] int32, w [nθ*nt*8] float32, t0, dt): for each
    parallel bin, the two redundant fan samples (bilinear in β and γ,
    averaged), as adjacent-channel tap pairs.
    """
    if abs(geometry.rotation_total - 2.0 * np.pi) > 1e-3:
        raise ValueError(
            "parallel rebinning requires a full 2*pi fan acquisition "
            f"(rotation_total={geometry.rotation_total}); use the direct "
            "fan backprojector for partial scans"
        )
    if getattr(geometry, "ffs", "none") != "none":
        raise ValueError(
            "this plan assumes a static focal spot; flying-focal-spot "
            "scans rebin through ops.ffs.parallel_rebin_plan_ffs")
    sid = geometry.SID
    v, c = geometry.N_proj, geometry.N_channels
    dgamma = geometry.dgamma
    dbeta = geometry.rotation_total / v
    gam_lim = geometry.gamma_fan / 2.0
    if t_max is None:
        t_max = sid * np.sin(gam_lim)
    dt = 2.0 * t_max / nt
    t0 = -t_max + 0.5 * dt
    thetas = np.arange(n_theta) * (np.pi / n_theta)
    ts = t0 + dt * np.arange(nt)

    tt, th = np.meshgrid(ts, thetas)  # [nθ, nt]
    sin_g = np.clip(tt / sid, -1.0, 1.0)
    gam = np.arcsin(sin_g)
    valid = np.abs(gam) <= gam_lim

    def fan_taps(beta, gamma):
        """Bilinear taps of (beta [wraps], gamma [clamped]) -> idx, w x4."""
        fb = np.mod(beta, 2.0 * np.pi) / dbeta
        ib0 = np.floor(fb).astype(np.int64)
        wb1 = fb - ib0
        ib1 = np.mod(ib0 + 1, v)
        ib0 = np.mod(ib0, v)
        fg = gamma / dgamma - 0.5 + c / 2.0
        ig0 = np.clip(np.floor(fg), 0, c - 2).astype(np.int64)
        wg1 = np.clip(fg - ig0, 0.0, 1.0)
        idx = np.stack([
            ib0 * c + ig0, ib0 * c + ig0 + 1,
            ib1 * c + ig0, ib1 * c + ig0 + 1,
        ], -1)
        w = np.stack([
            (1 - wb1) * (1 - wg1), (1 - wb1) * wg1,
            wb1 * (1 - wg1), wb1 * wg1,
        ], -1)
        return idx, w

    # copy A: (β = θ - γ + π/2, γ); copy B: the conjugate ray
    # (β' = θ + γ + 3π/2, γ' = -γ)
    idx_a, w_a = fan_taps(th - gam + np.pi / 2.0, gam)
    idx_b, w_b = fan_taps(th + gam + 1.5 * np.pi, -gam)
    idx = np.concatenate([idx_a, idx_b], -1).reshape(-1, 8)
    w = 0.5 * np.concatenate([w_a, w_b], -1).reshape(-1, 8)
    w = w * valid.reshape(-1, 1)
    return (idx.astype(np.int32).reshape(-1),
            w.astype(np.float32).reshape(-1), float(t0), float(dt))


def _rebin_shape(sinos, idx, w, nt, taps):
    if taps not in (4, 8, 16):
        raise ValueError(f"taps must be 4, 8 or 16, got {taps}")
    if sinos.dim() != 3:
        raise ValueError(f"sinos must be [K, V, C], got {tuple(sinos.shape)}")
    n = idx.numel()
    if n == 0 or n % (taps * nt) or w.numel() != n:
        raise ValueError(f"idx/w must hold n_theta * {nt} * {taps} taps, got "
                         f"{n} and {w.numel()}")
    return n // (taps * nt)


def rebin_to_parallel_plain(sinos, idx, w, nt, taps=8):
    """``dexct_tpu.ops.fbp_fast.rebin_to_parallel`` in torch: each bin sums
    its ``taps`` taps, read as adjacent-channel pairs (the pair's second tap
    is the element after its first, mod V*C)."""
    n_theta = _rebin_shape(sinos, idx, w, nt, taps)
    K = sinos.shape[0]
    table = sinos.reshape(K, -1)
    vc = table.shape[1]
    first = idx.reshape(-1, taps)[:, 0::2].to(torch.int64)
    src = torch.stack([first, (first + 1) % vc], -1).reshape(-1, taps)
    vals = (table[:, src] * w.reshape(-1, taps).to(table.dtype)).sum(-1)
    return vals.reshape(K, n_theta, nt)


def _rebin_cuda(sinos, idx, w, nt, taps):
    n_theta = _rebin_shape(sinos, idx, w, nt, taps)
    dev = sinos.device
    K = sinos.shape[0]
    table = kernels.require(sinos.reshape(K, -1), "sinos", dev,
                            torch.float32)
    n = idx.numel()
    idx = kernels.require(idx.reshape(-1), "idx", dev, torch.int32, (n,))
    w = kernels.require(w.reshape(-1), "w", dev, torch.float32, (n,))
    out = torch.empty((K, n_theta, nt), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_rebin_to_parallel(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
        n_theta * nt, K, table.shape[1], taps, kernels.stream_ptr(dev))
    kernels.check(rc, "rebin_to_parallel")
    rebin_to_parallel.launches += 1
    return out


def rebin_to_parallel(sinos, idx, w, nt, taps=8):
    """[K, V, C] fan sinograms -> [K, nθ, nt] parallel sinograms.

    idx/w are the flat [nθ*nt*taps] tables of :func:`parallel_rebin_plan`
    (``taps`` = 8; 16 for the flying-focal-spot plan; 4 for the helical PI
    method's row rebin, whose K are the detector rows), ordered as
    adjacent-channel pairs; nθ is inferred from their length.  CUDA tensors
    run kernel K5 (counted in ``rebin_to_parallel.launches``; float32
    sinograms and weights, int32 indices, all on the sinograms' device);
    CPU tensors run :func:`rebin_to_parallel_plain`.
    """
    nt, taps = int(nt), int(taps)
    if sinos.is_cuda:
        return _rebin_cuda(sinos, idx, w, nt, taps)
    if sinos.device.type != "cpu":
        raise ValueError(f"unsupported device {sinos.device}")
    return rebin_to_parallel_plain(sinos, idx, w, nt, taps)


rebin_to_parallel.launches = 0


@functools.lru_cache(maxsize=8)
def _fov_disc_mask(n_matrix, fov):
    """uint8 [N*N]: 1 where the pixel centre lies in the scan's FOV disc
    (r <= fov/2), tested in float64 on the host as the JAX program does;
    a float32 test would flip pixels on the circle.  Shared: never write."""
    c = (np.arange(n_matrix) + 0.5 - n_matrix / 2.0) * (fov / n_matrix)
    rr = np.hypot(c[None, :], c[:, None]).reshape(-1)
    return (rr <= fov / 2.0).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def _fov_disc_mask_on(n_matrix, fov, device):
    """:func:`_fov_disc_mask` on ``device``, uploaded once (pinned memory,
    an asynchronous copy) and kept: K6's wrapper reads it on every call.
    Shared: never write."""
    return upload(_fov_disc_mask(n_matrix, fov), device)


def parallel_backproject_multi_plain(packed, n_images, thetas, t0, dt, nt,
                                     n_matrix, fov, dtheta, *,
                                     fov_mask=True, view_block=64):
    """``dexct_tpu.ops.fbp_fast.parallel_backproject_multi`` in torch:
    blocks of ``view_block`` views, every (in-disc) pixel at once."""
    K = n_images
    dtype, dev = packed.dtype, packed.device
    X, Y = _pixel_coords(n_matrix, fov, dtype, dev)
    pix = None
    if fov_mask:
        pix = torch.as_tensor(np.flatnonzero(_fov_disc_mask(n_matrix, fov)),
                              device=dev)
        X, Y = X[pix], Y[pix]
    thetas = thetas.to(device=dev, dtype=dtype)
    acc = torch.zeros((K, X.shape[0]), dtype=dtype, device=dev)
    for v0 in range(0, thetas.shape[0], view_block):
        th = thetas[v0:v0 + view_block]
        ct, st = torch.cos(th)[:, None], torch.sin(th)[:, None]
        # tensor operands: on CUDA, division by a Python scalar multiplies
        # by its reciprocal and moves the edge taps
        u = X[None, :] * ct + Y[None, :] * st - t0
        c = u / torch.full_like(u, dt)
        c0 = torch.clamp(torch.floor(c), 0, nt - 2)
        f = torch.clamp(c - c0, 0.0, 1.0)
        w = ((c >= 0.0) & (c <= nt - 1.0)).to(dtype)
        vo = torch.arange(v0, v0 + th.shape[0], device=dev)[:, None] * nt
        idx = vo + c0.to(torch.int64)  # [B, P]
        rows = packed[idx.reshape(-1)].reshape(*idx.shape, 2 * K)
        taps = rows[..., :K] * (1.0 - f)[..., None] \
            + rows[..., K:] * f[..., None]  # [B, P, K]
        acc += torch.einsum("bp,bpk->kp", w, taps)
    acc = acc * dtheta
    if pix is not None:
        full = torch.zeros((K, n_matrix * n_matrix), dtype=dtype, device=dev)
        full[:, pix] = acc
        acc = full
    return acc.reshape(K, n_matrix, n_matrix)


def _parallel_backproject_cuda(packed, n_images, thetas, t0, dt, nt,
                               n_matrix, fov, dtheta, fov_mask):
    dev = packed.device
    n_th = thetas.shape[0]
    kernels.require(packed, "packed", dev, torch.float32,
                    (n_th * nt, 2 * n_images))
    _check_table(packed, n_images, n_th, nt, "K6")
    kernels.require(thetas, "thetas", dev, torch.float32, (n_th,))
    cos_t, sin_t = torch.cos(thetas), torch.sin(thetas)
    mask = _fov_disc_mask_on(n_matrix, fov, dev) if fov_mask else None
    out = torch.empty((n_images, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_parallel_backproject(
        packed.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), n_images,
        n_th, nt, n_matrix, fov / n_matrix, n_matrix / 2.0, t0, dt, dtheta,
        kernels.stream_ptr(dev))
    kernels.check(rc, "parallel_backproject")
    parallel_backproject_multi.launches += 1
    return out


def parallel_backproject_multi(packed, n_images, thetas, t0, dt, nt,
                               n_matrix, fov, dtheta, *, view_block=None,
                               fov_mask=True):
    """Backproject K images from packed parallel-beam taps.

    packed: [nθ*nt, 2K] from :func:`pack_filtered` of the filtered parallel
    sinograms; thetas: [nθ] view angles.  The channel coordinate per
    (θ, pixel) is affine: c = (x cosθ + y sinθ - t0) / dt.  Returns
    [K, n_matrix, n_matrix] times ``dtheta``; with ``fov_mask`` pixels
    outside the FOV disc (r > fov/2) are 0.  CUDA tensors run kernel K6
    (counted in ``parallel_backproject_multi.launches``; the table 16-byte
    aligned and under 2^31 floats, else ``ValueError``); CPU tensors run
    :func:`parallel_backproject_multi_plain`.  ``view_block`` (a TPU view-block
    layout) is accepted and ignored.
    """
    del view_block
    if not 1 <= n_images <= MAX_IMAGES:
        raise ValueError(f"n_images must be in 1..{MAX_IMAGES}")
    if nt < 2:
        raise ValueError("parallel backprojection needs at least 2 channels")
    args = (packed, int(n_images), thetas, float(t0), float(dt), int(nt),
            int(n_matrix), float(fov), float(dtheta))
    if packed.is_cuda:
        return _parallel_backproject_cuda(*args, bool(fov_mask))
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    return parallel_backproject_multi_plain(*args, fov_mask=fov_mask)


parallel_backproject_multi.launches = 0
