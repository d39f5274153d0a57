"""Gated (4-D) reconstruction: phase-binned weighted FBP for periodic
motion over multi-rotation scans.

Port of :mod:`dexct_tpu.pipeline.gated`.  A multi-rotation scan of a
quasi-periodically moving object (cardiac, respiratory) is reconstructed
per motion phase from the views acquired near it:

* :func:`gate_weights`: a raised-cosine window on the per-view phase
  (:func:`view_phases`);
* :func:`gated_fbp_recon`: filtered backprojection with per-view gate
  weights and a per-pixel accumulated-weight normalisation, kernel K31
  (``csrc/fan_backproject.cu``) on the card: each pixel divides by the
  gate weight that reached it, so non-contiguous view subsets and fan-edge
  coverage normalise instead of shading.  With all-ones weights over R
  full rotations it is the standard single-turn FBP;
* :func:`gated_series`: ``n_gates`` phase frames, all gates through one
  K31 launch (its weights [G, V] share the geometry).

The gate window must be chosen against the rotation period: views of one
gate spread over all angles only when the motion period is
incommensurate with the rotation (else the gate sees a fixed angular
wedge, the limited-angle gating artifact).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fbp import filter_sinogram
from ..utils import kernels
from ..utils.devices import as_float, device_of, upload

__all__ = ["view_phases", "gate_weights", "gated_fbp_recon",
           "gated_series"]

# gates per K31 launch (the kernel's num/den registers)
MAX_GATES = 4


def view_phases(n_views, period_views, phase0=0.0):
    """Motion phase in [0, 1) per view for a ``period_views``-periodic
    signal."""
    return np.mod(np.arange(n_views) / float(period_views) + phase0, 1.0)


def gate_weights(phases, center, width=0.2):
    """Raised-cosine gate [V]: weight 1 at ``center`` falling to 0 at
    phase distance ``width/2`` (circular distance)."""
    d = np.abs(np.mod(phases - center + 0.5, 1.0) - 0.5)
    return 0.5 * (1.0 + np.cos(np.pi * np.clip(2.0 * d / width, 0.0, 1.0)))


def _gated_backproject_plain(q, betas, w, sid, dgamma, n_matrix, fov, *,
                             view_block=64):
    """The JAX program ``_gated_backproject`` in torch for G gate
    weightings ``w`` [G, V] of one filtered sinogram q [V, C]: blocks of
    ``view_block`` views, every pixel at once.  Returns [G, N, N]."""
    from ..ops.fbp_fast import _pixel_coords

    dtype, dev = q.dtype, q.device
    n_proj, n_ch = q.shape
    X, Y = _pixel_coords(n_matrix, fov, dtype, dev)
    betas = betas.to(device=dev, dtype=dtype)
    w = w.to(device=dev, dtype=dtype)
    G = w.shape[0]
    num = torch.zeros((G, n_matrix * n_matrix), dtype=dtype, device=dev)
    den = torch.zeros_like(num)
    for v0 in range(0, n_proj, view_block):
        sl = slice(v0, v0 + view_block)
        beta = betas[sl, None]
        cb, sb = torch.cos(beta), torch.sin(beta)
        vr = X[None] * cb + Y[None] * sb - sid
        vt = -X[None] * sb + Y[None] * cb
        gamma = torch.atan2(-vt, -vr)
        L2 = vr * vr + vt * vt
        # a tensor divisor: PyTorch on CUDA divides by a Python scalar
        # through its reciprocal, which moves the hard fan edge
        c = gamma / torch.full_like(gamma, dgamma) - 0.5 + n_ch / 2.0
        c0 = torch.clamp(torch.floor(c), 0, n_ch - 2)
        fc = torch.clamp(c - c0, 0.0, 1.0)
        inside = (c >= 0.0) & (c <= n_ch - 1.0)
        qv = q[sl]
        c0 = c0.to(torch.int64)
        qi = (torch.gather(qv, 1, c0) * (1.0 - fc)
              + torch.gather(qv, 1, c0 + 1) * fc)
        contrib = torch.where(inside, qi / L2, torch.zeros_like(qi))
        ins = inside.to(dtype)
        wv = w[:, sl, None]  # [G, B, 1]
        num += (contrib[None] * wv).sum(1)
        den += (ins[None] * wv).sum(1)
    out = torch.where(den > 0, num / torch.clamp_min(den, 1e-30),
                      torch.zeros_like(num))
    return (out * (2.0 * np.pi)).reshape(G, n_matrix, n_matrix)


def _gated_cuda(q, betas, w, sid, dgamma, n_matrix, fov):
    dev = q.device
    V, C = q.shape
    kernels.require(q, "q", dev, torch.float32)
    betas = betas.to(device=dev, dtype=torch.float32)
    if betas.shape != (V,):
        raise ValueError(f"betas must be [{V}], got {tuple(betas.shape)}")
    cos_b, sin_b = torch.cos(betas).contiguous(), torch.sin(betas).contiguous()
    w = kernels.require(w.to(device=dev, dtype=torch.float32).contiguous(),
                        "w", dev, torch.float32)
    G = w.shape[0]
    out = torch.empty((G, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_gated_backproject(
        q.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), w.data_ptr(),
        out.data_ptr(), G, V, C, n_matrix, fov / n_matrix, n_matrix / 2.0,
        sid, dgamma, kernels.stream_ptr(dev))
    kernels.check(rc, "gated_backproject")
    _gated_backproject.launches += 1
    return out


def _gated_backproject(q, betas, w, sid, dgamma, n_matrix, fov, *,
                       view_block=64):
    """Gate-weighted fan backprojection with a per-pixel normalisation.

    q: [V, C] filtered sinogram; betas: [V]; w: [V] gate weights, or [G, V]
    for G gates of the same data (1..4 per kernel launch).  Per pixel, each
    in-fan view adds ``w_v q_tap / L^2`` to num and ``w_v`` to den; out =
    (den > 0 ? num / max(den, 1e-30) : 0) x 2 pi, with all-ones weights
    over R full rotations the single-turn dbeta sum.  Returns [N, N] (or
    [G, N, N]).  CUDA tensors run kernel K31 (counted in
    ``_gated_backproject.launches``); CPU tensors run
    :func:`_gated_backproject_plain` (``view_block`` views at a time).
    """
    n_proj, n_ch = q.shape
    if n_ch < 2:
        raise ValueError("fan backprojection needs at least 2 channels")
    w = torch.as_tensor(w)
    single = w.dim() == 1
    w = w[None] if single else w
    if w.dim() != 2 or w.shape[1] != n_proj:
        raise ValueError(f"w must be [{n_proj}] or [G, {n_proj}], got "
                         f"{tuple(w.shape)}")
    args = (betas, float(sid), float(dgamma), int(n_matrix), float(fov))
    if q.is_cuda:
        out = torch.cat([_gated_cuda(q, args[0], w[g:g + MAX_GATES],
                                     *args[1:])
                         for g in range(0, w.shape[0], MAX_GATES)])
    elif q.device.type == "cpu":
        out = _gated_backproject_plain(q, betas, w, *args[1:],
                                       view_block=view_block)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out[0] if single else out


_gated_backproject.launches = 0


def _filtered(sino_log, geometry, ramp, window, dtype, device):
    dev = device_of(sino_log, device)
    return filter_sinogram(as_float(sino_log, dev).to(dtype), geometry, ramp,
                           window).contiguous()


def gated_fbp_recon(sino_log, geometry, n_matrix, fov, weights, ramp=0.8,
                    window="sinc", dtype=torch.float32, view_block=64, *,
                    device=None):
    """Weighted fan-beam FBP with accumulated-weight normalization.

    weights: [V] per-view gate weights.  Filtering is per view (gate
    weights scale whole views, so they commute with the channel-axis
    ramp); the backprojection (K31) accumulates ``w * q / L^2`` and
    normalizes per pixel by the accumulated ``w`` over in-fan views, scaled
    so the all-ones gate over ``R`` rotations equals the standard
    single-turn FBP.  Runs on the device of ``sino_log`` when it is a
    tensor, else on ``device`` (default: the card).  Returns [N, N].
    """
    ct = geometry
    q = _filtered(sino_log, ct, ramp, window, dtype, device)
    return _gated_backproject(
        q, upload(ct.betas, q.device, dtype),
        upload(np.asarray(weights), q.device, dtype),
        float(ct.SID), float(ct.dgamma), int(n_matrix), float(fov),
        view_block=int(view_block))


def gated_series(sino_log, geometry, n_matrix, fov, period_views, *,
                 n_gates=4, width=0.3, phase0=0.0, ramp=0.8, window="sinc",
                 device=None):
    """Reconstruct ``n_gates`` phase frames [G, N, N]: gate g centred on
    phase g / n_gates.  The sinogram is filtered once and the gates go
    through K31 together (up to four per launch); each frame is
    :func:`gated_fbp_recon` with that gate's weights."""
    ct = geometry
    ph = view_phases(ct.N_proj, period_views, phase0)
    w = np.stack([gate_weights(ph, g / n_gates, width)
                  for g in range(n_gates)])
    q = _filtered(sino_log, ct, ramp, window, torch.float32, device)
    return _gated_backproject(
        q, upload(ct.betas, q.device, torch.float32),
        upload(w, q.device, torch.float32),
        float(ct.SID), float(ct.dgamma), int(n_matrix), float(fov))
