"""Polyenergetic forward model: material paths -> detected counts.

Port of :mod:`dexct_tpu.ops.spectral`:

    counts(ray) = sum_E i0_eff(E) exp(-clip(sum_m paths_m mu_m(E)))

:func:`counts_from_paths` dispatches on the device of its tensors: CUDA
tensors go to the hand-written CUDA C++ kernel K2
(``csrc/spectral_counts.cu``), CPU tensors to
:func:`counts_from_paths_plain`, the JAX package's two contractions in
torch.

K2 replaces the TPU program ``dexct_tpu/ops/spectral.py:counts_from_paths``
(two MXU matmuls, ``[R, M] @ [M, E]`` then ``exp(-L) @ i0``).  On the card
that form writes and re-reads an ``[R, E]`` float32 array (8e5 x 140 x 4 B
= 450 MB per spectrum at the reference protocol) and M = 6 is far too thin
for a tensor-core product.  What bounds the fused kernel is the exp per
(ray, energy) and the M FMAs that form its argument; the bytes moved are
only the paths in and one float out per ray.  Design: each thread owns a
few rays, keeps their paths in registers and walks E in 64-energy chunks
whose table (mu, i0, i2) the block stages in shared memory; per energy it
forms ``L = sum_m paths_m mu_m(E)`` with M FMAs, applies
``exp(clip(-L, -700, 2))`` and adds ``* i0(E)`` into the chunk's sum in
the order of the first K2 (a Triton kernel whose output the paths' pinned
bits come from; the order is spelled out in the source), so ``[R, E]``
never reaches device memory.  An optional second fluence table (the
compound-noise second moment ``i2``) shares the same exp pass.

K28 (``_table_counts_kernel``, :func:`counts_from_table`) is the same fused
pass with the fluence read from a table of rows, one row per ray: row
``t(r) = (r // stride) % n_rows`` of ``T [n_rows, E]``.  It replaces the
TPU programs ``dexct_tpu/ops/spectral.py:counts_from_paths(...,
per_channel=True)`` (the bowtie's per-channel ``[C, E]`` einsum against
``[V, C]`` rays: stride 1, n_rows = C) and
``dexct_tpu/ops/heel.py:counts_from_paths_heel`` (the anode heel's per-row
``[R, E]`` einsum against ``[V, R, C]`` rays: stride C, n_rows = R).  The
bound is K2's (one exp and M FMAs per ray and energy); the only new read
is a ``[BLOCK_R, BLOCK_E]`` gather from the table, which stays in L2
(800 x 140 x 4 B = 0.45 MB at the reference protocol).

K34 (``_bins_counts_kernel``, :func:`counts_from_paths_multibin`) is K2's
fused pass with M fluence columns: ``out[r, m] = sum_E i0[E, m]
exp(clip(-L[r, E]))`` for a stacked ``[E, M]`` table (a photon-counting
detector's M threshold bins).  It replaces the TPU program
``dexct_tpu/ops/spectral.py:counts_from_paths`` with the multi-bin
pipelines' ``[E, M]`` table (``dexct_tpu/pipeline/spectralct.py``), an
``[R, E] x [E, M]`` MXU product after the exp.  What bounds it is K2's
exp per (ray, energy) plus M FMAs for the bin sums; the bytes are the
paths in and M floats out per ray.  Design (Triton): one exp per (ray,
energy) in a ``[BLOCK_R, BLOCK_E]`` tile, then the tile times the
``[BLOCK_E, M]`` fluence block (M padded to 16) as a ``tl.dot`` in IEEE
float32 into a ``[BLOCK_R, M]`` accumulator in registers.  (A broadcast
product summed over the energies took 10.2 ms at 6 bins on the H100, the
dot 0.31 ms; PERF.md.)  K34 is its own function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import _scalar, check_float32, upload

__all__ = [
    "effective_fluence",
    "second_moment_fluence",
    "counts_from_paths",
    "counts_from_paths_plain",
    "counts_from_table",
    "counts_from_table_plain",
    "counts_from_paths_multibin",
    "log_sinogram",
    "sample_noise",
    "forward_counts",
]


def effective_fluence(spec, geometry):
    """Detector-weighted fluence per energy bin: i0_eff[E] (host, float64).

    ``I0(E) * eta(E) * [E if eid] * dE`` with dE[0] = E[0] — exactly the
    construction the GN decomposition applies on its union grid
    (matdecomp.py:146-151), evaluated here on the spectrum's own grid.
    """
    resp = geometry.detector_response(spec.E)
    return spec.I0 * resp * spec.bin_widths()


def second_moment_fluence(spec, geometry):
    """Second-moment table for compound-Poisson noise: i2[E].

    EID: detected photons are Poisson and the signal weights each by
    w(E) = eta(E) * E, so var(signal) = sum_E n(E) w(E)^2 with n = I0 dE
    photon counts.  PCD: each detected photon counts once, so
    var = mean = sum_E n(E) eta(E).
    """
    n = spec.I0 * spec.bin_widths()  # photons per bin
    w = geometry.detector_response(spec.E)  # eta * E when eid, else eta
    return n * w * w if geometry.eid else n * w


def counts_from_paths_plain(paths, mu_table, i0_eff):
    """``exp(-clip(paths @ mu)) @ i0`` with its rounding fixed by the
    expression, not by the CPU's BLAS or vector-math library (both pick
    their kernels, and so their rounding, by the host's instruction set):
    ``L`` is the float32 sum of the M products in material order, and the
    exp and the sum over energies are taken in float64 and rounded once."""
    mu = mu_table.to(paths.dtype)
    L = paths[..., :1] * mu[0]  # [..., E]
    for m in range(1, mu.shape[0]):
        L = L + paths[..., m:m + 1] * mu[m]
    # L >= 0 physically; the tight upper clip keeps float32 finite when an
    # approximate projector rings slightly negative at sharp edges
    atten = torch.exp(torch.clamp(-L, -700.0, 2.0).double())
    return (atten @ i0_eff.double()).to(paths.dtype)


def _table_rows(n_rays, stride, n_rows, device):
    """Table row of each ray: ``(r // stride) % n_rows``."""
    r = torch.arange(n_rays, device=device)
    return torch.div(r, stride, rounding_mode="floor") % n_rows


def counts_from_table_plain(paths, mu_table, table, *, stride=1):
    """:func:`counts_from_paths_plain` with the fluence of ray ``r`` read
    from row ``(r // stride) % n_rows`` of ``table [n_rows, E]`` (rays in
    the row-major order of ``paths[..., 0]``): the JAX package's
    ``einsum`` over a per-channel or per-row table, with K2's plain
    rounding (float32 ``L`` in material order, exp and the energy sum in
    float64, rounded once)."""
    m = paths.shape[-1]
    p2 = paths.reshape(-1, m)
    mu = mu_table.to(paths.dtype)
    L = p2[:, :1] * mu[0]
    for k in range(1, mu.shape[0]):
        L = L + p2[:, k:k + 1] * mu[k]
    atten = torch.exp(torch.clamp(-L, -700.0, 2.0).double())
    rows = _table_rows(p2.shape[0], stride, table.shape[0], paths.device)
    out = (atten * table.double()[rows]).sum(-1)
    return out.to(paths.dtype).reshape(paths.shape[:-1])


@functools.lru_cache(maxsize=1)
def _table_counts_kernel():
    """K28, a Triton kernel compiled on first use (``triton`` is imported
    here, not at module import: a CPU-only installation has no triton):
    K2's fused pass with the fluence of each ray gathered from its row of
    a table."""
    import triton
    import triton.language as tl

    @triton.jit
    def table_counts_kernel(paths_ptr, mu_ptr, t_ptr, t2_ptr, out_ptr,
                            var_ptr, R, E, stride, n_rows,
                            M: tl.constexpr, HAS_T2: tl.constexpr,
                            BLOCK_R: tl.constexpr, BLOCK_E: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        rmask = rows < R
        rows64 = rows.to(tl.int64)
        trow = ((rows64 // stride) % n_rows) * E
        acc = tl.zeros([BLOCK_R], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_R], dtype=tl.float32)
        for e0 in range(0, E, BLOCK_E):
            cols = e0 + tl.arange(0, BLOCK_E)
            emask = cols < E
            L = tl.zeros([BLOCK_R, BLOCK_E], dtype=tl.float32)
            for m in tl.static_range(M):
                p = tl.load(paths_ptr + rows64 * M + m, mask=rmask, other=0.0)
                mu = tl.load(mu_ptr + m * E + cols, mask=emask, other=0.0)
                L += p[:, None] * mu[None, :]
            att = tl.exp(tl.minimum(tl.maximum(-L, -700.0), 2.0))
            tmask = rmask[:, None] & emask[None, :]
            toff = trow[:, None] + cols[None, :]
            t = tl.load(t_ptr + toff, mask=tmask, other=0.0)
            acc += tl.sum(att * t, axis=1)
            if HAS_T2:
                t2 = tl.load(t2_ptr + toff, mask=tmask, other=0.0)
                acc2 += tl.sum(att * t2, axis=1)
        tl.store(out_ptr + rows64, acc, mask=rmask)
        if HAS_T2:
            tl.store(var_ptr + rows64, acc2, mask=rmask)

    return table_counts_kernel


@functools.lru_cache(maxsize=1)
def _bins_counts_kernel():
    """K34, compiled on first use like K28: K2's fused pass with M fluence
    columns accumulated side by side."""
    import triton
    import triton.language as tl

    @triton.jit
    def bins_counts_kernel(paths_ptr, mu_ptr, i0_ptr, out_ptr, R, E, NB,
                           M: tl.constexpr, NBP: tl.constexpr,
                           BLOCK_R: tl.constexpr, BLOCK_E: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        rmask = rows < R
        rows64 = rows.to(tl.int64)
        bins = tl.arange(0, NBP)
        bmask = bins < NB
        acc = tl.zeros([BLOCK_R, NBP], dtype=tl.float32)
        for e0 in range(0, E, BLOCK_E):
            cols = e0 + tl.arange(0, BLOCK_E)
            emask = cols < E
            L = tl.zeros([BLOCK_R, BLOCK_E], dtype=tl.float32)
            for m in tl.static_range(M):
                p = tl.load(paths_ptr + rows64 * M + m, mask=rmask, other=0.0)
                mu = tl.load(mu_ptr + m * E + cols, mask=emask, other=0.0)
                L += p[:, None] * mu[None, :]
            att = tl.exp(tl.minimum(tl.maximum(-L, -700.0), 2.0))
            # the [BLOCK_E, NBP] block of the [E, NB] fluence table
            i0 = tl.load(i0_ptr + cols[:, None] * NB + bins[None, :],
                         mask=emask[:, None] & bmask[None, :], other=0.0)
            acc = tl.dot(att, i0, acc, input_precision="ieee")
        out = out_ptr + rows64[:, None] * NB + bins[None, :]
        tl.store(out, acc, mask=rmask[:, None] & bmask[None, :])

    return bins_counts_kernel


# K34's tiles (tuned on the H100 at 8e5 rays, 8 materials, 140 energies
# and 4 or 6 bins); the bins pad to tl.dot's least width, 16
_B_BLOCK_R = 128
_B_BLOCK_E = 16
_B_WARPS = 4
# K28 holds a third [BLOCK_R, BLOCK_E] tile (the gathered table; a fourth
# with the second table), so it takes narrower energy chunks than K2: on
# the H100 at the reference protocol BLOCK_E 64 took 2.48 ms per spectrum,
# 32 0.34 ms and 16 0.22 ms (chip_smoke's tuning record in PERF.md)
_T_BLOCK_R = 128
_T_BLOCK_E = 16
_T_WARPS = 4


def _counts_cuda(paths, mu_table, i0_eff, i2_eff):
    dev = paths.device
    f32 = torch.float32
    m = paths.shape[-1]
    p2 = kernels.require(paths.reshape(-1, m).to(f32).contiguous(), "paths",
                         dev, f32)
    mu = kernels.require(mu_table.to(device=dev, dtype=f32).contiguous(),
                         "mu_table", dev, f32)
    e = mu.shape[1]
    if mu.shape[0] != m:
        raise ValueError(f"mu_table has {mu.shape[0]} materials, paths {m}")
    i0 = i0_eff.to(device=dev, dtype=f32).contiguous()
    if i0.shape != (e,):
        raise ValueError(f"i0_eff must have shape ({e},), got "
                         f"{tuple(i0.shape)}")
    i0 = kernels.require(i0, "i0_eff", dev, f32)
    r = p2.shape[0]
    out = torch.empty(r, dtype=f32, device=dev)
    has_i2 = i2_eff is not None
    i2 = var = None
    if has_i2:
        i2 = i2_eff.to(device=dev, dtype=f32).contiguous()
        if i2.shape != (e,):
            raise ValueError("i2_eff must match i0_eff's shape")
        i2 = kernels.require(i2, "i2_eff", dev, f32)
        var = torch.empty_like(out)
    rc = kernels.library().dexct_spectral_counts(
        p2.data_ptr(), mu.data_ptr(), i0.data_ptr(),
        i2.data_ptr() if has_i2 else None, out.data_ptr(),
        var.data_ptr() if has_i2 else None, r, m, e,
        kernels.stream_ptr(dev))
    kernels.check(rc, "spectral_counts")
    counts_from_paths.launches += 1
    shape = paths.shape[:-1]
    if has_i2:
        return out.reshape(shape), var.reshape(shape)
    return out.reshape(shape)


def _table_counts_cuda(paths, mu_table, table, table2, stride):
    dev = paths.device
    m = paths.shape[-1]
    p2 = paths.reshape(-1, m).to(torch.float32).contiguous()
    mu = mu_table.to(device=dev, dtype=torch.float32).contiguous()
    e = mu.shape[1]
    if mu.shape[0] != m:
        raise ValueError(f"mu_table has {mu.shape[0]} materials, paths {m}")
    t = table.to(device=dev, dtype=torch.float32).contiguous()
    if t.ndim != 2 or t.shape[1] != e:
        raise ValueError(f"the fluence table must be [n_rows, {e}], got "
                         f"{tuple(t.shape)}")
    r = p2.shape[0]
    out = torch.empty(r, dtype=torch.float32, device=dev)
    has_t2 = table2 is not None
    if has_t2:
        t2 = table2.to(device=dev, dtype=torch.float32).contiguous()
        if t2.shape != t.shape:
            raise ValueError("the second table must match the first's shape")
        var = torch.empty_like(out)
    else:
        t2, var = t, out  # unused by the kernel
    grid = (max(-(-r // _T_BLOCK_R), 1),)
    with torch.cuda.device(dev):
        _table_counts_kernel()[grid](p2, mu, t, t2, out, var, r, e,
                                     int(stride), t.shape[0], M=m,
                                     HAS_T2=has_t2, BLOCK_R=_T_BLOCK_R,
                                     BLOCK_E=_T_BLOCK_E, num_warps=_T_WARPS)
    counts_from_table.launches += 1
    shape = paths.shape[:-1]
    if has_t2:
        return out.reshape(shape), var.reshape(shape)
    return out.reshape(shape)


def _bins_counts_cuda(paths, mu_table, i0_bins):
    dev = paths.device
    m = paths.shape[-1]
    p2 = paths.reshape(-1, m).to(torch.float32).contiguous()
    mu = mu_table.to(device=dev, dtype=torch.float32).contiguous()
    e = mu.shape[1]
    if mu.shape[0] != m:
        raise ValueError(f"mu_table has {mu.shape[0]} materials, paths {m}")
    i0 = i0_bins.to(device=dev, dtype=torch.float32).contiguous()
    if i0.ndim != 2 or i0.shape[0] != e:
        raise ValueError(f"the fluence table must be [{e}, M], got "
                         f"{tuple(i0.shape)}")
    nb = i0.shape[1]
    r = p2.shape[0]
    out = torch.empty((r, nb), dtype=torch.float32, device=dev)
    grid = (max(-(-r // _B_BLOCK_R), 1),)
    with torch.cuda.device(dev):
        _bins_counts_kernel()[grid](
            p2, mu, i0, out, r, e, nb, M=m,
            NBP=max(1 << (max(nb, 1) - 1).bit_length(), 16),
            BLOCK_R=_B_BLOCK_R, BLOCK_E=_B_BLOCK_E, num_warps=_B_WARPS)
    counts_from_paths_multibin.launches += 1
    return out.reshape(paths.shape[:-1] + (nb,))


def counts_from_paths_multibin(paths, mu_table, i0_bins):
    """Detected counts of M photon-counting bins per ray.

    paths:    [..., n_mats] material path lengths [cm]
    mu_table: [n_mats, E] linear attenuation [1/cm]
    i0_bins:  [E, M] effective fluence of each bin (the multi-bin
              pipelines' stacked table, ``pcd_bin_fluences(...).T``)
    Returns counts ``[..., M]``, one attenuation ``exp(-L)`` per (ray,
    energy) shared by the bins.

    CUDA tensors run kernel K34 (counted in
    ``counts_from_paths_multibin.launches``); CPU tensors run
    :func:`counts_from_paths_plain`, whose ``atten @ i0`` takes the [E, M]
    table as it is.
    """
    if paths.is_cuda:
        return _bins_counts_cuda(paths, mu_table, i0_bins)
    if paths.device.type != "cpu":
        raise ValueError(f"unsupported device {paths.device}")
    if i0_bins.ndim != 2 or i0_bins.shape[0] != mu_table.shape[-1]:
        raise ValueError(f"the fluence table must be [{mu_table.shape[-1]}, "
                         f"M], got {tuple(i0_bins.shape)}")
    return counts_from_paths_plain(paths, mu_table, i0_bins)


counts_from_paths_multibin.launches = 0


def counts_from_table(paths, mu_table, table, table2=None, *, stride=1):
    """Detected signal per ray with a fluence table of rows.

    paths:    [..., n_mats] material path lengths [cm]; rays are counted
              in the row-major order of ``paths[..., 0]``
    mu_table: [n_mats, E] linear attenuation [1/cm]
    table:    [n_rows, E] effective fluence; ray ``r`` reads row
              ``(r // stride) % n_rows`` (a bowtie's per-channel table
              against [..., V, C] rays: stride 1; an anode heel's per-row
              table against [V, R, C] rays: stride C)
    table2:   optional second table of the same shape (the compound-noise
              second moment), contracted in the same pass.
    Returns counts ``[...]``, or ``(counts, var)`` when ``table2`` is given.

    CUDA tensors run kernel K28 (counted in ``counts_from_table.launches``);
    CPU tensors run :func:`counts_from_table_plain`.
    """
    if paths.is_cuda:
        return _table_counts_cuda(paths, mu_table, table, table2, stride)
    if paths.device.type != "cpu":
        raise ValueError(f"unsupported device {paths.device}")
    counts = counts_from_table_plain(paths, mu_table, table, stride=stride)
    if table2 is None:
        return counts
    return counts, counts_from_table_plain(paths, mu_table, table2,
                                           stride=stride)


counts_from_table.launches = 0


def counts_from_paths(paths, mu_table, i0_eff, i2_eff=None, *,
                      per_channel=False):
    """Detected signal per ray.

    paths:    [..., n_mats] material path lengths [cm]
    mu_table: [n_mats, E] linear attenuation of each material [1/cm]
    i0_eff:   [E] effective fluence per bin — or, with
              ``per_channel=True``, a per-channel table [C, E] (bowtie
              filtration, ops/bowtie.py) against rays laid out
              [..., V, C] (kernel K28, :func:`counts_from_table`)
              — or a stacked [E, M] table of M photon-counting bins
              (kernel K34, :func:`counts_from_paths_multibin`), which
              returns ``[..., M]``
    i2_eff:   optional second table of ``i0_eff``'s shape (compound-noise
              second moment) contracted against the same attenuation; not
              with an [E, M] table (PCD bins are Poisson).
    Returns counts ``[...]``, or ``(counts, var)`` when ``i2_eff`` is given.

    CUDA tensors run kernel K2 (counted in ``counts_from_paths.launches``);
    CPU tensors run :func:`counts_from_paths_plain`.
    """
    if per_channel:
        if i0_eff.ndim != 2:
            raise ValueError("per_channel=True requires a [C, E] i0 table")
        if paths.ndim < 2 or i0_eff.shape[0] != paths.shape[-2]:
            raise ValueError(f"a [C, E] table with C = {i0_eff.shape[0]} "
                             f"needs rays [..., V, C], got paths "
                             f"{tuple(paths.shape)}")
        return counts_from_table(paths, mu_table, i0_eff, i2_eff, stride=1)
    if i0_eff.ndim == 2:
        if i2_eff is not None:
            raise ValueError("a second-moment table goes with a [E] "
                             "fluence, not a stacked [E, M] bin table")
        return counts_from_paths_multibin(paths, mu_table, i0_eff)
    if paths.is_cuda:
        return _counts_cuda(paths, mu_table, i0_eff, i2_eff)
    if paths.device.type != "cpu":
        raise ValueError(f"unsupported device {paths.device}")
    counts = counts_from_paths_plain(paths, mu_table, i0_eff)
    if i2_eff is None:
        return counts
    return counts, counts_from_paths_plain(paths, mu_table, i2_eff)


counts_from_paths.launches = 0


def log_sinogram(counts, air_counts):
    """Log-normalized line-integral sinogram: -ln(counts / air).  A
    Python or NumPy scalar ``air_counts`` divides as a 0-d tensor of the
    counts' dtype on their device: on CUDA, PyTorch divides by a Python
    scalar as a product with its reciprocal, which rounds differently.
    The tensor is filled on the device (``torch.full``), not copied from
    the host, which would synchronise the stream."""
    c = torch.clamp_min(counts, 1e-30)
    if not isinstance(air_counts, torch.Tensor):
        air_counts = torch.full((), float(air_counts), dtype=c.dtype,
                                device=c.device)
    return -torch.log(c / air_counts)


def sample_noise(generator, counts, mode="poisson", var_scale=1.0, var=None):
    """Seedable detector-noise stage, drawing from ``generator`` (a
    ``torch.Generator`` on the device of ``counts``).

    mode='poisson': Poisson counting statistics (Gaussian limit above 1e5).
    mode='gaussian': Normal with variance ``var_scale * counts``.
    mode='compound': Normal with an explicit per-ray ``var`` array — the
        EID model (pair with :func:`second_moment_fluence`).
    mode='none': pass-through.
    """
    if mode == "none":
        return counts

    def normal():
        return torch.randn(counts.shape, generator=generator,
                           dtype=counts.dtype, device=counts.device)

    if mode == "compound":
        if var is None:
            raise ValueError("compound mode requires a per-ray var array")
        sigma = torch.sqrt(torch.clamp_min(var, 0.0))
        return torch.clamp_min(counts + sigma * normal(), 0.0)
    if mode == "poisson":
        # the discrete sampler is pointless at large rates: EID signals
        # are energy-weighted and reach ~1e10 per ray
        big = counts > 1e5
        small = torch.poisson(torch.where(big, 0.0, counts),
                              generator=generator)
        gauss = counts + torch.sqrt(torch.clamp_min(counts, 0.0)) * normal()
        return torch.where(big, torch.clamp_min(gauss, 0.0), small)
    if mode == "gaussian":
        sigma = torch.sqrt(torch.clamp_min(counts * var_scale, 0.0))
        return counts + sigma * normal()
    raise ValueError(f"unknown noise mode {mode!r}")


def forward_counts(paths, phantom, spec, geometry, *, noise="none",
                   generator=None, dtype=None, bowtie=None, tcm=None,
                   sigma_e=0.0):
    """paths -> (counts, log_sino): the get_sino back half, on the device
    of ``paths``, in float32 (``dtype`` must be float32 or None).

    With a ``bowtie`` (ops/bowtie.py) the fluence and the air
    normalization become per channel (kernel K28).  With ``tcm`` (a
    per-view relative output profile [V], pipeline/tcm.py) counts and the
    compound-noise second moment scale by ``s(v)`` and the log divides by
    the per-view air level, so the noiseless log sinogram is the
    unmodulated scan's.  ``sigma_e`` (compound mode) adds the electronic
    noise floor: ``var + sigma_e**2``.  One pass of K2 (or K28) gives the
    counts and, in compound mode, the second moment together.
    """
    check_float32(dtype)
    dev = paths.device
    mu_table = upload(phantom.materials.mu_table(spec.E), dev,
                      torch.float32)
    compound = noise == "compound"
    if bowtie is not None:
        from .bowtie import bowtie_fluence, bowtie_second_moment

        i0_h = bowtie_fluence(spec, geometry, bowtie)  # [C, E]
        air = upload(i0_h.sum(-1), dev, torch.float32)
        i2_h = bowtie_second_moment(spec, geometry, bowtie) \
            if compound else None
    else:
        i0_h = effective_fluence(spec, geometry)
        air = float(np.sum(i0_h))
        i2_h = second_moment_fluence(spec, geometry) if compound else None
    i0 = upload(i0_h, dev, torch.float32)
    paths = paths.to(torch.float32)
    var = None
    if compound:
        i2 = upload(i2_h, dev, torch.float32)
        counts, var = counts_from_paths(paths, mu_table, i0, i2,
                                        per_channel=bowtie is not None)
    else:
        counts = counts_from_paths(paths, mu_table, i0,
                                   per_channel=bowtie is not None)
    if tcm is not None:
        # per-view tube-current modulation, broadcast over the trailing
        # channel (and row) axes
        s = upload(tcm, dev, torch.float32)
        s = s.reshape(tuple(s.shape) + (1,) * (counts.ndim - 1))
        counts = counts * s
        air = air * s
        if var is not None:
            var = var * s
    if noise != "none":
        if generator is None:
            raise ValueError("noise sampling requires a torch.Generator")
        if var is not None and sigma_e:
            var = var + _scalar(sigma_e, var) ** 2
        counts = sample_noise(generator, counts, noise, var=var)
    return counts, log_sinogram(counts, air)
