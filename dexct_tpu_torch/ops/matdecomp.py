"""Gauss-Newton basis material decomposition.

Port of :mod:`dexct_tpu.ops.matdecomp` for the two-spectra, two-material
case of the main path (Rigie & La Riviere 2015).  Per sinogram pixel with
measured counts y_m the solver drives

    nu_m(a) = sum_E i0_m(E) exp(-(a_1 mu_1(E) + a_2 mu_2(E)))

to y_m by Newton steps on the log residuals ln y_m - ln nu_m, with a
closed-form 2x2 solve, a trust region and bounds; for M == K the log
residual and the Poisson likelihood share the root.

:func:`gauss_newton_solve` builds the energy tables once, then dispatches
on the device of its tensors: CUDA tensors go to the hand-written kernel K3
(``csrc/gauss_newton.cu``, one thread per pixel, all iterations in
registers), CPU tensors to :func:`gauss_newton_solve_plain`, the JAX
package's ``_solve_block`` in torch, bfloat16 warm phase included.

:func:`gauss_newton_solve_grouped` solves pixels that fall into fluence
groups, each with its own ``i0`` (a bowtie's thickness levels, an anode
heel's detector rows): kernel K29 (``csrc/gauss_newton.cu``, K3's
per-pixel body over pixels sorted into group order, each group padded to a
whole block) on CUDA tensors, :func:`gauss_newton_solve_grouped_plain`
(:func:`gauss_newton_solve_plain` once per group) on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import xcom
from ..physics.materials import BONE, TISSUE
from ..utils import kernels

__all__ = [
    "gauss_newton_solve",
    "gauss_newton_solve_plain",
    "gauss_newton_solve_grouped",
    "gauss_newton_solve_grouped_plain",
    "prepare_decomposition",
    "detectable_bins",
    "decompose_sinograms",
    "air_mask",
    "DEFAULT_BASIS",
]

DEFAULT_BASIS = (TISSUE, BONE)  # matdecomp.py:12-17
_CLIP = 80.0  # float32 exp-argument clip (exp overflows at ~88)


def _solve_spd(H, dF):
    """Closed-form solve of the symmetric 2x2 systems H [B, 3] (upper
    triangle 00, 01, 11), dF [B, 2], normalised per pixel by max|H|; a
    pixel whose H underflowed entirely takes a zero step."""
    m_raw = H.abs().amax(-1, keepdim=True)
    dead = m_raw < 1e-30
    m = torch.where(dead, torch.ones_like(m_raw), m_raw)
    H = H / m
    dF = torch.where(dead, torch.zeros_like(dF), dF / m)
    H00, H01, H11 = H[:, 0], H[:, 1], H[:, 2]
    det = H00 * H11 - H01 * H01
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    d0 = (H11 * dF[:, 0] - H01 * dF[:, 1]) / det
    d1 = (H00 * dF[:, 1] - H01 * dF[:, 0]) / det
    return torch.stack([d0, d1], -1)


def _bf16_products(a, musT):
    """bfloat16 ``a @ musT.T`` for a [B, 2], musT [E, 2], rounded as the
    JAX warm phase's ``jnp.matmul`` of bfloat16 operands rounds it: each
    product of two bfloat16 values is exact in float32, the two are summed
    in float32 and the sum is rounded once to bfloat16.  Written out, so
    that no CPU bfloat16 GEMM backend picks the rounding."""
    a32 = a.to(torch.bfloat16).float()
    m32 = musT.to(torch.bfloat16).float()
    return (a32[:, :1] * m32[:, 0] + a32[:, 1:] * m32[:, 1]).to(
        torch.bfloat16)


def _moments_plain(a, musT, w, bf16):
    """[B, 6] = (nu_0, nu_1, g_00, g_01, g_10, g_11) at iterate a [B, 2].

    ``bf16`` reproduces the JAX warm phase: iterate, tables, exponent and
    attenuation in bfloat16, products summed in float32.  The float32
    exponent is the two products summed in order, and the exp and the sums
    over energies are taken in float64 and rounded once, so that neither
    the CPU's BLAS nor its vector-math library (both pick their kernels by
    the host's instruction set) sets the rounding."""
    if bf16:
        L = _bf16_products(a, musT)
        atten = torch.exp(torch.clamp(-L, -_CLIP, 20.0))
        return (atten.double() @ w.to(torch.bfloat16).double()).float()
    L = a[:, :1] * musT[:, 0] + a[:, 1:] * musT[:, 1]
    atten = torch.exp(torch.clamp(-L, -_CLIP, 20.0).double())
    return (atten @ w.double()).float()


def _in_f64(fn, x):
    """``fn`` of float32 ``x`` taken in float64 and rounded once (the
    CPU's float32 log and sqrt round by the host's instruction set)."""
    return fn(x.double()).float()


def _log_step(a, ngh, log_y, smax, lo, hi):
    nu, g = ngh[:, :2], ngh[:, 2:].reshape(-1, 2, 2)
    nu_safe = torch.clamp_min(nu, 1e-35)
    J = g / nu_safe[..., None]  # [B, M, K]
    # photon-starved pixels would send the residual to -inf
    r = torch.clamp(log_y - _in_f64(torch.log, nu_safe), -30.0, 30.0)
    dF = (r[..., None] * J).sum(1)
    H = torch.stack([(J[:, :, 0] * J[:, :, 0]).sum(1),
                     (J[:, :, 0] * J[:, :, 1]).sum(1),
                     (J[:, :, 1] * J[:, :, 1]).sum(1)], -1)
    step = _solve_spd(H, dF)
    norm = _in_f64(torch.sqrt, (step * step).sum(-1, keepdim=True))
    step = step * torch.clamp_max(
        torch.full_like(norm, smax) / torch.clamp_min(norm, 1e-30), 1.0)
    return torch.clamp(a - step, lo, hi)


def _solve_block_plain(y, full, warm, n_warm, n_pol, warm_bf16, eps_init,
                       step_max, a_lo, a_hi):
    """Newton iterations for one pixel block, y [B, 2] normalised counts.

    ``full`` and ``warm`` are (musT [E, 2], w [E, 6]) tables: the union
    grid for the float32 polish and the warm-phase table.  Returns a
    [B, 2]."""
    a = torch.full_like(y, eps_init)
    log_y = _in_f64(torch.log, torch.clamp_min(y, 1e-35))
    lo = max(a_lo, -1.0)  # the log step clamps negative overshoot hard
    smax = 10.0 * step_max  # ... and has the loose trust radius
    for _ in range(n_warm):
        a = _log_step(a, _moments_plain(a, *warm, warm_bf16), log_y, smax,
                      lo, a_hi)
    for _ in range(n_pol):
        a = _log_step(a, _moments_plain(a, *full, False), log_y, smax, lo,
                      a_hi)
    return a


def _tables(i0n, mus, n_iters, polish_iters, warm_nodes):
    """Energy tables (musT [..., E, 2], w [..., E, 6]) for the polish and
    the warm phase, for ``i0n`` [..., 2, E] (a leading axis of fluence
    groups is kept); the warm table is moment-compressed to ~warm_nodes
    nodes when the union grid has more than 2 * warm_nodes bins (per
    segment of equal bin count the per-spectrum fluence sums exactly and
    the node attenuation is the combined-fluence-weighted mean)."""
    n_meas, E = i0n.shape[-2:]
    n_mats = mus.shape[-2]

    def weights(i0_, mu_):
        grad_w = torch.stack([i0_[..., m, :] * mu_[..., i, :]
                              for m in range(n_meas)
                              for i in range(n_mats)], -1)
        return (mu_.transpose(-1, -2).contiguous(),
                torch.cat([i0_.transpose(-1, -2), grad_w], -1))

    full = weights(i0n, mus.expand(i0n.shape[:-2] + mus.shape))
    if (warm_nodes and polish_iters > 0 and n_iters > polish_iters
            and E > 2 * warm_nodes):
        seg = -(-E // int(warm_nodes))
        kc = -(-E // seg)
        pad_e = kc * seg - E
        lead = i0n.shape[:-2]
        i0p = torch.nn.functional.pad(i0n, (0, pad_e))
        musp = torch.cat([mus, mus[:, -1:].expand(n_mats, pad_e)], 1)
        wgt = i0p.sum(-2).reshape(lead + (kc, seg)) + 1e-30  # combined
        i0_c = i0p.reshape(lead + (n_meas, kc, seg)).sum(-1)  # exact 0th
        mu_c = (musp.reshape(n_mats, kc, seg) * wgt[..., None, :, :]).sum(
            -1) / wgt.sum(-1)[..., None, :]
        return full, weights(i0_c, mu_c)
    return full, full


def _schedule(n_meas, n_mats, n_iters, polish_iters):
    """Checks and the phase lengths: (n_warm, n_pol, warm_bf16); the warm
    phase runs in bfloat16 whenever a float32 polish follows."""
    if n_mats > n_meas:
        raise ValueError(f"{n_mats} materials need at least that many "
                         f"measurements (got {n_meas})")
    if (n_meas, n_mats) != (2, 2):
        raise NotImplementedError(
            f"gauss_newton_solve with {n_meas} measurements and {n_mats} "
            "materials is not ported yet (ROADMAP queue 1, item 11: "
            "multi-bin spectral decomposition)")
    n_pol = min(polish_iters, n_iters)
    return n_iters - n_pol, n_pol, n_pol > 0


def _prepare(counts, i0, mus, n_iters, polish_iters, warm_nodes):
    """Checks, float32 casts, the common normalisation and the energy
    tables shared by the kernel and the plain version."""
    n_warm, n_pol, warm_bf16 = _schedule(counts.shape[0], mus.shape[0],
                                         n_iters, polish_iters)
    dev = counts.device
    counts = counts.to(torch.float32)
    i0 = i0.to(device=dev, dtype=torch.float32)
    mus = mus.to(device=dev, dtype=torch.float32)
    # common normalization keeps float32 in range; the Newton step is
    # invariant to a joint rescale of (y, i0)
    scale = torch.clamp_min(i0.max(), 1e-30)
    full, warm = _tables(i0 / scale, mus, n_iters, polish_iters, warm_nodes)
    return counts, scale, full, warm, n_warm, n_pol, warm_bf16


def gauss_newton_solve_plain(counts, i0, mus, *, n_iters=30, eps_init=1e-6,
                             pixel_block=65536, step_max=5.0,
                             a_bounds=(-20.0, 500.0), polish_iters=4,
                             warm_nodes=32):
    """The plain PyTorch version of :func:`gauss_newton_solve` on any
    device: ``_solve_block`` of the JAX package over blocks of
    ``pixel_block`` pixels."""
    counts, scale, full, warm, n_warm, n_pol, warm_bf16 = _prepare(
        counts, i0, mus, n_iters, polish_iters, warm_nodes)
    yn = (counts / scale).T
    block = max(min(pixel_block, yn.shape[0]), 1)
    out = [_solve_block_plain(yn[s:s + block], full, warm, n_warm, n_pol,
                              warm_bf16, eps_init, step_max, *a_bounds)
           for s in range(0, yn.shape[0], block)]
    return torch.cat(out) if out else yn.new_zeros((0, 2))


def gauss_newton_solve(counts, i0, mus, *, n_iters=30, eps_init=1e-6,
                       pixel_block=65536, step_max=5.0,
                       a_bounds=(-20.0, 500.0), polish_iters=4,
                       warm_nodes=32):
    """Vectorized two-material Newton solve over all sinogram pixels.

    counts: [2, P] detected counts; i0: [2, E] effective fluence per
    energy bin; mus: [2, E] basis mass attenuation [cm^2/g].  Returns
    a: [P, 2] area densities [g/cm^2], float32.

    Schedule of the JAX package's ``gauss_newton_solve`` for M == K:
    ``n_iters - polish_iters`` log-residual warm steps (bfloat16, on a
    ``warm_nodes``-node compressed table) then ``polish_iters`` float32
    log-residual steps on the full table.  CUDA tensors run kernel K3
    (counted in ``gauss_newton_solve.launches``); CPU tensors run
    :func:`gauss_newton_solve_plain`.
    """
    kw = dict(n_iters=n_iters, eps_init=eps_init, pixel_block=pixel_block,
              step_max=step_max, a_bounds=a_bounds,
              polish_iters=polish_iters, warm_nodes=warm_nodes)
    if counts.is_cuda:
        return _gauss_newton_cuda(counts, i0, mus, **kw)
    if counts.device.type != "cpu":
        raise ValueError(f"unsupported device {counts.device}")
    return gauss_newton_solve_plain(counts, i0, mus, **kw)


def _gauss_newton_cuda(counts, i0, mus, *, n_iters, eps_init, pixel_block,
                       step_max, a_bounds, polish_iters, warm_nodes):
    counts, scale, full, warm, n_warm, n_pol, warm_bf16 = _prepare(
        counts, i0, mus, n_iters, polish_iters, warm_nodes)
    dev = counts.device
    counts = counts.contiguous()
    P = counts.shape[1]
    rows = [torch.cat(full, 1), torch.cat(warm, 1)]  # [E, 8] rows
    if warm_bf16:  # the warm table as the bf16 warm phase sees it
        rows[1] = rows[1].to(torch.bfloat16).float()
    tables = torch.cat([r.reshape(-1) for r in rows]).contiguous()
    out = torch.empty((P, 2), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_gauss_newton(
        counts.data_ptr(), tables.data_ptr(), out.data_ptr(), P,
        full[0].shape[0], warm[0].shape[0], n_warm, n_pol, int(warm_bf16),
        float(scale), float(a_bounds[0]), float(a_bounds[1]),
        float(step_max), float(eps_init), _CLIP, kernels.stream_ptr(dev))
    kernels.check(rc, "gauss_newton")
    gauss_newton_solve.launches += 1
    return out


gauss_newton_solve.launches = 0

_GROUP_BLOCK = 128  # K29's threads per block; each group pads to a multiple


def gauss_newton_solve_grouped_plain(counts, group, i0_groups, mus,
                                     **kw):
    """The plain version of :func:`gauss_newton_solve_grouped`:
    :func:`gauss_newton_solve_plain` once per group on that group's own
    ``i0`` (its own scale, full and warm tables), which is what the JAX
    package's ``jax.vmap(gauss_newton_solve)`` over the groups computes
    for each real pixel."""
    out = counts.new_empty((counts.shape[1], 2), dtype=torch.float32)
    for g in range(i0_groups.shape[0]):
        sel = torch.nonzero(group == g).reshape(-1)
        if sel.numel():
            out[sel] = gauss_newton_solve_plain(counts[:, sel], i0_groups[g],
                                                mus, **kw)
    return out


def group_layout(group, n_groups, block=_GROUP_BLOCK):
    """K29's pixel layout, on the device of ``group`` [P]: ``(src [P_pad],
    slot [P], block_group [P_pad // block])``.  Pixels sorted into group
    order (stable), each group padded to a whole ``block`` with copies of
    its first pixel: slot ``i`` of the padded layout solves pixel
    ``src[i]``, pixel ``p``'s result lands in slot ``slot[p]``, and block
    ``b`` belongs to group ``block_group[b]``."""
    dev = group.device
    group = group.to(torch.int64)
    order = torch.argsort(group, stable=True)
    n_g = torch.bincount(group, minlength=n_groups)
    blocks_g = torch.div(n_g + block - 1, block, rounding_mode="floor")
    start = torch.cumsum(n_g, 0) - n_g  # first sorted index of each group
    pad_start = (torch.cumsum(blocks_g, 0) - blocks_g) * block
    n_pad = int(blocks_g.sum()) * block
    sorted_g = group[order]
    pos = pad_start[sorted_g] + torch.arange(order.numel(), device=dev) \
        - start[sorted_g]
    block_group = torch.repeat_interleave(
        torch.arange(n_groups, device=dev), blocks_g)
    # padding repeats the group's first pixel (a real, solvable ray)
    first = order[torch.clamp_max(start, max(order.numel() - 1, 0))]
    src = torch.repeat_interleave(first, blocks_g * block)
    src[pos] = order
    slot = torch.empty_like(order)
    slot[order] = pos
    return src, slot, block_group.to(torch.int32)


def gauss_newton_solve_grouped(counts, group, i0_groups, mus, *,
                               n_iters=30, eps_init=1e-6, pixel_block=65536,
                               step_max=5.0, a_bounds=(-20.0, 500.0),
                               polish_iters=4, warm_nodes=32):
    """Two-material Newton solve of pixels in fluence groups.

    counts: [2, P] detected counts; group: [P] integer group of each
    pixel, in ``[0, G)``; i0_groups: [G, 2, E] effective fluence of each
    group; mus: [2, E] basis mass attenuation.  Returns a: [P, 2] area
    densities [g/cm^2], each pixel solved exactly as
    :func:`gauss_newton_solve` solves it with its group's ``i0``.

    CUDA tensors run kernel K29 (counted in
    ``gauss_newton_solve_grouped.launches``); CPU tensors run
    :func:`gauss_newton_solve_grouped_plain`.
    """
    kw = dict(n_iters=n_iters, eps_init=eps_init, pixel_block=pixel_block,
              step_max=step_max, a_bounds=a_bounds,
              polish_iters=polish_iters, warm_nodes=warm_nodes)
    if group.shape != counts.shape[1:]:
        raise ValueError(f"group must have shape ({counts.shape[1]},), got "
                         f"{tuple(group.shape)}")
    if counts.is_cuda:
        return _gauss_newton_grouped_cuda(counts, group, i0_groups, mus,
                                          **kw)
    if counts.device.type != "cpu":
        raise ValueError(f"unsupported device {counts.device}")
    return gauss_newton_solve_grouped_plain(counts, group, i0_groups, mus,
                                            **kw)


def _gauss_newton_grouped_cuda(counts, group, i0_groups, mus, *, n_iters,
                               eps_init, pixel_block, step_max, a_bounds,
                               polish_iters, warm_nodes):
    del pixel_block  # one launch covers every pixel
    dev = counts.device
    G = i0_groups.shape[0]
    n_warm, n_pol, warm_bf16 = _schedule(counts.shape[0], mus.shape[0],
                                         n_iters, polish_iters)
    # every group's tables at once: _prepare's per group, batched
    i0_g = i0_groups.to(device=dev, dtype=torch.float32)
    mus = mus.to(device=dev, dtype=torch.float32)
    scales = torch.clamp_min(i0_g.amax((-2, -1)), 1e-30)  # [G]
    full, warm = _tables(i0_g / scales[:, None, None], mus, n_iters,
                         polish_iters, warm_nodes)
    rows = [torch.cat(full, -1), torch.cat(warm, -1)]  # [G, E, 8] rows
    if warm_bf16:  # the warm tables as the bf16 warm phase sees them
        rows[1] = rows[1].to(torch.bfloat16).float()
    e_full, e_warm = rows[0].shape[1], rows[1].shape[1]
    tables = torch.cat([r.reshape(G, -1) for r in rows], 1).contiguous()
    scales = scales.contiguous()
    src, slot, block_group = group_layout(group.to(dev), G)
    y = counts.to(torch.float32)[:, src].contiguous()
    n_pad = y.shape[1]
    out = torch.empty((n_pad, 2), dtype=torch.float32, device=dev)
    for t, name in ((y, "counts"), (block_group, "block_group"),
                    (scales, "scales"), (tables, "tables")):
        kernels.require(t, name, dev, t.dtype)
    rc = kernels.library().dexct_gauss_newton_grouped(
        y.data_ptr(), block_group.data_ptr(), scales.data_ptr(),
        tables.data_ptr(), out.data_ptr(), n_pad, _GROUP_BLOCK, e_full,
        e_warm, n_warm, n_pol, int(warm_bf16), float(a_bounds[0]),
        float(a_bounds[1]), float(step_max), float(eps_init), _CLIP,
        kernels.stream_ptr(dev))
    kernels.check(rc, "gauss_newton_grouped")
    gauss_newton_solve_grouped.launches += 1
    return out[slot]


gauss_newton_solve_grouped.launches = 0


def prepare_decomposition(geometry, spec1, spec2, basis=DEFAULT_BASIS,
                          t_ref=1.0):
    """Union-energy-grid tables for the two-spectra solve (host, float64).

    Sorted union of the two spectra's energy grids; dE with first-bin =
    E[0]; detector response interpolated and EID-weighted; I0
    interpolated per spectrum; basis curves as MASS attenuation, so the
    outputs are g/cm^2 area densities (matdecomp.py:140-160); bins that no
    measured ray can see are pruned (:func:`detectable_bins`).

    Returns (ee [E], i0 [2, E], mus [2, E]).
    """
    ee = np.array(sorted(set(np.append(spec1.E, spec2.E))))
    dE = np.append([ee[0]], np.diff(ee))
    detresponse = geometry.detector_response(ee)
    i0 = np.stack([
        np.interp(ee, spec1.E, spec1.I0) * detresponse * dE,
        np.interp(ee, spec2.E, spec2.I0) * detresponse * dE,
    ])
    mus = np.stack([xcom.mixatten(m.matcomp, ee) for m in basis])
    keep = detectable_bins(i0, mus, t_ref=t_ref)
    return ee[keep], i0[:, keep], mus[:, keep]


def detectable_bins(i0, mus, t_ref=1.0, rel_floor=1e-12):
    """Mask of energy bins that can influence a measured (non-air) ray:
    bins whose photons cannot traverse ``t_ref`` g/cm^2 of the first basis
    material only reach air rays, which the decomposition masks, but they
    would dominate the a = 0 Jacobian."""
    i0 = np.asarray(i0, np.float64)
    mus = np.asarray(mus, np.float64)
    w = i0.sum(0) * np.exp(-np.clip(mus[0] * t_ref, 0.0, 700.0))
    keep = w > rel_floor * np.max(w)
    if not np.any(keep):  # degenerate table; keep everything
        return np.ones(i0.shape[1], bool)
    return keep


def air_mask(sino_raw, mask_thresh=0.95):
    """Air-ray mask: counts above ``mask_thresh`` times the maximum over
    the whole sinogram (matdecomp.py:194-196)."""
    return sino_raw >= mask_thresh * sino_raw.max()


def decompose_sinograms(geometry, sino1, sino2, spec1, spec2, *, n_iters=30,
                        mask_thresh=0.95, basis=DEFAULT_BASIS,
                        pixel_block=65536):
    """Counts sinogram pair -> basis material sinogram pair, on the device
    of ``sino1``.  Returns (mat1, mat2), each [N_proj, N_channels] in
    g/cm^2."""
    _, i0, mus = prepare_decomposition(geometry, spec1, spec2, basis)
    dev = sino1.device
    shape = sino1.shape
    counts = torch.stack([sino1.reshape(-1), sino2.reshape(-1)]).float()
    a = gauss_newton_solve(
        counts,
        torch.as_tensor(i0, dtype=torch.float32, device=dev),
        torch.as_tensor(mus, dtype=torch.float32, device=dev),
        n_iters=n_iters, pixel_block=pixel_block,
    )
    mask = air_mask(sino1, mask_thresh)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    mat1 = torch.where(mask, zero, a[:, 0].reshape(shape))
    mat2 = torch.where(mask, zero, a[:, 1].reshape(shape))
    return mat1, mat2
