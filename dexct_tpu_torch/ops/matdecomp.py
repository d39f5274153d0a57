"""Gauss-Newton basis material decomposition.

Port of :mod:`dexct_tpu.ops.matdecomp` (Rigie & La Riviere 2015).  Per
sinogram pixel with measured counts y_m (M measurements: two spectra, or
the bins of a photon-counting detector) the solver fits K in {2, 3, 4}
basis-material area densities a to

    nu_m(a) = sum_E i0_m(E) exp(-sum_k a_k mu_k(E))

by Newton steps, with closed-form 2x2, 3x3 and 4x4 adjugate solves, a
trust region and bounds.  The schedule is the JAX package's
``_solve_block``: ``n_iters - polish_iters`` warm steps (log-residual
steps with ``warm="log"`` and the Gauss-Newton method, else Poisson-MLE
steps; in bfloat16 whenever a float32 polish follows, on a
``warm_nodes``-node compressed table for the log warm phase), then
``polish_iters`` float32 steps on the full table (the log step when
M == K, else the Poisson-MLE Fisher-scoring step, or the full Newton
step with ``method="newton"``); ``lm_damping`` scales the Hessian's
diagonal.

:func:`gauss_newton_solve` builds the energy tables once, then dispatches
on the device of its tensors.  CUDA tensors of the two-spectra,
two-material log-warm Gauss-Newton solve go to the hand-written kernel K3
(``csrc/gauss_newton.cu``, four pixels a thread over each table row, all
iterations in registers); every other CUDA call goes to K35 (the same
file: one pixel a thread, float64 sums over a float64 copy of the table
staged in shared memory a phase's rows at a time, templated on K and on M
at the paths' shapes, else on a compile-time maximum of M,
:data:`MAX_BINS`).  CPU
tensors run :func:`gauss_newton_solve_plain`, the JAX package's
``_solve_block`` in torch, bfloat16 warm phase included.

:func:`gauss_newton_solve_grouped` solves pixels that fall into fluence
groups, each with its own ``i0`` (a bowtie's thickness levels, an anode
heel's detector rows): kernel K29 (``csrc/gauss_newton.cu``, K3's
per-pixel body at one pixel a thread over pixels sorted into group order,
each group padded to a whole block) on CUDA tensors, :func:`gauss_newton_solve_grouped_plain`
(:func:`gauss_newton_solve_plain` once per group) on CPU tensors.

The multi-bin helpers :func:`pcd_bin_fluences` and
:func:`decompose_multibin_grid` serve the spectral photon-counting
pipelines (:mod:`dexct_tpu_torch.pipeline.spectralct`);
:func:`image_domain_decomposition` is the per-pixel 2x2 product of the
image-domain method (plain torch, no kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import xcom
from ..physics.materials import BONE, TISSUE
from ..utils import kernels
from ..utils.devices import check_float32, device_of, upload

__all__ = [
    "gauss_newton_solve",
    "gauss_newton_solve_plain",
    "gauss_newton_solve_grouped",
    "gauss_newton_solve_grouped_plain",
    "pcd_bin_fluences",
    "decompose_multibin_grid",
    "prepare_decomposition",
    "detectable_bins",
    "decompose_sinograms",
    "air_mask",
    "DEFAULT_BASIS",
    "image_domain_decomposition",
    "MAX_BINS",
]

DEFAULT_BASIS = (TISSUE, BONE)  # matdecomp.py:12-17
_CLIP = 80.0  # float32 exp-argument clip (exp overflows at ~88)
# K35's compile-time maximum number of measurements (its per-pixel
# accumulators live in registers); the JAX tests use up to 6 bins
MAX_BINS = 8


def _tri_pairs(k):
    """Upper-triangle index pairs in row order, e.g. k=2 -> 00,01,11."""
    return [(i, j) for i in range(k) for j in range(i, k)]


def _osum(x, dim):
    """Sum over ``dim`` in index order, one rounding per addition (no
    reduction kernel picks the order)."""
    s = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        s = s + x.select(dim, k)
    return s


def _solve_spd(H, dF, n_mats):
    """Closed-form solve of the symmetric systems H [B, T] (upper triangle
    in row order), dF [B, K], normalised per pixel by max|H|; a pixel whose
    H underflowed entirely takes a zero step.  The adjugate expressions are
    the JAX package's, operation for operation."""
    m_raw = H.abs().amax(-1, keepdim=True)
    dead = m_raw < 1e-30
    m = torch.where(dead, torch.ones_like(m_raw), m_raw)
    H = H / m
    dF = torch.where(dead, torch.zeros_like(dF), dF / m)

    def safe(det):
        return torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30),
                           det)

    f = [dF[:, k] for k in range(n_mats)]
    if n_mats == 2:
        H00, H01, H11 = H[:, 0], H[:, 1], H[:, 2]
        det = safe(H00 * H11 - H01 * H01)
        d0 = (H11 * f[0] - H01 * f[1]) / det
        d1 = (H00 * f[1] - H01 * f[0]) / det
        return torch.stack([d0, d1], -1)
    if n_mats == 3:
        a, b, c, d, e, f_ = (H[:, k] for k in range(6))
        A00 = d * f_ - e * e
        A01 = c * e - b * f_
        A02 = b * e - c * d
        A11 = a * f_ - c * c
        A12 = b * c - a * e
        A22 = a * d - b * b
        det = safe(a * A00 + b * A01 + c * A02)
        x0 = (A00 * f[0] + A01 * f[1] + A02 * f[2]) / det
        x1 = (A01 * f[0] + A11 * f[1] + A12 * f[2]) / det
        x2 = (A02 * f[0] + A12 * f[1] + A22 * f[2]) / det
        return torch.stack([x0, x1, x2], -1)
    if n_mats == 4:
        a, b, c, d, e, f_, g, h, i, j = (H[:, k] for k in range(10))
        A00 = e * (h * j - i * i) - f_ * (f_ * j - g * i) \
            + g * (f_ * i - g * h)
        A01 = -(b * (h * j - i * i) - f_ * (c * j - i * d)
                + g * (c * i - h * d))
        A02 = b * (f_ * j - i * g) - e * (c * j - i * d) \
            + g * (c * g - f_ * d)
        A03 = -(b * (f_ * i - h * g) - e * (c * i - h * d)
                + f_ * (c * g - f_ * d))
        A11 = a * (h * j - i * i) - c * (c * j - i * d) \
            + d * (c * i - h * d)
        A12 = -(a * (f_ * j - i * g) - b * (c * j - i * d)
                + d * (c * g - f_ * d))
        A13 = a * (f_ * i - h * g) - b * (c * i - h * d) \
            + c * (c * g - f_ * d)
        A22 = a * (e * j - g * g) - b * (b * j - g * d) \
            + d * (b * g - e * d)
        A23 = -(a * (e * i - f_ * g) - b * (b * i - f_ * d)
                + c * (b * g - e * d))
        A33 = a * (e * h - f_ * f_) - b * (b * h - f_ * c) \
            + c * (b * f_ - e * c)
        det = safe(a * A00 + b * A01 + c * A02 + d * A03)
        x0 = (A00 * f[0] + A01 * f[1] + A02 * f[2] + A03 * f[3]) / det
        x1 = (A01 * f[0] + A11 * f[1] + A12 * f[2] + A13 * f[3]) / det
        x2 = (A02 * f[0] + A12 * f[1] + A22 * f[2] + A23 * f[3]) / det
        x3 = (A03 * f[0] + A13 * f[1] + A23 * f[2] + A33 * f[3]) / det
        return torch.stack([x0, x1, x2, x3], -1)
    raise NotImplementedError("closed-form solve supports 2-4 materials")


def _bf16_products(a, musT):
    """bfloat16 ``a @ musT.T`` for a [B, K], musT [E, K], rounded as the
    JAX warm phase's ``jnp.matmul`` of bfloat16 operands rounds it: each
    product of two bfloat16 values is exact in float32, the K are summed
    in float32 in order and the sum is rounded once to bfloat16.  Written
    out, so that no CPU bfloat16 GEMM backend picks the rounding."""
    a32 = a.to(torch.bfloat16).float()
    m32 = musT.to(torch.bfloat16).float()
    L = a32[:, :1] * m32[:, 0]
    for k in range(1, a.shape[1]):
        L = L + a32[:, k:k + 1] * m32[:, k]
    return L.to(torch.bfloat16)


def _moments_plain(a, musT, w, bf16):
    """``exp(-clip(a @ musT.T)) @ w`` at iterate a [B, K]: the columns of
    w [E, M + M K (+ M T)] give nu_m, g_mi (and the Hessian weights).

    ``bf16`` reproduces the JAX warm phase: iterate, tables, exponent and
    attenuation in bfloat16, products summed in float32.  The float32
    exponent is the K products summed in order, and the exp and the sums
    over energies are taken in float64 and rounded once, so that neither
    the CPU's BLAS nor its vector-math library (both pick their kernels by
    the host's instruction set) sets the rounding."""
    if bf16:
        L = _bf16_products(a, musT)
        atten = torch.exp(torch.clamp(-L, -_CLIP, 20.0))
        return (atten.double() @ w.to(torch.bfloat16).double()).float()
    L = a[:, :1] * musT[:, 0]
    for k in range(1, a.shape[1]):
        L = L + a[:, k:k + 1] * musT[:, k]
    atten = torch.exp(torch.clamp(-L, -_CLIP, 20.0).double())
    return (atten @ w.double()).float()


def _in_f64(fn, x):
    """``fn`` of float32 ``x`` taken in float64 and rounded once (the
    CPU's float32 log and sqrt round by the host's instruction set)."""
    return fn(x.double()).float()


def _log_system(ngh, log_y, n_meas, n_mats):
    """(H [B, T], dF [B, K]) of the Newton step on the log residuals
    r_m = ln y_m - ln nu_m with Jacobian J_mi = g_mi / nu_m, through the
    normal equations JtJ d = Jt r."""
    nu = ngh[:, :n_meas]
    g = ngh[:, n_meas:n_meas * (1 + n_mats)].reshape(-1, n_meas, n_mats)
    nu_safe = torch.clamp_min(nu, 1e-35)
    J = g / nu_safe[..., None]  # [B, M, K]
    # photon-starved pixels would send the residual to -inf
    r = torch.clamp(log_y - _in_f64(torch.log, nu_safe), -30.0, 30.0)
    dF = _osum(r[..., None] * J, 1)
    H = torch.stack([_osum(J[:, :, i] * J[:, :, j], 1)
                     for i, j in _tri_pairs(n_mats)], -1)
    return H, dF


def _mle_system(ngh, y, n_meas, n_mats, newton):
    """(H, dF) of the Poisson-MLE step: Fisher scoring H = sum_m y/nu^2 g
    g^T, or with ``newton`` the full Hessian -sum_m (r_m h_m - y/nu^2 g
    g^T); nu floored at 1e-17 (the float32 overflow boundary of y/nu^2)."""
    n_g = n_meas * n_mats
    tri = _tri_pairs(n_mats)
    nu = torch.clamp_min(ngh[:, :n_meas], 1e-17)
    g = ngh[:, n_meas:n_meas + n_g].reshape(-1, n_meas, n_mats)
    r = y / nu - 1.0
    yv2 = y / (nu * nu)
    dF = _osum(r[..., None] * g, 1)
    gg = torch.stack([g[:, :, i] * g[:, :, j] for i, j in tri], -1)
    if newton:
        h = ngh[:, n_meas + n_g:].reshape(-1, n_meas, len(tri))
        return -_osum(r[..., None] * h - yv2[..., None] * gg, 1), dF
    return _osum(yv2[..., None] * gg, 1), dF


def _newton_step(a, H, dF, lm_damping, smax, lo, hi):
    n_mats = a.shape[1]
    if lm_damping:
        # Levenberg-Marquardt diagonal scaling
        diag = np.cumsum([0] + [n_mats - i for i in range(n_mats)])[:n_mats]
        H = H.clone()
        H[:, diag] = H[:, diag] * (1.0 + lm_damping)
    step = _solve_spd(H, dF, n_mats)
    # trust region
    norm = _in_f64(torch.sqrt, _osum(step * step, 1)[:, None])
    step = step * torch.clamp_max(
        torch.full_like(norm, smax) / torch.clamp_min(norm, 1e-30), 1.0)
    return torch.clamp(a - step, lo, hi)


def _solve_block_plain(y, full, warm, sched, eps_init, step_max, a_lo, a_hi,
                       lm_damping):
    """Newton iterations for one pixel block, y [B, M] normalised counts.

    ``full`` and ``warm`` are (musT [E, K], w [E, ...]) tables: the union
    grid for the float32 polish and the warm-phase table; ``sched`` is
    :func:`_schedule`'s.  Returns a [B, K]."""
    n_warm, n_pol, warm_bf16, warm_log, polish_log, newton = sched
    n_meas, n_mats = y.shape[1], full[0].shape[1]
    n_ng = n_meas * (1 + n_mats)
    a = y.new_full((y.shape[0], n_mats), eps_init)
    log_y = _in_f64(torch.log, torch.clamp_min(y, 1e-35))

    def step(a, tab, bf16, log):
        musT, w = tab
        if log:
            # the log step has the loose trust radius and clamps negative
            # overshoot hard
            H, dF = _log_system(_moments_plain(a, musT, w[:, :n_ng], bf16),
                                log_y, n_meas, n_mats)
            return _newton_step(a, H, dF, lm_damping, 10.0 * step_max,
                                max(a_lo, -1.0), a_hi)
        if not newton:
            w = w[:, :n_ng]
        H, dF = _mle_system(_moments_plain(a, musT, w, bf16), y, n_meas,
                            n_mats, newton)
        return _newton_step(a, H, dF, lm_damping, step_max, a_lo, a_hi)

    for _ in range(n_warm):
        a = step(a, warm, warm_bf16, warm_log)
    for _ in range(n_pol):
        a = step(a, full, False, polish_log)
    return a


def _tables(i0n, mus, n_iters, polish_iters, warm_nodes, newton=False,
            compress=True):
    """Energy tables (musT [..., E, K], w [..., E, M + M K (+ M T)]) for
    the polish and the warm phase, for ``i0n`` [..., M, E] (a leading axis
    of fluence groups is kept); ``newton`` adds the Hessian weights
    i0_m mu_i mu_j.  With ``compress`` (the log warm phase) the warm table
    is moment-compressed to ~warm_nodes nodes when the union grid has more
    than 2 * warm_nodes bins (per segment of equal bin count the
    per-measurement fluence sums exactly and the node attenuation is the
    combined-fluence-weighted mean)."""
    n_meas, E = i0n.shape[-2:]
    n_mats = mus.shape[-2]

    def weights(i0_, mu_, hess):
        cols = [i0_.transpose(-1, -2)]
        cols.append(torch.stack([i0_[..., m, :] * mu_[..., i, :]
                                 for m in range(n_meas)
                                 for i in range(n_mats)], -1))
        if hess:
            cols.append(torch.stack([i0_[..., m, :] * mu_[..., i, :]
                                     * mu_[..., j, :]
                                     for m in range(n_meas)
                                     for i, j in _tri_pairs(n_mats)], -1))
        return mu_.transpose(-1, -2).contiguous(), torch.cat(cols, -1)

    full = weights(i0n, mus.expand(i0n.shape[:-2] + mus.shape), newton)
    if (compress and warm_nodes and polish_iters > 0
            and n_iters > polish_iters and E > 2 * warm_nodes):
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
        return full, weights(i0_c, mu_c, False)
    return full, full


def _schedule(n_meas, n_mats, n_iters, polish_iters, method="gn",
              warm="log"):
    """Checks and the phase plan: (n_warm, n_pol, warm_bf16, warm_log,
    polish_log, newton).  The warm phase runs in bfloat16 whenever a
    float32 polish follows; it takes log steps with ``warm="log"`` and the
    Gauss-Newton method, and the polish does so when M == K (for M > K the
    Poisson-MLE weighting owns the fixed point)."""
    if n_mats > n_meas:
        raise ValueError(f"{n_mats} materials need at least that many "
                         f"measurements (got {n_meas})")
    if n_mats not in (2, 3, 4):
        raise NotImplementedError("closed-form solve supports 2-4 materials")
    if n_meas > MAX_BINS:
        raise ValueError(f"gauss_newton_solve takes at most {MAX_BINS} "
                         f"measurements (MAX_BINS, the per-pixel "
                         f"accumulators of its kernel), got {n_meas}")
    if method not in ("gn", "newton"):
        raise ValueError(f"unknown method {method!r} (expected 'gn' or "
                         "'newton')")
    newton = method == "newton"
    n_pol = min(polish_iters, n_iters)
    warm_log = warm == "log" and not newton
    return (n_iters - n_pol, n_pol, n_pol > 0, warm_log,
            warm_log and n_meas == n_mats, newton)


def _prepare(counts, i0, mus, n_iters, polish_iters, warm_nodes, method,
             warm):
    """Checks, float32 casts, the common normalisation and the energy
    tables shared by the kernels and the plain version."""
    sched = _schedule(counts.shape[0], mus.shape[0], n_iters, polish_iters,
                      method, warm)
    dev = counts.device
    counts = counts.to(torch.float32)
    i0 = i0.to(device=dev, dtype=torch.float32)
    mus = mus.to(device=dev, dtype=torch.float32)
    # common normalization keeps float32 in range; the Newton step is
    # invariant to a joint rescale of (y, i0)
    scale = torch.clamp_min(i0.max(), 1e-30)
    full, warm_tab = _tables(i0 / scale, mus, n_iters, polish_iters,
                             warm_nodes, newton=sched[5],
                             compress=sched[3])
    return counts, scale, full, warm_tab, sched


def gauss_newton_solve_plain(counts, i0, mus, *, n_iters=30, eps_init=1e-6,
                             pixel_block=65536, step_max=5.0,
                             a_bounds=(-20.0, 500.0), method="gn",
                             lm_damping=0.0, polish_iters=4, warm="log",
                             warm_nodes=32):
    """The plain PyTorch version of :func:`gauss_newton_solve` on any
    device: ``_solve_block`` of the JAX package over blocks of
    ``pixel_block`` pixels."""
    counts, scale, full, warm_tab, sched = _prepare(
        counts, i0, mus, n_iters, polish_iters, warm_nodes, method, warm)
    yn = (counts / scale).T
    block = max(min(pixel_block, yn.shape[0]), 1)
    out = [_solve_block_plain(yn[s:s + block], full, warm_tab, sched,
                              eps_init, step_max, *a_bounds, lm_damping)
           for s in range(0, yn.shape[0], block)]
    return torch.cat(out) if out else yn.new_zeros((0, mus.shape[0]))


def gauss_newton_solve(counts, i0, mus, *, n_iters=30, eps_init=1e-6,
                       pixel_block=65536, step_max=5.0,
                       a_bounds=(-20.0, 500.0), method="gn", lm_damping=0.0,
                       polish_iters=4, warm="log", warm_nodes=32):
    """Vectorized Poisson-MLE Newton solve over all sinogram pixels.

    counts: [M, P] detected counts (M = 2 for classic DE, more for
    multi-bin photon counting, at most :data:`MAX_BINS`); i0: [M, E]
    effective fluence per energy bin; mus: [K, E] basis mass attenuation
    [cm^2/g], K in {2, 3, 4} and K <= M.  Returns a: [P, K] area
    densities [g/cm^2], float32.

    The schedule of the JAX package's ``gauss_newton_solve`` (module
    docstring).  CUDA tensors run kernel K3 for M = K = 2 with the
    defaults ``method="gn"``, ``lm_damping=0`` and ``warm="log"``
    (counted in ``gauss_newton_solve.launches``) and kernel K35 otherwise
    (counted in ``_gauss_newton_general.launches``); CPU tensors run
    :func:`gauss_newton_solve_plain`.
    """
    kw = dict(n_iters=n_iters, eps_init=eps_init, pixel_block=pixel_block,
              step_max=step_max, a_bounds=a_bounds, method=method,
              lm_damping=lm_damping, polish_iters=polish_iters, warm=warm,
              warm_nodes=warm_nodes)
    if counts.is_cuda:
        if (counts.shape[0], mus.shape[0]) == (2, 2) and method == "gn" \
                and not lm_damping and warm == "log":
            return _gauss_newton_cuda(counts, i0, mus, **kw)
        return _gauss_newton_general(counts, i0, mus, **kw)
    if counts.device.type != "cpu":
        raise ValueError(f"unsupported device {counts.device}")
    return gauss_newton_solve_plain(counts, i0, mus, **kw)


def k3_arguments(counts, i0, mus, *, n_iters=30, eps_init=1e-6,
                 step_max=5.0, a_bounds=(-20.0, 500.0), polish_iters=4,
                 warm_nodes=32):
    """K3's launch arguments on the device of ``counts``: ``(counts [2, P]
    contiguous, tables [(E_full + E_warm) * 8] (the full rows, then the
    warm rows, rounded to bfloat16 when the warm phase runs in it), scale
    (0-d), P, E_full, E_warm, n_warm, n_pol, warm_bf16, a_lo, a_hi,
    step_max, eps_init, clip)``, the C entry's order."""
    counts, scale, full, warm_tab, sched = _prepare(
        counts, i0, mus, n_iters, polish_iters, warm_nodes, "gn", "log")
    n_warm, n_pol, warm_bf16 = sched[:3]
    counts = counts.contiguous()
    rows = [torch.cat(full, 1), torch.cat(warm_tab, 1)]  # [E, 8] rows
    if warm_bf16:  # the warm table as the bf16 warm phase sees it
        rows[1] = rows[1].to(torch.bfloat16).float()
    tables = torch.cat([r.reshape(-1) for r in rows]).contiguous()
    scale = kernels.require(scale, "scale", counts.device, torch.float32, ())
    return (counts, tables, scale, counts.shape[1], rows[0].shape[0],
            rows[1].shape[0], n_warm, n_pol, int(warm_bf16),
            float(a_bounds[0]), float(a_bounds[1]), float(step_max),
            float(eps_init), _CLIP)


def _gauss_newton_cuda(counts, i0, mus, *, n_iters, eps_init, pixel_block,
                       step_max, a_bounds, method, lm_damping, polish_iters,
                       warm, warm_nodes):
    del pixel_block, method, lm_damping, warm  # one launch, K3's schedule
    counts, tables, scale, P, *rest = k3_arguments(
        counts, i0, mus, n_iters=n_iters, eps_init=eps_init,
        step_max=step_max, a_bounds=a_bounds, polish_iters=polish_iters,
        warm_nodes=warm_nodes)
    dev = counts.device
    out = torch.empty((P, 2), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_gauss_newton(
        counts.data_ptr(), tables.data_ptr(), scale.data_ptr(),
        out.data_ptr(), P, *rest, kernels.stream_ptr(dev))
    kernels.check(rc, "gauss_newton")
    gauss_newton_solve.launches += 1
    return out


gauss_newton_solve.launches = 0


def k35_arguments(counts, i0, mus, *, n_iters=30, eps_init=1e-6,
                  step_max=5.0, a_bounds=(-20.0, 500.0), method="gn",
                  lm_damping=0.0, polish_iters=4, warm="log", warm_nodes=32):
    """K35's launch arguments on the device of ``counts``: ``(counts [M, P]
    contiguous, tables, scale (0-d), P, M, K, newton, E_full, E_warm,
    n_warm, n_pol, warm_bf16, warm_log, polish_log, lm_damping, a_lo,
    a_hi, step_max, eps_init, clip)``, the C entry's order.  ``tables`` is
    float64: the float32 rows [mu_k (K), i0_m (M), g_mi (M K), and with
    ``newton`` h_m,ij (M T)], the full grid for the polish, then the warm
    table (rounded to bfloat16 when the warm phase runs in it), each value
    cast exactly; one row layout serves both, since only the log warm
    phase, which has no Hessian columns, takes a compressed table."""
    counts, scale, full, warm_tab, sched = _prepare(
        counts, i0, mus, n_iters, polish_iters, warm_nodes, method, warm)
    n_warm, n_pol, warm_bf16, warm_log, polish_log, newton = sched
    counts = counts.contiguous()
    rows = [torch.cat(full, 1), torch.cat(warm_tab, 1)]
    if warm_bf16:  # the warm table as the bf16 warm phase sees it
        rows[1] = rows[1].to(torch.bfloat16).float()
    tables = torch.cat([r.reshape(-1) for r in rows]).double()
    scale = kernels.require(scale, "scale", counts.device, torch.float32, ())
    return (counts, tables, scale, counts.shape[1], counts.shape[0],
            mus.shape[0], int(newton), rows[0].shape[0], rows[1].shape[0],
            n_warm, n_pol, int(warm_bf16), int(warm_log), int(polish_log),
            float(lm_damping), float(a_bounds[0]), float(a_bounds[1]),
            float(step_max), float(eps_init), _CLIP)


def _gauss_newton_general(counts, i0, mus, *, n_iters, eps_init,
                          pixel_block, step_max, a_bounds, method,
                          lm_damping, polish_iters, warm, warm_nodes):
    """K35: every (M, K, method, lm_damping, warm) of the solve on CUDA
    tensors, one launch over all pixels, on :func:`k35_arguments`'
    float64 table."""
    del pixel_block  # one launch covers every pixel
    counts, tables, scale, P, M, K, *rest = k35_arguments(
        counts, i0, mus, n_iters=n_iters, eps_init=eps_init,
        step_max=step_max, a_bounds=a_bounds, method=method,
        lm_damping=lm_damping, polish_iters=polish_iters, warm=warm,
        warm_nodes=warm_nodes)
    dev = counts.device
    out = torch.empty((P, K), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_gauss_newton_general(
        counts.data_ptr(), tables.data_ptr(), scale.data_ptr(),
        out.data_ptr(), P, M, K, *rest, kernels.stream_ptr(dev))
    kernels.check(rc, "gauss_newton_general")
    _gauss_newton_general.launches += 1
    return out


_gauss_newton_general.launches = 0

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
    if (counts.shape[0], mus.shape[0]) != (2, 2):
        raise NotImplementedError(
            "gauss_newton_solve_grouped solves two spectra and two "
            f"materials, got {counts.shape[0]} and {mus.shape[0]}")
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
                                         n_iters, polish_iters)[:3]
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
                        mask_thresh=0.95, basis=DEFAULT_BASIS, dtype=None,
                        pixel_block=65536):
    """Counts sinogram pair -> basis material sinogram pair, on the device
    of ``sino1``, in float32 (``dtype``, the JAX signature's, must be
    float32 or None).  Returns (mat1, mat2), each [N_proj, N_channels] in
    g/cm^2."""
    check_float32(dtype)
    _, i0, mus = prepare_decomposition(geometry, spec1, spec2, basis)
    dev = sino1.device
    shape = sino1.shape
    counts = torch.stack([sino1.reshape(-1), sino2.reshape(-1)]).float()
    a = gauss_newton_solve(
        counts,
        upload(i0, dev, torch.float32),
        upload(mus, dev, torch.float32),
        n_iters=n_iters, pixel_block=pixel_block,
    )
    mask = air_mask(sino1, mask_thresh)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    mat1 = torch.where(mask, zero, a[:, 0].reshape(shape))
    mat2 = torch.where(mask, zero, a[:, 1].reshape(shape))
    return mat1, mat2


def pcd_bin_fluences(geometry, spec, thresholds):
    """Split a spectrum into photon-counting energy bins (host, float64).

    thresholds: ascending bin edges [keV]; bin m spans
    [thresholds[m], thresholds[m+1]) with the last bin open-ended.
    Returns i0 [n_bins, E] effective fluences on the spectrum's grid,
    ready for the multi-measurement :func:`gauss_newton_solve`.
    """
    from .spectral import effective_fluence

    base = effective_fluence(spec, geometry)
    e = spec.E
    edges = list(thresholds) + [np.inf]
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        out.append(np.where((e >= lo) & (e < hi), base, 0.0))
    return np.stack(out)


def decompose_multibin_grid(sinos, ee, i0s, basis, *, n_iters=30,
                            mask_thresh=0.95, dtype=None, pixel_block=65536,
                            method="gn", a_bounds=(-20.0, 500.0),
                            device=None):
    """Multi-measurement basis decomposition on an explicit energy grid,
    on the device of ``sinos`` when it is a tensor, else on ``device``
    (default: the card), in float32 (``dtype`` must be float32 or None).

    sinos: [M, V, C] counts; ee: [E] energies [keV]; i0s: [M, E]
    effective fluences; basis: K Materials (K <= M, K in {2, 3, 4}).
    Returns ([K, V, C] basis sinograms [g/cm^2], air mask [V, C], from the
    first measurement).  ``a_bounds`` clamps the per-ray area densities:
    photon-starved rays rail at the upper bound, so a physical limit
    bounds their FBP streaks at low dose.
    """
    check_float32(dtype)
    dev = device_of(sinos, device)
    sinos = upload(sinos, dev, torch.float32)
    m, v, c = sinos.shape
    mus = np.stack([xcom.mixatten(b.matcomp, np.asarray(ee))
                    for b in basis])
    a = gauss_newton_solve(
        sinos.reshape(m, -1),
        upload(np.asarray(i0s), dev, torch.float32),
        upload(mus, dev, torch.float32),
        n_iters=n_iters, pixel_block=pixel_block, method=method,
        a_bounds=a_bounds)
    mask = air_mask(sinos[0], mask_thresh)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    mats = torch.where(mask[None], zero, a.T.reshape(len(basis), v, c))
    return mats.contiguous(), mask


def image_domain_decomposition(recon1_raw, recon2_raw, spec1, spec2,
                               geometry, *, basis=DEFAULT_BASIS,
                               device=None):
    """Image-domain DE decomposition: a per-pixel 2x2 solve on the
    reconstructions, on the device of ``recon1_raw`` when it is a tensor,
    else on ``device`` (default: the card).

    Each reconstruction is modelled as the fluence-weighted effective
    attenuation ``mu_i(x) = sum_m a_m(x) <mu/rho_m>_i`` with
    ``<mu/rho_m>_i = sum_E w_i(E) (mu/rho)_m(E)`` (w_i the normalised
    detected fluence of spectrum i), and the 2x2 mixing matrix is
    inverted per pixel (host float64, applied in float32).  Exact only in
    the thin-object limit: beam hardening makes the effective energies
    object-dependent, which the projection-domain solve does not suffer.
    Returns the basis-density images (a_1, a_2) [g/cm^3].
    """
    from .spectral import effective_fluence

    if len(basis) != 2:
        raise ValueError("image-domain solve is the 2-measurement, "
                         "2-basis special case")
    a_mat = np.zeros((2, 2))
    for i, spec in enumerate((spec1, spec2)):
        w = effective_fluence(spec, geometry)
        w = w / w.sum()
        for m, mat in enumerate(basis):
            a_mat[i, m] = float(np.sum(w * mat.mass_atten(spec.E)))
    dev = device_of(recon1_raw, device)
    a_inv = upload(np.linalg.inv(a_mat), dev, torch.float32)
    mu1 = upload(recon1_raw, dev, torch.float32)
    mu2 = upload(recon2_raw, dev, torch.float32)
    return (mu1 * a_inv[0, 0] + mu2 * a_inv[0, 1],
            mu1 * a_inv[1, 0] + mu2 * a_inv[1, 1])
