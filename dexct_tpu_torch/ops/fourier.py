"""Fourier-slice (projection-slice theorem) fast projector.

Port of :mod:`dexct_tpu.ops.fourier`.  The material-path sinograms are
computed through the projection-slice theorem at O(N^2 log N) instead of
an exact per-ray walk:

    1. one-hot material images are deapodized, 2x zero-padded and 2-D
       FFT'd (``torch.fft``);
    2. the spectrum is sampled along nθ radial half-lines with a width-4
       Kaiser-Bessel kernel, from host-precomputed window bases and weights
       (:func:`kb_sample`, kernel K7 on the card, over the samples binned
       once per table by spectrum tile, :func:`kb_tiles`);
    3. an inverse real FFT along the radial axis gives the parallel-beam
       Radon transform R_m(θ, t) on a (nθ x nt) grid;
    4. fan rays (β, γ) map to parallel coordinates (θ = β + γ - π/2,
       t = SID sin γ) and bilinearly sample R (:func:`resample_to_fan`,
       kernel K8 on the card).

The projector of images (:func:`fourier_project_images`) is
differentiable: the backward passes of steps 2 and 4 are their adjoints
(:func:`kb_sample_adjoint`, K21, and :func:`resample_to_fan_adjoint`, K22,
on the card), where the JAX package transposes them with
``jax.linear_transpose`` and ``jax.grad``.  Both gather over the plan's taps
transposed, built once per plan on the plan's device at the first adjoint:
K22 over the fan taps as a CSR over the Radon bins (:func:`fan_transpose`),
K21 over the sampler's 16 taps as a CSR over the spectrum's cells
(:func:`kb_transpose`).

Accuracy is set by the KB gridding parameters (oversampling σ=2, W=4:
~1e-3 relative).  The host part (KB kernel, plan tables) is the JAX
package's NumPy code unchanged; the plan's tables are tensors on a given
device.  The JAX sampler's ``packed_table`` choice picks a TPU table
layout of the same sum and selects nothing here.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import numpy as np
import torch

from ..utils import kernels

__all__ = [
    "FourierProjectorPlan",
    "plan_fourier_projector",
    "plan_arrays",
    "fourier_radon",
    "fourier_project_images",
    "fourier_paths",
    "fourier_paths_stack_from_arrays",
    "fourier_paths_from_arrays",
    "radon_grid",
    "kb_sample",
    "kb_sample_plain",
    "resample_to_fan",
    "resample_to_fan_plain",
    "kb_sample_adjoint",
    "kb_sample_adjoint_plain",
    "resample_to_fan_adjoint",
    "resample_to_fan_adjoint_plain",
    "fan_transpose",
    "plan_fan_adjoint",
    "KBTranspose",
    "kb_transpose",
    "KBTiles",
    "kb_tiles",
]


# ---------------------------------------------------------------------------
# Kaiser-Bessel gridding kernel (host-side; only tables reach the device)
# ---------------------------------------------------------------------------

KB_WIDTH = 4
OVERSAMPLE = 2


def _kb_beta(width=KB_WIDTH, sigma=OVERSAMPLE):
    # Beatty et al. optimal beta for oversampled gridding
    return np.pi * np.sqrt(
        (width / sigma) ** 2 * (sigma - 0.5) ** 2 - 0.8
    )


def _kb_kernel(u, width=KB_WIDTH, beta=None):
    """KB kernel value at offset u (grid units), support |u| <= width/2."""
    beta = _kb_beta(width) if beta is None else beta
    t = 1.0 - (2.0 * u / width) ** 2
    inside = t > 0
    val = np.where(inside, np.i0(beta * np.sqrt(np.clip(t, 0, None))), 0.0)
    return val / np.i0(beta)


def _kb_deapod_1d(n_img, grid, width=KB_WIDTH, beta=None):
    """Gridding correction at image pixel offsets (length n_img): the
    Fourier transform of the peak-normalized KB kernel,
    K(x) = W sinh(sqrt(beta^2 - (pi W x / G)^2)) / (sqrt(...) I0(beta)),
    continued with sin for imaginary arguments."""
    beta = _kb_beta(width) if beta is None else beta
    # integer centered FFT-array offsets; the half-pixel world offset is a
    # separate smooth phase on the sampled spectrum, NOT part of K
    x = np.arange(n_img) - n_img / 2.0
    arg2 = beta**2 - (np.pi * width * x / grid) ** 2
    pos = arg2 > 0
    sq = np.sqrt(np.abs(arg2))
    c = np.where(pos, np.sinh(sq) / np.maximum(sq, 1e-30),
                 np.sinc(sq / np.pi))
    return c * (width / np.i0(beta))


# ---------------------------------------------------------------------------
# Plans: host-precomputed tables for a (phantom grid, scan geometry) pair
# ---------------------------------------------------------------------------

def radon_grid(n_img, dx, n_theta=1024, nt_pad_factor=2):
    """The (θ, t) grid used by the fast paths.

    Returns (thetas [nθ] over [0, π), t0, dt, nt) with nt = pad_factor * G
    and dt = dx / pad_factor (sinc-refined by spectral zero-padding).
    """
    grid = OVERSAMPLE * n_img
    nt = nt_pad_factor * grid
    dt = (grid * dx) / nt
    thetas = np.arange(n_theta) * (np.pi / n_theta)
    t0 = -0.5 * nt * dt
    return thetas, t0, dt, nt


@dataclasses.dataclass
class FourierProjectorPlan:
    """Device tables + static meta for :func:`fourier_paths`."""

    n_img: int
    n_materials: int
    dx: float
    n_theta: int
    nt: int
    t0: float
    dt: float
    grid: int
    deapod: torch.Tensor  # [n_img, n_img] float32
    slice_idx: torch.Tensor  # [nθ * nl] int32 window base into [G, G]
    slice_w: torch.Tensor  # [nθ * nl * 16] float32, tap k = i*4 + j
    phase_cos: torch.Tensor  # [nθ, nl] half-pixel + t-centering phase
    phase_sin: torch.Tensor  # [nθ, nl]
    fan_idx: torch.Tensor  # [V*C, 4] int32 into flat [nθ * nt]
    fan_w: torch.Tensor  # [V*C, 4] float32
    scale: float
    # the fan taps transposed, (row_ptr, ray, w): built by fan_transpose at
    # the adjoint's first use
    fan_t: tuple | None = None
    # the sampler's taps transposed: built by kb_transpose at the adjoint's
    # first use
    kb_t: KBTranspose | None = None


def plan_fourier_projector(phantom, geometry, n_theta=1024, *, device):
    """Build the projector plan for a voxel phantom + fan geometry, with
    its tables on ``device``."""
    n_img = phantom.Nx
    if phantom.Ny != n_img:
        raise ValueError("fourier projector requires a square phantom grid")
    dx = float(phantom.dx)
    if abs(phantom.dy - dx) > 1e-12:
        raise ValueError("fourier projector requires square pixels")
    n_mat = phantom.n_materials
    grid = OVERSAMPLE * n_img
    thetas, t0, dt, nt = radon_grid(n_img, dx, n_theta)
    nl = grid // 2 + 1  # radial rfft bins

    # deapodization (separable)
    c1 = _kb_deapod_1d(n_img, grid)
    deapod = np.outer(c1, c1)

    # radial slice taps: sample the centered spectrum at (l cosθ, l sinθ)
    ll = np.arange(nl)
    uu = np.outer(np.cos(thetas), ll)  # [nθ, nl]
    vv = np.outer(np.sin(thetas), ll)
    taps = np.arange(KB_WIDTH) - (KB_WIDTH // 2 - 1)  # [-1, 0, 1, 2]
    u0 = np.floor(uu)[..., None] + taps  # [nθ, nl, 4]
    v0 = np.floor(vv)[..., None] + taps
    wu = _kb_kernel(uu[..., None] - u0)
    wv = _kb_kernel(vv[..., None] - v0)
    # 2-D separable 16-tap footprint (k = i*4 + j <-> offsets u+i, v+j);
    # spectrum indices wrap (DC at 0), slice_idx holds the window's base
    # corner (floor - 1, wrapped)
    w2 = wu[..., :, None] * wv[..., None, :]  # [nθ, nl, 4, 4]
    ub = np.mod(u0[..., 0], grid).astype(np.int64)
    vb = np.mod(v0[..., 0], grid).astype(np.int64)
    slice_idx = (vb * grid + ub).astype(np.int32)  # [nθ, nl]
    slice_w = w2.reshape(n_theta, nl, 16).astype(np.float32)

    # Sampled spectrum ~ centered DTFT; the world pixel-center half-pixel
    # offset contributes e^{-i π (a+b)/G}, and (-1)^l folds the t origin
    # into the middle of the nt grid:
    #   phi = -π (a+b)/G + π l
    ab = uu + vv
    phi = -np.pi * ab / grid + np.pi * ll[None, :]
    phase_cos = np.cos(phi).astype(np.float32)
    phase_sin = np.sin(phi).astype(np.float32)

    # fan ray -> (θ, t) bilinear taps
    betas = geometry.betas
    gammas = geometry.gammas
    th = (betas[:, None] + gammas[None, :] - np.pi / 2.0)
    tt = geometry.SID * np.sin(gammas)[None, :] * np.ones_like(th)
    k = np.floor(th / np.pi)
    th = th - k * np.pi  # into [0, π)
    sign = np.where((k.astype(np.int64) % 2) != 0, -1.0, 1.0)
    tt = tt * sign
    # θ interpolation (wraps at π with t -> -t; handled by weight folding)
    ft = th / (np.pi / n_theta)
    i_th0 = np.floor(ft).astype(np.int64)
    f_th = ft - i_th0
    i_th1 = i_th0 + 1
    wrap1 = i_th1 >= n_theta
    i_th0 = np.clip(i_th0, 0, n_theta - 1)
    i_th1 = np.where(wrap1, 0, i_th1)

    def t_taps(t_signed):
        """t index and fraction (per θ-tap; the wrapped tap flips sign)."""
        ft_ = (t_signed - t0) / dt
        i0 = np.clip(np.floor(ft_).astype(np.int64), 0, nt - 2)
        f = np.clip(ft_ - i0, 0.0, 1.0)
        return i0, f

    i_t0a, f_ta = t_taps(tt)
    i_t0b, f_tb = t_taps(np.where(wrap1, -tt, tt))
    idx = np.stack([
        i_th0 * nt + i_t0a,
        i_th0 * nt + i_t0a + 1,
        i_th1 * nt + i_t0b,
        i_th1 * nt + i_t0b + 1,
    ], -1)
    w = np.stack([
        (1 - f_th) * (1 - f_ta),
        (1 - f_th) * f_ta,
        f_th * (1 - f_tb),
        f_th * f_tb,
    ], -1)
    fan_idx = idx.reshape(-1, 4).astype(np.int32)
    fan_w = w.reshape(-1, 4).astype(np.float32)

    # overall scale: p(t_i) = df * nt * irfft(...)[i] with S = dx^2 * DFT
    # -> dx^2 * nt / (G dx) = dx * nt / G   (irfft carries the 1/nt)
    scale = (dx * nt) / grid

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return FourierProjectorPlan(
        n_img=n_img,
        n_materials=n_mat,
        dx=dx,
        n_theta=n_theta,
        nt=nt,
        t0=t0,
        dt=dt,
        grid=grid,
        deapod=dev(deapod, torch.float32),
        slice_idx=dev(slice_idx.reshape(-1), torch.int32),
        slice_w=dev(slice_w.reshape(-1), torch.float32),
        phase_cos=dev(phase_cos, torch.float32),
        phase_sin=dev(phase_sin, torch.float32),
        fan_idx=dev(fan_idx, torch.int32),
        fan_w=dev(fan_w, torch.float32),
        scale=float(scale),
    )


def plan_arrays(plan: FourierProjectorPlan, view_shape):
    """The plan's tables under the keys of the fused pipeline's array dict
    (the JAX package's layout: ``fp_fan_idx``/``fp_fan_w`` as [V, C*4])."""
    v, c = view_shape
    return {
        "fp_deapod": plan.deapod,
        "fp_slice_idx": plan.slice_idx,
        "fp_slice_w": plan.slice_w,
        "fp_phase_cos": plan.phase_cos,
        "fp_phase_sin": plan.phase_sin,
        "fp_fan_idx": plan.fan_idx.reshape(v, c * 4),
        "fp_fan_w": plan.fan_w.reshape(v, c * 4),
    }


# ---------------------------------------------------------------------------
# K7: Kaiser-Bessel sampler
# ---------------------------------------------------------------------------

def _window_indices(slice_idx, grid):
    """[S, 16] flat spectrum indices of each sample's 4 x 4 window (tap
    k = i*4 + j at column offset i, row offset j, wrapped mod G)."""
    base = slice_idx.reshape(-1).to(torch.int64)
    vb, ub = base // grid, base % grid
    offs = torch.arange(4, device=base.device)
    idx16 = (torch.remainder(vb[:, None, None] + offs[None, None, :], grid)
             * grid
             + torch.remainder(ub[:, None, None] + offs[None, :, None],
                               grid))
    return idx16.reshape(-1, 16)


def kb_sample_plain(F, slice_idx, slice_w, phase_cos, phase_sin):
    """The sampler of ``dexct_tpu.ops.fourier._radon_from_images`` in
    torch: for each (θ, l), the 16-tap KB sum of every material spectrum
    over the 4 x 4 window at ``slice_idx`` (offsets wrapped mod G), times
    the phase.  F: [M, G, G] complex; returns complex [M, nθ, nl]."""
    M, G, _ = F.shape
    n_theta, nl = phase_cos.shape
    S = n_theta * nl
    idx16 = _window_indices(slice_idx, G)
    table = torch.cat([F.real, F.imag]).reshape(2 * M, G * G)
    rows = table[:, idx16.reshape(-1)].reshape(2 * M, S, 16)
    s = (rows * slice_w.reshape(1, S, 16)).sum(-1)  # [2M, S]
    z_re, z_im = s[:M], s[M:]
    pc, ps = phase_cos.reshape(1, S), phase_sin.reshape(1, S)
    spec = torch.complex(z_re * pc - z_im * ps, z_re * ps + z_im * pc)
    return spec.reshape(M, n_theta, nl)


# K7's work items: the samples whose window base lies in one KB_TILE x
# KB_TILE tile of the spectrum, at most KB_ITEM of them (a thread block)
KB_TILE = 8
KB_ITEM = 128


@dataclasses.dataclass
class KBTiles:
    """The sampler's samples binned by spectrum tile, K7's table
    (:func:`kb_tiles`).

    Samples stand in binned order p: by the T x T tile (T = ``KB_TILE``)
    of the G x G spectrum that holds their window base (the base clamped
    into the plane as K7 clamps it; tiles in row-major order, ragged at the
    last row and column when G is no multiple of T), each tile's samples in
    increasing s.  A tile of n samples splits into ceil(n / ``KB_ITEM``)
    work items of near-equal size.  ``items`` [n_items + 1] int32: item i
    holds binned samples [items[i], items[i + 1]); ``origin`` [n_items, 2]
    int32, its tile's first (row, column); ``rec`` [S, 4] int32, per binned
    sample its index s, its window base in the staged tile ((row - origin
    row) * (T + 3) + column - origin column) and the float32 bits of its
    phase pair; ``w`` [4, S, 4] float32, its tap k = 4 q + e at ``w[q, p,
    e]``."""

    grid: int
    items: torch.Tensor
    origin: torch.Tensor
    rec: torch.Tensor
    w: torch.Tensor

    @property
    def n_items(self):
        return self.items.numel() - 1

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.items, self.origin, self.rec, self.w))


def _kb_tiles_build(slice_idx, slice_w, phase_cos, phase_sin, grid):
    """:class:`KBTiles` of the sampler's tables, built in plain PyTorch on
    their device: a stable sort of the samples by tile, a bincount, the
    items' bounds, the records and weights gathered into binned order.
    Reads the number of items back to the host."""
    G = int(grid)
    tile, cap = KB_TILE, KB_ITEM
    S = slice_idx.numel()
    if slice_w.numel() != 16 * S or phase_cos.numel() != S \
            or phase_sin.numel() != S:
        raise ValueError(f"sampler tables of {S} samples: slice_w holds "
                         f"{slice_w.numel()}, the phases {phase_cos.numel()}"
                         f" and {phase_sin.numel()}")
    dev = slice_idx.device
    base = slice_idx.reshape(-1).to(torch.int64).clamp(0, G * G - 1)
    vb, ub = base // G, base % G
    ty, tx = vb // tile, ub // tile
    n_side = -(-G // tile)
    tile_id = ty * n_side + tx
    order = torch.sort(tile_id, stable=True).indices
    count = torch.bincount(tile_id, minlength=n_side * n_side)
    k = torch.div(count + cap - 1, cap, rounding_mode="floor")
    n_items = int(k.sum())
    item_tile = torch.repeat_interleave(
        torch.arange(n_side * n_side, device=dev), k, output_size=n_items)
    first = torch.cumsum(k, 0) - k
    start = torch.cumsum(count, 0) - count
    j = torch.arange(n_items, device=dev) - first[item_tile]
    n = count[item_tile]
    items = torch.empty(n_items + 1, dtype=torch.int32, device=dev)
    items[:-1] = start[item_tile] + torch.div(j * n, k[item_tile],
                                              rounding_mode="floor")
    items[-1] = S
    origin = torch.stack([item_tile // n_side * tile,
                          item_tile % n_side * tile], 1).to(torch.int32)
    local = (vb - ty * tile) * (tile + 3) + (ub - tx * tile)
    rec = torch.stack([
        order.to(torch.int32), local[order].to(torch.int32),
        phase_cos.reshape(-1)[order].to(torch.float32).view(torch.int32),
        phase_sin.reshape(-1)[order].to(torch.float32).view(torch.int32)], 1)
    w = slice_w.reshape(S, 4, 4)[order].to(torch.float32).transpose(0, 1)
    return KBTiles(G, items, origin, rec, w.contiguous())


# kb_tiles' cache: id(slice_idx) -> (KBTiles, slice_w, phase_cos,
# phase_sin); an entry goes when its slice_idx tensor does
_KB_TILES = {}


def kb_tiles(slice_idx, slice_w, phase_cos, phase_sin, grid):
    """The samples of the sampler's tables binned by spectrum tile
    (:class:`KBTiles`), K7's table, on the tables' device: built at the
    first call for a ``slice_idx`` tensor and kept while that tensor lives
    (the same ``slice_w`` and phase tensors and grid reuse it), about 80
    bytes a sample (21 MB at G = 512, n_theta = 1024).  Counts its builds
    in ``kb_tiles.builds``."""
    key = id(slice_idx)
    hit = _KB_TILES.get(key)
    if (hit is not None and hit[1] is slice_w and hit[2] is phase_cos
            and hit[3] is phase_sin and hit[0].grid == int(grid)):
        return hit[0]
    tiles = _kb_tiles_build(slice_idx, slice_w, phase_cos, phase_sin, grid)
    kb_tiles.builds += 1
    if hit is None:
        weakref.finalize(slice_idx, _KB_TILES.pop, key, None)
    _KB_TILES[key] = (tiles, slice_w, phase_cos, phase_sin)
    return tiles


kb_tiles.builds = 0


def _kb_sample_cuda(F, slice_idx, slice_w, phase_cos, phase_sin):
    dev = F.device
    M, G, _ = F.shape
    n_theta, nl = phase_cos.shape
    S = n_theta * nl
    kernels.require(F, "F", dev, torch.complex64, (M, G, G))
    tiles = kb_tiles(slice_idx, slice_w, phase_cos, phase_sin, G)
    n_items = tiles.n_items
    items = kernels.require(tiles.items, "tiles items", dev, torch.int32,
                            (n_items + 1,))
    origin = kernels.require(tiles.origin, "tiles origin", dev, torch.int32,
                             (n_items, 2))
    rec = kernels.require(tiles.rec, "tiles rec", dev, torch.int32, (S, 4))
    w = kernels.require(tiles.w, "tiles w", dev, torch.float32, (4, S, 4))
    out = torch.empty((M, n_theta, nl), dtype=torch.complex64, device=dev)
    rc = kernels.library().dexct_kb_sample(
        F.data_ptr(), items.data_ptr(), origin.data_ptr(), rec.data_ptr(),
        w.data_ptr(), out.data_ptr(), S, M, G, n_items,
        kernels.stream_ptr(dev))
    kernels.check(rc, "kb_sample")
    kb_sample.launches += 1
    return out


def kb_sample(F, slice_idx, slice_w, phase_cos, phase_sin):
    """KB gridding samples of the spectra ``F`` [M, G, G] along the plan's
    radial lines: complex [M, nθ, nl].  CUDA tensors run kernel K7
    (counted in ``kb_sample.launches``; complex64 F) over the samples
    binned by spectrum tile (:func:`kb_tiles` of the tables, built at the
    first call for them), bit for bit the sampler's first kernel; CPU
    tensors run :func:`kb_sample_plain`, which bins nothing.
    """
    if F.dim() != 3 or F.shape[1] != F.shape[2]:
        raise ValueError(f"F must be [M, G, G], got {tuple(F.shape)}")
    if F.is_cuda:
        return _kb_sample_cuda(F, slice_idx, slice_w, phase_cos, phase_sin)
    if F.device.type != "cpu":
        raise ValueError(f"unsupported device {F.device}")
    return kb_sample_plain(F, slice_idx, slice_w, phase_cos, phase_sin)


kb_sample.launches = 0


# ---------------------------------------------------------------------------
# K21: the sampler's adjoint
# ---------------------------------------------------------------------------

def kb_sample_adjoint_plain(spec_grad, slice_idx, slice_w, phase_cos,
                            phase_sin, grid):
    """The adjoint of :func:`kb_sample_plain` in the (re, im) pairing of
    torch's autograd: each sample's complex value times the conjugate
    phase, scattered with its 16 KB weights into the spectrum [M, G, G]
    (``index_add_``).  ``spec_grad``: complex [M, nθ, nl]."""
    M = spec_grad.shape[0]
    S = phase_cos.numel()
    idx = _window_indices(slice_idx, grid).reshape(-1)
    g = spec_grad.reshape(M, S)
    pc, ps = phase_cos.reshape(1, S), phase_sin.reshape(1, S)
    z = torch.cat([g.real * pc + g.imag * ps, g.imag * pc - g.real * ps])
    vals = z[:, :, None] * slice_w.reshape(1, S, 16).to(z.dtype)
    table = z.new_zeros((2 * M, grid * grid))
    table.index_add_(1, idx, vals.reshape(2 * M, S * 16))
    return torch.complex(table[:M], table[M:]).reshape(M, grid, grid)


# rows of the transposed taps longer than this go to a warp each in K21
# (the cells around DC, where every line's first windows land); shorter
# rows to a thread each, which takes its taps KB_BATCH at a time
KB_WARP_ROW = 64
KB_BATCH = 8
_KB_SLICE = 32  # rows a slice of the short rows' ELLPACK


@dataclasses.dataclass
class KBTranspose:
    """The sampler's taps transposed into a CSR over the spectrum's G^2
    cells, K21's table (:func:`kb_transpose`).

    ``row_ptr`` [G^2 + 1] int32; ``entries`` [16 S, 2] int32, per tap its
    sample s and its weight's float32 bits, each cell's taps in the stable
    (cell, s * 16 + k) order; ``rows`` [G^2] int32, the cells by
    decreasing count of ``KB_BATCH``-tap batches (stable, so cells of one
    count stay in cell order); ``n_long`` the number of cells with more
    than :data:`KB_WARP_ROW` taps, the first ``n_long`` of ``rows``.  The
    other rows' entries also stand in a sliced ELLPACK, ``ell`` [slots, 2]
    int32: the short row of rank i (``rows[n_long + i]``) holds its j-th
    tap at ``ell_offset[i // 32] + 32 j + i % 32``, each slice of 32 rows
    padded to its longest, so that 32 neighbouring threads read 256
    contiguous bytes."""

    row_ptr: torch.Tensor
    entries: torch.Tensor
    rows: torch.Tensor
    n_long: int
    ell: torch.Tensor
    ell_offset: torch.Tensor

    @property
    def sample(self):
        return self.entries[:, 0]

    @property
    def weight(self):
        return self.entries[:, 1].view(torch.float32)


def _pack_kb_transpose(cells, sample, weight, n_cells):
    """A :class:`KBTranspose` from its taps' cells (ascending), samples
    and float32 weights, in that order.  Reads two counts back to the host
    (``n_long`` and the ELLPACK's slots)."""
    if cells.numel() >= 2 ** 31:
        raise ValueError(f"{cells.numel()} sampler taps do not fit int32 "
                         "offsets")
    dev = cells.device
    length = torch.bincount(cells, minlength=n_cells)
    starts = torch.cumsum(length, 0) - length
    row_ptr = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(length, 0)
    entries = torch.stack([sample.to(torch.int32),
                           weight.to(torch.float32).view(torch.int32)], 1)
    batches = torch.div(length + KB_BATCH - 1, KB_BATCH,
                        rounding_mode="floor")
    rows = torch.sort(batches, descending=True, stable=True).indices
    n_long = int((length > KB_WARP_ROW).sum())
    # the short rows' slices: each as wide as its longest row
    short = rows[n_long:]
    n_slices = -(-short.numel() // _KB_SLICE)
    width = torch.zeros(n_slices * _KB_SLICE, dtype=torch.int64, device=dev)
    width[:short.numel()] = length[short]
    width = width.reshape(n_slices, _KB_SLICE).amax(1)
    ell_offset = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
    ell_offset[1:] = torch.cumsum(_KB_SLICE * width, 0)
    slots = int(ell_offset[-1])
    if slots >= 2 ** 31:
        raise ValueError(f"{slots} ELLPACK slots do not fit int32 offsets")
    rank = torch.full((n_cells,), -1, dtype=torch.int64, device=dev)
    rank[short] = torch.arange(short.numel(), device=dev)
    r = rank[cells]
    on = torch.nonzero(r >= 0).squeeze(1)
    r = r[on]
    pos = (ell_offset[torch.div(r, _KB_SLICE, rounding_mode="floor")]
           + _KB_SLICE * (on - starts[cells[on]]) + r % _KB_SLICE)
    ell = torch.zeros((slots, 2), dtype=torch.int32, device=dev)
    ell[pos] = entries[on]
    return KBTranspose(row_ptr, entries, rows.to(torch.int32), n_long, ell,
                       ell_offset.to(torch.int32))


def _kb_transpose_taps(slice_idx, slice_w, grid):
    """The sampler's 16 taps per sample transposed, in plain PyTorch on
    their device: a stable sort of the taps' cells (the window base
    clamped into [0, G^2) as K7 clamps it, the offsets wrapped mod G), so
    each cell's taps run in increasing p = s * 16 + k, the order in which
    ``index_add_`` on the CPU adds them."""
    n_cells = grid * grid
    base = slice_idx.reshape(-1).to(torch.int64).clamp(0, n_cells - 1)
    cells = _window_indices(base, grid).reshape(-1)
    order = torch.sort(cells, stable=True).indices
    return _pack_kb_transpose(
        cells[order], torch.div(order, 16, rounding_mode="floor"),
        slice_w.reshape(-1)[order], n_cells)


def kb_transpose(plan: FourierProjectorPlan):
    """The plan's sampler taps transposed (:class:`KBTranspose`), built on
    the plan's device at the first call and kept on the plan: K21's table,
    8 bytes a tap and again for the short rows' (~70 MB at G = 512,
    n_theta = 1024).  The forward projector never needs it."""
    if plan.kb_t is None:
        plan.kb_t = _kb_transpose_taps(plan.slice_idx, plan.slice_w,
                                       plan.grid)
    return plan.kb_t


def _kb_sample_adjoint_cuda(spec_grad, slice_idx, slice_w, phase_cos,
                            phase_sin, grid, kb_t):
    dev = spec_grad.device
    M = spec_grad.shape[0]
    n_theta, nl = phase_cos.shape
    S = n_theta * nl
    n_cells = int(grid) * int(grid)
    if kb_t is None:
        kb_t = _kb_transpose_taps(slice_idx, slice_w, int(grid))
    g = kernels.require(spec_grad, "spec_grad", dev, torch.complex64,
                        (M, n_theta, nl))
    kernels.require(phase_cos, "phase_cos", dev, torch.float32)
    kernels.require(phase_sin, "phase_sin", dev, torch.float32,
                    (n_theta, nl))
    row_ptr = kernels.require(kb_t.row_ptr, "kb_t row_ptr", dev,
                              torch.int32, (n_cells + 1,))
    entries = kernels.require(kb_t.entries, "kb_t entries", dev, torch.int32,
                              (16 * S, 2))
    rows = kernels.require(kb_t.rows, "kb_t rows", dev, torch.int32,
                           (n_cells,))
    n_slices = -(-(n_cells - kb_t.n_long) // _KB_SLICE)
    ell = kernels.require(kb_t.ell, "kb_t ell", dev, torch.int32)
    ell_offset = kernels.require(kb_t.ell_offset, "kb_t ell_offset", dev,
                                 torch.int32, (n_slices + 1,))
    # each sample's conjugate-phased values, images side by side (in pairs
    # beyond one image)
    z = torch.empty(S * (1 if M == 1 else 2 * ((M + 1) // 2)),
                    dtype=torch.complex64, device=dev)
    out = torch.empty((M, grid, grid), dtype=torch.complex64, device=dev)
    rc = kernels.library().dexct_kb_sample_adjoint(
        g.data_ptr(), row_ptr.data_ptr(), entries.data_ptr(),
        rows.data_ptr(), ell.data_ptr(), ell_offset.data_ptr(),
        phase_cos.data_ptr(), phase_sin.data_ptr(), z.data_ptr(),
        out.data_ptr(), S, M, n_cells, kb_t.n_long, kernels.stream_ptr(dev))
    kernels.check(rc, "kb_sample_adjoint")
    kb_sample_adjoint.launches += 1
    return out


def kb_sample_adjoint(spec_grad, slice_idx, slice_w, phase_cos, phase_sin,
                      grid, *, kb_t=None):
    """The adjoint of :func:`kb_sample`: complex samples [M, nθ, nl] ->
    the spectra's gradient [M, G, G], as torch's autograd pairs re and im
    (the JAX package gets the same real operator from
    ``jax.linear_transpose``).  CUDA tensors run kernel K21 (counted in
    ``kb_sample_adjoint.launches``), a gather over the transposed taps
    ``kb_t`` (:func:`kb_transpose` of the plan; built for this call when
    absent), bit for bit :func:`kb_sample_adjoint_plain` on the CPU; CPU
    tensors run :func:`kb_sample_adjoint_plain`, which needs no ``kb_t``."""
    if spec_grad.dim() != 3 or spec_grad.shape[1:] != phase_cos.shape:
        raise ValueError(f"spec_grad must be [M, {phase_cos.shape[0]}, "
                         f"{phase_cos.shape[1]}], got "
                         f"{tuple(spec_grad.shape)}")
    if spec_grad.is_cuda:
        return _kb_sample_adjoint_cuda(spec_grad, slice_idx, slice_w,
                                       phase_cos, phase_sin, grid, kb_t)
    if spec_grad.device.type != "cpu":
        raise ValueError(f"unsupported device {spec_grad.device}")
    return kb_sample_adjoint_plain(spec_grad, slice_idx, slice_w, phase_cos,
                                   phase_sin, grid)


kb_sample_adjoint.launches = 0


class _KBSample(torch.autograd.Function):
    """The sampler (K7) with its adjoint (K21) as the backward pass.
    ``kb_t``: a callable that returns K21's table, called at a backward
    pass on the card (the forward pass builds nothing); None builds one
    per call there."""

    @staticmethod
    def forward(ctx, F, slice_idx, slice_w, phase_cos, phase_sin, kb_t=None):
        ctx.save_for_backward(slice_idx, slice_w, phase_cos, phase_sin)
        ctx.grid = F.shape[-1]
        ctx.kb_t = kb_t
        return kb_sample(F, slice_idx, slice_w, phase_cos, phase_sin)

    @staticmethod
    def backward(ctx, grad):
        kb_t = ctx.kb_t() if ctx.kb_t is not None and grad.is_cuda else None
        g = kb_sample_adjoint(grad.contiguous(), *ctx.saved_tensors,
                              ctx.grid, kb_t=kb_t)
        return g, None, None, None, None, None


# ---------------------------------------------------------------------------
# K8: fan resample
# ---------------------------------------------------------------------------

def resample_to_fan_plain(radon, fan_idx, fan_w, out_shape):
    """``dexct_tpu.ops.fourier._resample_to_fan`` in torch: each ray sums
    its 4 bilinear taps of every Radon transform [M, nθ, nt]; returns
    ``out_shape`` = (V, C, M)."""
    m = radon.shape[0]
    table = radon.reshape(m, -1)
    idx = fan_idx.reshape(-1, 4).to(torch.int64)
    vals = (table[:, idx] * fan_w.reshape(-1, 4).to(table.dtype)).sum(-1)
    return vals.T.reshape(out_shape)


def _resample_to_fan_cuda(radon, fan_idx, fan_w, out_shape):
    dev = radon.device
    m = radon.shape[0]
    table = kernels.require(radon.reshape(m, -1), "radon", dev,
                            torch.float32)
    n_rays = fan_idx.numel() // 4
    idx = kernels.require(fan_idx.reshape(-1, 4), "fan_idx", dev,
                          torch.int32, (n_rays, 4))
    w = kernels.require(fan_w.reshape(-1, 4), "fan_w", dev, torch.float32,
                        (n_rays, 4))
    out = torch.empty((n_rays, m), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_resample_to_fan(
        table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
        n_rays, m, table.shape[1], kernels.stream_ptr(dev))
    kernels.check(rc, "resample_to_fan")
    resample_to_fan.launches += 1
    return out.reshape(out_shape)


def resample_to_fan(radon, fan_idx, fan_w, out_shape):
    """Fan-ray line integrals from Radon transforms [M, nθ, nt]: the 4
    bilinear taps per ray of the plan's ``fan_idx``/``fan_w`` ([V*C, 4]
    or [V, C*4]).  Returns ``out_shape`` = (V, C, M), the layout the
    spectral counts read.  CUDA tensors run kernel K8 (counted in
    ``resample_to_fan.launches``); CPU tensors run
    :func:`resample_to_fan_plain`."""
    out_shape = tuple(int(n) for n in out_shape)
    if (fan_idx.numel() != 4 * out_shape[0] * out_shape[1]
            or fan_w.numel() != fan_idx.numel()
            or out_shape[2] != radon.shape[0]):
        raise ValueError(f"fan tables of {fan_idx.numel()} taps and radon "
                         f"{tuple(radon.shape)} do not give {out_shape}")
    if radon.is_cuda:
        return _resample_to_fan_cuda(radon, fan_idx, fan_w, out_shape)
    if radon.device.type != "cpu":
        raise ValueError(f"unsupported device {radon.device}")
    return resample_to_fan_plain(radon, fan_idx, fan_w, out_shape)


resample_to_fan.launches = 0


# ---------------------------------------------------------------------------
# K22: the fan resample's adjoint
# ---------------------------------------------------------------------------

def resample_to_fan_adjoint_plain(values, fan_idx, fan_w, radon_shape):
    """The adjoint of :func:`resample_to_fan_plain`: each ray's M values,
    times its 4 bilinear weights, added into the Radon transforms
    ``radon_shape`` = (M, nθ, nt) (``index_add_``)."""
    m = radon_shape[0]
    idx = fan_idx.reshape(-1, 4).to(torch.int64)
    v = values.reshape(-1, m).T  # [M, rays]
    vals = v[:, :, None] * fan_w.reshape(1, -1, 4).to(v.dtype)
    table = v.new_zeros((m, radon_shape[1] * radon_shape[2]))
    table.index_add_(1, idx.reshape(-1), vals.reshape(m, -1))
    return table.reshape(radon_shape)


def _transpose_taps(fan_idx, fan_w, n_bins):
    """The fan taps as a CSR over the Radon bins, in plain PyTorch on their
    device: ``(row_ptr [n_bins + 1] int32, ray [n_taps] int32, w [n_taps]
    float32)``, each bin's taps in the stable (bin, ray * 4 + tap) order
    (the order in which ``index_add_`` on the CPU visits them), the tap
    indices clamped into the bins as K8 clamps them."""
    bins = fan_idx.reshape(-1).to(torch.int64).clamp(0, n_bins - 1)
    if bins.numel() >= 2 ** 31:
        raise ValueError(f"{bins.numel()} fan taps do not fit int32 "
                         "offsets")
    order = torch.sort(bins, stable=True).indices
    row_ptr = torch.zeros(n_bins + 1, dtype=torch.int32, device=bins.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(bins, minlength=n_bins), 0)
    ray = torch.div(order, 4, rounding_mode="floor").to(torch.int32)
    return row_ptr, ray, fan_w.reshape(-1)[order].to(torch.float32)


def fan_transpose(plan: FourierProjectorPlan):
    """The plan's fan taps transposed (see :func:`_transpose_taps`), built
    on the plan's device at the first call and kept on the plan: K22's
    table.  The forward projector never needs it."""
    if plan.fan_t is None:
        plan.fan_t = _transpose_taps(plan.fan_idx, plan.fan_w,
                                     plan.n_theta * plan.nt)
    return plan.fan_t


def _resample_to_fan_adjoint_cuda(values, fan_idx, fan_w, radon_shape,
                                  fan_t):
    dev = values.device
    m = radon_shape[0]
    n_rays = fan_idx.numel() // 4
    n_bins = radon_shape[1] * radon_shape[2]
    if fan_t is None:
        fan_t = _transpose_taps(fan_idx, fan_w, n_bins)
    g = kernels.require(values.reshape(n_rays, m), "values", dev,
                        torch.float32)
    row_ptr = kernels.require(fan_t[0], "fan_t row_ptr", dev, torch.int32,
                              (n_bins + 1,))
    ray = kernels.require(fan_t[1], "fan_t ray", dev, torch.int32,
                          (4 * n_rays,))
    w = kernels.require(fan_t[2], "fan_t w", dev, torch.float32,
                        (4 * n_rays,))
    out = torch.empty((m, n_bins), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_resample_to_fan_adjoint(
        g.data_ptr(), row_ptr.data_ptr(), ray.data_ptr(), w.data_ptr(),
        out.data_ptr(), n_bins, m, kernels.stream_ptr(dev))
    kernels.check(rc, "resample_to_fan_adjoint")
    resample_to_fan_adjoint.launches += 1
    return out.reshape(radon_shape)


def resample_to_fan_adjoint(values, fan_idx, fan_w, radon_shape, *,
                            fan_t=None):
    """The adjoint of :func:`resample_to_fan`: fan values [V, C, M] (or
    [V*C, M]) -> Radon-transform gradient ``radon_shape`` = (M, nθ, nt).
    CUDA tensors run kernel K22 (counted in
    ``resample_to_fan_adjoint.launches``), a gather over the transposed
    taps ``fan_t`` (:func:`fan_transpose` of the plan; built for this call
    when absent); CPU tensors run :func:`resample_to_fan_adjoint_plain`,
    which needs no ``fan_t``."""
    radon_shape = tuple(int(n) for n in radon_shape)
    if (fan_w.numel() != fan_idx.numel()
            or values.numel() != fan_idx.numel() // 4 * radon_shape[0]):
        raise ValueError(f"fan tables of {fan_idx.numel()} taps and values "
                         f"{tuple(values.shape)} do not fit {radon_shape}")
    if values.is_cuda:
        return _resample_to_fan_adjoint_cuda(values, fan_idx, fan_w,
                                             radon_shape, fan_t)
    if values.device.type != "cpu":
        raise ValueError(f"unsupported device {values.device}")
    return resample_to_fan_adjoint_plain(values, fan_idx, fan_w, radon_shape)


resample_to_fan_adjoint.launches = 0


def plan_fan_adjoint(plan: FourierProjectorPlan, values, radon_shape):
    """:func:`resample_to_fan_adjoint` over the plan's fan taps: on the
    card K22 reads the plan's cached transpose (:func:`fan_transpose`,
    built at the first call), on the CPU the plain version needs none."""
    fan_t = fan_transpose(plan) if values.is_cuda else None
    return resample_to_fan_adjoint(values, plan.fan_idx, plan.fan_w,
                                   radon_shape, fan_t=fan_t)


class _ResampleToFan(torch.autograd.Function):
    """The plan's fan resample (K8) with its adjoint (K22) as the backward
    pass."""

    @staticmethod
    def forward(ctx, radon, plan, out_shape):
        ctx.plan = plan
        ctx.radon_shape = tuple(radon.shape)
        return resample_to_fan(radon, plan.fan_idx, plan.fan_w, out_shape)

    @staticmethod
    def backward(ctx, grad):
        g = plan_fan_adjoint(ctx.plan, grad.contiguous(), ctx.radon_shape)
        return g, None, None


# ---------------------------------------------------------------------------
# Device-side projection
# ---------------------------------------------------------------------------

def _spectrum(imgs, deapod, grid, n_img):
    """Deapodized, 2x zero-padded, corner-centred 2-D FFT of an image
    stack [K, N, N] -> complex64 [K, G, G] with DC at index 0 (gridding
    accuracy requires the object at |centered index| <= G/4)."""
    img = imgs / deapod[None]
    pad = grid - n_img
    img = torch.nn.functional.pad(img, (0, pad, 0, pad))
    img = torch.roll(img, (-(n_img // 2), -(n_img // 2)), dims=(-2, -1))
    return torch.fft.fft2(img)


def _radon_from_images(imgs, deapod, slice_idx, slice_w, phase_cos,
                       phase_sin, scale, *, n_theta, nt, grid, n_img,
                       packed_table=True, kb_t=None):
    """Radon transforms of an image stack [K, N, N] -> [K, nθ, nt].

    ``packed_table`` chooses between two TPU table layouts of the same
    sampler in the JAX package; it is accepted and ignored.  ``kb_t``: a
    callable that returns the sampler's transposed taps for a backward
    pass on the card (see :class:`_KBSample`).
    """
    del packed_table
    F = _spectrum(imgs, deapod, grid, n_img)
    spec = _KBSample.apply(F, slice_idx, slice_w, phase_cos, phase_sin,
                           kb_t)
    if spec.shape[1] != n_theta:
        raise ValueError(f"phase tables hold {spec.shape[1]} lines, "
                         f"n_theta={n_theta}")
    # radial inverse FFT -> projections over centered t (nt bins); irfft
    # zero-pads the nl = G/2 + 1 bins to nt/2 + 1, as numpy's does
    proj = torch.fft.irfft(spec, n=nt, dim=-1)  # [K, nθ, nt]
    return proj * scale  # scale = dx^2 * df * nt (irfft carries 1/nt)


def _onehot_images(labels, n_materials):
    """[M, N, N] float32 one-hot images of a label grid; labels outside
    0..M-1 give all-zero columns, as ``jax.nn.one_hot`` does."""
    mats = torch.arange(n_materials, device=labels.device)
    return (labels.to(torch.int64)[None] == mats[:, None, None]).to(
        torch.float32)


def fourier_radon(plan: FourierProjectorPlan, images):
    """Radon transforms [K, nθ, nt] of an image stack [K, N, N].  On the
    card K7 runs over the plan's samples binned by spectrum tile
    (:func:`kb_tiles`, built at the first call and kept while the plan's
    ``slice_idx`` lives) and a backward pass runs K21 over the plan's
    cached transpose (:func:`kb_transpose`, built at the first backward)."""
    return _radon_from_images(
        images, plan.deapod, plan.slice_idx, plan.slice_w,
        plan.phase_cos, plan.phase_sin, plan.scale,
        n_theta=plan.n_theta, nt=plan.nt, grid=plan.grid,
        n_img=plan.n_img,
        kb_t=functools.partial(kb_transpose, plan)
        if plan.slice_idx.is_cuda else None,
    )


def fourier_project_images(plan: FourierProjectorPlan, images, view_shape):
    """Fan-beam line integrals [V, C, K] of arbitrary images [K, N, N].
    Differentiable: autograd's backward pass runs the adjoints of the fan
    resample and of the sampler (K22, K21 on the card) and differentiates
    the FFT steps natively."""
    radon = fourier_radon(plan, images)
    return _ResampleToFan.apply(radon, plan,
                                tuple(view_shape) + (images.shape[0],))


def fourier_paths(plan: FourierProjectorPlan, labels, view_shape):
    """Material-path sinogram [V, C, M] via the Fourier slice theorem."""
    return fourier_project_images(
        plan, _onehot_images(labels, plan.n_materials), view_shape
    )


def fourier_paths_from_arrays(a, labels, meta_fp):
    """:func:`fourier_paths` over the array dict of :func:`plan_arrays`.

    meta_fp: (n_materials, n_theta, nt, grid, n_img, scale), optionally
    extended with the JAX package's 7th ``packed_table`` flag (ignored).
    """
    return fourier_paths_stack_from_arrays(a, labels[None], meta_fp)[0]


def fourier_paths_stack_from_arrays(a, labels, meta_fp):
    """:func:`fourier_paths_from_arrays` for a stack of label slices [Z, N,
    N] in one pass: the one-hot images of every slice go through the FFT,
    the KB sampler (K7, over the binned samples that :func:`kb_tiles`
    keeps for ``a["fp_slice_idx"]``) and the fan resample (K8) as one
    batch of Z x M images.  Returns [Z, V, C, M], each slice contiguous."""
    n_mat, n_theta, nt, grid, n_img, scale = meta_fp[:6]
    z = labels.shape[0]
    imgs = torch.cat([_onehot_images(lab, n_mat) for lab in labels])
    radon = _radon_from_images(
        imgs, a["fp_deapod"], a["fp_slice_idx"], a["fp_slice_w"],
        a["fp_phase_cos"], a["fp_phase_sin"], scale, n_theta=n_theta, nt=nt,
        grid=grid, n_img=n_img,
    )
    fan_idx = a["fp_fan_idx"]  # [V, C*4]
    v, c = fan_idx.shape[0], fan_idx.shape[1] // 4
    paths = resample_to_fan(radon, fan_idx, a["fp_fan_w"], (v, c, z * n_mat))
    return paths.reshape(v, c, z, n_mat).permute(2, 0, 1, 3).contiguous()
