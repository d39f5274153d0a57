"""Exact Siddon ray tracing: per-material radiological paths.

Port of :mod:`dexct_tpu.ops.siddon`.  The polyenergetic model needs, per
ray, the exact intersection length with the cells of each material label:
``paths[view, channel, material]``; the energy axis is then a contraction
(:mod:`dexct_tpu_torch.ops.spectral`), never a second walk.

:func:`trace_paths` dispatches on the device of its tensors: CUDA tensors
go to the hand-written kernel K1 (``csrc/siddon_trace.cu``, one thread per
ray walking only the cells it crosses), CPU tensors to
:func:`trace_paths_plain`, the fixed-trip DDA of the JAX package written in
torch and vectorised over rays.  Both follow ``_ray_setup`` of the JAX
package in float32 operation by operation.

:func:`trace_paths_stack` traces the same rays through every slice of a
label stack ``[Nz, Ny, Nx]`` (the z-stack of
:mod:`dexct_tpu_torch.pipeline.zstack`): CUDA tensors go to kernel K17
(``csrc/siddon_trace_stack.cu``, one walk per ray for a chunk of slices),
CPU tensors to :func:`trace_paths_stack_plain`.  Slice ``z`` of either
equals :func:`trace_paths` on ``labels[z]`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import upload

__all__ = ["material_path_sinogram", "mono_sinogram", "trace_paths",
           "trace_paths_plain",
           "trace_paths_stack", "trace_paths_stack_plain", "labels_tensor",
           "labels_stack_tensor"]

_BIG = 1e30
MAX_MATERIALS = 32
# K17 keeps Z x M per-material sums in registers: at most this many
MAX_STACK_ACC = 64
# the label of K17's padding slices: no material takes it
PAD_LABEL = 255


def _grid_constants(labels_shape, dx, dy):
    """Grid edges (float64 host scalars, rounded to float32 where used)."""
    ny, nx = labels_shape
    x0 = -0.5 * nx * dx
    y0 = -0.5 * ny * dy
    return x0, y0, x0 + nx * dx, y0 + ny * dy, 1e-6 * (dx + dy)


def _ray_setup(labels_shape, src, dirs, dx, dy):
    """Entry/exit parameters and DDA state for a batch of rays [R, 2]
    (float32; the same operations, in the same order, as the JAX
    package's ``_ray_setup``).

    Every division has tensor operands on both sides: on a CUDA tensor,
    PyTorch divides by a Python scalar as a multiplication by its
    reciprocal, whose rounding moves entry cells at cell boundaries."""
    ny, nx = labels_shape
    x0, y0, x1, y1, eps = _grid_constants(labels_shape, dx, dy)
    px, py = src[:, 0], src[:, 1]
    dxr, dyr = dirs[:, 0], dirs[:, 1]

    def axis_setup(p, d, g0, g1):
        ok = d.abs() > 1e-12
        safe_d = torch.where(ok, d, torch.ones_like(d))
        t_lo = (g0 - p) / safe_d
        t_hi = (g1 - p) / safe_d
        # axis-parallel rays: inside the slab -> unbounded, outside -> miss
        inside = (p >= g0) & (p <= g1)
        big = torch.full_like(p, _BIG)
        tmin = torch.where(ok, torch.minimum(t_lo, t_hi),
                           torch.where(inside, -big, big))
        tmax = torch.where(ok, torch.maximum(t_lo, t_hi),
                           torch.where(inside, big, -big))
        return ok, safe_d, tmin, tmax

    okx, sdx, txmin, txmax = axis_setup(px, dxr, x0, x1)
    oky, sdy, tymin, tymax = axis_setup(py, dyr, y0, y1)
    t_in = torch.clamp_min(torch.maximum(txmin, tymin), 0.0)
    t_out = torch.minimum(txmax, tymax)
    t_out = torch.where(t_in < t_out, t_out, t_in)  # zero length on miss

    # entry cell, nudged inside to break boundary ties
    ex = px + (t_in + eps) * dxr
    ey = py + (t_in + eps) * dyr
    ix = torch.clamp(torch.floor((ex - x0) / torch.full_like(ex, dx)), 0,
                     nx - 1).to(torch.int64)
    iy = torch.clamp(torch.floor((ey - y0) / torch.full_like(ey, dy)), 0,
                     ny - 1).to(torch.int64)

    def next_crossing(p, d, ok, safe_d, g0, cell, idx):
        plane = g0 + (idx + (d > 0)).to(torch.int32) * cell
        big = torch.full_like(p, _BIG)
        t_next = torch.where(ok, (plane - p) / safe_d, big)
        dt = torch.where(ok, torch.full_like(p, cell) / safe_d.abs(), big)
        step = torch.where(ok, torch.sign(d), torch.zeros_like(d))
        return t_next, dt, step.to(torch.int64)

    tnx, dtx, sx = next_crossing(px, dxr, okx, sdx, x0, dx, ix)
    tny, dty, sy = next_crossing(py, dyr, oky, sdy, y0, dy, iy)
    return t_in, t_out, ix, iy, tnx, tny, dtx, dty, sx, sy


def trace_paths_plain(labels, src, dirs, dx, dy, *, n_materials,
                      n_steps=None):
    """The fixed-trip DDA of ``dexct_tpu.ops.siddon.trace_paths`` in torch:
    ``n_steps`` (default nx+ny+1) vectorised steps over all rays; exhausted
    rays add zero-length segments."""
    ny, nx = labels.shape
    k = n_steps if n_steps is not None else nx + ny + 1
    batch_shape = src.shape[:-1]
    src2 = src.reshape(-1, 2).to(torch.float32)
    dirs2 = dirs.reshape(-1, 2).to(torch.float32)
    flat = labels.reshape(-1).to(torch.int64)
    t, t_out, ix, iy, tnx, tny, dtx, dty, sx, sy = _ray_setup(
        (ny, nx), src2, dirs2, dx, dy)
    mats = torch.arange(n_materials, device=src.device)
    acc = torch.zeros((src2.shape[0], n_materials), dtype=torch.float32,
                      device=src.device)
    for _ in range(k):
        # clamp into [t, t_out] so misses and exhausted rays stay inert
        t_next = torch.maximum(
            torch.minimum(torch.minimum(tnx, tny), t_out), t)
        seg = t_next - t
        lab = flat[iy * nx + ix]
        # one-hot add: labels >= n_materials contribute nothing
        acc += seg[:, None] * (lab[:, None] == mats).to(acc.dtype)
        take_x = tnx <= tny
        ix = torch.clamp(torch.where(take_x, ix + sx, ix), 0, nx - 1)
        iy = torch.clamp(torch.where(take_x, iy, iy + sy), 0, ny - 1)
        tnx = torch.where(take_x, tnx + dtx, tnx)
        tny = torch.where(take_x, tny, tny + dty)
        t = t_next
    return acc.reshape(*batch_shape, n_materials)


def _trace_paths_cuda(labels, src, dirs, dx, dy, n_materials, n_steps):
    ny, nx = labels.shape
    dev = src.device
    lab = _uint8_labels(labels, dev).contiguous()
    src2 = src.reshape(-1, 2).to(torch.float32).contiguous()
    dirs2 = dirs.reshape(-1, 2).to(torch.float32).contiguous()
    n_rays = src2.shape[0]
    out = torch.empty((n_rays, n_materials), dtype=torch.float32, device=dev)
    x0, y0, x1, y1, eps = _grid_constants((ny, nx), dx, dy)
    rc = kernels.library().dexct_siddon_trace(
        lab.data_ptr(), src2.data_ptr(), dirs2.data_ptr(), out.data_ptr(),
        n_rays, nx, ny, n_materials, x0, y0, x1, y1, dx, dy, eps,
        n_steps, kernels.stream_ptr(dev))
    kernels.check(rc, "siddon_trace")
    trace_paths.launches += 1
    return out.reshape(*src.shape[:-1], n_materials)


def trace_paths(labels, src, dirs, dx, dy, *, n_materials, n_steps=None):
    """Exact per-material radiological paths for a batch of rays.

    labels: [Ny, Nx] integer label grid (uint8 on the CUDA path; labels
    >= n_materials contribute nothing); src, dirs: [..., 2] ray origins and
    unit directions; dx, dy: cell sizes [cm].  Returns float32
    ``[..., n_materials]`` intersection lengths [cm].

    CUDA tensors run kernel K1 (counted in ``trace_paths.launches``); CPU
    tensors run :func:`trace_paths_plain`.  ``n_steps`` caps the walk
    (default nx+ny+1, the exact bound).
    """
    ny, nx = labels.shape
    _check_materials(n_materials)
    k = n_steps if n_steps is not None else nx + ny + 1
    if src.is_cuda:
        return _trace_paths_cuda(labels, src, dirs, float(dx), float(dy),
                                 int(n_materials), int(k))
    if src.device.type != "cpu":
        raise ValueError(f"unsupported device {src.device}")
    return trace_paths_plain(labels, src, dirs, float(dx), float(dy),
                             n_materials=n_materials, n_steps=k)


trace_paths.launches = 0


def _check_materials(n_materials):
    if not 1 <= n_materials <= MAX_MATERIALS:
        raise ValueError(f"n_materials must be in 1..{MAX_MATERIALS}, got "
                         f"{n_materials}")


def trace_paths_stack_plain(labels, src, dirs, dx, dy, *, n_materials,
                            n_steps=None):
    """:func:`trace_paths_plain` on every slice of ``labels`` [Nz, Ny, Nx],
    stacked: float32 ``[Nz, ..., n_materials]``."""
    return torch.stack([
        trace_paths_plain(lab, src, dirs, dx, dy, n_materials=n_materials,
                          n_steps=n_steps) for lab in labels])


def slice_chunk(nz, n_materials):
    """K17's slices per walk: the largest of 8, 4, 2, 1 whose Z x M sums
    fit ``MAX_STACK_ACC`` registers (M rounded up to the kernel's 16 or 32
    above 8), and no larger than the stack needs."""
    m = n_materials if n_materials <= 8 else (16 if n_materials <= 16
                                               else 32)
    z = 8
    while z > 1 and (z * m > MAX_STACK_ACC or z // 2 >= nz):
        z //= 2
    return z


def pack_stack_labels(labels, z_chunk):
    """[Nz, Ny, Nx] uint8 -> K17's z-minor chunks [ceil(Nz / Z), Ny, Nx,
    Z], the missing slices of the last chunk filled with ``PAD_LABEL``."""
    nz, ny, nx = labels.shape
    n_chunks = -(-nz // z_chunk)
    pad = n_chunks * z_chunk - nz
    if pad:
        labels = torch.cat([labels, labels.new_full((pad, ny, nx),
                                                    PAD_LABEL)])
    return labels.reshape(n_chunks, z_chunk, ny, nx).permute(
        0, 2, 3, 1).contiguous()


def _uint8_labels(labels, device):
    lab = labels.to(device)
    if lab.dtype != torch.uint8:
        if lab.numel() and (int(lab.min()) < 0 or int(lab.max()) > 255):
            raise ValueError("material labels must lie in 0..255")
        lab = lab.to(torch.uint8)
    return lab


def _trace_paths_stack_cuda(labels, src, dirs, dx, dy, n_materials, n_steps):
    nz, ny, nx = labels.shape
    dev = src.device
    z_chunk = slice_chunk(nz, n_materials)
    packed = pack_stack_labels(_uint8_labels(labels, dev), z_chunk)
    src2 = src.reshape(-1, 2).to(torch.float32).contiguous()
    dirs2 = dirs.reshape(-1, 2).to(torch.float32).contiguous()
    n_rays = src2.shape[0]
    out = torch.empty((nz, n_rays, n_materials), dtype=torch.float32,
                      device=dev)
    x0, y0, x1, y1, eps = _grid_constants((ny, nx), dx, dy)
    rc = kernels.library().dexct_siddon_trace_stack(
        packed.data_ptr(), src2.data_ptr(), dirs2.data_ptr(), out.data_ptr(),
        n_rays, nx, ny, nz, n_materials, z_chunk, x0, y0, x1, y1, dx, dy,
        eps, n_steps, kernels.stream_ptr(dev))
    kernels.check(rc, "siddon_trace_stack")
    trace_paths_stack.launches += 1
    return out.reshape(nz, *src.shape[:-1], n_materials)


def trace_paths_stack(labels, src, dirs, dx, dy, *, n_materials,
                      n_steps=None):
    """Exact per-material paths of one ray batch through every slice of a
    label stack.

    labels: [Nz, Ny, Nx] integer labels (uint8 on the CUDA path, checked
    into 0..255 otherwise; labels >= n_materials contribute nothing); src,
    dirs: [..., 2]; dx, dy: cell sizes [cm].  Returns float32 ``[Nz, ...,
    n_materials]``, slice-major; slice z equals :func:`trace_paths` on
    ``labels[z]``.  CUDA tensors run kernel K17 (counted in
    ``trace_paths_stack.launches``, one launch for the whole stack); CPU
    tensors run :func:`trace_paths_stack_plain`.
    """
    if labels.dim() != 3:
        raise ValueError(f"labels must be [Nz, Ny, Nx], got "
                         f"{tuple(labels.shape)}")
    _check_materials(n_materials)
    nz, ny, nx = labels.shape
    k = n_steps if n_steps is not None else nx + ny + 1
    if src.is_cuda:
        return _trace_paths_stack_cuda(labels, src, dirs, float(dx),
                                       float(dy), int(n_materials), int(k))
    if src.device.type != "cpu":
        raise ValueError(f"unsupported device {src.device}")
    return trace_paths_stack_plain(labels, src, dirs, float(dx), float(dy),
                                   n_materials=n_materials, n_steps=k)


trace_paths_stack.launches = 0


def _labels_checked(lab):
    lab = np.asarray(lab)
    if lab.size and (lab.min() < 0 or lab.max() > 255):
        raise ValueError("material labels must lie in 0..255")
    return lab.astype(np.uint8)


def labels_tensor(phantom, device):
    """The phantom's 2-D label slice as a uint8 tensor (the kernel's
    label type), after checking that every label fits."""
    return upload(_labels_checked(phantom.slice_labels()), device)


def labels_stack_tensor(labels, device):
    """A host label stack [Nz, Ny, Nx] as a uint8 tensor, after the same
    check."""
    return upload(_labels_checked(labels), device)


def material_path_sinogram(phantom, geometry, *, device,
                           dtype=torch.float32, method="auto",
                           trace_group=None, trace_bundle=None):
    """Full material-path sinogram [N_proj, N_channels, n_materials].

    Host-side convenience wrapper: derives the rays from the geometry and
    traces them on ``device``.  One exact per-ray trace serves every grid,
    so the JAX package's ``method`` choice (accepted and ignored) has no
    counterpart here, and its ``trace_group`` and ``trace_bundle`` (TPU
    ray-plan layouts) are accepted and ignored.  An
    :class:`~dexct_tpu_torch.system.analytic.AnalyticPhantom` is traced in
    closed form (:func:`~dexct_tpu_torch.system.analytic.analytic_paths`).
    """
    del method, trace_group, trace_bundle
    from ..system.analytic import (AnalyticPhantom,
                                   material_path_sinogram_analytic)

    if isinstance(phantom, AnalyticPhantom):
        return material_path_sinogram_analytic(phantom, geometry,
                                               device=device, dtype=dtype)
    src, dirs = geometry.ray_geometry()
    return trace_paths(
        labels_tensor(phantom, device),
        upload(src, device, dtype),
        upload(dirs, device, dtype),
        float(phantom.dx), float(phantom.dy),
        n_materials=phantom.n_materials,
    )



def mono_sinogram(paths, mu_per_material):
    """Monoenergetic line-integral sinogram: ``paths [..., M]`` contracted
    with a per-material linear attenuation vector ``[M]`` [1/cm], in full
    float32 (TF32 plays no part in a matrix-vector product)."""
    mu = upload(mu_per_material, paths)
    return torch.matmul(paths, mu)
