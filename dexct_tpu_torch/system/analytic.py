"""Analytic phantoms: ellipse compositions with exact closed-form tracing.

Port of :mod:`dexct_tpu.system.analytic`.  The voxel phantom's generators
are built from ellipse primitives; this module keeps them analytic, so a
ray's per-material path is exact to float precision: per ray, every ellipse
intersection is a quadratic solve, and paint-order semantics (shapes
painted in list order over vacuum, a leading "air disk" standing in for the
air of a voxel grid) pick the topmost shape of each segment between sorted
intersection events.

:func:`analytic_paths` dispatches on the device of its tensors: CUDA
tensors go to the hand-written kernel K9 (``csrc/analytic_chords.cu``, one
thread per ray), CPU tensors to :func:`analytic_paths_plain`, the JAX
function's arithmetic in torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..physics.materials import MaterialTable
from ..utils import kernels
from ..utils.devices import upload

__all__ = ["Ellipse", "AnalyticPhantom", "analytic_paths",
           "analytic_paths_plain", "material_path_sinogram_analytic",
           "pelvis_analytic", "water_cylinder_analytic"]

MAX_MATERIALS = 32


@dataclasses.dataclass(frozen=True)
class Ellipse:
    material: int  # material table index
    cx: float
    cy: float
    rx: float
    ry: float
    angle: float = 0.0  # [rad], counterclockwise


@dataclasses.dataclass
class AnalyticPhantom:
    """Ordered ellipse composition over vacuum."""

    name: str
    shapes: list  # of Ellipse, painted in order
    materials: MaterialTable

    @property
    def n_materials(self):
        return len(self.materials)

    def shape_arrays(self):
        """(params [S, 5], labels [S]) host arrays for the tracer."""
        p = np.array([[s.cx, s.cy, s.rx, s.ry, s.angle]
                      for s in self.shapes], np.float64)
        lab = np.array([s.material for s in self.shapes], np.int32)
        return p, lab

    def rasterize(self, N, dx, name=None):
        """Voxelize onto an N x N grid of pixel size dx (paint order)."""
        from .phantom import VoxelPhantom, _ellipse_mask

        labels = np.zeros((N, N), np.uint8)
        for s in self.shapes:
            m = _ellipse_mask(N, dx, s.cx, s.cy, s.rx, s.ry, s.angle)
            labels[m] = s.material
        return VoxelPhantom(name or self.name, labels, self.materials,
                            dx, dx, dx)

    def mu_image(self, energy_keV, N, dx):
        return self.rasterize(N, dx).mu_image(energy_keV)


def _shape_table(params, device):
    """[S, 6] float32 (cx, cy, rx, ry, cos, sin) of the shapes; cos and sin
    of the float32 angle are taken by torch on ``device``, so the kernel
    and the plain version read the same values."""
    prm = params.to(device=device, dtype=torch.float32)
    ang = prm[:, 4]
    return torch.stack([prm[:, 0], prm[:, 1], prm[:, 2], prm[:, 3],
                        torch.cos(ang), torch.sin(ang)], -1).contiguous()


def _chords_block(p, d, tab, lab_tab, n_materials):
    """Paths [B, n_materials] of rays p, d [B, 2] (the JAX function's
    float32 operations in its order, each rounded; every division has
    tensor operands)."""
    cx, cy, rx, ry, ca, sa = (tab[:, i] for i in range(6))
    px = p[:, 0:1] - cx
    py = p[:, 1:2] - cy
    ox = (ca * px + sa * py) / rx
    oy = (-sa * px + ca * py) / ry
    vx = (ca * d[:, 0:1] + sa * d[:, 1:2]) / rx
    vy = (-sa * d[:, 0:1] + ca * d[:, 1:2]) / ry
    a = vx * vx + vy * vy
    b = ox * vx + oy * vy
    c = ox * ox + oy * oy - 1.0
    disc = b * b - a * c
    hit = disc > 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_a = torch.clamp_min(a, 1e-30)
    t_in = torch.clamp_min((-b - sq) / safe_a, 0.0)  # clip behind-source
    t_out = torch.clamp_min((-b + sq) / safe_a, 0.0)
    hit = hit & (t_out > t_in)
    zero = torch.zeros_like(t_in)
    t_in = torch.where(hit, t_in, zero)
    t_out = torch.where(hit, t_out, zero)

    events = torch.sort(torch.cat([t_in, t_out], 1), dim=1).values
    lo, hi = events[:, :-1], events[:, 1:]
    seg = torch.clamp_min(hi - lo, 0.0)
    mid = 0.5 * (lo + hi)  # [B, G]
    # topmost (last-painted) shape covering each segment midpoint
    cover = ((mid[:, :, None] >= t_in[:, None, :])
             & (mid[:, :, None] < t_out[:, None, :]))  # [B, G, S]
    order = torch.arange(1, tab.shape[0] + 1, device=p.device)
    top = torch.where(cover, order, torch.zeros_like(order)).amax(-1)
    mat = lab_tab[top]  # label 0 where uncovered, with zero weight below
    keep = (top > 0) & (mat < n_materials)
    w = torch.where(keep, seg, torch.zeros_like(seg))
    out = torch.zeros((p.shape[0], n_materials), dtype=p.dtype,
                      device=p.device)
    return out.scatter_add_(1, torch.where(keep, mat, 0), w)


def analytic_paths_plain(params, labels, src, dirs, *, n_materials,
                         ray_block=65536):
    """``dexct_tpu.system.analytic.analytic_paths`` in torch, over blocks of
    ``ray_block`` rays: the S quadratics, the sorted 2S events, and the
    half-open topmost-cover test at each segment midpoint."""
    dev = src.device
    batch = src.shape[:-1]
    p = src.reshape(-1, 2).to(torch.float32)
    d = dirs.reshape(-1, 2).to(device=dev, dtype=torch.float32)
    tab = _shape_table(params, dev)
    lab_tab = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         labels.to(device=dev, dtype=torch.int64)])
    out = [_chords_block(p[s:s + ray_block], d[s:s + ray_block], tab,
                         lab_tab, n_materials)
           for s in range(0, p.shape[0], ray_block)]
    out = torch.cat(out) if out else p.new_zeros((0, n_materials))
    return out.reshape(*batch, n_materials)


def _analytic_paths_cuda(params, labels, src, dirs, n_materials):
    dev = src.device
    S = params.shape[0]
    tab = _shape_table(params, dev)
    lab = kernels.require(labels.to(device=dev, dtype=torch.int32)
                          .contiguous(), "labels", dev, torch.int32, (S,))
    src2 = src.reshape(-1, 2).to(torch.float32).contiguous()
    dirs2 = kernels.require(dirs.reshape(-1, 2).to(torch.float32)
                            .contiguous(), "dirs", dev, torch.float32,
                            src2.shape)
    n_rays = src2.shape[0]
    out = torch.empty((n_rays, n_materials), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_analytic_chords(
        tab.data_ptr(), lab.data_ptr(), src2.data_ptr(), dirs2.data_ptr(),
        out.data_ptr(), n_rays, S, n_materials, kernels.stream_ptr(dev))
    kernels.check(rc, "analytic_chords")
    analytic_paths.launches += 1
    return out.reshape(*src.shape[:-1], n_materials)


def analytic_paths(params, labels, src, dirs, *, n_materials):
    """Exact per-material path lengths through an ellipse composition.

    params: [S, 5] (cx, cy, rx, ry, angle); labels: [S] material ids
    (paint order = array order); src/dirs: [..., 2].  Returns float32
    ``[..., n_materials]``; labels >= n_materials contribute nothing.

    CUDA tensors run kernel K9 (counted in ``analytic_paths.launches``);
    CPU tensors run :func:`analytic_paths_plain`.
    """
    if not 1 <= n_materials <= MAX_MATERIALS:
        raise ValueError(f"n_materials must be in 1..{MAX_MATERIALS}, got "
                         f"{n_materials}")
    if params.dim() != 2 or params.shape[1] != 5:
        raise ValueError(f"params must be [S, 5], got {tuple(params.shape)}")
    if src.is_cuda:
        return _analytic_paths_cuda(params, labels, src, dirs,
                                    int(n_materials))
    if src.device.type != "cpu":
        raise ValueError(f"unsupported device {src.device}")
    return analytic_paths_plain(params, labels, src, dirs,
                                n_materials=int(n_materials))


analytic_paths.launches = 0


def material_path_sinogram_analytic(phantom: AnalyticPhantom, geometry, *,
                                    device, dtype=torch.float32):
    """[N_proj, N_channels, n_materials] exact paths for a geometry; the
    shape table and the rays go up through ``upload`` (pinned memory, an
    asynchronous copy)."""
    src, dirs = geometry.ray_geometry()
    params, labels = phantom.shape_arrays()
    return analytic_paths(
        upload(params, device, dtype), upload(labels, device),
        upload(src, device, dtype), upload(dirs, device, dtype),
        n_materials=phantom.n_materials)


# ---------------------------------------------------------------------------
# Analytic versions of the built-in phantoms (shape-identical to the voxel
# generators in system/phantom.py)
# ---------------------------------------------------------------------------

def water_cylinder_analytic(extent_cm=12.8, radius_cm=None,
                            name="water_cyl"):
    from ..physics.materials import AIR, WATER

    radius = radius_cm if radius_cm is not None else 0.4 * extent_cm
    half = extent_cm / 2.0
    shapes = [
        Ellipse(0, 0.0, 0.0, half, half),  # air backdrop disk
        Ellipse(1, 0.0, 0.0, radius, radius),
    ]
    return AnalyticPhantom(name, shapes, MaterialTable([AIR, WATER]))


def pelvis_analytic(extent_cm=51.2, implant=None, name=None):
    """The synthetic pelvis as analytic shapes (mirrors
    system/phantom.pelvis_phantom)."""
    from ..physics.materials import (
        ADIPOSE,
        AIR,
        BONE,
        MUSCLE,
        STEEL_316L,
        TISSUE,
        TITANIUM,
        WATER,
    )

    half = extent_cm / 2.0
    brx, bry = 0.82 * half, 0.58 * half
    shapes = [
        Ellipse(0, 0.0, 0.0, half, half),  # air backdrop
        Ellipse(1, 0.0, 0.0, brx, bry),  # adipose shell
        Ellipse(2, 0.0, 0.0, 0.92 * brx, 0.88 * bry),  # soft tissue
    ]
    for sx in (-1, 1):
        shapes.append(Ellipse(3, sx * 0.45 * brx, -0.35 * bry,
                              0.30 * brx, 0.38 * bry, sx * 0.3))
    shapes.append(Ellipse(5, 0.0, 0.12 * bry, 0.22 * brx, 0.30 * bry))
    for sx in (-1, 1):
        shapes.append(Ellipse(4, sx * 0.52 * brx, 0.18 * bry,
                              0.16 * brx, 0.42 * bry, -sx * 0.5))
        shapes.append(Ellipse(2, sx * 0.52 * brx, 0.18 * bry,
                              0.10 * brx, 0.34 * bry, -sx * 0.5))
    shapes.append(Ellipse(4, 0.0, -0.52 * bry, 0.18 * brx, 0.22 * bry))
    for sx in (-1, 1):
        shapes.append(Ellipse(4, sx * 0.62 * brx, -0.30 * bry,
                              0.085 * brx, 0.12 * bry))
    mats = [AIR, ADIPOSE, TISSUE, MUSCLE, BONE, WATER]
    if implant:
        metal = {"titanium": TITANIUM, "steel": STEEL_316L}[implant]
        mats.append(metal)
        shapes.append(Ellipse(6, 0.62 * brx, -0.30 * bry,
                              0.06 * brx, 0.09 * bry))
    default_name = "pelvis" + (f"_{implant}" if implant else "")
    return AnalyticPhantom(name or default_name, shapes,
                           MaterialTable(mats))
