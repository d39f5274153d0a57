"""Circular and helical cone-beam projection and Feldkamp reconstruction.

Port of the parts of :mod:`dexct_tpu.ops.conebeam` that the fused cone
pipeline (:mod:`dexct_tpu_torch.pipeline.cone`) runs.  Three kernels, each
behind a wrapper that dispatches on the device of its tensors (CUDA tensors
launch the kernel, CPU tensors run the plain PyTorch version beside it):

- :func:`trace_paths_3d`: K10 (``csrc/siddon_trace_3d.cu``), the exact 3-D
  Siddon trace, one thread per ray walking only the voxels it crosses.  On
  the card it replaces the JAX package's packed dominant-axis cone tracers
  (label packs, ray plans and bundles are TPU gather-count layouts of the
  same paths) as well as its ``trace_paths_3d``;
- :func:`_fdk_backproject_multi`: K11 (``csrc/cone_backproject.cu``), the
  voxel-driven circular FDK backprojection of K filtered stacks;
- :func:`_helical_backproject`: K12 (the same source), the
  generalized-Feldkamp backprojection of a helical scan, in each of the
  JAX package's six view weightings;
- :func:`project_volume_3d`: K18 (``csrc/siddon_project_3d.cu``), the exact
  3-D Siddon line integrals of a volume, with K19 (the same source), its
  adjoint, as the backward pass; :func:`cone_cg_recon` and
  :func:`cone_pwls_recon` iterate on the pair.

The JAX backprojectors' ``orbit4``, ``pair_mode``, ``view_block``,
``bf16_taps`` and ``pair_seq`` options are TPU gather-count layouts of one
image; the kernels compute that image directly.  Pixel centres and the FOV
disc are the host's float64 values, as in the JAX programs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import check_float32

__all__ = ["WEIGHTINGS", "trace_paths_3d", "trace_paths_3d_plain",
           "_fdk_backproject_multi", "_fdk_backproject_multi_plain",
           "_helical_backproject", "_helical_backproject_plain",
           "project_volume_3d", "project_volume_3d_plain",
           "project_volume_3d_adjoint", "project_volume_3d_adjoint_plain",
           "cone_cg_recon", "cone_pwls_recon", "fdk_reconstruct",
           "fdk_tilted_reconstruct", "helical_fdk_reconstruct",
           "cone_material_paths", "cone_sinogram", "simulate_cone_dect"]

_BIG = 1e30
MAX_MATERIALS = 32
MAX_IMAGES = 4


# ---------------------------------------------------------------------------
# K10: exact 3-D Siddon trace
# ---------------------------------------------------------------------------

def _grid_3d(labels_shape, dx, dy, dz):
    """Grid origin, far edges and entry nudge (float64 host scalars,
    rounded to float32 where used, as the JAX program's Python floats)."""
    nz, ny, nx = labels_shape
    g0 = (-0.5 * nx * dx, -0.5 * ny * dy, -0.5 * nz * dz)
    g1 = (g0[0] + nx * dx, g0[1] + ny * dy, g0[2] + nz * dz)
    return g0, g1, 1e-6 * (dx + dy + dz)


def _ray_setup_3d(labels_shape, p, d, dx, dy, dz):
    """Entry/exit parameters and DDA state of rays p, d [R, 3] (float32, or
    float64 for the projector's plain version; the operations of the JAX
    ``trace_paths_3d`` set-up in its order, every division between
    tensors)."""
    nz, ny, nx = labels_shape
    g0, g1, eps = _grid_3d(labels_shape, dx, dy, dz)
    cells, dims = (dx, dy, dz), (nx, ny, nz)

    def full(v):
        return torch.full_like(p[:, 0], v)

    setup = []
    for i in range(3):
        pi, di = p[:, i], d[:, i]
        ok = di.abs() > 1e-12
        safe = torch.where(ok, di, full(1.0))
        t_lo = (g0[i] - pi) / safe
        t_hi = (g1[i] - pi) / safe
        inside = (pi >= g0[i]) & (pi <= g1[i])
        tmin = torch.where(ok, torch.minimum(t_lo, t_hi),
                           torch.where(inside, full(-_BIG), full(_BIG)))
        tmax = torch.where(ok, torch.maximum(t_lo, t_hi),
                           torch.where(inside, full(_BIG), full(-_BIG)))
        setup.append((ok, safe, tmin, tmax))
    t_in = torch.clamp_min(torch.maximum(
        setup[0][2], torch.maximum(setup[1][2], setup[2][2])), 0.0)
    t_out = torch.minimum(setup[0][3],
                          torch.minimum(setup[1][3], setup[2][3]))
    t_out = torch.where(t_in < t_out, t_out, t_in)  # zero length on miss

    state = []
    for i in range(3):
        pi, di = p[:, i], d[:, i]
        ok, safe, _, _ = setup[i]
        e = pi + (t_in + eps) * di
        idx = torch.clamp(torch.floor((e - g0[i]) / full(cells[i])), 0,
                          dims[i] - 1).to(torch.int64)
        plane = g0[i] + (idx + (di > 0)).to(p.dtype) * cells[i]
        t_next = torch.where(ok, (plane - pi) / safe, full(_BIG))
        dt = torch.where(ok, full(cells[i]) / safe.abs(), full(_BIG))
        step = torch.where(ok, torch.sign(di), full(0.0)).to(torch.int64)
        state.append((idx, t_next, dt, step))
    return t_in, t_out, state


def _max_steps(labels_shape):
    """The walk's trip count: nx+ny+nz+2 bounds the voxels any ray
    crosses (the JAX ``trace_paths_3d``'s default)."""
    nz, ny, nx = labels_shape
    return nx + ny + nz + 2


def _walk_3d(labels_shape, p, d, dx, dy, dz, n_steps):
    """The fixed-trip DDA of the JAX ``trace_paths_3d`` and
    ``project_volume_3d``, vectorised over the rays p, d [R, 3]: yields per
    step the flat [z, y, x] index of each ray's current cell and its
    segment length, ending after ``n_steps`` steps or once every ray has
    reached its exit (the remaining steps add zero-length segments)."""
    nz, ny, nx = labels_shape
    t, t_out, state = _ray_setup_3d(labels_shape, p, d, dx, dy, dz)
    (ix, tnx, dtx, sx), (iy, tny, dty, sy), (iz, tnz, dtz, sz) = state
    for step in range(n_steps):
        if step % 32 == 0 and not bool((t < t_out).any()):
            return
        t_min = torch.minimum(torch.minimum(tnx, tny), tnz)
        t_next = torch.maximum(torch.minimum(t_min, t_out), t)
        yield (iz * ny + iy) * nx + ix, t_next - t
        # advance the axis whose crossing is nearest (ties: x, then y)
        take_x = tnx <= torch.minimum(tny, tnz)
        take_y = ~take_x & (tny <= tnz)
        take_z = ~(take_x | take_y)
        ix = torch.clamp(torch.where(take_x, ix + sx, ix), 0, nx - 1)
        iy = torch.clamp(torch.where(take_y, iy + sy, iy), 0, ny - 1)
        iz = torch.clamp(torch.where(take_z, iz + sz, iz), 0, nz - 1)
        tnx = torch.where(take_x, tnx + dtx, tnx)
        tny = torch.where(take_y, tny + dty, tny)
        tnz = torch.where(take_z, tnz + dtz, tnz)
        t = t_next


def trace_paths_3d_plain(labels, src, dirs, dx, dy, dz, *, n_materials):
    """The fixed-trip DDA of ``dexct_tpu.ops.conebeam.trace_paths_3d`` in
    torch (:func:`_walk_3d`), the segments added per material."""
    batch = src.shape[:-1]
    p = src.reshape(-1, 3).to(torch.float32)
    d = dirs.reshape(-1, 3).to(device=p.device, dtype=torch.float32)
    flat = labels.reshape(-1).to(device=p.device, dtype=torch.int64)
    mats = torch.arange(n_materials, device=p.device)
    acc = torch.zeros((p.shape[0], n_materials), dtype=torch.float32,
                      device=p.device)
    for lin, seg in _walk_3d(labels.shape, p, d, dx, dy, dz,
                             _max_steps(labels.shape)):
        # one-hot add: labels >= n_materials contribute nothing
        acc += seg[:, None] * (flat[lin][:, None] == mats).to(acc.dtype)
    return acc.reshape(*batch, n_materials)


def labels_u8(labels, device):
    """A label volume as the contiguous uint8 tensor the kernel reads,
    after checking that every label fits."""
    lab = torch.as_tensor(labels, device=device)
    if lab.dtype != torch.uint8:
        if lab.numel() and (int(lab.min()) < 0 or int(lab.max()) > 255):
            raise ValueError("material labels must lie in 0..255")
        lab = lab.to(torch.uint8)
    return lab.contiguous()


def _trace_paths_3d_cuda(labels, src, dirs, dx, dy, dz, n_materials):
    nz, ny, nx = labels.shape
    dev = src.device
    lab = labels_u8(labels, dev)
    src2 = src.reshape(-1, 3).to(torch.float32).contiguous()
    dirs2 = kernels.require(dirs.reshape(-1, 3).to(torch.float32)
                            .contiguous(), "dirs", dev, torch.float32,
                            src2.shape)
    n_rays = src2.shape[0]
    out = torch.empty((n_rays, n_materials), dtype=torch.float32, device=dev)
    g0, g1, eps = _grid_3d((nz, ny, nx), dx, dy, dz)
    rc = kernels.library().dexct_siddon_trace_3d(
        lab.data_ptr(), src2.data_ptr(), dirs2.data_ptr(), out.data_ptr(),
        n_rays, nx, ny, nz, n_materials, *g0, *g1, dx, dy, dz, eps,
        _max_steps((nz, ny, nx)), kernels.stream_ptr(dev))
    kernels.check(rc, "siddon_trace_3d")
    trace_paths_3d.launches += 1
    return out.reshape(*src.shape[:-1], n_materials)


def trace_paths_3d(labels, src, dirs, dx, dy, dz, *, n_materials,
                   n_steps=None):
    """Exact per-material radiological paths of 3-D rays.

    labels: [Nz, Ny, Nx] integer labels (uint8 on the CUDA path; labels
    >= n_materials contribute nothing), the grid centred on the origin;
    src, dirs: [..., 3] ray origins and unit directions (x, y, z); dx, dy,
    dz: voxel sizes [cm].  Returns float32 ``[..., n_materials]``.
    ``n_steps`` (the JAX DDA's fixed trip count, a loop bound of its TPU
    program) is accepted and ignored: every walk runs to the grid's edge.

    CUDA tensors run kernel K10 (counted in ``trace_paths_3d.launches``);
    CPU tensors run :func:`trace_paths_3d_plain`.
    """
    del n_steps
    if not 1 <= n_materials <= MAX_MATERIALS:
        raise ValueError(f"n_materials must be in 1..{MAX_MATERIALS}, got "
                         f"{n_materials}")
    args = (float(dx), float(dy), float(dz))
    if src.is_cuda:
        return _trace_paths_3d_cuda(labels, src, dirs, *args,
                                    int(n_materials))
    if src.device.type != "cpu":
        raise ValueError(f"unsupported device {src.device}")
    return trace_paths_3d_plain(torch.as_tensor(labels), src, dirs, *args,
                                n_materials=int(n_materials))


trace_paths_3d.launches = 0


# ---------------------------------------------------------------------------
# Shared backprojection geometry
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _disc_host(n_matrix, fov):
    """(X [P], Y [P] float32, sel [P] int64): centres of the pixels inside
    the FOV disc, tested and computed in float64 as the JAX programs do.
    Shared: never write."""
    N = n_matrix
    c = (np.arange(N) + 0.5 - N / 2.0) * (fov / N)
    XX, YY = np.meshgrid(c, c)
    sel = np.nonzero((np.hypot(XX, YY) <= fov / 2.0).reshape(-1))[0]
    return (XX.reshape(-1)[sel].astype(np.float32),
            YY.reshape(-1)[sel].astype(np.float32), sel.astype(np.int64))


def _disc(n_matrix, fov, device):
    X, Y, sel = _disc_host(int(n_matrix), float(fov))
    return (torch.as_tensor(X, device=device),
            torch.as_tensor(Y, device=device),
            torch.as_tensor(sel, device=device))


def _inplane(X, Y, beta, sid, dgamma, C):
    """Per-(view, pixel) tap geometry [B, P] of the JAX programs' ``block``
    body: channel index and weight, 1/sqrt(h^2), w_in / h^2, the fan angle
    gamma and h^2."""
    cb, sb = torch.cos(beta)[:, None], torch.sin(beta)[:, None]
    ell = sid - (X[None, :] * cb + Y[None, :] * sb)
    vt = -X[None, :] * sb + Y[None, :] * cb
    gam = torch.atan2(-vt, ell)
    h2 = ell * ell + vt * vt
    inv_h = torch.ones_like(h2) / torch.sqrt(h2)
    cidx = gam / torch.full_like(gam, dgamma) - 0.5 + C / 2.0
    c0 = torch.clamp(torch.floor(cidx), 0, C - 2)
    fc = torch.clamp(cidx - c0, 0.0, 1.0)
    w_in = ((cidx >= 0.0) & (cidx <= C - 1.0)).to(h2.dtype)
    return c0.to(torch.int64), fc, inv_h, w_in / h2, gam, h2


def _bilinear(qf, base, c0, fc, ridx, R, C):
    """Bilinear (row, channel) value of the K flat stacks ``qf`` [K, V*R*C]
    at rows ``ridx`` and channels (c0, fc); ``base`` = v * R * C.  Returns
    (values [K, ...], w_z)."""
    r0 = torch.clamp(torch.floor(ridx), 0, max(R - 2, 0))
    fr = torch.clamp(ridx - r0, 0.0, 1.0)
    w_z = ((ridx >= -0.5) & (ridx <= R - 0.5)).to(ridx.dtype)
    r0 = r0.to(torch.int64)
    r1 = torch.clamp_max(r0 + 1, R - 1)  # the JAX row shift repeats row R-1
    i00 = base + r0 * C + c0
    i10 = base + r1 * C + c0
    top = qf[:, i00] * (1 - fc) + qf[:, i00 + 1] * fc
    bot = qf[:, i10] * (1 - fc) + qf[:, i10 + 1] * fc
    return top * (1 - fr) + bot * fr, w_z


def _check_stack(q, name):
    if q.dim() != 4:
        raise ValueError(f"{name} must be [K, V, R, C], got "
                         f"{tuple(q.shape)}")
    K, V, R, C = q.shape
    if not 1 <= K <= MAX_IMAGES:
        raise ValueError(f"{name} stacks 1..{MAX_IMAGES} images, got {K}")
    if C < 2 or R < 1:
        raise ValueError(f"{name} needs at least 2 channels and 1 row")


def _place(vals, sel, n_matrix):
    """[K, nz, P] disc values -> [K, nz, N, N] volumes, 0 off the disc."""
    K, nz, _ = vals.shape
    vol = vals.new_zeros((K, nz, n_matrix * n_matrix))
    vol[:, :, sel] = vals
    return vol.reshape(K, nz, n_matrix, n_matrix)


# ---------------------------------------------------------------------------
# K11: circular FDK
# ---------------------------------------------------------------------------

def _fdk_z(nz_out, dz_out, z_center, device):
    """Slice centres of the JAX FDK grid, in float32."""
    return ((torch.arange(nz_out, dtype=torch.float32, device=device) + 0.5
             - nz_out / 2.0) * dz_out + z_center)


def _fdk_backproject_multi_plain(qs, betas, sid, dgamma, row_h, n_rows,
                                 n_matrix, nz_out, fov, dz_out, dbeta,
                                 z_center=0.0, *, view_block=8):
    """``dexct_tpu.ops.conebeam._fdk_backproject_multi`` in torch: blocks
    of ``view_block`` views, every (disc pixel, slice) at once."""
    K, V, R, C = qs.shape
    dev = qs.device
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _fdk_z(nz_out, dz_out, z_center, dev)
    betas = betas.to(device=dev, dtype=torch.float32)
    qf = qs.to(torch.float32).reshape(K, -1)
    acc = qf.new_zeros((K, nz_out, X.shape[0]))
    for v0 in range(0, V, view_block):
        beta = betas[v0:v0 + view_block]
        c0, fc, inv_h, w_amp, _, _ = _inplane(X, Y, beta, sid, dgamma, C)
        ridx = ((zc[None, :, None] * sid) * inv_h[:, None, :]
                / torch.full_like(inv_h[:, None, :], row_h)) - 0.5 + R / 2.0
        base = (torch.arange(v0, v0 + beta.shape[0], device=dev)
                * (R * C))[:, None, None]
        val, w_z = _bilinear(qf, base, c0[:, None, :], fc[:, None, :], ridx,
                             R, C)
        acc += (val * (w_amp[:, None, :] * w_z)).sum(1)
    return _place(acc * dbeta, sel, n_matrix)


def _fdk_cuda(qs, betas, sid, dgamma, row_h, n_matrix, nz_out, fov, dz_out,
              dbeta, z_center):
    dev = qs.device
    K, V, R, C = qs.shape
    kernels.require(qs, "qs", dev, torch.float32)
    kernels.require(betas, "betas", dev, torch.float32, (V,))
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _fdk_z(nz_out, dz_out, z_center, dev)
    cos_b, sin_b = torch.cos(betas), torch.sin(betas)
    out = torch.zeros((K, nz_out, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_fdk_backproject(
        qs.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), X.data_ptr(),
        Y.data_ptr(), sel.data_ptr(), zc.data_ptr(), out.data_ptr(), K, V,
        R, C, X.shape[0], nz_out, n_matrix * n_matrix, sid, dgamma, row_h,
        dbeta, kernels.stream_ptr(dev))
    kernels.check(rc, "fdk_backproject")
    _fdk_backproject_multi.launches += 1
    return out


def _fdk_backproject_multi(qs, betas, sid, dgamma, row_h, n_rows, n_matrix,
                           nz_out, fov, dz_out, dbeta, z_center=0.0):
    """Voxel-driven FDK backprojection of K filtered stacks at once.

    qs: [K, V, R, C] (cos- and cone-weighted, ramp-filtered, times dgamma);
    betas: [V].  Per (disc pixel, slice, view): bilinear (row, channel)
    taps with the fan-edge and detector-edge masks and the 1/h^2 weight;
    the sum is multiplied by ``dbeta``.  Returns [K, nz_out, N, N], 0 off
    the FOV disc.  CUDA tensors run kernel K11 (counted in
    ``_fdk_backproject_multi.launches``); CPU tensors run
    :func:`_fdk_backproject_multi_plain`.
    """
    _check_stack(qs, "qs")
    if qs.shape[2] != n_rows:
        raise ValueError(f"qs has {qs.shape[2]} rows, n_rows={n_rows}")
    geo = (float(sid), float(dgamma), float(row_h))
    grid = (int(n_matrix), int(nz_out), float(fov), float(dz_out),
            float(dbeta), float(z_center))
    if qs.is_cuda:
        return _fdk_cuda(qs, betas, *geo, *grid)
    if qs.device.type != "cpu":
        raise ValueError(f"unsupported device {qs.device}")
    return _fdk_backproject_multi_plain(qs, betas, *geo, int(n_rows), *grid)


_fdk_backproject_multi.launches = 0


# ---------------------------------------------------------------------------
# K12: helical generalized Feldkamp
# ---------------------------------------------------------------------------

def _helical_z(nz_out, dz_out, z0, device):
    """Slice centres of the JAX helical grid, in float32."""
    return (torch.tensor(z0, dtype=torch.float32, device=device)
            + torch.arange(nz_out, dtype=torch.float32, device=device)
            * dz_out)


WEIGHTINGS = ("full", "feather", "td", "cosz", "short", "pair")


def _helical_window_halfwidth(weighting, n_channels, dgamma):
    """Half-width of each gFDK weighting's view window in units of pi:
    every weight is an exact zero beyond |beta - beta_c| = hw pi (the JAX
    package's single source of truth for its slice-windowed scan, copied;
    ``feather``'s 1.2501 is a margin over its 1.25 pi edge)."""
    return {"full": 1.0, "pair": 1.0, "feather": 1.2501,
            "td": 1.5, "cosz": 1.5,
            "short": 0.5 + 0.5 * n_channels * dgamma / np.pi}[weighting]


def _window_constants(weighting, C, dgamma, pitch, row_h, R, sid):
    """The scalars of the JAX ``win_weight`` windows, computed in float64
    on the host as the JAX program's Python floats are (each enters the
    float32 program rounded once); ``hwpi`` bounds each slice's views."""
    return dict(
        hwpi=_helical_window_halfwidth(weighting, C, dgamma) * np.pi,
        pitch=pitch, qp=pitch / (4.0 * np.pi), nqp=-(pitch / (4.0 * np.pi)),
        taper=0.5 * row_h, hmax=0.5 * abs(pitch) + 0.25 * row_h,
        gm=0.5 * C * dgamma, pi_2gm=np.pi + 2.0 * (0.5 * C * dgamma),
        two_sid=2.0 * sid, hdet=0.5 * row_h * R + 0.5 * row_h,
        scale=max(0.25 * abs(pitch), 0.75 * row_h))


def _cos2(x):
    c = torch.cos(x)
    return c * c


def _window_weight(weighting, k, d, gam, zt, z, sz, h2, inv_h, sid):
    """The JAX ``win_weight`` of one weighting without its ``w_z`` factor,
    operation by operation in float32, every division between tensors.
    ``k``: :func:`_window_constants`; d = beta - beta_c ``[B, nz, 1]``;
    gam, h2, inv_h ``[B, 1, P]``; zt ``[B, nz, P]``; z ``[1, nz, 1]``; sz
    ``[B, 1, 1]``."""
    def t(v, like):
        return torch.full_like(like, v)

    pi = np.pi
    if weighting == "full":
        return (d.abs() <= pi).to(zt.dtype).expand_as(zt)
    if weighting == "feather":
        dd = d.abs() / t(pi, d)
        x = torch.clamp((dd - 0.75) / t(0.5, dd), 0.0, 1.0)
        return _cos2(x * (0.5 * pi)).expand_as(zt)
    if weighting == "td":
        cg = torch.cos(gam)
        two_g = 2.0 * gam
        htop = (k["qp"] * (pi - two_g)) / cg
        hbot = (k["nqp"] * (pi + two_g)) / cg
        tap = t(k["taper"], zt)
        w_td = (torch.clamp((zt - hbot) / tap, 0.0, 1.0)
                * torch.clamp((htop - zt) / tap, 0.0, 1.0))
        return w_td * (d.abs() <= 1.5 * pi).to(zt.dtype)
    if weighting == "cosz":
        kz = _cos2(torch.clamp(zt / t(k["hmax"], zt), -1.0, 1.0)
                   * (0.5 * pi)) + 1e-3
        return kz * (d.abs() <= 1.5 * pi).to(zt.dtype)
    if weighting == "short":
        gm = k["gm"]
        alpha = (d + 0.5 * pi) + gm  # [B, nz, 1]
        lo_den = torch.clamp_min(gm - gam, 1e-3)
        hi_den = torch.clamp_min(gm + gam, 1e-3)
        w_lo = torch.sin((0.25 * pi) * torch.clamp(alpha / lo_den, 0.0,
                                                   2.0)) ** 2
        w_hi = torch.sin((0.25 * pi) * torch.clamp(
            (k["pi_2gm"] - alpha) / hi_den, 0.0, 2.0)) ** 2
        one = torch.ones_like(w_lo)
        w_park = torch.where(alpha < 2.0 * (gm - gam), w_lo,
                             torch.where(alpha > pi - 2.0 * gam, w_hi, one))
        in_scan = (alpha >= 0.0) & (alpha <= k["pi_2gm"])
        return torch.where(in_scan, w_park, torch.zeros_like(w_park))
    if weighting == "pair":
        two_g = 2.0 * gam
        dbc = torch.where(d > -two_g, -(pi - two_g), pi + two_g)
        sz_conj = sz + (dbc * k["pitch"]) / t(2.0 * pi, dbc)
        h_own = h2 * inv_h
        h_conj = torch.clamp_min(k["two_sid"] * torch.cos(gam) - h_own, 1e-3)
        zt_c = ((z - sz_conj) * sid) / h_conj
        sc = t(k["scale"], zt)

        def kfun(v):
            return _cos2(torch.clamp(v / sc, -1.0, 1.0) * (0.5 * pi)) + 1e-4

        k_own = kfun(zt)
        k_c = kfun(zt_c) * (zt_c.abs() <= k["hdet"]).to(zt.dtype)
        w_pair = k_own / (k_own + k_c + 1e-30)
        return w_pair * (d.abs() <= pi).to(zt.dtype)
    raise ValueError(f"unknown helical weighting {weighting!r}")


def _helical_backproject_plain(q, betas, src_z, row_off, beta_c, sid, dgamma,
                               row_h, n_rows, pitch, n_matrix, nz_out, fov,
                               dz_out, z0, *, weighting="full", view_block=8):
    """``dexct_tpu.ops.conebeam._helical_backproject`` in torch: blocks of
    ``view_block`` views over every (disc pixel, slice); views outside a
    slice's window add exact zeros."""
    M, V, R, C = q.shape
    dev = q.device
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _helical_z(nz_out, dz_out, z0, dev)
    f32 = dict(device=dev, dtype=torch.float32)
    betas, src_z, row_off, beta_c = (t.to(**f32) for t in
                                     (betas, src_z, row_off, beta_c))
    k = _window_constants(weighting, C, dgamma, pitch, row_h, R, sid)
    qf = q.to(torch.float32).reshape(M, -1)
    num = qf.new_zeros((M, nz_out, X.shape[0]))
    den = qf.new_zeros((nz_out, X.shape[0]))
    for v0 in range(0, V, view_block):
        sl = slice(v0, v0 + view_block)
        beta, sz, ro = betas[sl], src_z[sl], row_off[sl]
        c0, fc, inv_h, w_amp, gam, h2 = _inplane(X, Y, beta, sid, dgamma, C)
        zt = ((zc[None, :] - sz[:, None]) * sid)[:, :, None] \
            * inv_h[:, None, :]  # [B, nz, P]
        ridx = (zt / torch.full_like(zt, row_h) - 0.5 + R / 2.0
                + ro[:, None, None])
        base = (torch.arange(v0, v0 + beta.shape[0], device=dev)
                * (R * C))[:, None, None]
        val, w_z = _bilinear(qf, base, c0[:, None, :], fc[:, None, :], ridx,
                             R, C)
        w = w_z * _window_weight(
            weighting, k, (beta[:, None] - beta_c[None, :])[:, :, None],
            gam[:, None, :], zt, zc[None, :, None], sz[:, None, None],
            h2[:, None, :], inv_h[:, None, :], sid)
        num += (val * (w_amp[:, None, :] * w)).sum(1)
        den += w.sum(0)
    out = torch.where(den > 0, num / torch.clamp_min(den, 1e-30),
                      torch.zeros_like(num))
    return _place(out * (2.0 * np.pi), sel, n_matrix)


def _helical_cuda(q, betas, src_z, row_off, beta_c, sid, dgamma, row_h,
                  pitch, n_matrix, nz_out, fov, dz_out, z0, dbeta, weighting):
    dev = q.device
    M, V, R, C = q.shape
    kernels.require(q, "q", dev, torch.float32)
    for name, t in (("betas", betas), ("src_z", src_z),
                    ("row_off", row_off)):
        kernels.require(t, name, dev, torch.float32, (V,))
    kernels.require(beta_c, "beta_c", dev, torch.float32, (nz_out,))
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _helical_z(nz_out, dz_out, z0, dev)
    cos_b, sin_b = torch.cos(betas), torch.sin(betas)
    beta0 = float(betas[0])  # the origin of each slice's view range
    k = _window_constants(weighting, C, dgamma, pitch, row_h, R, sid)
    out = torch.zeros((M, nz_out, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_helical_backproject(
        q.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), betas.data_ptr(),
        src_z.data_ptr(), row_off.data_ptr(), beta_c.data_ptr(),
        X.data_ptr(), Y.data_ptr(), sel.data_ptr(), zc.data_ptr(),
        out.data_ptr(), M, WEIGHTINGS.index(weighting), V, R, C, X.shape[0],
        nz_out, n_matrix * n_matrix, sid, dgamma, row_h, beta0, dbeta,
        *(k[name] for name in _WINDOW_ARGS), kernels.stream_ptr(dev))
    kernels.check(rc, "helical_backproject")
    _helical_backproject.launches += 1
    return out


# the window constants the kernel takes, in its argument order
_WINDOW_ARGS = ("hwpi", "pitch", "qp", "nqp", "taper", "hmax", "gm", "pi_2gm",
                "two_sid", "hdet", "scale")


def _helical_backproject(q, betas, src_z, row_off, beta_c, sid, dgamma,
                         row_h, n_rows, pitch, n_matrix, nz_out, fov, dz_out,
                         z0, *, dbeta, weighting="full", view_block=None,
                         pair_mode=None):
    """Generalized-Feldkamp backprojection of a helical orbit.

    Per (disc pixel, slice) each view inside the slice's window around
    ``beta_c`` adds its circular-FDK 1/h^2 weighted bilinear tap (rows
    shifted by the source's ``src_z`` and by ``row_off``) times its window
    weight w; the sum is normalised by the sum of w over the views on the
    detector and scaled by 2 pi.  ``weighting`` picks w (the JAX package's
    study windows, :data:`WEIGHTINGS`): ``full`` (|beta - beta_c| <= pi),
    ``feather`` (a cos^2 edge out to 1.25 pi), ``td`` (the Tam-Danielsson
    window within 1.5 pi), ``cosz`` (a cos^2 row-height kernel within
    1.5 pi), ``short`` (voxel-centred Parker short scan) or ``pair`` (the
    conjugate-pair row-height partition).  q: [M, V, R, C]; betas, src_z,
    row_off: [V], the views uniformly spaced, ``betas[v] = betas[0] + v
    dbeta`` (``dbeta > 0``), so that each slice visits only the views
    within the weighting's half-width of its ``beta_c`` (the terms dropped
    are exact zeros); beta_c: [nz_out].  Returns [M, nz_out, N, N].

    CUDA tensors run kernel K12 (counted in
    ``_helical_backproject.launches``); CPU tensors run
    :func:`_helical_backproject_plain`.  ``view_block`` and ``pair_mode``
    (TPU layouts of one image) are accepted and ignored.
    """
    del view_block, pair_mode
    if weighting not in WEIGHTINGS:
        raise ValueError(f"unknown helical weighting {weighting!r}")
    _check_stack(q, "q")
    if q.shape[2] != n_rows:
        raise ValueError(f"q has {q.shape[2]} rows, n_rows={n_rows}")
    if not dbeta > 0.0:
        raise ValueError(f"dbeta must be > 0, got {dbeta}")
    geo = (float(sid), float(dgamma), float(row_h))
    grid = (int(n_matrix), int(nz_out), float(fov), float(dz_out), float(z0))
    if q.is_cuda:
        return _helical_cuda(q, betas, src_z, row_off, beta_c, *geo,
                             float(pitch), *grid, float(dbeta), weighting)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return _helical_backproject_plain(q, betas, src_z, row_off, beta_c, *geo,
                                      int(n_rows), float(pitch), *grid,
                                      weighting=weighting)


_helical_backproject.launches = 0


# ---------------------------------------------------------------------------
# K18 / K19: the exact 3-D projector of a volume and its adjoint
# ---------------------------------------------------------------------------

def _rays(src, dirs, dtype, device):
    return (src.reshape(-1, 3).to(device=device, dtype=dtype),
            dirs.reshape(-1, 3).to(device=device, dtype=dtype))


def project_volume_3d_plain(vol, src, dirs, dx, dy, dz, *, n_steps=None):
    """``dexct_tpu.ops.conebeam.project_volume_3d`` in torch: the walk of
    :func:`_walk_3d`, adding segment x voxel value per step (float64 for a
    float64 volume)."""
    dtype = torch.promote_types(vol.dtype, torch.float32)
    p, d = _rays(src, dirs, dtype, vol.device)
    flat = vol.reshape(-1).to(dtype)
    acc = torch.zeros(p.shape[0], dtype=dtype, device=vol.device)
    k = _max_steps(vol.shape) if n_steps is None else int(n_steps)
    for lin, seg in _walk_3d(vol.shape, p, d, dx, dy, dz, k):
        acc += seg * flat[lin]
    return acc.reshape(src.shape[:-1])


def project_volume_3d_adjoint_plain(y, src, dirs, vol_shape, dx, dy, dz, *,
                                    n_steps=None):
    """The adjoint of :func:`project_volume_3d_plain`: the same walk, each
    step's segment x ``y[ray]`` added into its cell (``index_add_``)."""
    vol_shape = tuple(int(n) for n in vol_shape)
    dtype = torch.promote_types(y.dtype, torch.float32)
    p, d = _rays(src, dirs, dtype, y.device)
    yf = y.reshape(-1).to(dtype)
    out = torch.zeros(int(np.prod(vol_shape)), dtype=dtype, device=y.device)
    k = _max_steps(vol_shape) if n_steps is None else int(n_steps)
    for lin, seg in _walk_3d(vol_shape, p, d, dx, dy, dz, k):
        out.index_add_(0, lin, seg * yf)
    return out.reshape(vol_shape)


def _walk_args(shape, dx, dy, dz, n_steps):
    """The kernels' grid arguments after the ray count."""
    nz, ny, nx = shape
    g0, g1, eps = _grid_3d(shape, dx, dy, dz)
    return (nx, ny, nz, *g0, *g1, dx, dy, dz, eps, n_steps)


def _project_cuda(vol, src, dirs, dx, dy, dz, n_steps):
    dev = vol.device
    kernels.require(vol, "vol", dev, torch.float32)
    s2 = kernels.require(src.reshape(-1, 3), "src", dev, torch.float32)
    d2 = kernels.require(dirs.reshape(-1, 3), "dirs", dev, torch.float32,
                         s2.shape)
    out = torch.empty(s2.shape[0], dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_project_3d(
        vol.data_ptr(), s2.data_ptr(), d2.data_ptr(), out.data_ptr(),
        s2.shape[0], *_walk_args(vol.shape, dx, dy, dz, n_steps),
        kernels.stream_ptr(dev))
    kernels.check(rc, "project_3d")
    project_volume_3d.launches += 1
    return out.reshape(src.shape[:-1])


def _adjoint_cuda(y, src, dirs, vol_shape, dx, dy, dz, n_steps):
    dev = y.device
    s2 = kernels.require(src.reshape(-1, 3), "src", dev, torch.float32)
    d2 = kernels.require(dirs.reshape(-1, 3), "dirs", dev, torch.float32,
                         s2.shape)
    y2 = kernels.require(y.reshape(-1), "y", dev, torch.float32,
                         (s2.shape[0],))
    out = torch.zeros(vol_shape, dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_backproject_3d(
        y2.data_ptr(), s2.data_ptr(), d2.data_ptr(), out.data_ptr(),
        s2.shape[0], *_walk_args(vol_shape, dx, dy, dz, n_steps),
        kernels.stream_ptr(dev))
    kernels.check(rc, "backproject_3d")
    project_volume_3d_adjoint.launches += 1
    return out


def _check_volume_shape(vol_shape):
    if len(vol_shape) != 3 or min(vol_shape) < 1:
        raise ValueError(f"the volume must be [Nz, Ny, Nx], got "
                         f"{tuple(vol_shape)}")


def _project(vol, src, dirs, dx, dy, dz, n_steps):
    if vol.is_cuda:
        return _project_cuda(vol, src, dirs, dx, dy, dz, n_steps)
    if vol.device.type != "cpu":
        raise ValueError(f"unsupported device {vol.device}")
    return project_volume_3d_plain(vol, src, dirs, dx, dy, dz,
                                   n_steps=n_steps)


def project_volume_3d_adjoint(y, src, dirs, vol_shape, dx, dy, dz, *,
                              n_steps=None):
    """A^T y: the exact adjoint of :func:`project_volume_3d` (the JAX
    package's ``jax.linear_transpose`` of it), ``y [...]`` over the rays'
    batch shape -> ``[Nz, Ny, Nx]``.  CUDA tensors run kernel K19 (float32
    atomic adds, counted in ``project_volume_3d_adjoint.launches``); CPU
    tensors run :func:`project_volume_3d_adjoint_plain`."""
    vol_shape = tuple(int(n) for n in vol_shape)
    _check_volume_shape(vol_shape)
    k = _max_steps(vol_shape) if n_steps is None else int(n_steps)
    args = (float(dx), float(dy), float(dz))
    if y.is_cuda:
        return _adjoint_cuda(y, src, dirs, vol_shape, *args, k)
    if y.device.type != "cpu":
        raise ValueError(f"unsupported device {y.device}")
    return project_volume_3d_adjoint_plain(y, src, dirs, vol_shape, *args,
                                           n_steps=k)


project_volume_3d_adjoint.launches = 0


class _Project3D(torch.autograd.Function):
    """The projector with its adjoint as the backward pass."""

    @staticmethod
    def forward(ctx, vol, src, dirs, grid):
        ctx.save_for_backward(src, dirs)
        ctx.grid, ctx.vol_shape = grid, tuple(vol.shape)
        return _project(vol, src, dirs, *grid)

    @staticmethod
    def backward(ctx, grad):
        src, dirs = ctx.saved_tensors
        dx, dy, dz, k = ctx.grid
        g = project_volume_3d_adjoint(grad.contiguous(), src, dirs,
                                      ctx.vol_shape, dx, dy, dz, n_steps=k)
        return g, None, None, None


def project_volume_3d(vol, src, dirs, dx, dy, dz, *, n_steps=None):
    """Exact line integrals of a continuous mu volume ``[Nz, Ny, Nx]`` (the
    grid centred on the origin, voxels dx, dy, dz [cm]) along the rays
    ``src``, ``dirs [..., 3]`` (origins and unit directions): the 3-D Siddon
    walk of :func:`trace_paths_3d`, adding segment x voxel value.  Returns
    ``[...]``.  ``n_steps`` caps the walk (default Nx + Ny + Nz + 2, enough
    for every ray).  A linear operator; autograd's backward pass is its
    exact adjoint, :func:`project_volume_3d_adjoint`.

    CUDA tensors run kernel K18 (counted in ``project_volume_3d.launches``);
    CPU tensors run :func:`project_volume_3d_plain`.
    """
    _check_volume_shape(vol.shape)
    k = _max_steps(vol.shape) if n_steps is None else int(n_steps)
    return _Project3D.apply(vol, src, dirs,
                            (float(dx), float(dy), float(dz), k))


project_volume_3d.launches = 0


def _cone_operator(geometry, vol_shape, voxel, device):
    """(A, A^T) of a cone geometry's rays on ``device``: the projector and
    its explicit adjoint, as the iterative loops call them."""
    src, dirs = (torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                 device=device).contiguous()
                 for x in geometry.ray_geometry_3d())
    dx, dy, dz = (float(v) for v in voxel)
    shape = tuple(int(n) for n in vol_shape)

    def apply_fn(vol):
        return project_volume_3d(vol, src, dirs, dx, dy, dz)

    def adjoint_fn(y):
        return project_volume_3d_adjoint(y, src, dirs, shape, dx, dy, dz)

    return apply_fn, adjoint_fn


def _device_of(x, device):
    if device is not None:
        return torch.device(device)
    return x.device if torch.is_tensor(x) else torch.device("cuda")


def cone_cg_recon(sino, geometry, vol_shape, voxel, *, n_iters=30, x0=None,
                  device=None):
    """Conjugate-gradient least-squares cone-beam reconstruction: solves
    min_x ||A x - sino||^2 with A the exact 3-D projector
    (:func:`project_volume_3d`, K18) over the geometry's rays and A^T its
    adjoint (K19).  ``vol_shape``: (Nz, Ny, Nx); ``voxel``: (dx, dy, dz)
    [cm]; ``x0`` the start (zeros by default).  Runs on ``device`` (default:
    the device of ``sino`` if it is a tensor, else the card).  Returns
    ``(volume [Nz, Ny, Nx] cm^-1, residual-norm history [n_iters])``."""
    from .iterative import _cg

    dev = _device_of(sino, device)
    apply_fn, adjoint_fn = _cone_operator(geometry, vol_shape, voxel, dev)
    b = torch.as_tensor(sino, dtype=torch.float32, device=dev)
    x0 = (torch.zeros(tuple(vol_shape), dtype=torch.float32, device=dev)
          if x0 is None else torch.as_tensor(x0, dtype=torch.float32,
                                             device=dev))
    return _cg(apply_fn, b, x0, int(n_iters), 0.0, adjoint=adjoint_fn)


def cone_pwls_recon(sino_log, counts, geometry, vol_shape, voxel, *,
                    n_iters=60, beta=1e-2, delta=5e-3, nonneg=True, x0=None,
                    power_iters=12, sigma_e=0.0, var_ratio=1.0, device=None,
                    _v0=None):
    """3-D penalized weighted least-squares reconstruction: the
    count-weighted data term over the exact 3-D projector (K18, adjoint
    K19) plus the 6-neighbour edge-preserving Huber penalty, solved by
    FISTA (:func:`~dexct_tpu_torch.ops.iterative._pwls_fista`).  ``beta`` is
    relative to ||A^T W A||, estimated by ``power_iters`` power iterations
    from a normal start vector drawn by a ``torch.Generator`` seeded 0.
    Warm-start ``x0`` from :func:`fdk_reconstruct`.  Runs on ``device``
    (default: the device of ``sino_log`` if it is a tensor, else the card).
    Returns the [Nz, Ny, Nx] volume in cm^-1."""
    from .iterative import _pwls_fista, pwls_weights

    dev = _device_of(sino_log, device)
    apply_fn, adjoint_fn = _cone_operator(geometry, vol_shape, voxel, dev)
    y = torch.as_tensor(sino_log, dtype=torch.float32, device=dev)
    w = pwls_weights(torch.as_tensor(counts, device=dev), sigma_e=sigma_e,
                     var_ratio=var_ratio)
    x0 = (torch.zeros(tuple(vol_shape), dtype=torch.float32, device=dev)
          if x0 is None else torch.as_tensor(x0, dtype=torch.float32,
                                             device=dev))
    return _pwls_fista(apply_fn, y, w, x0, int(n_iters), float(beta),
                       float(delta), bool(nonneg), int(power_iters),
                       adjoint=adjoint_fn, _v0=_v0)


# ---------------------------------------------------------------------------
# K16: trilinear resample
# ---------------------------------------------------------------------------

def _trilinear_volume_sample_plain(vol, zi, yi, xi):
    """``dexct_tpu.ops.conebeam._trilinear_volume_sample`` in torch: the
    eight corners summed z, then y, then x, each weighted ((wz wy) wx)."""
    nz, ny, nx = vol.shape[-3:]
    zi, yi, xi = (t.to(torch.float32) for t in
                  torch.broadcast_tensors(zi, yi, xi))
    corner, frac = [], []
    for t, n in ((zi, nz), (yi, ny), (xi, nx)):
        t0 = torch.clamp(torch.floor(t), 0, n - 2)
        corner.append(t0.to(torch.int64))
        frac.append(torch.clamp(t - t0, 0.0, 1.0))
    ok = ((zi >= 0.0) & (zi <= nz - 1.0) & (yi >= 0.0) & (yi <= ny - 1.0)
          & (xi >= 0.0) & (xi <= nx - 1.0))
    (z0, y0, x0), (fz, fy, fx) = corner, frac
    acc = None
    for dz_ in (0, 1):
        wz = fz if dz_ else 1.0 - fz
        for dy_ in (0, 1):
            wy = fy if dy_ else 1.0 - fy
            for dx_ in (0, 1):
                wx = fx if dx_ else 1.0 - fx
                term = (wz * wy * wx) * vol[..., z0 + dz_, y0 + dy_, x0 + dx_]
                acc = term if acc is None else acc + term
    return acc * ok.to(acc.dtype)


@functools.lru_cache(maxsize=64)
def _index_layout(shapes, strides):
    """K16's view of three index tensors of ``shapes`` and element
    ``strides`` as they broadcast together, without making the broadcast
    views: ``(shape, sizes, strides3)``, the output's trailing shape, that
    shape as three axes, and each tensor's strides along them (0 on
    broadcast axes).  Size-1 axes are dropped, neighbouring axes merged
    where all three tensors' strides allow, and the result padded in front
    with size-1 axes; ``sizes`` and ``strides3`` are ``None`` when more
    than three axes remain.  Cached: a path calls K16 on the same layouts
    again and again, and the host time of a call is what bounds it."""
    rank = max(len(sz) for sz in shapes)
    shape = [1] * rank
    views = []
    for sz, st in zip(shapes, strides):
        pad = rank - len(sz)
        sz, st = (1,) * pad + tuple(sz), (0,) * pad + tuple(st)
        for d, n in enumerate(sz):
            if n != 1 and shape[d] != n:
                if shape[d] != 1:
                    raise ValueError(f"index shapes {list(shapes)} do not "
                                     "broadcast")
                shape[d] = n
        views.append((sz, st))
    sizes, axes = [], []
    for d, n in enumerate(shape):
        if n == 1:
            continue
        st = tuple(s[d] if sz[d] != 1 else 0 for sz, s in views)
        if sizes and axes[-1] == tuple(s * n for s in st):
            sizes[-1] *= n
            axes[-1] = st
        else:
            sizes.append(n)
            axes.append(st)
    pad = 3 - len(sizes)
    if pad < 0:
        return tuple(shape), None, None
    axes = [(0,) * len(views)] * pad + axes
    return (tuple(shape), (1,) * pad + tuple(sizes),
            tuple(tuple(a[i] for a in axes) for i in range(len(views))))


def _trilinear_cuda(vol, zi, yi, xi):
    """K16 on CUDA tensors.  The indices are read through their own
    strides, broadcast or not: no copy of a float32 index tensor.  The
    host work is kept small (no ``torch.broadcast_*`` call, a cached
    layout): at the tilted shape the kernel takes ~0.03 ms (NVIDIA H100
    80GB HBM3, 700.00 W)."""
    dev = vol.device
    nz, ny, nx = vol.shape[-3:]
    vols = kernels.require(vol.reshape(-1, nz, ny, nx).contiguous(), "vol",
                           dev, torch.float32)
    idx = []
    for t, name in ((zi, "zi"), (yi, "yi"), (xi, "xi")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.is_neg():
            raise ValueError(f"{name} carries a lazy negation; resolve it "
                             "first")
        idx.append(t if t.dtype == torch.float32 else t.to(torch.float32))
    shape, sizes, strides = _index_layout(
        tuple(t.shape for t in idx), tuple(t.stride() for t in idx))
    if sizes is None:  # more than three unmergeable axes
        idx = [t.contiguous() for t in torch.broadcast_tensors(*idx)]
        shape, sizes, strides = _index_layout(
            tuple(t.shape for t in idx), tuple(t.stride() for t in idx))
    out = torch.empty((*vol.shape[:-3], *shape), dtype=torch.float32,
                      device=dev)
    rc = kernels.library().dexct_trilinear_sample(
        vols.data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(),
        idx[2].data_ptr(), out.data_ptr(), vols.shape[0], *sizes,
        *strides[0], *strides[1], *strides[2], nz, ny, nx,
        kernels.stream_ptr(dev))
    kernels.check(rc, "trilinear_sample")
    _trilinear_volume_sample.launches += 1
    return out


def _trilinear_volume_sample(vol, zi, yi, xi):
    """Trilinear sample of ``vol [..., nz, ny, nx]`` (each axis >= 2) at
    the continuous indices ``zi``, ``yi``, ``xi`` (broadcast together to
    the output's trailing shape); points outside the index box give 0.

    CUDA tensors run kernel K16 (counted in
    ``_trilinear_volume_sample.launches``); CPU tensors run
    :func:`_trilinear_volume_sample_plain`.
    """
    if min(vol.shape[-3:]) < 2:
        raise ValueError(f"each volume axis needs 2 samples, got "
                         f"{tuple(vol.shape[-3:])}")
    if vol.is_cuda:
        return _trilinear_cuda(vol, zi, yi, xi)
    if vol.device.type != "cpu":
        raise ValueError(f"unsupported device {vol.device}")
    return _trilinear_volume_sample_plain(vol, zi, yi, xi)


_trilinear_volume_sample.launches = 0


# ---------------------------------------------------------------------------
# The stateless 3-D branch: reconstructors and simulate_cone_dect
# ---------------------------------------------------------------------------

def _fdk_filter(sino_log, weights, ct, ramp, window):
    """Pre-weight ``[..., V, R, C]`` data by the host table ``weights``
    (float64, broadcast against it), ramp-filter along channels (cuFFT on
    the card) and scale by dgamma: the JAX FDK filter chain."""
    from .fbp import filter_views
    from .filters import filter_frequency_response

    dev = sino_log.device
    C = sino_log.shape[-1]
    H, m = filter_frequency_response(C, ct.dgamma, ramp, window, "fan")
    f32 = dict(dtype=torch.float32, device=dev)
    return filter_views(sino_log.to(torch.float32),
                        torch.as_tensor(weights, **f32),
                        torch.as_tensor(H, **f32), m, ct.dgamma).contiguous()


def _fdk_weights(ct):
    """The FDK pre-weight cos(gamma) cos(kappa) SID, [R, C] (float64)."""
    cosg = np.cos(ct.gammas)
    cosk = ct.SID / np.sqrt(ct.SID ** 2 + np.asarray(ct.z_iso) ** 2)
    return cosg[None, :] * cosk[:, None] * ct.SID


def _fdk_filter_zffs(sino_log, ct, ramp, window="sinc"):
    """Filtered, preweighted projections of a z-FFS scan ``[..., V, R,
    C]``: the static chain with each view's true deflected-ray cone factor
    ``cos(kappa) = SDD / sqrt(SDD^2 + (z_det[r] - delta_v)^2)``."""
    cosg = np.cos(ct.gammas)
    z_det = np.asarray(ct.z_iso) * ct.SDD / ct.SID
    off = np.asarray(ct.ffs_view_offsets, np.float64)
    cosk = ct.SDD / np.sqrt(ct.SDD ** 2
                            + (z_det[None, :] - off[:, None]) ** 2)
    w = cosg[None, None, :] * cosk[:, :, None] * ct.SID
    return _fdk_filter(sino_log, w, ct, ramp, window)


def _stack(sino_log, name="sino_log"):
    """``[V, R, C]`` or ``[M, V, R, C]`` -> (4-D stack, was it 3-D)."""
    if sino_log.dim() not in (3, 4):
        raise ValueError(f"{name} must be [V, R, C] or [M, V, R, C]")
    single = sino_log.dim() == 3
    return (sino_log[None] if single else sino_log), single


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def fdk_reconstruct(sino_log, geometry, n_matrix, fov, ramp, *, nz_out=None,
                    dz_out=None, window="sinc", view_block=None):
    """FDK cone-beam reconstruction -> ``[nz_out, N, N]`` in cm^-1 (or
    ``[M, nz_out, N, N]`` for a stack ``[M, V, R, C]``, all volumes in one
    backprojection).

    ``sino_log``: ``[V, R, C]`` line integrals of a circular
    :class:`~dexct_tpu_torch.system.geometry.ConeBeamGeometry` scan; the
    z grid defaults to one slice per row at the isocenter pitch.  The FDK
    pre-weight and ramp filter (cuFFT on the card), then K11.  A z
    flying-focal-spot scan (``ffs='z'``) takes each view's true cone factor
    and row offset and backprojects through the helical K12 at pitch 0
    with the window centred on the orbit, which then covers every view.
    ``view_block`` (a TPU view-block layout) is accepted and ignored.
    """
    del view_block
    ct = geometry
    if abs(getattr(ct, "pitch", 0.0)) > 1e-12:
        raise ValueError(
            "geometry has a helical pitch; use helical_fdk_reconstruct "
            "(the circular FDK assumes a z=0 source orbit)"
        )
    if abs(getattr(ct, "tilt", 0.0)) > 1e-12:
        raise ValueError(
            "geometry has a gantry tilt; use fdk_tilted_reconstruct "
            "(the circular FDK assumes a z=0 source orbit)")
    if getattr(ct, "flat_panel", False):
        raise ValueError(
            "flat-panel geometries reconstruct with "
            "ops.flatpanel.fdk_flat_reconstruct (equidistant columns; "
            "this FDK assumes an equiangular cylindrical detector)")
    stack, single = _stack(sino_log)
    V, R, C = stack.shape[-3:]
    if R != ct.N_rows:
        raise ValueError(f"sinogram has {R} rows, geometry {ct.N_rows}")
    nz = R if nz_out is None else int(nz_out)
    dz = float(ct.h_iso if dz_out is None else dz_out)
    dev = stack.device
    betas = _f32(ct.betas, dev)
    dbeta = float(ct.rotation_total / V)
    if getattr(ct, "ffs", "none") == "z":
        q = _fdk_filter_zffs(stack, ct, ramp, window)
        off = np.asarray(ct.ffs_view_offsets, np.float64)
        row_off = off * ct.SID / (ct.SDD * ct.h_iso)
        z0 = (0.5 - nz / 2.0) * dz
        beta_c = np.full(nz, 0.5 * ct.rotation_total)
        out = _helical_backproject(
            q, betas, _f32(off, dev), _f32(row_off, dev), _f32(beta_c, dev),
            float(ct.SID), float(ct.dgamma), float(ct.h_iso), int(R), 0.0,
            int(n_matrix), nz, float(fov), dz, float(z0), dbeta=dbeta)
    else:
        q = _fdk_filter(stack, _fdk_weights(ct), ct, ramp, window)
        out = _fdk_backproject_multi(
            q, betas, float(ct.SID), float(ct.dgamma), float(ct.h_iso),
            int(R), int(n_matrix), nz, float(fov), dz, dbeta)
    return out[0] if single else out


def fdk_tilted_reconstruct(sino_log, geometry, n_matrix, fov, ramp, *,
                           nz_out=None, dz_out=None, window="sinc",
                           view_block=None):
    """Gantry-tilted circular cone-beam FDK -> ``[nz, N, N]`` cm^-1 on the
    patient-frame grid (``[M, nz, N, N]`` for a stack).

    A tilted scan is a circular scan of the rotated patient: the data are
    filtered and backprojected (K11, all volumes at once) in the gantry
    frame (``geometry.untilted()``) on a grid enlarged to cover the
    rotated patient box, then resampled onto the patient grid by one
    trilinear pass (K16).  Patient points whose gantry image falls outside
    the scanned FOV come back 0.  ``tilt = 0`` is :func:`fdk_reconstruct`
    of each volume.  ``view_block`` (a TPU view-block layout) is accepted and
    ignored.
    """
    del view_block
    ct = geometry
    tau = float(getattr(ct, "tilt", 0.0))
    stack, single = _stack(sino_log)
    V, R, C = stack.shape[-3:]
    if R != ct.N_rows:
        raise ValueError(f"sinogram has {R} rows, geometry {ct.N_rows}")
    nz = R if nz_out is None else int(nz_out)
    dz = float(ct.h_iso if dz_out is None else dz_out)
    ct_g = ct.untilted() if hasattr(ct, "untilted") else ct
    if abs(tau) < 1e-12:
        out = torch.stack([
            fdk_reconstruct(s, ct_g, n_matrix, fov, ramp, nz_out=nz,
                            dz_out=dz, window=window) for s in stack])
        return out[0] if single else out

    n_g, fov_g, nz_g = _tilted_grid(tau, n_matrix, fov, nz, dz)
    dev = stack.device
    q = _fdk_filter(stack, _fdk_weights(ct_g), ct_g, ramp, window)
    vols = _fdk_backproject_multi(
        q, _f32(ct_g.betas, dev), float(ct_g.SID), float(ct_g.dgamma),
        float(ct_g.h_iso), int(R), n_g, nz_g, float(fov_g), dz,
        float(ct_g.rotation_total / V))
    out = _trilinear_volume_sample(
        vols, *_tilted_indices(tau, n_matrix, fov, nz, dz, dev))
    return out[0] if single else out


def _tilted_grid(tau, n_matrix, fov, nz, dz):
    """``(n_g, fov_g, nz_g)``: the gantry grid covering R_x(-tau) of the
    patient grid at the same pixel and slice pitch; x is unchanged by the
    tilt, so it keeps the full fov."""
    c_t, s_t = abs(np.cos(tau)), abs(np.sin(tau))
    px = fov / n_matrix
    z_half = 0.5 * nz * dz
    fov_g = max(fov, fov * c_t + 2.0 * z_half * s_t) + 2.0 * px
    n_g = int(-(-fov_g / px // 2) * 2)
    zg_half = 0.5 * fov * s_t + z_half * c_t + dz
    nz_g = int(-(-2.0 * zg_half / dz // 2) * 2)
    return n_g, n_g * px, nz_g


def _tilted_indices(tau, n_matrix, fov, nz, dz, device):
    """The gantry-grid indices ``(zi, yi, xi)`` of the patient grid's voxel
    centres, shaped to broadcast to ``[nz, N, N]``: R_x(-tau) in float32,
    operation by operation as the JAX program."""
    n_g, fov_g, nz_g = _tilted_grid(tau, n_matrix, fov, nz, dz)
    f32 = np.float32
    px = fov / n_matrix
    xs = ((np.arange(n_matrix) + 0.5 - n_matrix / 2) * px).astype(f32)
    zs = ((np.arange(nz) + 0.5 - nz / 2) * dz).astype(f32)
    ct_, st_ = f32(np.cos(tau)), f32(np.sin(tau))
    y_g = ct_ * xs[None, :] + st_ * zs[:, None]  # [nz, N]
    z_g = -st_ * xs[None, :] + ct_ * zs[:, None]
    px_g = fov_g / n_g
    yi = (y_g / px_g + n_g / 2 - 0.5)[:, :, None]
    zi = (z_g / dz + nz_g / 2 - 0.5)[:, :, None]
    xi = (xs / px_g + n_g / 2 - 0.5)[None, None, :]
    return tuple(torch.as_tensor(t, device=device) for t in (zi, yi, xi))


def helical_slices(ct, z_out=None):
    """``(z_out [nz] float64, dz)``: the helical reconstructors' slice grid,
    by default one slice per ``h_iso`` over the central 80 % of the source
    travel; a given ``z_out`` must be uniformly spaced."""
    if z_out is None:
        travel = ct.pitch * ct.rotation_total / (2.0 * np.pi)
        half = 0.4 * travel
        nz = max(int(2.0 * half / ct.h_iso), 1)
        z_out = (np.arange(nz) + 0.5) * (2.0 * half / nz) - half
    z_out = np.asarray(z_out, np.float64)
    if len(z_out) > 1:
        dzs = np.diff(z_out)
        if not np.allclose(dzs, dzs[0]):
            raise ValueError("z_out must be uniformly spaced")
        return z_out, float(dzs[0])
    return z_out, float(ct.h_iso)


def helical_fdk_reconstruct(sino_log, geometry, n_matrix, fov, ramp, *,
                            z_out=None, window="sinc", view_block=None,
                            weighting="full"):
    """Helical generalized-Feldkamp reconstruction -> ``[nz, N, N]``
    cm^-1 (``[M, nz, N, N]`` for a stack, all volumes in one K12 pass).

    ``z_out``: uniformly spaced slice positions [cm]; by default one slice
    per ``h_iso`` across the central 80 % of the source travel.  The FDK
    filter chain (each view's own cone factor for a z flying focal spot),
    then K12.  ``pitch = 0`` delegates to :func:`fdk_reconstruct`.
    ``weighting`` picks the per-voxel view window (:data:`WEIGHTINGS`, see
    :func:`_helical_backproject`; the JAX package's round-3 study measured
    ``full`` best); a z flying focal spot takes ``full`` or ``feather``.
    ``view_block`` (a TPU view-block layout) is accepted and ignored.
    """
    del view_block
    ct = geometry
    stack, single = _stack(sino_log)
    V, R, C = stack.shape[-3:]
    if R != ct.N_rows:
        raise ValueError(f"sinogram has {R} rows, geometry {ct.N_rows}")
    if abs(getattr(ct, "pitch", 0.0)) < 1e-12:
        kw = {}
        if z_out is not None:
            zo = np.asarray(z_out, np.float64)
            dzs = np.diff(zo)
            if len(zo) > 1 and not np.allclose(dzs, dzs[0]):
                raise ValueError("z_out must be uniformly spaced")
            dz0 = float(dzs[0]) if len(zo) > 1 else float(ct.h_iso)
            if abs(zo.mean()) > 1e-9 + 1e-6 * abs(dz0):
                raise ValueError(
                    "circular FDK slice grids are centered on z=0; "
                    f"got mean z {zo.mean():g}")
            kw = dict(nz_out=len(zo), dz_out=dz0)
        return fdk_reconstruct(sino_log, ct, n_matrix, fov, ramp,
                               window=window, **kw)
    z_out, dz = helical_slices(ct, z_out)

    if getattr(ct, "ffs", "none") == "z":
        if weighting not in ("full", "feather"):
            raise ValueError(
                "z-FFS helical reconstruction supports the 'full' and "
                f"'feather' weightings (got {weighting!r}); the other "
                "study windows assume a static spot")
        q = _fdk_filter_zffs(stack, ct, ramp, window)
    else:
        q = _fdk_filter(stack, _fdk_weights(ct), ct, ramp, window)
    if weighting not in WEIGHTINGS:
        raise ValueError(f"unknown helical weighting {weighting!r}")
    dev = stack.device
    off = np.asarray(ct.ffs_view_offsets, np.float64)  # zeros if none
    sz = np.asarray(ct.source_z, np.float64) + off
    row_off = off * ct.SID / (ct.SDD * ct.h_iso)
    beta_c = 0.5 * ct.rotation_total + 2.0 * np.pi * z_out / ct.pitch
    dbeta = (float(ct.betas[1] - ct.betas[0]) if V > 1
             else float(ct.rotation_total))
    out = _helical_backproject(
        q, _f32(ct.betas, dev), _f32(sz, dev), _f32(row_off, dev),
        _f32(beta_c, dev), float(ct.SID), float(ct.dgamma),
        float(ct.h_iso), int(R), float(ct.pitch), int(n_matrix),
        len(z_out), float(fov), dz, float(z_out[0]), dbeta=dbeta,
        weighting=weighting)
    return out[0] if single else out


def cone_material_paths(phantom, geometry, *, device, dtype=None,
                        view_block=None, method="auto"):
    """``[N_proj, N_rows, N_channels, n_materials]`` exact cone-beam paths
    of the geometry's rays (``ray_geometry_3d``, exact for every cone
    geometry: tilted, flat-panel, z flying focal spot), traced by K10 on
    ``device`` in float32 (``dtype`` must be float32 or None).  The JAX
    package's packed dominant-axis tracers and their DDA fallback compute
    the same paths, so its ``method`` choice is accepted and ignored, as is
    ``view_block`` (a TPU view-block layout)."""
    del view_block, method
    check_float32(dtype)
    src, dirs = geometry.ray_geometry_3d()
    return trace_paths_3d(
        labels_u8(np.asarray(phantom.labels), device), _f32(src, device),
        _f32(dirs, device), phantom.dx, phantom.dy, phantom.dz,
        n_materials=phantom.n_materials)


def cone_sinogram(phantom, geometry, spectrum, *, device, dtype=None,
                  view_block=None):
    """Polyenergetic cone-beam acquisition -> (counts, log sinogram), both
    ``[N_proj, N_rows, N_channels]`` on ``device``, in float32 (``dtype``
    must be float32 or None).  ``view_block`` (a TPU view-block layout) is
    accepted and ignored."""
    del view_block
    check_float32(dtype)
    from . import spectral as sp_ops

    paths = cone_material_paths(phantom, geometry, device=device)
    mu_t = _f32(phantom.materials.mu_table(spectrum.E), device)
    i0 = sp_ops.effective_fluence(spectrum, geometry)
    counts = sp_ops.counts_from_paths(paths, mu_t, _f32(i0, device))
    return counts, sp_ops.log_sinogram(counts, float(np.sum(i0)))


RECONS_3D = ("auto", "fdk", "helical", "tilted", "flat", "katsevich")


def reconstruct_3d(stack, ct, n_matrix, fov, ramp, *, recon="auto",
                   **recon_kw):
    """Reconstruct ``[M, V, R, C]`` (or ``[V, R, C]``) by ``recon`` (one of
    :data:`RECONS_3D`), all volumes in one pass: the stateless branch's
    dispatch.  ``'auto'`` picks flat for a flat panel, tilted for a tilted
    gantry, helical for a helix and fdk otherwise; ``'katsevich'`` takes
    ``ramp`` to apodize its derivative."""
    if recon not in RECONS_3D:
        raise ValueError(f"unknown recon {recon!r}")
    if recon == "auto":  # helical geometries must not reach circular FDK
        if getattr(ct, "flat_panel", False):
            recon = "flat"
        elif abs(getattr(ct, "tilt", 0.0)) > 1e-12:
            recon = "tilted"
        else:
            recon = ("helical" if abs(getattr(ct, "pitch", 0.0)) > 1e-12
                     else "fdk")
    if recon == "katsevich":
        from .katsevich import katsevich_reconstruct

        return katsevich_reconstruct(stack, ct, n_matrix, fov, ramp=ramp,
                                     **recon_kw)
    if recon == "flat":
        from .flatpanel import fdk_flat_reconstruct

        return fdk_flat_reconstruct(stack, ct, n_matrix, fov, ramp,
                                    **recon_kw)
    fn = {"helical": helical_fdk_reconstruct,
          "tilted": fdk_tilted_reconstruct,
          "fdk": fdk_reconstruct}[recon]
    return fn(stack, ct, n_matrix, fov, ramp, **recon_kw)


def simulate_cone_dect(ct, phantom, spec1, spec2, n_matrix, fov, ramp, *,
                       device, n_iters=10, noise="none", generator=None,
                       recon="auto", mask_thresh=0.95, do_recon=True,
                       heel=None, **recon_kw):
    """The stateless 3-D dual-energy pipeline on ``device``: trace once
    (K10) -> two polyenergetic acquisitions (K2) -> Gauss-Newton
    decomposition (K3) with the air mask ``c1 >= mask_thresh * max(c1)``
    -> reconstruction of both single-energy volumes and both basis
    volumes.

    ``recon``: ``'fdk'`` (:func:`fdk_reconstruct`), ``'helical'``
    (:func:`helical_fdk_reconstruct`), ``'tilted'``
    (:func:`fdk_tilted_reconstruct`), ``'flat'``
    (:func:`~dexct_tpu_torch.ops.flatpanel.fdk_flat_reconstruct`),
    ``'katsevich'``
    (:func:`~dexct_tpu_torch.ops.katsevich.katsevich_reconstruct`) or
    ``'auto'``, dispatched by :func:`reconstruct_3d`, which reconstructs
    the four volumes in one pass.  Noise is
    drawn from ``generator`` (a ``torch.Generator`` on ``device``; seed 0 if
    none), spectrum 1 first.  Returns the JAX package's dict: ``sino_raw``,
    ``sino_log``, ``mat_sinos`` pairs ``[V, R, C]`` and ``recon_raw``,
    ``recon_HU``, ``mat_recons`` pairs ``[nz, N, N]`` (``None`` when
    ``do_recon`` is false).  ``heel`` (:class:`~dexct_tpu_torch.ops.heel.
    HeelEffect`) puts the anode heel under both acquisitions: per-row
    fluence tables (K28), per-row air normalization and the row-grouped
    decomposition (K29); ``d0_cm = 0`` is the heel-free result bit for
    bit.
    """
    from ..pipeline.api import effective_water_mu
    from . import matdecomp as md
    from . import spectral as sp_ops
    from .fbp import hu_image

    if heel is not None and heel.d0_cm == 0.0:
        heel = None
    if recon not in RECONS_3D:
        raise ValueError(f"unknown recon {recon!r}")
    paths = cone_material_paths(phantom, ct, device=device)
    mu_t1 = _f32(phantom.materials.mu_table(spec1.E), device)
    mu_t2 = _f32(phantom.materials.mu_table(spec2.E), device)
    if heel is not None:
        # anode heel (ops/heel.py): per-row fluence tables (K28), per-row
        # air normalization and the row-grouped exact decomposition (K29)
        from .heel import (counts_from_paths_heel, heel_fluence,
                           heel_second_moment)

        i0_1 = heel_fluence(spec1, ct, heel)
        i0_2 = heel_fluence(spec2, ct, heel)
        i2_1 = heel_second_moment(spec1, ct, heel)
        i2_2 = heel_second_moment(spec2, ct, heel)

        def counts(mu_t, i0, i2):
            return counts_from_paths_heel(paths, mu_t, i0, i2)
    else:
        i0_1 = sp_ops.effective_fluence(spec1, ct)
        i0_2 = sp_ops.effective_fluence(spec2, ct)
        i2_1 = sp_ops.second_moment_fluence(spec1, ct)
        i2_2 = sp_ops.second_moment_fluence(spec2, ct)

        def counts(mu_t, i0, i2):
            return sp_ops.counts_from_paths(
                paths, mu_t, _f32(i0, device),
                None if i2 is None else _f32(i2, device))
    if noise == "none":
        c1 = counts(mu_t1, i0_1, None)
        c2 = counts(mu_t2, i0_2, None)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        v1 = v2 = None
        if noise == "compound":
            c1, v1 = counts(mu_t1, i0_1, i2_1)
            c2, v2 = counts(mu_t2, i0_2, i2_2)
        else:
            c1 = counts(mu_t1, i0_1, None)
            c2 = counts(mu_t2, i0_2, None)
        c1 = sp_ops.sample_noise(generator, c1, noise, var=v1)
        c2 = sp_ops.sample_noise(generator, c2, noise, var=v2)
    del paths
    if heel is not None:
        from .heel import decompose_cone_sinograms_heel

        log1 = sp_ops.log_sinogram(c1, _f32(i0_1.sum(-1), device)[:, None])
        log2 = sp_ops.log_sinogram(c2, _f32(i0_2.sum(-1), device)[:, None])
        mat1, mat2 = decompose_cone_sinograms_heel(
            ct, c1, c2, spec1, spec2, heel, n_iters=n_iters,
            mask_thresh=mask_thresh)
    else:
        log1 = sp_ops.log_sinogram(c1, float(np.sum(i0_1)))
        log2 = sp_ops.log_sinogram(c2, float(np.sum(i0_2)))
        _, dec_i0, dec_mus = md.prepare_decomposition(ct, spec1, spec2)
        ab = md.gauss_newton_solve(
            torch.stack([c1.reshape(-1), c2.reshape(-1)]),
            _f32(dec_i0, device), _f32(dec_mus, device), n_iters=n_iters)
        mask = c1 >= mask_thresh * c1.max()  # air rays
        zero = torch.zeros((), dtype=ab.dtype, device=ab.device)
        mat1 = torch.where(mask, zero, ab[:, 0].reshape(c1.shape))
        mat2 = torch.where(mask, zero, ab[:, 1].reshape(c1.shape))
    out = {"sino_raw": (c1, c2), "sino_log": (log1, log2),
           "mat_sinos": (mat1, mat2)}
    if not do_recon:
        none = (None, None)
        return {**out, "recon_raw": none, "recon_HU": none,
                "mat_recons": none}
    vols = reconstruct_3d(torch.stack([log1, log2, mat1, mat2]), ct,
                          n_matrix, fov, ramp, recon=recon, **recon_kw)
    mu_w1 = effective_water_mu(spec1, ct)
    mu_w2 = effective_water_mu(spec2, ct)
    return {**out, "recon_raw": (vols[0], vols[1]),
            "recon_HU": (hu_image(vols[0], mu_w1), hu_image(vols[1], mu_w2)),
            "mat_recons": (vols[2], vols[3])}
