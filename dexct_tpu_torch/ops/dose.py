"""Patient dose maps: per-voxel deposited energy from the scan beam.

Port of :mod:`dexct_tpu.ops.dose`: the absorbed-dose map of a fan-beam
acquisition (:func:`dose_map`) and of a circular or helical cone-beam scan
(:func:`dose_map_3d`), with their energy bookkeeping
(:func:`beam_energy_removed`, :func:`beam_energy_removed_3d`) and the
CTDI, DLP and organ reports.  The physics is the JAX package's:
``scoring='removed'`` scores the energy a ray loses in a voxel there (its
deposited total equals the beam energy that Beer-Lambert attenuation
removes), ``scoring='kerma'`` contracts against ``mu_en`` instead.

Per view, the labels are sampled bilinearly (trilinearly in 3-D) on a
polar grid around the source, (gamma, r) or (gamma, t, r) with t the
tangent of the cone angle, and a running sum along r turns the occupancy
into the partial material paths T from the source to every sample; each
voxel then reads T at its own (gamma, r) bilinearly, attenuates the
spectrum by exp(-T . mu(E)) and contracts it with its own material's
deposition coefficients.  On the card this is kernel K23 (2-D: a polar
pass, T through device memory, a pass over the (voxel, view) terms, then
their sum in view order) or K24
(3-D: T built and read in shared memory, one patch of polar lines per
thread block) (:func:`_dose_accumulate`, :func:`_dose_accumulate_3d`);
CPU tensors run the plain twins, which follow the JAX program's operation
order.

The port reads the uint8 labels directly: the JAX package's bit-packed
label layouts (``_pack_label_quads``, ``_pack_label_nines``,
``_pack_label_nines_zminor``) are TPU gather layouts of the same values,
and its ``pixel_block``, ``vox_tap_fold``, ``view_chunk`` and ``_pair``
arguments (TPU layouts, a TPU-worker time limit) are accepted and ignored.
The entry points run on ``device`` (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import upload
from .conebeam import labels_u8

__all__ = ["dose_map", "sharded_dose_map", "dose_map_3d", "DoseResult",
           "beam_energy_removed", "beam_energy_removed_3d", "ctdi_metrics",
           "organ_dose_report", "dose_efficiency", "ctdi_vol", "dlp",
           "dose_z_profile"]

KEV_TO_J = 1.602176634e-16
KEV_PER_G_TO_MGY = KEV_TO_J / 1e-3 * 1e3  # keV/g -> mGy
# the scratch of one block of views (K23's partial-path table T with its
# per-view terms, K24's per-view terms) stays under this size
_SCRATCH_BYTES = 1 << 30
# voxels per plain spectral stage (bounds its [voxels, E] intermediates)
_PLAIN_VOXELS = 1 << 18


class DoseResult:
    """Dose map + energy bookkeeping.

    dose_mGy:     [Ny, Nx] absorbed dose in the slice plane [mGy]
                  ([Nz, Ny, Nx] for :func:`dose_map_3d`)
    deposited_J:  total energy scored over the 3-D beam [J]
                  (the in-plane map integrated over the r-dependent beam
                  height — the quantity conserved against
                  :func:`beam_energy_removed`)
    """

    def __init__(self, dose_mGy, deposited_J):
        self.dose_mGy = dose_mGy
        self.deposited_J = float(deposited_J)


def _device(device):
    return torch.device("cuda" if device is None else device)


def _sample_grids(ct, phantom, n_gamma, n_r, oversample):
    """Host-side (gamma, r) sampling grid covering the image disk."""
    nx, ny = phantom.Nx, phantom.Ny
    r_img = 0.5 * float(np.hypot(nx * phantom.dx, ny * phantom.dy))
    r_img = min(r_img, ct.SID * 0.95)  # never reach back to the source
    g_half = min(float(np.arcsin(min(r_img / ct.SID, 1.0))) * 1.02,
                 0.5 * ct.gamma_fan)
    if n_gamma is None:
        n_gamma = int(oversample * max(nx, ny))
    if n_r is None:
        n_r = int(oversample * max(nx, ny))
    gammas = np.linspace(-g_half, g_half, n_gamma)
    r0 = max(ct.SID - r_img, 1e-3)
    r1 = ct.SID + r_img
    rs = np.linspace(r0, r1, n_r)
    return gammas, rs


def _dose_energy_grid(phantom, spec, n_energy, scoring="removed"):
    """(mu_kE [K, G], mu_dep_kE [K, G], i0w [G]): the spectral tables of
    the deposition stage, optionally compressed to ``n_energy``
    energy-fluence-weighted groups (each group's tables at its
    energy-fluence centroid, which keeps the 0th and 1st moments).
    ``mu_kE`` attenuates the fluence; ``mu_dep_kE`` weights the local
    deposition: ``mu`` itself for ``scoring='removed'``, ``mu_en`` for
    ``scoring='kerma'``.  ``n_energy=None`` keeps the native grid."""
    if scoring not in ("removed", "kerma"):
        raise ValueError(f"unknown scoring={scoring!r}")
    i0w_full = np.asarray(spec.I0, np.float64) * spec.bin_widths() \
        * np.asarray(spec.E, np.float64)  # photons * keV
    if not n_energy or n_energy >= len(spec.E):
        e_c, i0w = spec.E, i0w_full
    else:
        e = np.asarray(spec.E, np.float64)
        live = i0w_full > 0
        e_l, w_l = e[live], i0w_full[live]
        edges = np.linspace(e_l.min(), e_l.max(), int(n_energy) + 1)
        idx = np.clip(np.digitize(e_l, edges) - 1, 0, int(n_energy) - 1)
        w_g = np.bincount(idx, weights=w_l, minlength=int(n_energy))
        e_g = np.bincount(idx, weights=w_l * e_l, minlength=int(n_energy))
        keep = w_g > 0
        e_c, i0w = e_g[keep] / w_g[keep], w_g[keep]
    mu = phantom.materials.mu_table(e_c)
    mu_dep = (mu if scoring == "removed"
              else phantom.materials.mu_en_table(e_c))
    return mu, mu_dep, i0w


def _f32(x, device):
    """Host data as a float32 tensor on ``device``, up through
    :func:`upload` (pinned memory, an asynchronous copy)."""
    return upload(np.ascontiguousarray(x), device, torch.float32)


def _spectral_tables(mu_kE, mu_dep_kE, i0w_E, device):
    """The float32 tables on ``device``, without the bins of zero fluence
    (their terms are exact zeros of every voxel's sum)."""
    i0w = np.asarray(i0w_E, np.float32)
    live = i0w != 0
    return (_f32(np.asarray(mu_kE, np.float32)[:, live], device),
            _f32(np.asarray(mu_dep_kE, np.float32)[:, live], device),
            _f32(i0w[live], device))


def _view_trig(betas, gammas, sid):
    """Per view the source (x, y) = sid (cos beta, sin beta) [V, 2] and the
    polar lines' cos and sin of beta + gamma [V, n_g], float32 on the
    device of ``betas``: both routes read these same values."""
    src = sid * torch.stack([torch.cos(betas), torch.sin(betas)], -1)
    ang = betas[:, None] + gammas[None, :]
    return src.contiguous(), torch.cos(ang), torch.sin(ang)


def _deposit(t_vox, phi0, lab, mu, mu_dep, i0w):
    """keV deposited per cm^3 per unit view weight: phi0 times the voxel's
    own material's sum_E i0w(E) exp(-t_vox . mu(E)) mu_dep(E).  The JAX
    program contracts over every material and picks its own by a one-hot
    product; this gathers the same column."""
    att = torch.exp(-torch.matmul(t_vox, mu))
    c = torch.matmul(att * i0w[None, :], mu_dep.T)  # [vox, K]
    own = c.gather(1, lab.long().clamp_max(c.shape[1] - 1)[:, None])[:, 0]
    own = torch.where(lab.long() < c.shape[1], own, torch.zeros_like(own))
    return phi0 * own


def _chunks(n):
    return [(s, min(s + _PLAIN_VOXELS, n)) for s in range(0, n, _PLAIN_VOXELS)]


def _view_block(n_views, per_view_bytes, fixed_bytes=0):
    """Views per block: as many as keep the block's scratch (per view, plus
    ``fixed_bytes`` once) under ``_SCRATCH_BYTES``, at least one."""
    room = _SCRATCH_BYTES - fixed_bytes
    return max(1, min(n_views, room // max(per_view_bytes, 1)))


def _max_k(n_mats):
    for m in (4, 8, 16):
        if n_mats <= m:
            return m
    raise ValueError(f"the dose kernels take at most 16 materials, got "
                     f"{n_mats}")


# ---------------------------------------------------------------------------
# K23: the 2-D dose accumulation
# ---------------------------------------------------------------------------

def _polar_2d_plain(labels, ca, sa, src, rs, dr, dx, dy, n_mats):
    """T [n_g, n_r, K]: partial material paths from the source to every
    (gamma, r) sample of one view (the JAX program's occupancy, its
    corners summed in its order, and its midpoint running sum)."""
    ny, nx = labels.shape
    px = src[0] - ca[:, None] * rs[None, :]
    py = src[1] - sa[:, None] * rs[None, :]
    fx = px / dx + (nx / 2 - 0.5)
    fy = py / dy + (ny / 2 - 0.5)
    ix0, iy0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - ix0, fy - iy0
    ix0, iy0 = ix0.long(), iy0.long()
    mats = torch.arange(n_mats, device=labels.device)
    occ = torch.zeros(fx.shape + (n_mats,), dtype=torch.float32,
                      device=labels.device)
    for ty in (0, 1):
        for tx in (0, 1):
            iy, ix = iy0 + ty, ix0 + tx
            ok = (iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)
            lab = labels[iy.clamp(0, ny - 1), ix.clamp(0, nx - 1)].long()
            w = ((wy if ty else 1.0 - wy) * (wx if tx else 1.0 - wx)) * ok
            occ = occ + w[..., None] * (lab[..., None] == mats)
    return (torch.cumsum(occ, 1) - 0.5 * occ) * dr


def _dose_accumulate_plain(labels, mu, mu_dep, i0w, betas, view_w, gammas,
                           rs, vox_xy, rho_vox, lab_vox, scalars):
    """The JAX program ``_dose_accumulate`` in torch, view by view:
    returns (dose [vox] keV/g, float32, deposited keV)."""
    dev = labels.device
    f32 = dict(dtype=torch.float32, device=dev)
    sid, dx, dy, geom, g_half, h_over_sid, dxdy = (
        torch.full((), float(v), **f32) for v in scalars)
    n_mats = mu.shape[0]
    n_g, n_r = gammas.shape[0], rs.shape[0]
    dr, dg = rs[1] - rs[0], gammas[1] - gammas[0]
    src, ca, sa = _view_trig(betas, gammas, sid)
    dose = torch.zeros(vox_xy.shape[0], **f32)
    edep = 0.0
    for v in range(betas.shape[0]):
        T = _polar_2d_plain(labels, ca[v], sa[v], src[v], rs, dr, dx, dy,
                            n_mats).reshape(n_g * n_r, n_mats)
        for s, e in _chunks(vox_xy.shape[0]):
            rel = vox_xy[s:e] - src[v][None, :]
            r_v = torch.sqrt(rel[:, 0] ** 2 + rel[:, 1] ** 2)
            d0 = -src[v] / sid
            dotp = (rel[:, 0] * d0[0] + rel[:, 1] * d0[1]) / r_v
            crossp = (d0[0] * rel[:, 1] - d0[1] * rel[:, 0]) / r_v
            g_v = torch.atan2(crossp, dotp)
            gi = torch.clamp((g_v - gammas[0]) / dg, 0.0, n_g - 1.001)
            ri = torch.clamp((r_v - rs[0]) / dr, 0.0, n_r - 1.001)
            gi0, ri0 = torch.floor(gi), torch.floor(ri)
            wg, wr = (gi - gi0)[:, None], (ri - ri0)[:, None]
            base = gi0.long() * n_r + ri0.long()
            t_lo = T[base] * (1 - wr) + T[base + 1] * wr
            t_hi = T[base + n_r] * (1 - wr) + T[base + n_r + 1] * wr
            t_vox = t_lo * (1 - wg) + t_hi * wg
            in_fan = (torch.abs(g_v) <= g_half).to(torch.float32)
            phi0 = geom / (r_v * r_v) * in_fan
            e_vol = _deposit(t_vox, phi0, lab_vox[s:e], mu, mu_dep, i0w)
            dose[s:e] = dose[s:e] + view_w[v] * (e_vol / rho_vox[s:e])
            edep += float(view_w[v] * torch.sum(
                e_vol * dxdy * (h_over_sid * r_v)))
    return dose, edep


def _k23_blocks(V, n_vox, n_g, n_r, K, nx, ny):
    """Views per C call of K23: the label quads, and per view its T and its
    terms [vox, 2], within ``_SCRATCH_BYTES``."""
    quads = (ny + 1) * (nx + 1) * 4
    return _view_block(V, n_vox * 8 + n_r * n_g * K * 4, quads)


def _dose_2d_launch(labels, mu, mu_dep, i0w, betas, view_w, gammas, rs,
                    vox_xy, rho_vox, lab_vox, scalars):
    """K23's C calls on the card, one per block of views: returns the dose
    [vox] and the float64 deposited-energy slots, without waiting for them
    (no host synchronisation: every scalar tensor is filled on the card,
    the grids' first values and steps are read there)."""
    dev = labels.device
    ny, nx = labels.shape
    K, E = mu.shape
    V, n_g, n_r = betas.shape[0], gammas.shape[0], rs.shape[0]
    n_vox = vox_xy.shape[0]
    req = kernels.require
    req(labels, "labels", dev, torch.uint8, (ny, nx))
    req(mu, "mu", dev, torch.float32, (K, E))
    req(mu_dep, "mu_dep", dev, torch.float32, (K, E))
    req(i0w, "i0w", dev, torch.float32, (E,))
    req(betas, "betas", dev, torch.float32, (V,))
    req(view_w, "view_w", dev, torch.float32, (V,))
    req(gammas, "gammas", dev, torch.float32, (n_g,))
    req(rs, "rs", dev, torch.float32, (n_r,))
    req(vox_xy, "vox_xy", dev, torch.float32, (n_vox, 2))
    req(rho_vox, "rho_vox", dev, torch.float32, (n_vox,))
    req(lab_vox, "lab_vox", dev, torch.uint8, (n_vox,))
    if min(n_g, n_r) < 2:
        raise ValueError("the polar grids need at least two samples each")
    sid, dx, dy, geom, g_half, h_over_sid, dxdy = (float(v) for v in scalars)
    f32 = dict(dtype=torch.float32, device=dev)
    src, ca, sa = _view_trig(betas, gammas, torch.full((), sid, **f32))
    muT = mu.T.contiguous()
    maxk = _max_k(K)
    dose = torch.zeros(n_vox, **f32)
    edep = torch.zeros((n_vox + 255) // 256, dtype=torch.float64, device=dev)
    vb = _k23_blocks(V, n_vox, n_g, n_r, K, nx, ny)
    quads = torch.empty((ny + 1, nx + 1), dtype=torch.int32, device=dev)
    T = torch.empty((vb, n_r, n_g, K), **f32)
    terms = torch.empty((vb, n_vox, 2), **f32)
    lib, stream = kernels.library(), kernels.stream_ptr(dev)
    for v0 in range(0, V, vb):
        nv = min(vb, V - v0)
        rc = lib.dexct_dose_2d(
            labels.data_ptr(), src[v0:].data_ptr(), ca[v0:].data_ptr(),
            sa[v0:].data_ptr(), view_w[v0:].data_ptr(), gammas.data_ptr(),
            rs.data_ptr(), vox_xy.data_ptr(), rho_vox.data_ptr(),
            lab_vox.data_ptr(), muT.data_ptr(), mu_dep.data_ptr(),
            i0w.data_ptr(), quads.data_ptr(), T.data_ptr(), terms.data_ptr(),
            dose.data_ptr(), edep.data_ptr(), maxk, nv, n_g, n_r, K, E, nx, ny, n_vox,
            sid, dx, dy, geom, g_half, h_over_sid, dxdy, stream)
        kernels.check(rc, "dose_map")
        _dose_accumulate.launches += 1
    return dose, edep


def _dose_accumulate_cuda(*args):
    dose, edep = _dose_2d_launch(*args)
    return dose, float(edep.sum())


def _dose_accumulate(labels, mu, mu_dep, i0w, betas, view_w, gammas, rs,
                     vox_xy, rho_vox, lab_vox, scalars):
    """Dose [vox] in keV/g (float32) and the deposited keV of a fan-beam
    scan: the JAX program ``dexct_tpu.ops.dose._dose_accumulate`` on
    uint8 ``labels`` [ny, nx], the float32 spectral tables, per-view
    angles and weights, the polar grids, the voxel centres, densities and
    labels, and the float32 ``scalars`` (sid, dx, dy, geom_const,
    gamma_half_fan, h_over_sid, dxdy).  CUDA tensors run kernel K23: one
    C call per block of views (:func:`_k23_blocks`), counted in
    ``_dose_accumulate.launches``; a call packs the labels as corner
    quads, runs the polar pass (T) and the term pass (each voxel's term of
    each view into a per-view scratch), then adds each voxel's terms in
    view order into the dose.  CPU tensors run
    :func:`_dose_accumulate_plain`."""
    if labels.is_cuda:
        return _dose_accumulate_cuda(labels, mu, mu_dep, i0w, betas, view_w,
                                     gammas, rs, vox_xy, rho_vox, lab_vox,
                                     scalars)
    if labels.device.type != "cpu":
        raise ValueError(f"unsupported device {labels.device}")
    return _dose_accumulate_plain(labels, mu, mu_dep, i0w, betas, view_w,
                                  gammas, rs, vox_xy, rho_vox, lab_vox,
                                  scalars)


_dose_accumulate.launches = 0


def _dose_prep(phantom, ct, spec, *, n_gamma, n_r, oversample, views,
               z_index, n_energy, view_weights, scoring, device):
    """Host prep of :func:`dose_map`: the arguments of
    :func:`_dose_accumulate` on ``device`` and the image shape."""
    labels2d = np.asarray(phantom.slice_labels(z_index)).astype(np.int32)
    ny, nx = labels2d.shape
    mu_kE, mu_dep, i0w = _dose_energy_grid(phantom, spec, n_energy,
                                           scoring)
    betas = np.asarray(ct.betas if views is None else views, np.float64)
    gammas, rs = _sample_grids(ct, phantom, n_gamma, n_r, oversample)
    # voxel centres in world coordinates
    xs = (np.arange(nx) + 0.5 - nx / 2) * phantom.dx
    ys = (np.arange(ny) + 0.5 - ny / 2) * phantom.dy
    vx, vy = np.meshgrid(xs, ys, indexing="xy")
    vox_xy = np.stack([vx.ravel(), vy.ravel()], -1)
    rho = phantom.materials.densities[labels2d].ravel()
    geom_const = ct.SID / (ct.dgamma * ct.h_iso)
    scalars = np.asarray(
        [ct.SID, phantom.dx, phantom.dy, geom_const, 0.5 * ct.gamma_fan,
         ct.h_iso / ct.SID, phantom.dx * phantom.dy], np.float32)
    lab = labels_u8(labels2d, device)
    args = (lab, *_spectral_tables(mu_kE, mu_dep, i0w, device),
            _f32(betas, device),
            _f32(np.ones_like(betas) if view_weights is None
                 else np.asarray(view_weights, np.float64), device),
            _f32(gammas, device), _f32(rs, device), _f32(vox_xy, device),
            _f32(np.maximum(rho, 1e-12), device), lab.reshape(-1),
            scalars)
    return args, (ny, nx)


def dose_map(phantom, ct, spec, *, n_gamma=None, n_r=None, oversample=2,
             views=None, pixel_block=65536, z_index=None, n_energy=None,
             view_weights=None, scoring="removed", vox_tap_fold=True,
             device=None):
    """Absorbed-dose map of a fan-beam acquisition.

    phantom/ct/spec: the standard triplet; the spectrum's counts are per
        channel per view, the forward model's convention, so a spectrum
        rescaled for an N-view scan gives the dose of that whole scan.
    oversample: polar sampling density relative to the pixel grid (the
        grid is ``oversample * max(Nx, Ny)`` in each polar axis unless
        ``n_gamma`` / ``n_r`` override it).
    views: optional view angles [rad] (default ``ct.betas``);
    view_weights: optional per-view relative fluence [V] (tube-current
        modulation);
    n_energy: optional energy-fluence-weighted compression of the
        spectral axis (default: the native grid);
    scoring: ``'removed'`` or ``'kerma'`` (module docstring).
    ``pixel_block`` and ``vox_tap_fold`` select TPU layouts and are
    ignored.  Runs on ``device`` (default: the card: kernel K23).

    Returns a :class:`DoseResult`.
    """
    del pixel_block, vox_tap_fold
    args, shape = _dose_prep(
        phantom, ct, spec, n_gamma=n_gamma, n_r=n_r, oversample=oversample,
        views=views, z_index=z_index, n_energy=n_energy,
        view_weights=view_weights, scoring=scoring, device=_device(device))
    dose, edep = _dose_accumulate(*args)
    dose_mGy = dose.cpu().numpy().astype(np.float64).reshape(shape) \
        * KEV_PER_G_TO_MGY
    return DoseResult(dose_mGy, edep * KEV_TO_J)


def sharded_dose_map(mesh, phantom, ct, spec, *, axis="views", **dose_kw):
    """The JAX package's view-sharded :func:`dose_map`: multi-device work is
    not ported yet (ROADMAP queue 1, item 15)."""
    raise NotImplementedError(
        "sharded_dose_map needs the multi-device layer, which is not ported "
        "yet (ROADMAP queue 1, item 15); dose_map computes the same map on "
        "one card")


def beam_energy_removed(phantom, ct, spec, *, paths=None, device=None):
    """Total beam energy removed by the object over the scan [J]:
    ``sum_rays sum_E I0 dE E (1 - exp(-L))`` over the exact-Siddon material
    paths (given, or traced by K1 on the card), in float64 on ``device``
    (default: the card) — the conservation partner of :func:`dose_map`'s
    ``deposited_J``."""
    from .siddon import material_path_sinogram

    dev = _device(device)
    if paths is None:
        paths = material_path_sinogram(phantom, ct, device=dev)
    return _removed_keV(paths, phantom, spec, dev) * KEV_TO_J


def _removed_keV(paths, phantom, spec, device):
    """sum_rays sum_E I0 dE E (1 - exp(-paths . mu(E))) in float64 on
    ``device``, the rays in blocks (the JAX package takes the same sum in
    float64 NumPy over one [rays, E] array)."""
    f64 = dict(dtype=torch.float64, device=device)
    mu = upload(phantom.materials.mu_table(spec.E), device, torch.float64)
    i0w = upload(spec.I0 * spec.bin_widths() * spec.E, device, torch.float64)
    p = upload(paths, device).reshape(-1, mu.shape[0])
    total = torch.zeros((), **f64)
    for s, e in _chunks(p.shape[0]):
        L = p[s:e].to(torch.float64) @ mu
        total = total + torch.sum((1.0 - torch.exp(-L)) @ i0w)
    return float(total)


def ctdi_metrics(dose_mGy, dx, *, phantom_radius_cm=8.0, roi_radius_cm=0.5,
                 margin_cm=1.0, dy=None):
    """CTDI-style summary of a dose map of a cylindrical phantom: a central
    ROI and four peripheral ROIs ``margin_cm`` below the surface,
    ``CTDI_w = (1/3) center + (2/3) mean(periphery)`` (IEC 60601-2-44
    weighting).  Returns ``{"center", "periphery", "ctdi_w"}`` in the
    dose map's units."""
    d = np.asarray(dose_mGy, np.float64)
    ny, nx = d.shape[-2], d.shape[-1]
    dy = dx if dy is None else dy
    ys = (np.arange(ny) + 0.5 - ny / 2) * dy
    xs = (np.arange(nx) + 0.5 - nx / 2) * dx
    yy, xx = np.meshgrid(ys, xs, indexing="ij")

    def roi_mean(cy, cx):
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= roi_radius_cm ** 2
        if not np.any(m):
            raise ValueError("ROI contains no pixels; increase roi_radius")
        return float(d[m].mean())

    rp = phantom_radius_cm - margin_cm
    center = roi_mean(0.0, 0.0)
    periph = [roi_mean(rp, 0.0), roi_mean(-rp, 0.0),
              roi_mean(0.0, rp), roi_mean(0.0, -rp)]
    p = float(np.mean(periph))
    return {"center": center, "periphery": p,
            "ctdi_w": center / 3.0 + 2.0 * p / 3.0}


def organ_dose_report(dose_mGy, phantom, *, z_index=None):
    """Per-material dose summary of a labeled phantom:
    ``{material_name: {"mean", "max", "mass_g", "energy_J"}}`` (mean and
    max in the map's units; mass and imparted energy assume the in-plane
    map applies over one ``phantom.dz`` of z)."""
    d = np.asarray(dose_mGy, np.float64)
    labels = phantom.slice_labels(z_index)
    if d.shape != labels.shape:
        raise ValueError(f"dose map {d.shape} vs labels {labels.shape}")
    dv = phantom.dx * phantom.dy * phantom.dz  # cm^3
    rho = phantom.materials.densities
    out = {}
    for k, mat in enumerate(phantom.materials):
        m = labels == k
        if not np.any(m):
            continue
        mass = float(m.sum()) * dv * float(rho[k])  # g
        mean = float(d[m].mean())
        # mean [mGy] = 1e-3 J/kg = 1e-6 J/g
        out[mat.name] = {"mean": mean, "max": float(d[m].max()),
                         "mass_g": mass,
                         "energy_J": mean * 1e-6 * mass}
    return out


def dose_efficiency(d_prime, dose_mGy_ref):
    """Task-based dose efficiency: d'^2 per unit dose (``dose_mGy_ref``
    any scalar dose metric held consistent across the systems compared,
    e.g. ``ctdi_w``)."""
    if dose_mGy_ref <= 0:
        raise ValueError("reference dose must be positive")
    return float(d_prime) ** 2 / float(dose_mGy_ref)


# ---------------------------------------------------------------------------
# K24: the 3-D dose accumulation
# ---------------------------------------------------------------------------

def _polar_3d_plain(labels, ca, sa, src, z_s, ts, sec, rs, dr, dx, dy, dz,
                    n_mats):
    """T [n_g, n_t, n_r, K]: partial material paths along arc length from
    the source to every (gamma, t, r) sample of one view."""
    nz, ny, nx = labels.shape
    px = src[0] - ca[:, None, None] * rs[None, None, :]
    py = src[1] - sa[:, None, None] * rs[None, None, :]
    pz = z_s + ts[None, :, None] * rs[None, None, :]
    fx = px / dx + (nx / 2 - 0.5)
    fy = py / dy + (ny / 2 - 0.5)
    fz = pz / dz + (nz / 2 - 0.5)
    ix0, iy0, iz0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    wx, wy, wz = fx - ix0, fy - iy0, fz - iz0
    ix0, iy0, iz0 = ix0.long(), iy0.long(), iz0.long()
    mats = torch.arange(n_mats, device=labels.device)
    occ = torch.zeros(torch.broadcast_shapes(fx.shape, fz.shape)
                      + (n_mats,), dtype=torch.float32,
                      device=labels.device)
    for tz in (0, 1):
        iz = iz0 + tz
        ok_z = (iz >= 0) & (iz < nz)
        w_z = (wz if tz else 1.0 - wz) * ok_z
        for ty in (0, 1):
            for tx in (0, 1):
                iy, ix = iy0 + ty, ix0 + tx
                ok = (iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)
                lab = labels[iz.clamp(0, nz - 1), iy.clamp(0, ny - 1),
                             ix.clamp(0, nx - 1)].long()
                w = (w_z * (wy if ty else 1.0 - wy)
                     * (wx if tx else 1.0 - wx)) * ok
                occ = occ + w[..., None] * (lab[..., None] == mats)
    return ((torch.cumsum(occ, 2) - 0.5 * occ) * dr
            * sec[None, :, None, None])


def _z_slabs(src_zs, ts, rs, vox_z0, dz, nz, z_window):
    """Per view the first slice k0 of its z slab (the JAX program's float32
    formula: the beam reaches |z - z_s| <= max|t| r_max); all zeros and
    the full depth without a window."""
    if z_window is None:
        return torch.zeros_like(src_zs, dtype=torch.int32), nz
    span = torch.abs(ts).max() * rs[-1]
    k0 = torch.clamp(torch.floor((src_zs - span - vox_z0) / dz) - 1.0, 0.0,
                     float(nz - z_window))
    return k0.to(torch.int32), int(z_window)


def _dose_accumulate_3d_plain(labels, mu, mu_dep, i0w, betas, src_zs,
                              view_w, gammas, ts, rs, vox_xyz, rho_vox,
                              lab_vox, scalars, z_window):
    """The JAX program ``_dose_accumulate_3d`` in torch, view by view (each
    view's voxel stage over its z slab when ``z_window`` is set): returns
    (dose [vox] keV/g, float32, deposited keV)."""
    dev = labels.device
    f32 = dict(dtype=torch.float32, device=dev)
    sid, dx, dy, dz, geom, g_half, t_half, dvol = (
        torch.full((), float(v), **f32) for v in scalars)
    nz, ny, nx = labels.shape
    n_mats = mu.shape[0]
    n_g, n_t, n_r = gammas.shape[0], ts.shape[0], rs.shape[0]
    dr, dg, dt = rs[1] - rs[0], gammas[1] - gammas[0], ts[1] - ts[0]
    sec = torch.sqrt(1.0 + ts * ts)
    sg = n_t * n_r
    src, ca, sa = _view_trig(betas, gammas, sid)
    k0s, depth = _z_slabs(src_zs, ts, rs, vox_xyz[0, 2], dz, nz, z_window)
    nynx = ny * nx
    dose = torch.zeros(vox_xyz.shape[0], **f32)
    edep = 0.0
    for v in range(betas.shape[0]):
        z_s = src_zs[v]
        T = _polar_3d_plain(labels, ca[v], sa[v], src[v], z_s, ts, sec, rs,
                            dr, dx, dy, dz, n_mats).reshape(-1, n_mats)
        s0 = int(k0s[v]) * nynx
        for s, e in _chunks(depth * nynx):
            s, e = s0 + s, s0 + e
            vox = vox_xyz[s:e]
            relx, rely = vox[:, 0] - src[v][0], vox[:, 1] - src[v][1]
            r_v = torch.sqrt(relx * relx + rely * rely)
            d0 = -src[v] / sid
            dotp = (relx * d0[0] + rely * d0[1]) / r_v
            crossp = (d0[0] * rely - d0[1] * relx) / r_v
            g_v = torch.atan2(crossp, dotp)
            t_v = (vox[:, 2] - z_s) / r_v
            gi = torch.clamp((g_v - gammas[0]) / dg, 0.0, n_g - 1.001)
            ti = torch.clamp((t_v - ts[0]) / dt, 0.0, n_t - 1.001)
            ri = torch.clamp((r_v - rs[0]) / dr, 0.0, n_r - 1.001)
            gi0, ti0, ri0 = torch.floor(gi), torch.floor(ti), torch.floor(ri)
            wg, wt, wr = ((a - b)[:, None] for a, b in
                          ((gi, gi0), (ti, ti0), (ri, ri0)))
            base = (gi0.long() * n_t + ti0.long()) * n_r + ri0.long()

            def lerp_r(b):
                return T[b] * (1 - wr) + T[b + 1] * wr

            t_vox = ((1 - wg) * ((1 - wt) * lerp_r(base)
                                 + wt * lerp_r(base + n_r))
                     + wg * ((1 - wt) * lerp_r(base + sg)
                             + wt * lerp_r(base + sg + n_r)))
            sec_v = torch.sqrt(1.0 + t_v * t_v)
            in_beam = ((torch.abs(g_v) <= g_half)
                       & (torch.abs(t_v) <= t_half)).to(torch.float32)
            phi0 = geom * sec_v / (r_v * r_v) * in_beam
            e_vol = _deposit(t_vox, phi0, lab_vox[s:e], mu, mu_dep, i0w)
            dose[s:e] = dose[s:e] + view_w[v] * (e_vol / rho_vox[s:e])
            edep += float(view_w[v] * (torch.sum(e_vol) * dvol))
    return dose, edep


def _voxel_axes(vox_xyz, nz, ny, nx):
    """The x, y and z coordinates [nx], [ny], [nz] of the voxel centres
    ``vox_xyz`` [nz * ny * nx, 3] in raster order, as :func:`_dose_prep_3d`
    makes them (x depends on the column only, y on the row, z on the
    slice): the columns of the first row, the rows of the first slice, the
    first voxel of each slice; copies on the device, no host sync."""
    return (vox_xyz[:nx, 0].contiguous(),
            vox_xyz[:ny * nx:nx, 1].contiguous(),
            vox_xyz[::ny * nx, 2].contiguous())


def _dose_3d_launch(labels, mu, mu_dep, i0w, betas, src_zs, view_w, gammas,
                    ts, rs, vox_xyz, rho_vox, lab_vox, scalars, z_window):
    """K24's C calls on the card, one per block of views: returns the dose
    [vox] and the float64 deposited-energy slots, without waiting for them
    (no host synchronisation: every scalar tensor is filled on the card)."""
    dev = labels.device
    nz, ny, nx = labels.shape
    K, E = mu.shape
    V, n_g, n_t, n_r = (betas.shape[0], gammas.shape[0], ts.shape[0],
                        rs.shape[0])
    n_vox = vox_xyz.shape[0]
    req = kernels.require
    req(labels, "labels", dev, torch.uint8, (nz, ny, nx))
    req(mu, "mu", dev, torch.float32, (K, E))
    req(mu_dep, "mu_dep", dev, torch.float32, (K, E))
    req(i0w, "i0w", dev, torch.float32, (E,))
    req(betas, "betas", dev, torch.float32, (V,))
    req(src_zs, "src_zs", dev, torch.float32, (V,))
    req(view_w, "view_w", dev, torch.float32, (V,))
    req(gammas, "gammas", dev, torch.float32, (n_g,))
    req(ts, "ts", dev, torch.float32, (n_t,))
    req(rs, "rs", dev, torch.float32, (n_r,))
    req(vox_xyz, "vox_xyz", dev, torch.float32, (nz * ny * nx, 3))
    req(rho_vox, "rho_vox", dev, torch.float32, (n_vox,))
    req(lab_vox, "lab_vox", dev, torch.uint8, (n_vox,))
    if min(n_g, n_t, n_r) < 2:
        raise ValueError("the polar grids need at least two samples each")
    sid, dx, dy, dz, geom, g_half, t_half, dvol = (float(v) for v in scalars)
    f32 = dict(dtype=torch.float32, device=dev)
    src, ca, sa = _view_trig(betas, gammas, torch.full((), sid, **f32))
    sec = torch.sqrt(1.0 + ts * ts)
    k0s, depth = _z_slabs(src_zs, ts, rs, vox_xyz[0, 2],
                          torch.full((), dz, **f32), nz, z_window)
    muT = mu.T.contiguous()
    maxk = _max_k(K)
    dose = torch.zeros(n_vox, **f32)
    edep = torch.zeros((n_vox + 255) // 256, dtype=torch.float64, device=dev)
    # the voxel centres' axes, the labels as corner quads, and the per-view
    # terms of one block of views [views, slab voxels, 2]: the quads and
    # the terms together within the scratch bound
    xc, yc, zc = _voxel_axes(vox_xyz, nz, ny, nx)
    quads = torch.empty((nz, ny + 1, nx + 1), dtype=torch.int32, device=dev)
    n_slab = depth * ny * nx
    vb = _view_block(V, n_slab * 8, quads.numel() * 4)
    contrib = torch.empty((vb, n_slab, 2), **f32)
    lib, stream = kernels.library(), kernels.stream_ptr(dev)
    for v0 in range(0, V, vb):
        nv = min(vb, V - v0)
        rc = lib.dexct_dose_3d(
            labels.data_ptr(), src[v0:].data_ptr(), src_zs[v0:].data_ptr(),
            ca[v0:].data_ptr(), sa[v0:].data_ptr(), view_w[v0:].data_ptr(),
            k0s[v0:].data_ptr(), gammas.data_ptr(), ts.data_ptr(),
            sec.data_ptr(), rs.data_ptr(), xc.data_ptr(), yc.data_ptr(),
            zc.data_ptr(), rho_vox.data_ptr(), lab_vox.data_ptr(),
            muT.data_ptr(), mu_dep.data_ptr(), i0w.data_ptr(),
            quads.data_ptr(), contrib.data_ptr(), dose.data_ptr(),
            edep.data_ptr(), maxk, nv, n_g, n_t, n_r, K, E, nx, ny, nz,
            depth, n_vox, sid, dx, dy, dz, geom, g_half, t_half, dvol,
            stream)
        kernels.check(rc, "dose_map_3d")
        _dose_accumulate_3d.launches += 1
    return dose, edep


def _dose_accumulate_3d_cuda(*args):
    dose, edep = _dose_3d_launch(*args)
    return dose, float(edep.sum())


def _dose_accumulate_3d(labels, mu, mu_dep, i0w, betas, src_zs, view_w,
                        gammas, ts, rs, vox_xyz, rho_vox, lab_vox, scalars,
                        z_window=None):
    """Dose [vox] in keV/g (float32) and the deposited keV of a cone-beam
    scan: the JAX program ``dexct_tpu.ops.dose._dose_accumulate_3d`` on
    uint8 ``labels`` [nz, ny, nx], with the float32 ``scalars`` (sid, dx,
    dy, dz, geom_const, gamma_half_fan, t_half_beam, voxel_volume); each
    view's voxel stage covers its ``z_window``-slice slab when that is set
    (identical results).  CUDA tensors run kernel K24: one C call per
    block of views (as many as 1 GiB holds beside the label quads),
    counted in ``_dose_accumulate_3d.launches``; a call zero-fills the
    terms, packs the labels as corner quads, runs the patch pass (a thread block per view and patch of polar lines, the
    partial paths T in shared memory) and the view-ordered sum into the
    dose.  ``vox_xyz`` must hold the centres of the labels' voxels in
    raster order, as :func:`_dose_prep_3d` makes them.  CPU tensors run
    :func:`_dose_accumulate_3d_plain`."""
    args = (labels, mu, mu_dep, i0w, betas, src_zs, view_w, gammas, ts, rs,
            vox_xyz, rho_vox, lab_vox, scalars, z_window)
    if labels.is_cuda:
        return _dose_accumulate_3d_cuda(*args)
    if labels.device.type != "cpu":
        raise ValueError(f"unsupported device {labels.device}")
    return _dose_accumulate_3d_plain(*args)


_dose_accumulate_3d.launches = 0


def dose_map_3d(phantom, ct, spec, *, n_gamma=None, n_t=None, n_r=None,
                oversample=2, views=None, pixel_block=65536,
                n_energy=None, view_chunk=32, view_weights=None,
                scoring="removed", _z_window="auto", _pair="auto",
                device=None):
    """Absorbed-dose volume of a circular or helical cone-beam scan.

    ``ct`` is a cone-beam geometry (or the helical one: the per-view
    source z is ``ct.source_z``).  The same primary-beam local-deposition
    model as :func:`dose_map` (with ``n_energy``, ``view_weights`` and
    ``scoring``); ``DoseResult.dose_mGy`` has shape [Nz, Ny, Nx] and
    ``deposited_J`` is the 3-D integral (conservation partner:
    :func:`beam_energy_removed_3d`).  Each view's voxel stage covers only
    the z slab its collimated beam can reach (``_z_window``, a test hook:
    ``None`` forces the full scan, with identical results).
    ``pixel_block``, ``view_chunk`` and ``_pair`` select TPU layouts or
    work around a TPU-worker time limit and are ignored.  Runs on
    ``device`` (default: the card: kernel K24).
    """
    del pixel_block, view_chunk, _pair
    # the polar fluence model is EQUIANGULAR (per-channel counts over
    # uniform dgamma) with the orbit in a z-normal plane: flat-panel
    # (equidistant-column) and gantry-tilted geometries would get a
    # silently wrong fluence profile — fail loudly instead
    from ..system.geometry import (FlatPanelConeBeamGeometry,
                                   TiltedConeBeamGeometry)

    if isinstance(ct, FlatPanelConeBeamGeometry):
        raise ValueError(
            "dose_map_3d assumes equiangular channels; flat-panel "
            "fluence varies per column (cos^2) — not supported")
    if isinstance(ct, TiltedConeBeamGeometry) and float(ct.tilt) != 0.0:
        raise ValueError(
            "dose_map_3d assumes a z-normal orbit; for tilted scans "
            "compute dose in the gantry frame on the rotated phantom")
    args, shape = _dose_prep_3d(
        phantom, ct, spec, n_gamma=n_gamma, n_t=n_t, n_r=n_r,
        oversample=oversample, views=views, n_energy=n_energy,
        view_weights=view_weights, scoring=scoring, z_window=_z_window,
        device=_device(device))
    dose, edep = _dose_accumulate_3d(*args)
    dose_mGy = dose.cpu().numpy().astype(np.float64).reshape(shape) \
        * KEV_PER_G_TO_MGY
    return DoseResult(dose_mGy, edep * KEV_TO_J)


def _dose_prep_3d(phantom, ct, spec, *, n_gamma, n_t, n_r, oversample,
                  views, n_energy, view_weights, scoring, z_window, device):
    """Host prep of :func:`dose_map_3d`: the arguments of
    :func:`_dose_accumulate_3d` on ``device`` (the per-view ones at
    positions 4-6) and the volume shape."""
    dev = device
    labels3 = np.asarray(phantom.labels, np.int32)
    nz, ny, nx = labels3.shape
    mu_kE, mu_dep, i0w = _dose_energy_grid(phantom, spec, n_energy,
                                           scoring)
    betas = np.asarray(ct.betas if views is None else views, np.float64)
    src_z = getattr(ct, "source_z", None)
    if src_z is None or np.ndim(src_z) == 0:
        src_z = np.zeros_like(betas)
    else:
        src_z = np.asarray(src_z, np.float64)
        if views is not None:
            raise ValueError("views override not supported for helical "
                             "geometries (source_z is per ct.betas)")
    gammas, rs = _sample_grids(ct, phantom, n_gamma, n_r, oversample)

    # cone-angle grid: covers the collimated beam, fine enough that the
    # z-resolution at the far edge of the object matches the voxel dz
    t_half = 0.5 * ct.N_rows * ct.h_iso / ct.SID
    if n_t is None:
        r_far = float(rs[-1])
        n_t = int(max(2 * ct.N_rows,
                      np.ceil(2.0 * t_half * r_far / phantom.dz
                              * oversample / 2.0))) + 1
    # one-step margin so beam-edge voxels interpolate inside the grid
    tpad = 2.0 * t_half / max(n_t - 1, 1)
    ts = np.linspace(-t_half - tpad, t_half + tpad, n_t + 2)

    xs = (np.arange(nx) + 0.5 - nx / 2) * phantom.dx
    ys = (np.arange(ny) + 0.5 - ny / 2) * phantom.dy
    zs = (np.arange(nz) + 0.5 - nz / 2) * phantom.dz
    vz, vy, vx = np.meshgrid(zs, ys, xs, indexing="ij")
    vox = np.stack([vx.ravel(), vy.ravel(), vz.ravel()], -1)
    rho = phantom.materials.densities[labels3].ravel()
    geom_const = ct.SID / (ct.dgamma * ct.h_iso)
    scalars = np.asarray(
        [ct.SID, phantom.dx, phantom.dy, phantom.dz, geom_const,
         0.5 * ct.gamma_fan, t_half,
         phantom.dx * phantom.dy * phantom.dz], np.float32)
    # the z slab: the collimated beam reaches at most max|t| * r_max from
    # the source z, so each view touches Lz = O(collimation / dz) slices
    Lz = int(np.ceil(2.0 * float(np.abs(ts).max()) * float(rs[-1])
                     / phantom.dz)) + 4
    if z_window == "auto":  # else the test hook's choice
        z_window = Lz if Lz <= nz - 2 else None
    vw = (np.ones_like(betas) if view_weights is None
          else np.asarray(view_weights, np.float64))
    lab = labels_u8(labels3, dev)
    args = (lab, *_spectral_tables(mu_kE, mu_dep, i0w, dev),
            _f32(betas, dev), _f32(src_z, dev), _f32(vw, dev),
            _f32(gammas, dev), _f32(ts, dev), _f32(rs, dev), _f32(vox, dev),
            _f32(np.maximum(rho, 1e-12), dev), lab.reshape(-1), scalars,
            z_window)
    return args, (nz, ny, nx)


def beam_energy_removed_3d(phantom, ct, spec, *, paths=None, device=None):
    """Total beam energy removed over a cone or helical scan [J] — the
    conservation partner of :func:`dose_map_3d`, over the exact cone-beam
    paths (given, or :func:`~dexct_tpu_torch.ops.conebeam.
    cone_material_paths`: K10 on the card), in float64 on ``device``
    (default: the card)."""
    from .conebeam import cone_material_paths

    dev = _device(device)
    if paths is None:
        paths = cone_material_paths(phantom, ct, device=dev)
    return _removed_keV(paths, phantom, spec, dev) * KEV_TO_J


def ctdi_vol(ctdi_w, ct):
    """CTDI_vol: CTDI_w divided by the helical pitch factor
    ``pitch / (N_rows * h_iso)`` (== CTDI_w for circular scans)."""
    pitch = float(getattr(ct, "pitch", 0.0))
    if pitch <= 0.0:
        return float(ctdi_w)
    return float(ctdi_w) / (pitch / (ct.N_rows * ct.h_iso))


def dlp(ctdi_vol_mGy, scan_length_cm):
    """Dose-length product [mGy*cm]."""
    return float(ctdi_vol_mGy) * float(scan_length_cm)


def dose_z_profile(dose_3d, dx, *, roi_radius_cm=1.0, center=(0.0, 0.0),
                   dy=None):
    """Central-ROI mean dose per z slice (the helical overlap and
    over-ranging profile).  Returns [Nz]."""
    d = np.asarray(dose_3d, np.float64)
    ny, nx = d.shape[-2:]
    dy = dx if dy is None else dy
    ys = (np.arange(ny) + 0.5 - ny / 2) * dy
    xs = (np.arange(nx) + 0.5 - nx / 2) * dx
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    m = (yy - center[0]) ** 2 + (xx - center[1]) ** 2 <= roi_radius_cm ** 2
    if not np.any(m):
        raise ValueError("ROI contains no pixels")
    return d[:, m].mean(-1)
