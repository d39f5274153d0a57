"""First-principles single-scatter estimation: Klein-Nishina transport.

Port of :mod:`dexct_tpu.ops.scatter_physics`.  `ops/scatter.py` ships the
standard *empirical* projection-domain scatter model (kernel superposition
with a tuned SPR).  This module computes the single-Compton-scatter
sinogram *deterministically from the physics*: for every scatter vertex
x, incident energy E and detector element d,

    S(d) = sum_x n_e(x) dV * phi(x, E)
           * dSigma/dOmega_KN(E, theta_xd) * dOmega_d(x)
           * exp(-L_exit(x->d, E')) * resp(E')

with E' the Compton-shifted energy, phi the attenuated primary fluence
at the vertex, and resp the detector weighting (eta(E') * E' for EID).
Free-electron Klein-Nishina (binding/Doppler corrections neglected —
a few percent below 30 keV), single coherent (Rayleigh) scatter through
atomic form factors (:mod:`dexct_tpu_torch.physics.formfactor`), and
exactly one scatter (object SPR at fan-beam collimation is dominated by
first scatter; ``multiple_factor`` adds a flat higher-order tail).
Vertices are taken in the z=0 plane (fan collimation is thin: beam
height h_iso*r/SID << object size), but solid angles and the Compton
geometry are fully 3-D; :func:`single_scatter_conebeam` fills the
collimated slab with 3-D vertices.

Validation: host float64 Monte Carlo references with *random* vertices,
exact per-vertex geometry, the full spectrum and fine ray marching
(:func:`mc_single_scatter_reference`, :func:`mc_second_order_reference`,
:func:`mc_multi_order_reference`), copied from the JAX package as they
are, so that the same seed gives the same numbers.

On the card the (view x vertex x element x energy) contraction is kernel
K26 (fan, ``csrc/scatter.cu``) or K27 (cone), each two launches per
block of views: an incident stage (one thread per (view, vertex): the
fan-gated march from the source, the attenuated fluence phi [G]) and an
exit stage (one block per (view, element), one thread per vertex: the
exit march into K material paths in registers, the Compton and Rayleigh
terms at the 2G fine-table bins each needs, a block reduction in a fixed
order).  The marches, the bilinear (fan) or trilinear (cone) label
occupancy and the energy terms live in one header
(``csrc/scatter_march.cuh``), so the N_rows = 1 cone reproduces the fan
estimator by construction.  One change of formulation against the JAX
programs, in both routes: the scattering angle enters as
``1 - cos(theta) = |u_in - u_out|^2 / 2``.  The JAX programs form
``1 - u_in . u_out``, which near the forward direction keeps only the last
bits of the dot product; at MeV energies the Rayleigh form factor
``F(q ~ E sqrt(1 - cos))`` amplifies them to 0.4 % of the sinogram (the
JAX program's float32 result against the same program run in float64),
where the port stays within 2e-5 of that float64 result.  CPU tensors run the plain twins
(:func:`_scatter_plain`), blocked as the JAX programs are.  The port reads
the uint8 labels directly (the JAX package's ``_pack_label_quads`` is a
TPU gather layout of the same values); the TPU arguments ``x_block``,
``c_block``, ``d_block`` and ``view_chunk`` are accepted and ignored on
the card (``view_chunk`` bounded a TPU worker's program time; the port
launches once per call for all views) and block the plain twins.  The
entry points run on ``device`` (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import formfactor, xcom
from ..utils import kernels
from ..utils.devices import _scalar, upload
from .conebeam import labels_u8

__all__ = [
    "electron_density_image",
    "klein_nishina_differential",
    "compton_energy",
    "single_scatter_sinogram",
    "single_scatter_conebeam",
    "mc_single_scatter_reference",
    "mc_second_order_reference",
    "multiple_to_single_factor",
    "scatter_to_primary_ratio",
]


def compton_energy(energy_keV, cos_theta):
    """Compton-scattered photon energy E' [keV]."""
    e = np.asarray(energy_keV, np.float64)
    k = e / xcom.ELECTRON_REST_KEV
    return e / (1.0 + k * (1.0 - np.asarray(cos_theta, np.float64)))


def klein_nishina_differential(energy_keV, cos_theta):
    """KN differential cross-section dSigma/dOmega [cm^2/sr/electron]."""
    e = np.asarray(energy_keV, np.float64)
    c = np.asarray(cos_theta, np.float64)
    k = e / xcom.ELECTRON_REST_KEV
    ratio = 1.0 / (1.0 + k * (1.0 - c))  # E'/E
    r2 = xcom.ELECTRON_RADIUS_CM ** 2
    return 0.5 * r2 * ratio ** 2 * (ratio + 1.0 / ratio - (1.0 - c * c))


def electron_density_image(phantom, z_index=None):
    """Electron density image [electrons/cm^3]: rho N_A sum_i w_i Z_i/A_i."""
    ne = phantom.materials.densities * np.array(
        [m.electrons_per_gram() for m in phantom.materials])
    return ne[phantom.slice_labels(z_index)]


def _rebin_spectrum(spec, n_energy):
    """Photon-conserving rebin to n_energy groups: (E_c [G], n0 [G])."""
    n0 = np.asarray(spec.I0, np.float64) * spec.bin_widths()
    e = np.asarray(spec.E, np.float64)
    live = n0 > 0
    e_live, n_live = e[live], n0[live]
    edges = np.linspace(e_live.min(), e_live.max(), n_energy + 1)
    idx = np.clip(np.digitize(e_live, edges) - 1, 0, n_energy - 1)
    n_g = np.bincount(idx, weights=n_live, minlength=n_energy)
    e_g = np.bincount(idx, weights=n_live * e_live, minlength=n_energy)
    keep = n_g > 0
    return e_g[keep] / n_g[keep], n_g[keep]


# ---------------------------------------------------------------------------
# The device programs: K26 (fan beam) and K27 (cone beam)
# ---------------------------------------------------------------------------

_INV_MEC2 = 1.0 / xcom.ELECTRON_REST_KEV
_R2 = xcom.ELECTRON_RADIUS_CM ** 2
_INV_HC = 1.0 / formfactor.HC_KEV_A
# the per-(view, vertex) scratch of the incident stage stays under this
# many floats per launch (the views are split into launches beyond it)
_INCIDENT_FLOATS = 1 << 26


def _f32(x, device):
    return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                           device=device)


def _max_k(n_mats):
    """The kernels' register width for ``n_mats`` materials."""
    for m in (4, 8, 16):
        if n_mats <= m:
            return m
    raise ValueError(f"the scatter kernels take at most 16 materials, got "
                     f"{n_mats}")


def _slab_clip(p0, seg, half_extents):
    """Segment ∩ axis-aligned box: parameters (t0, t1) ⊂ [0, 1].

    ``half_extents``: per-axis half sizes of the box centered at the
    origin.  Degenerate axes (|seg| ~ 0) constrain nothing when the
    point is inside and empty the interval when outside; an empty
    intersection returns t1 == t0 (zero-length sampling window)."""
    lo = torch.zeros(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    hi_t = torch.ones(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    for ax, h in enumerate(half_extents):
        sa = seg[..., ax]
        pa = p0[..., ax]
        inv = 1.0 / torch.where(torch.abs(sa) < 1e-20,
                                torch.full_like(sa, 1e-20), sa)
        ta = (-h - pa) * inv
        tb = (h - pa) * inv
        lo = torch.maximum(lo, torch.minimum(ta, tb))
        hi_t = torch.minimum(hi_t, torch.maximum(ta, tb))
    t0 = torch.clamp(lo, 0.0, 1.0)
    t1 = torch.clamp(hi_t, 0.0, 1.0)
    return t0, torch.maximum(t1, t0)


def _march_plain(labels, p0, p1, n_steps, cell, n_mats):
    """Material path lengths along segments p0 -> p1: [..., K].

    ``labels`` [nz, ny, nx] uint8; points [..., 2] (bilinear in the plane
    of ``labels[0]``) or [..., 3] (trilinear); ``cell`` the float32 (dx,
    dy[, dz]).  The segment is slab-clipped to the decode hull
    ``|p| <= (n/2 + 0.5) d`` per axis: beyond it every corner is out of
    range, so the occupancy there is identically zero (vacuum) and the
    clip concentrates every step in-grid.  The occupancy sums its corners
    in the JAX program's order, then over the steps."""
    dims = p0.shape[-1]
    nz, ny, nx = labels.shape
    shape = (nx, ny, nz)[:dims]
    seg = p1 - p0
    length = torch.sqrt(torch.sum(seg * seg, -1))
    half = [float(np.float32(n / 2 + 0.5) * np.float32(c))
            for n, c in zip(shape, cell)]
    t0, t1 = _slab_clip(p0, seg, half)
    steps = (torch.arange(n_steps, dtype=p0.dtype, device=p0.device)
             + 0.5) / n_steps
    frac = t0[..., None] + (t1 - t0)[..., None] * steps
    pts = p0[..., None, :] + seg[..., None, :] * frac[..., None]
    f = [pts[..., a] / _scalar(cell[a], pts) + (shape[a] / 2 - 0.5)
         for a in range(dims)]
    i0 = [torch.floor(fa) for fa in f]
    w = [fa - ia for fa, ia in zip(f, i0)]
    i0 = [ia.long() for ia in i0]
    mats = torch.arange(n_mats, device=labels.device)
    occ = 0.0
    layers = (0, 1) if dims == 3 else (None,)
    for tz in layers:
        if tz is None:
            iz, w_z = torch.zeros_like(i0[0]), None
        else:
            iz = i0[2] + tz
            w_z = (w[2] if tz else 1.0 - w[2]) * ((iz >= 0) & (iz < nz))
        for ty in (0, 1):
            for tx in (0, 1):
                iy, ix = i0[1] + ty, i0[0] + tx
                ok = (iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)
                lab = labels[iz.clamp(0, nz - 1), iy.clamp(0, ny - 1),
                             ix.clamp(0, nx - 1)].long()
                wc = ((w[1] if ty else 1.0 - w[1])
                      * (w[0] if tx else 1.0 - w[0]))
                if w_z is not None:
                    wc = w_z * wc
                wc = wc * ok
                occ = occ + wc[..., None] * (lab[..., None] == mats)
    return occ.sum(-2) * (length * (t1 - t0) / n_steps)[..., None]


def _view_geometry(betas, det_ga, sid, sdd, cone):
    """Per view the source [V, 3], the unit vector d0 = -src_xy / sid
    [V, 2], the evaluated elements [V, D, 3] and their in-plane normals
    [V, D, 2], float32 on the device of ``betas``: both routes read these
    same values.  ``det_ga`` is [D] fan angles (fan) or [D, 2] (fan
    angle, axial tangent) pairs (cone); fan elements sit at z = 0."""
    sid_t = torch.full((), float(sid), dtype=torch.float32,
                       device=betas.device)
    zero = torch.zeros_like(betas)
    src = torch.stack([sid_t * torch.cos(betas), sid_t * torch.sin(betas),
                       zero], -1)
    gam = det_ga[:, 0] if cone else det_ga
    ang = betas[:, None] + gam[None, :]
    dz = (det_ga[:, 1] * sdd)[None, :].expand(ang.shape) if cone \
        else torch.zeros_like(ang)
    det = torch.stack([src[:, None, 0] - sdd * torch.cos(ang),
                       src[:, None, 1] - sdd * torch.sin(ang), dz], -1)
    nrm = src[:, None, :2] - det[..., :2]
    nrm = nrm / torch.sqrt(torch.sum(nrm * nrm, -1))[..., None]
    d0 = -src[:, :2] / sid_t
    return (src.contiguous(), d0.contiguous(), det.contiguous(),
            nrm.contiguous())


def _scatter_scalars(scalars, cone):
    """The device programs' float32 scalars as a dict, and e_g [G]."""
    names = (("sid", "sdd", "dx", "dy", "dz", "geom", "ef0", "def", "a_det",
              "g_half", "t_half", "half_cz", "dq_inv") if cone else
             ("sid", "sdd", "dx", "dy", "geom", "ef0", "def", "a_det",
              "g_half", "h_over_sid", "dq_inv"))
    sc = np.asarray(scalars, np.float32)
    out = {k: float(v) for k, v in zip(names, sc[:len(names)])}
    return out, sc[len(names):]


def _dot(a, b):
    """Sum of a * b over the last axis, left to right."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out


def _incident_plain(labels, cells, ne_w, src, d0, mu_gE, n0_g, sc, s_in,
                    n_mats, cone):
    """Per vertex of one view: (pos [X, 3], phi [X, G], w_x [X], col
    [X]): the fan-gated incident fluence at the scatter vertex (the
    cone's at its beam-overlap midpoint) and its scattering weights."""
    f32 = torch.float32
    rel2 = cells[:, :2] - src[None, :2]
    r_ip = torch.sqrt(_dot(rel2, rel2))
    g_v = torch.atan2(d0[0] * rel2[:, 1] - d0[1] * rel2[:, 0],
                      rel2[:, 0] * d0[0] + rel2[:, 1] * d0[1])
    in_fan = (torch.abs(g_v) <= sc["g_half"]).to(f32)
    if cone:
        bh = sc["t_half"] * r_ip  # beam half-height at the vertex
        z_lo = torch.maximum(cells[:, 2] - sc["half_cz"], -bh)
        z_hi = torch.minimum(cells[:, 2] + sc["half_cz"], bh)
        overlap = torch.clamp_min(z_hi - z_lo, 0.0)
        z_eff = 0.5 * (z_lo + z_hi)  # weight 0 where there is no overlap
        pos = torch.cat([cells[:, :2], z_eff[:, None]], -1)
        cell = (sc["dx"], sc["dy"], sc["dz"])
        t_in = _march_plain(labels, src.expand(pos.shape), pos, s_in, cell,
                            n_mats)
        rel = pos - src[None, :]
        r_3 = torch.sqrt(torch.sum(rel * rel, -1))
        pref = sc["geom"] * (r_3 / r_ip) / (r_ip * r_ip)
        col = overlap * in_fan
    else:
        pos = torch.cat([cells, torch.zeros_like(cells[:, :1])], -1)
        t_in = _march_plain(labels, src[None, :2].expand(cells.shape), cells,
                            s_in, (sc["dx"], sc["dy"]), n_mats)
        pref = sc["geom"] / (r_ip * r_ip)
        col = (sc["h_over_sid"] * r_ip) * in_fan
    phi = pref[:, None] * n0_g[None, :] * torch.exp(
        -torch.matmul(t_in, mu_gE))
    return pos, phi, ne_w * col, col


def _exit_plain(labels, pos, src, det, nrm, phi, w_x, col, f2w, tables, sc,
                s_out, n_mats, coherent, cone):
    """Detected single scatter [D] of one block of vertices (pos [xb, 3])
    into one block of elements (det [db, 3]): the JAX program's per-block
    body, its [xb, db, s_out, K] march and [xb, db, F] fine table, with
    1 - cos(theta) formed as |u_in - u_out|^2 / 2 (module docstring)."""
    mu_fine, resp_fine, resp_g, e_g = tables
    dims = 3 if cone else 2
    xb, db = pos.shape[0], det.shape[0]
    F = mu_fine.shape[1]
    cell = (sc["dx"], sc["dy"], sc["dz"]) if cone else (sc["dx"], sc["dy"])
    p0 = pos[:, None, :dims].expand(xb, db, dims)
    p1 = det[None, :, :dims].expand(xb, db, dims)
    t_ex = _march_plain(labels, p0, p1, s_out, cell, n_mats)  # [xb, db, K]
    rel = pos[:, :dims] - src[None, :dims]
    u_in = rel / torch.sqrt(_dot(rel, rel))[:, None]
    dvec = p1 - p0
    r_d = torch.sqrt(_dot(dvec, dvec))
    u_out = dvec / r_d[..., None]
    # 1 - cos(theta) = |u_in - u_out|^2 / 2: the JAX program forms
    # 1 - u_in . u_out, which near the forward direction keeps only the
    # last bits of the dot product, and at MeV energies the Rayleigh form
    # factor F(q ~ E sqrt(1 - cos)) turns them into 0.4 % of the sinogram
    du = u_in[:, None, :] - u_out
    one_m = 0.5 * _dot(du, du)  # [xb, db]
    cos_t = 1.0 - one_m
    cos_inc = torch.abs(u_out[..., 0] * nrm[None, :, 0]
                        + u_out[..., 1] * nrm[None, :, 1])
    d_omega = sc["a_det"] * cos_inc / (r_d * r_d)

    k = e_g * _INV_MEC2
    ratio = 1.0 / (1.0 + k[None, None, :] * one_m[..., None])
    e_p = e_g[None, None, :] * ratio
    sin2 = (one_m * (2.0 - one_m))[..., None]
    kn = 0.5 * _R2 * ratio * ratio * (ratio + 1.0 / ratio - sin2)
    l_fine = torch.matmul(t_ex, mu_fine)  # [xb, db, F]
    f_max = float(np.float32(F - 1.001))
    ef0 = torch.full((), float(sc["ef0"]), dtype=e_g.dtype,
                     device=e_g.device)
    de = torch.full((), float(sc["def"]), dtype=e_g.dtype, device=e_g.device)
    fi = torch.clamp((e_p - ef0) / de, 0.0, f_max)
    fi0 = torch.floor(fi)
    wf = fi - fi0
    fi0 = fi0.long()
    l0 = torch.gather(l_fine, -1, fi0)
    l1 = torch.gather(l_fine, -1, fi0 + 1)
    l_ex = l0 + (l1 - l0) * wf
    resp = resp_fine[fi0] + (resp_fine[fi0 + 1] - resp_fine[fi0]) * wf
    contrib = (phi[:, None, :] * kn * resp
               * torch.exp(-torch.clamp(l_ex, 0.0, 60.0))
               * d_omega[..., None])
    out = torch.sum(contrib * w_x[:, None, None], dim=(0, 2))
    if coherent:
        Q = f2w.shape[1]
        q_half = torch.sqrt(torch.clamp(one_m * 0.5, 0.0, 1.0)) * _INV_HC
        qi = torch.clamp(q_half[..., None] * e_g * sc["dq_inv"], 0.0,
                         float(np.float32(Q - 1.001)))
        qi0 = torch.floor(qi)
        wq = qi - qi0
        qi0 = qi0.long()
        f2full = f2w[:, None, :].expand(xb, db, Q)
        f0 = torch.gather(f2full, -1, qi0)
        f1 = torch.gather(f2full, -1, qi0 + 1)
        f2v = f0 + (f1 - f0) * wq
        ray = 0.5 * _R2 * (1.0 + cos_t[..., None] ** 2) * f2v
        fic = torch.clamp((e_g - ef0) / de, 0.0, f_max)
        fic0 = torch.floor(fic)
        wfc = fic - fic0
        idx_c = fic0.long()[None, None, :].expand(xb, db, -1)
        l0c = torch.gather(l_fine, -1, idx_c)
        l1c = torch.gather(l_fine, -1, idx_c + 1)
        l_exc = l0c + (l1c - l0c) * wfc
        contrib_r = (phi[:, None, :] * ray * resp_g[None, None, :]
                     * torch.exp(-torch.clamp(l_exc, 0.0, 60.0))
                     * d_omega[..., None])
        out = out + torch.sum(contrib_r * col[:, None, None], dim=(0, 2))
    return out


def _scatter_plain(labels, ne_w, f2w, cells, mu_gE, mu_fine, resp_fine,
                   resp_g, n0_g, betas, det_ga, scalars, *, n_mats, s_in,
                   s_out, coherent, cone, x_block, d_block):
    """The JAX programs ``_scatter_scan`` (fan) and ``_scatter_scan_cone``
    in torch, view by view, in blocks of ``x_block`` vertices x
    ``d_block`` elements: [V, D] float32."""
    sc, e_g = _scatter_scalars(scalars, cone)
    e_g = upload(e_g, betas)
    src, d0, det, nrm = _view_geometry(betas, det_ga, sc["sid"], sc["sdd"],
                                       cone)
    tables = (mu_fine, resp_fine, resp_g, e_g)
    X, D = cells.shape[0], det.shape[1]
    out = torch.zeros((betas.shape[0], D), dtype=torch.float32,
                      device=betas.device)
    for v in range(betas.shape[0]):
        pos, phi, w_x, col = _incident_plain(labels, cells, ne_w, src[v],
                                             d0[v], mu_gE, n0_g, sc, s_in,
                                             n_mats, cone)
        for d_0 in range(0, D, d_block):
            ds = slice(d_0, d_0 + d_block)
            parts = [_exit_plain(labels, pos[xs], src[v], det[v, ds],
                                 nrm[v, ds], phi[xs], w_x[xs], col[xs],
                                 f2w[xs], tables, sc, s_out, n_mats,
                                 coherent, cone)
                     for xs in (slice(x0, x0 + x_block)
                                for x0 in range(0, X, x_block))]
            out[v, ds] = torch.stack(parts).sum(0)
    return out


def _scatter_cuda(labels, ne_w, f2w, cells, mu_gE, mu_fine, resp_fine,
                  resp_g, n0_g, betas, det_ga, scalars, *, n_mats, s_in,
                  s_out, coherent, cone):
    dev = betas.device
    req = kernels.require
    nz, ny, nx = labels.shape
    dims = 3 if cone else 2
    X = cells.shape[0]
    K, G = mu_gE.shape
    F = mu_fine.shape[1]
    Q = f2w.shape[1]
    V = betas.shape[0]
    req(labels, "labels", dev, torch.uint8)
    req(ne_w, "ne_w", dev, torch.float32, (X,))
    req(f2w, "f2w", dev, torch.float32, (X, Q))
    req(cells, "cells", dev, torch.float32, (X, dims))
    req(mu_gE, "mu_gE", dev, torch.float32, (K, G))
    req(mu_fine, "mu_fine", dev, torch.float32, (K, F))
    req(resp_fine, "resp_fine", dev, torch.float32, (F,))
    req(resp_g, "resp_g", dev, torch.float32, (G,))
    req(n0_g, "n0_g", dev, torch.float32, (G,))
    req(betas, "betas", dev, torch.float32, (V,))
    if K != n_mats:
        raise ValueError(f"mu tables hold {K} materials, expected {n_mats}")
    if F < 2 or (coherent and Q < 2):
        raise ValueError("the fine energy and q grids need 2 points each")
    maxk = _max_k(n_mats)
    sc, e_g = _scatter_scalars(scalars, cone)
    e_g_t = upload(e_g, betas)
    src, d0, det, nrm = _view_geometry(betas, det_ga, sc["sid"], sc["sdd"],
                                       cone)
    D = det.shape[1]
    # the kernels read the mu tables zero-padded to maxk materials
    mu_gE_p = torch.zeros((maxk, G), dtype=torch.float32, device=dev)
    mu_gE_p[:K] = mu_gE
    mu_fine_p = torch.zeros((maxk, F), dtype=torch.float32, device=dev)
    mu_fine_p[:K] = mu_fine
    out = torch.empty((V, D), dtype=torch.float32, device=dev)
    vb = max(1, min(V, _INCIDENT_FLOATS // max(X * (G + 4), 1)))
    phi = torch.empty((vb, G, X), dtype=torch.float32, device=dev)
    aux = torch.empty((vb, X, 4), dtype=torch.float32, device=dev)
    dz = sc["dz"] if cone else 1.0
    halves = [float(np.float32(n / 2 + 0.5) * np.float32(c))
              for n, c in ((nx, sc["dx"]), (ny, sc["dy"]), (nz, dz))]
    centres = [float(np.float32(n / 2 - 0.5)) for n in (nx, ny, nz)]
    beam = ((sc["t_half"], sc["half_cz"]) if cone
            else (sc["h_over_sid"], 0.0))
    lib, stream = kernels.library(), kernels.stream_ptr(dev)
    fn = lib.dexct_scatter_3d if cone else lib.dexct_scatter_2d
    for v0 in range(0, V, vb):
        nv = min(vb, V - v0)
        rc = fn(labels.data_ptr(), cells.data_ptr(), ne_w.data_ptr(),
                f2w.data_ptr(), mu_gE_p.data_ptr(), mu_fine_p.data_ptr(),
                resp_fine.data_ptr(), resp_g.data_ptr(), n0_g.data_ptr(),
                e_g_t.data_ptr(), src[v0:].data_ptr(), d0[v0:].data_ptr(),
                det[v0:].data_ptr(), nrm[v0:].data_ptr(), phi.data_ptr(),
                aux.data_ptr(), out[v0:].data_ptr(), maxk, nv, X, D, G, F,
                Q, nx, ny, nz, s_in, s_out, int(bool(coherent)), sc["dx"],
                sc["dy"], dz, *halves, *centres, sc["geom"], sc["g_half"],
                *beam, sc["ef0"], sc["def"], float(np.float32(F - 1.001)),
                float(np.float32(Q - 1.001)), sc["a_det"], sc["dq_inv"],
                float(np.float32(0.5 * _R2)), float(np.float32(_INV_HC)),
                float(np.float32(_INV_MEC2)), stream)
        kernels.check(rc, "single_scatter_conebeam" if cone
                      else "single_scatter")
        if cone:
            _scatter_scan_cone.launches += 1
        else:
            _scatter_scan.launches += 1
    return out


def _scatter_dispatch(cone, labels, ne_w, f2w, cells, mu_gE, mu_fine,
                      resp_fine, resp_g, n0_g, betas, det_ga, scalars, *,
                      n_mats, s_in, s_out, x_block, d_block, coherent):
    kw = dict(n_mats=int(n_mats), s_in=int(s_in), s_out=int(s_out),
              coherent=bool(coherent), cone=cone)
    args = (labels, ne_w, f2w, cells, mu_gE, mu_fine, resp_fine, resp_g,
            n0_g, betas, det_ga, scalars)
    if cells.shape[0] == 0:  # no scatter vertex: nothing to detect
        return torch.zeros((betas.shape[0], det_ga.shape[0]),
                           dtype=torch.float32, device=betas.device)
    if betas.is_cuda:
        return _scatter_cuda(*args, **kw)
    if betas.device.type != "cpu":
        raise ValueError(f"unsupported device {betas.device}")
    return _scatter_plain(*args, **kw, x_block=max(int(x_block), 1),
                          d_block=max(int(d_block), 1))


def _scatter_scan(labels, ne_w, f2w, cell_xy, mu_gE, mu_fine, resp_fine,
                  resp_g, n0_g, betas, det_gammas, scalars, *, n_mats, s_in,
                  s_out, coherent, x_block=1024, c_block=32):
    """Single-scatter detected signal of a fan-beam scan: [V, C] float32.

    The JAX program ``dexct_tpu.ops.scatter_physics._scatter_scan`` on
    tensors of one device: uint8 ``labels`` [1, ny, nx]; ``ne_w`` [X]
    electrons per unit z of each vertex (cell area folded; the local beam
    height and the fan gate are applied here); ``f2w`` [X, Q] the cells'
    coherent angular weight on the uniform q grid; ``cell_xy`` [X, 2];
    ``mu_gE`` [K, G] attenuation at the compressed incident bins,
    ``mu_fine`` [K, F] on the fine exit grid, ``resp_fine`` [F] and
    ``resp_g`` [G] the detector weights, ``n0_g`` [G] photons per channel
    per view, ``betas`` [V], ``det_gammas`` [C] the evaluated elements'
    fan angles, and the host float32 ``scalars`` (sid, sdd, dx, dy,
    geom_const, e_fine0, de_fine, a_det, g_half_fan, h_over_sid, dq_inv)
    + e_g.  CUDA tensors run kernel K26 (an incident and an exit launch
    per block of views, counted once in ``_scatter_scan.launches``); CPU
    tensors run :func:`_scatter_plain` in ``x_block`` x ``c_block``
    blocks.  When ``coherent`` the Rayleigh term rides the same exit
    marches: F^2 at q = E sin(theta/2)/hc from the cell's table, the exit
    attenuation at the unshifted energy, the detector response at E."""
    return _scatter_dispatch(False, labels, ne_w, f2w, cell_xy, mu_gE,
                             mu_fine, resp_fine, resp_g, n0_g, betas,
                             det_gammas, scalars, n_mats=n_mats, s_in=s_in,
                             s_out=s_out, x_block=x_block, d_block=c_block,
                             coherent=coherent)


_scatter_scan.launches = 0


def _material_f2_tables(materials, e_max_keV, n_q):
    """Per-material coherent weight tables on a uniform q grid.

    Returns (f2_mat [K, Q], q grid [Q]): Sum_i n_i F_i(q)^2 per unit
    volume for each material.  The grid spans [0, min(3, E_max/hc)]
    1/A — beyond q = 3 the form factors have fallen > 4 orders and the
    kernel clamps to the last entry.
    """
    q_max = min(3.0, float(e_max_keV) / formfactor.HC_KEV_A)
    q = np.linspace(0.0, q_max, n_q)
    f2 = np.stack([
        formfactor.material_f2_per_volume(m, m.density, q)
        if m.density > 0 else np.zeros_like(q)
        for m in materials])
    return f2, q


def _cell_f2_weights(labels2d, materials, coarse, cell_area, e_max_keV,
                     n_q):
    """[nyc*nxc, Q] cell-mean coherent weight x cell area (the per-unit-z
    Rayleigh analog of ``ne_w``), averaged exactly like the electron
    density: per-material occupancy fractions of each coarse cell."""
    ny, nx = labels2d.shape
    cf = int(coarse)
    nyc, nxc = -(-ny // cf), -(-nx // cf)
    f2_mat, _ = _material_f2_tables(materials, e_max_keV, n_q)
    lab_pad = np.pad(labels2d, ((0, nyc * cf - ny), (0, nxc * cf - nx)))
    blocks = lab_pad.reshape(nyc, cf, nxc, cf)
    out = np.zeros((nyc, nxc, n_q))
    for k in range(len(f2_mat)):
        if not np.any(f2_mat[k]):
            continue
        occ = (blocks == k).mean((1, 3))
        out += occ[..., None] * f2_mat[k][None, None, :]
    return out.reshape(-1, n_q) * cell_area


def _sinogram_prep(phantom, ct, spec, *, coarse, n_energy, n_fine, s_in,
                   s_out, views, channel_sub, z_index, coherent, n_q,
                   device):
    """Host set-up of :func:`single_scatter_sinogram`, as the JAX package
    does it: the arguments of :func:`_scatter_scan` on ``device``, its
    keywords, and (all channels' fan angles, the evaluated ones)."""
    labels2d = np.asarray(phantom.slice_labels(z_index), np.int32)
    ny, nx = labels2d.shape
    n_mats = phantom.n_materials
    # the marches slab-clip to the grid hull, so every step lands
    # in-grid: half the PRE-CLIP step counts keep the old in-grid
    # sampling density (the clip fraction of a source/detector segment
    # is ~0.3-0.5) at half the march cost — accuracy pinned by the MC
    # cross-validation tests
    if s_in is None:
        s_in = max(nx, ny) // 2
    if s_out is None:
        s_out = max(nx, ny) // 4
    betas = np.asarray(ct.betas if views is None else views, np.float64)

    # coarse vertex grid.  The z-extent: the fan's photons fill
    # |z| < h(r)/2, so the scattering column at a vertex holds
    # n_e * (cell area) * h(r_v) electrons; phi is the mid-plane
    # fluence.  h(r_v) is folded in-kernel (h_over_sid * r_v).
    ne_img = electron_density_image(phantom, z_index)
    cf = int(coarse)
    nyc, nxc = -(-ny // cf), -(-nx // cf)  # ceil: pad, never crop
    pad_y, pad_x = nyc * cf - ny, nxc * cf - nx
    ne_pad = np.pad(ne_img, ((0, pad_y), (0, pad_x)))
    ne_cells = ne_pad.reshape(nyc, cf, nxc, cf).mean((1, 3))
    xs = ((np.arange(nxc) + 0.5) * cf - nx / 2) * phantom.dx
    ys = ((np.arange(nyc) + 0.5) * cf - ny / 2) * phantom.dy
    cx, cy = np.meshgrid(xs, ys, indexing="xy")
    cell_xy = np.stack([cx.ravel(), cy.ravel()], -1)
    keep = ne_cells.ravel() > 0
    cell_xy = cell_xy[keep]
    cell_area = (cf * phantom.dx) * (cf * phantom.dy)
    ne_w = ne_cells.ravel()[keep] * cell_area  # electrons per unit z
    # spectra rebin first (the coherent q grid needs e_g)
    e_g, n0_g = _rebin_spectrum(spec, n_energy)
    if coherent:
        f2w = _cell_f2_weights(labels2d, phantom.materials, cf,
                               cell_area, e_g.max(), n_q)[keep]
        _, q_grid = _material_f2_tables(phantom.materials, e_g.max(),
                                        n_q)
        dq_inv = 1.0 / (q_grid[1] - q_grid[0])
    else:
        f2w = np.zeros((len(ne_w), 1))
        dq_inv = 1.0
    # evaluated channels (subsampled)
    gam_all = np.asarray(ct.gammas, np.float64)
    sub = max(int(channel_sub), 1)
    # always evaluate the last channel too, so the interpolation never
    # extrapolates (np.interp clamps, flattening the edge)
    ch_idx = np.unique(np.append(np.arange(0, len(gam_all), sub),
                                 len(gam_all) - 1))
    gam_eval = gam_all[ch_idx]
    n_eval = len(gam_eval)

    # attenuation tables (e_g/n0_g rebinned above)
    mu_gE = phantom.materials.mu_table(e_g)  # [K, G]
    e_min_p = float(compton_energy(e_g.min(), -1.0)) * 0.95
    e_fine = np.linspace(e_min_p, float(e_g.max()) * 1.001, n_fine)
    mu_fine = phantom.materials.mu_table(e_fine)  # [K, F]
    resp_fine = np.asarray(ct.detector_response(e_fine), np.float64)
    resp_g = np.asarray(ct.detector_response(e_g), np.float64)

    # detector element area and fluence normalization
    h_det = ct.h_iso * ct.SDD / ct.SID
    a_det = (ct.SDD * ct.dgamma) * h_det  # element area [cm^2]
    geom_const = ct.SID / (ct.dgamma * ct.h_iso)

    scalars = np.concatenate([
        [ct.SID, ct.SDD, phantom.dx, phantom.dy, geom_const,
         float(e_fine[0]), float(e_fine[1] - e_fine[0]), a_det,
         0.5 * ct.gamma_fan, ct.h_iso / ct.SID, dq_inv], e_g])
    args = (labels_u8(labels2d[None], device), _f32(ne_w, device),
            _f32(f2w, device), _f32(cell_xy, device), _f32(mu_gE, device),
            _f32(mu_fine, device), _f32(resp_fine, device),
            _f32(resp_g, device), _f32(n0_g, device), _f32(betas, device),
            _f32(gam_eval, device), np.asarray(scalars, np.float32))
    kw = dict(n_mats=n_mats, s_in=int(s_in), s_out=int(s_out),
              coherent=bool(coherent))
    return args, kw, (gam_all, gam_eval)


def single_scatter_sinogram(phantom, ct, spec, *, coarse=4, n_energy=12,
                            n_fine=96, s_in=None, s_out=None, views=None,
                            channel_sub=1, x_block=1024, c_block=32,
                            z_index=None, view_chunk=4, coherent=True,
                            n_q=48, multiple_factor=0.0, device=None):
    """Deterministic scatter sinogram [V, C] in detected units.

    Transport content: single Compton (Klein-Nishina) + single coherent
    (Rayleigh, atomic form factors — ``coherent``); optionally a
    multiplicative higher-order tail ``multiple_factor`` (the
    2nd-to-1st-order ratio measured by
    :func:`multiple_to_single_factor`; second scatter is even smoother
    than first, so a flat multiplier is the standard closure).

    coarse: vertex-grid downsampling factor relative to the phantom
        grid (scatter is low-frequency; 4-8 is plenty).
    n_energy: compressed incident energy bins.
    n_fine: fine grid for Compton-shifted exit attenuation/response.
    s_in/s_out: marching steps for incident/exit paths (default:
        phantom N and N/2).
    channel_sub: evaluate every k-th detector channel and interpolate
        the rest (Compton is smooth across channels; the coherent
        forward peak has ~0.03 rad angular width, so keep
        sub * dgamma below ~0.01 rad — production channel counts take
        4-8 comfortably, and the cost falls by the same factor).
    x_block/c_block: blocking of the plain twin's (vertex x channel)
        exit marching — bounds its largest live intermediate at
        [x_block, c_block, s_out, K]; the card's kernel K26 ignores them.
    view_chunk: accepted and ignored (a TPU worker's program-time
        split); the port launches once per call for all views.
    device: where the scan runs (default: the card: kernel K26).

    Cost model: the exit march dominates at
    ``X * C/channel_sub * s_out * 4`` gathers per view with
    ``X ~ (N/coarse)^2`` in-body vertices — size coarse/channel_sub/
    views to your accuracy needs (the result is smooth in all three).

    The result adds directly onto the primary counts from
    ``forward_counts`` (same detected-signal units) and feeds the
    kernel-correction machinery in :mod:`dexct_tpu_torch.ops.scatter`.
    """
    del view_chunk
    args, kw, (gam_all, gam_eval) = _sinogram_prep(
        phantom, ct, spec, coarse=coarse, n_energy=n_energy, n_fine=n_fine,
        s_in=s_in, s_out=s_out, views=views, channel_sub=channel_sub,
        z_index=z_index, coherent=coherent, n_q=n_q,
        device=torch.device("cuda" if device is None else device))
    s_eval = _scatter_scan(*args, **kw, x_block=x_block, c_block=c_block
                           ).cpu().numpy().astype(np.float64)
    n_eval, sub = len(gam_eval), max(int(channel_sub), 1)
    s_eval = s_eval * (1.0 + float(multiple_factor))
    if sub == 1:
        return s_eval
    out = np.empty((s_eval.shape[0], ct.N_channels))
    for i in range(s_eval.shape[0]):
        out[i] = np.interp(gam_all, gam_eval[:n_eval], s_eval[i])
    return out


def scatter_to_primary_ratio(scatter_sino, primary_sino, *,
                             atten_thresh=0.9):
    """Mean in-object SPR diagnostic.

    In-object rays are the *attenuated* ones (primary below
    ``atten_thresh`` of the air level — unattenuated air channels have
    maximal primary and near-zero SPR, so including them biases the
    diagnostic low); rays below 1e-6 of max are excluded as
    photon-starved.
    """
    p = np.asarray(primary_sino, np.float64)
    s = np.asarray(scatter_sino, np.float64)
    m = (p < atten_thresh * p.max()) & (p > 1e-6 * p.max())
    if not np.any(m):
        raise ValueError("no attenuated rays: nothing in the beam?")
    return float((s[m] / p[m]).mean())


def mc_single_scatter_reference(phantom, ct, spec, beta, n_samples, *,
                                seed=0, march_step=None, z_index=None,
                                coherent=True):
    """Host float64 Monte Carlo single-scatter oracle for ONE view.

    Next-event estimation with RANDOM vertices and exact geometry —
    no coarse grids, no energy compression, adaptive marching — an
    independent cross-check of :func:`single_scatter_sinogram`'s
    discretizations.  ``coherent`` adds the Rayleigh NEE term (per-
    vertex material form factors, elastic exit attenuation) — the same
    physics as the device kernel's coherent branch, discretized
    independently.  Returns (scatter [C], stderr [C]).
    """
    rng = np.random.default_rng(seed)
    labels2d = np.asarray(phantom.slice_labels(z_index), np.int32)
    ny, nx = labels2d.shape
    if march_step is None:
        march_step = 0.5 * min(phantom.dx, phantom.dy)

    e = np.asarray(spec.E, np.float64)
    n0 = np.asarray(spec.I0, np.float64) * spec.bin_widths()
    live = n0 > 0
    e, n0 = e[live], n0[live]
    p_e = n0 / n0.sum()
    mu_table = phantom.materials.mu_table(e)  # [K, Elive]
    ne_img = electron_density_image(phantom, z_index)

    src = ct.SID * np.array([np.cos(beta), np.sin(beta)])
    ang = beta + ct.gammas
    det = src[None, :] - ct.SDD * np.stack([np.cos(ang), np.sin(ang)], -1)
    h_det = ct.h_iso * ct.SDD / ct.SID
    a_det = (ct.SDD * ct.dgamma) * h_det

    r_img = 0.5 * float(np.hypot(nx * phantom.dx, ny * phantom.dy))
    r0, r1 = ct.SID - r_img, ct.SID + r_img
    seg_len = r1 - r0

    def march_paths(p0, p1):
        """Material paths along p0->p1 (vectorized, [n, K])."""
        segv = p1 - p0
        lens = np.linalg.norm(segv, axis=-1)
        n_steps = max(int(np.ceil(lens.max() / march_step)), 2)
        fr = (np.arange(n_steps) + 0.5) / n_steps
        pts = p0[:, None, :] + segv[:, None, :] * fr[None, :, None]
        fx = pts[..., 0] / phantom.dx + (nx / 2 - 0.5)
        fy = pts[..., 1] / phantom.dy + (ny / 2 - 0.5)
        ix = np.clip(np.round(fx).astype(int), 0, nx - 1)
        iy = np.clip(np.round(fy).astype(int), 0, ny - 1)
        inside = ((fx > -0.5) & (fx < nx - 0.5)
                  & (fy > -0.5) & (fy < ny - 0.5))
        lab = np.where(inside, labels2d[iy, ix], -1)
        K = phantom.n_materials
        occ = np.zeros((len(p0), K))
        for kmat in range(K):
            occ[:, kmat] = (lab == kmat).sum(1)
        return occ * (lens / n_steps)[:, None]

    # sample (fan angle, energy, s): gamma CONTINUOUS over the fan —
    # the beam is a continuous fluence field (discrete-channel vertex
    # rays under-resolve small objects); with fan = C * dgamma the
    # importance weight below is unchanged
    g_half = 0.5 * ct.gamma_fan
    gam = rng.uniform(-g_half, g_half, n_samples)
    ei = rng.choice(len(e), n_samples, p=p_e)
    s = r0 + seg_len * rng.random(n_samples)
    angv = beta + gam
    u_in = -np.stack([np.cos(angv), np.sin(angv)], -1)  # [n, 2]
    vtx = src[None, :] + u_in * s[:, None]
    fxv = vtx[:, 0] / phantom.dx + (nx / 2 - 0.5)
    fyv = vtx[:, 1] / phantom.dy + (ny / 2 - 0.5)
    inside = ((fxv > 0) & (fxv < nx - 1) & (fyv > 0) & (fyv < ny - 1))
    ne_v = np.where(
        inside,
        ne_img[np.clip(np.round(fyv).astype(int), 0, ny - 1),
               np.clip(np.round(fxv).astype(int), 0, nx - 1)], 0.0)
    sel = ne_v > 0
    if not np.any(sel):
        return np.zeros(ct.N_channels), np.zeros(ct.N_channels)
    idx = np.where(sel)[0]
    t_in = march_paths(np.broadcast_to(src, (len(idx), 2)), vtx[idx])
    l_in = np.einsum("nk,kn->n", t_in, mu_table[:, ei[idx]])
    h_v = ct.h_iso * s[idx] / ct.SID  # illuminated z column
    # vertex weight: (photons n0[ei]/p? handled via p_e sampling) —
    # estimate = mean over samples of f/pdf with
    # f = N_tot_photons_density * ... ; pdf = p_e/(C * seg_len)
    # importance weight f/pdf: vertices sampled via (channel, s) with
    # pdf_area = 1/(C seg_len s dgamma); fluence = n0 SID/(dgamma h r^2)
    # -> the dgamma and one power of s cancel
    n_tot = n0.sum()
    # base vertex weight WITHOUT the interaction density: Compton
    # multiplies by n_e, Rayleigh by Sum n_i F_i(q)^2 (q per channel)
    w_base = (ct.N_channels * seg_len / n_samples) * n_tot \
        * np.exp(-l_in) * h_v * ct.SID / (ct.h_iso * s[idx])
    w_vtx = w_base * ne_v[idx]
    if coherent:
        f2_mat, q_grid = _material_f2_tables(
            phantom.materials, float(e.max()), 128)
        fxi = np.clip(np.round(vtx[idx, 0] / phantom.dx
                               + (nx / 2 - 0.5)).astype(int), 0, nx - 1)
        fyi = np.clip(np.round(vtx[idx, 1] / phantom.dy
                               + (ny / 2 - 0.5)).astype(int), 0, ny - 1)
        f2_v = f2_mat[labels2d[fyi, fxi]]  # [n, Qm]
        mu_e = mu_table[:, ei[idx]]  # [K, n] at the unshifted energy
        resp_e = ct.detector_response(e[ei[idx]])
        r2_e = xcom.ELECTRON_RADIUS_CM ** 2

    # NEE to every detector element
    tally = np.zeros(ct.N_channels)
    tally2 = np.zeros(ct.N_channels)
    e_i = e[ei[idx]]
    for c in range(ct.N_channels):
        dvec = det[c][None, :] - vtx[idx]
        r_d = np.linalg.norm(dvec, axis=-1)
        u_out = dvec / r_d[:, None]
        cos_t = np.einsum("nd,nd->n", u_in[idx], u_out)
        e_p = compton_energy(e_i, cos_t)
        kn = klein_nishina_differential(e_i, cos_t)
        nrm = (src - det[c]) / ct.SDD
        cos_inc = np.abs(u_out @ nrm)
        d_omega = a_det * cos_inc / r_d**2
        t_ex = march_paths(vtx[idx], np.broadcast_to(det[c],
                                                     (len(idx), 2)))
        mu_ep = phantom.materials.mu_table(e_p)  # [K, n]
        l_ex = np.einsum("nk,kn->n", t_ex, mu_ep)
        resp = ct.detector_response(e_p)
        w = w_vtx * kn * d_omega * np.exp(-l_ex) * resp
        if coherent:
            q = formfactor.momentum_transfer(e_i, cos_t)
            qi = np.clip(q / (q_grid[1] - q_grid[0]), 0.0,
                         len(q_grid) - 1.001)
            qi0 = qi.astype(int)
            wq = qi - qi0
            f2q = np.take_along_axis(f2_v, qi0[:, None], 1)[:, 0]
            f2q += wq * (np.take_along_axis(
                f2_v, qi0[:, None] + 1, 1)[:, 0] - f2q)
            l_exc = np.einsum("nk,kn->n", t_ex, mu_e)
            w = w + (w_base * 0.5 * r2_e * (1.0 + cos_t**2) * f2q
                     * d_omega * np.exp(-l_exc) * resp_e)
        tally[c] = w.sum()
        tally2[c] = (w * w).sum() * n_samples
    stderr = np.sqrt(np.maximum(tally2 - tally**2, 0.0) / n_samples)
    return tally, stderr


def mc_second_order_reference(phantom, ct, spec, beta, n_samples, *,
                              seed=0, march_step=None, z_index=None,
                              n_rows=None):
    """Host float64 Monte Carlo SECOND-order (Compton-Compton) scatter
    for ONE view: (scatter [C], stderr [C]) in detected units.

    Transport model: the phantom slice is z-extruded (a body is long
    compared with the beam), the beam illuminates the collimated slab
    (``n_rows`` x h_iso; default the geometry's slice), the detector
    band sits at z = 0.  First vertices are sampled exactly as in
    :func:`mc_single_scatter_reference`; the scattered direction is
    drawn from the Klein-Nishina phase function (inverse-CDF in
    cos theta, uniform azimuth, full 3-D), the second vertex is
    importance-sampled along the scattered ray inside the xy hull, and
    next-event estimation connects it to every detector element.
    Rayleigh chains are excluded (elastic + forward-peaked: their
    higher-order contribution changes neither energy nor direction
    much and is far below the MC noise at this order).

    The ratio sum(second)/sum(first) is the ``multiple_factor`` closure
    consumed by the deterministic estimators; second scatter is even
    smoother across channels than first, which is what justifies the
    flat multiplier (checked by test: the 2nd-order channel profile is
    broad and structureless).
    """
    rng = np.random.default_rng(seed)
    labels2d = np.asarray(phantom.slice_labels(z_index), np.int32)
    ny, nx = labels2d.shape
    if march_step is None:
        march_step = 0.5 * min(phantom.dx, phantom.dy)

    e = np.asarray(spec.E, np.float64)
    n0 = np.asarray(spec.I0, np.float64) * spec.bin_widths()
    live = n0 > 0
    e, n0 = e[live], n0[live]
    p_e = n0 / n0.sum()
    mu_table = phantom.materials.mu_table(e)  # [K, Elive]
    ne_img = electron_density_image(phantom, z_index)

    src2 = ct.SID * np.array([np.cos(beta), np.sin(beta)])
    ang = beta + ct.gammas
    det2 = src2[None, :] - ct.SDD * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    h_det = ct.h_iso * ct.SDD / ct.SID
    a_det = (ct.SDD * ct.dgamma) * h_det

    r_img = 0.5 * float(np.hypot(nx * phantom.dx, ny * phantom.dy))
    r0, r1 = ct.SID - r_img, ct.SID + r_img
    seg_len = r1 - r0
    if n_rows is None:
        n_rows = getattr(ct, "N_rows", 1)

    def march_xy(p0, p1):
        """Material paths along 2-D xy segments [n, K] (z-extruded)."""
        segv = p1 - p0
        lens = np.linalg.norm(segv, axis=-1)
        n_steps = max(int(np.ceil(max(lens.max(), 1e-9) / march_step)),
                      2)
        fr = (np.arange(n_steps) + 0.5) / n_steps
        pts = p0[:, None, :] + segv[:, None, :] * fr[None, :, None]
        fx = pts[..., 0] / phantom.dx + (nx / 2 - 0.5)
        fy = pts[..., 1] / phantom.dy + (ny / 2 - 0.5)
        ix = np.clip(np.round(fx).astype(int), 0, nx - 1)
        iy = np.clip(np.round(fy).astype(int), 0, ny - 1)
        inside = ((fx > -0.5) & (fx < nx - 0.5)
                  & (fy > -0.5) & (fy < ny - 0.5))
        lab = np.where(inside, labels2d[iy, ix], -1)
        K = phantom.n_materials
        occ = np.zeros((len(p0), K))
        for kmat in range(K):
            occ[:, kmat] = (lab == kmat).sum(1)
        return occ * (lens / n_steps)[:, None]

    def march_3d(p0_xyz, p1_xyz):
        """[n, K] material paths of 3-D segments through the extruded
        slice: xy marching scaled by the 3-D/2-D length ratio."""
        d2 = np.linalg.norm(p1_xyz[:, :2] - p0_xyz[:, :2], axis=-1)
        d3 = np.linalg.norm(p1_xyz - p0_xyz, axis=-1)
        t = march_xy(p0_xyz[:, :2], p1_xyz[:, :2])
        # degenerate xy (near-vertical ray): constant material column
        degen = d2 < 1e-9
        if np.any(degen):
            fx = np.clip(np.round(p0_xyz[degen, 0] / phantom.dx
                                  + (nx / 2 - 0.5)).astype(int),
                         0, nx - 1)
            fy = np.clip(np.round(p0_xyz[degen, 1] / phantom.dy
                                  + (ny / 2 - 0.5)).astype(int),
                         0, ny - 1)
            t[degen] = 0.0
            t[degen, labels2d[fy, fx]] = d3[degen]
        scale = np.where(degen, 1.0, d3 / np.maximum(d2, 1e-12))
        return t * scale[:, None]

    # --- stage 1: first Compton vertex (same sampling as 1st order) --
    g_half = 0.5 * ct.gamma_fan
    gam = rng.uniform(-g_half, g_half, n_samples)
    ei = rng.choice(len(e), n_samples, p=p_e)
    s = r0 + seg_len * rng.random(n_samples)
    angv = beta + gam
    u_in2 = -np.stack([np.cos(angv), np.sin(angv)], -1)
    vtx = src2[None, :] + u_in2 * s[:, None]
    fxv = vtx[:, 0] / phantom.dx + (nx / 2 - 0.5)
    fyv = vtx[:, 1] / phantom.dy + (ny / 2 - 0.5)
    inside = ((fxv > 0) & (fxv < nx - 1) & (fyv > 0) & (fyv < ny - 1))
    ne_v = np.where(
        inside,
        ne_img[np.clip(np.round(fyv).astype(int), 0, ny - 1),
               np.clip(np.round(fxv).astype(int), 0, nx - 1)], 0.0)
    sel = ne_v > 0
    if not np.any(sel):
        return np.zeros(ct.N_channels), np.zeros(ct.N_channels)
    idx = np.where(sel)[0]
    n1 = len(idx)
    t_in = march_xy(np.broadcast_to(src2, (n1, 2)), vtx[idx])
    l_in = np.einsum("nk,kn->n", t_in, mu_table[:, ei[idx]])
    # illuminated column n_rows*h(r); per-row fluence is collimation-
    # independent, so w1 scales with n_rows (matches the device
    # kernels' overlap gate)
    h_v = n_rows * ct.h_iso * s[idx] / ct.SID
    n_tot = n0.sum()
    w1 = (ct.N_channels * seg_len / n_samples) * n_tot \
        * np.exp(-l_in) * ne_v[idx] * h_v * ct.SID \
        / (ct.h_iso * s[idx])
    e_i = e[ei[idx]]

    # --- stage 2: KN-sampled scattered direction -------------------
    # per-spectrum-bin inverse CDF of the KN phase function in cos
    cgrid = np.linspace(-1.0, 1.0, 513)
    cmid = 0.5 * (cgrid[1:] + cgrid[:-1])
    kn_tab = klein_nishina_differential(e[:, None], cmid[None, :])
    sig_int = 2.0 * np.pi * kn_tab.sum(1) * (cgrid[1] - cgrid[0])
    cdf = np.cumsum(kn_tab, 1)
    cdf /= cdf[:, -1:]
    u = rng.random(n1)
    rows = ei[idx]
    ic = np.array([np.searchsorted(cdf[r], uu)
                   for r, uu in zip(rows, u)])
    cos1 = cmid[np.clip(ic, 0, len(cmid) - 1)]
    phi1 = rng.uniform(0.0, 2.0 * np.pi, n1)
    sin1 = np.sqrt(np.maximum(1.0 - cos1**2, 0.0))
    # orthonormal frame about the (in-plane) incident direction
    e1 = np.concatenate([u_in2[idx], np.zeros((n1, 1))], -1)
    e2 = np.stack([-u_in2[idx, 1], u_in2[idx, 0], np.zeros(n1)], -1)
    e3 = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (n1, 3))
    u1 = (cos1[:, None] * e1
          + (sin1 * np.cos(phi1))[:, None] * e2
          + (sin1 * np.sin(phi1))[:, None] * e3)
    e_1 = compton_energy(e_i, cos1)
    w2 = w1 * sig_int[rows]

    # --- second vertex along the scattered ray ----------------------
    x1 = np.concatenate([vtx[idx], np.zeros((n1, 1))], -1)
    # xy chord to the hull
    hx, hy = (nx / 2) * phantom.dx, (ny / 2) * phantom.dy
    t_exit = np.full(n1, np.inf)
    for axis, h in ((0, hx), (1, hy)):
        ua = u1[:, axis]
        pa = x1[:, axis]
        with np.errstate(divide="ignore"):
            t_hi = np.where(np.abs(ua) > 1e-12,
                            np.maximum((h - pa) / ua, (-h - pa) / ua),
                            np.inf)
        t_exit = np.minimum(t_exit, t_hi)
    diag = 2.0 * r_img
    # t_exit is already a 3-D ray parameter (the plane crossings above
    # use the 3-D direction's xy components), so no xy->3-D rescale is
    # applied (ADVICE round 4: the old |u1_xy| division double-counted
    # the correction and inflated t_max with zero-weight samples).
    # Near-vertical rays have an unbounded xy exit; the explicit 4*diag
    # cap bounds their z-extruded support, beyond which exp(-l_12)
    # through >~100 cm of body is numerically zero.
    t_max = np.clip(t_exit, 1e-6, 4.0 * diag)
    t2 = t_max * rng.random(n1)
    x2 = x1 + u1 * t2[:, None]
    fx2 = x2[:, 0] / phantom.dx + (nx / 2 - 0.5)
    fy2 = x2[:, 1] / phantom.dy + (ny / 2 - 0.5)
    in2 = ((fx2 > 0) & (fx2 < nx - 1) & (fy2 > 0) & (fy2 < ny - 1))
    ne_2 = np.where(
        in2, ne_img[np.clip(np.round(fy2).astype(int), 0, ny - 1),
                    np.clip(np.round(fx2).astype(int), 0, nx - 1)], 0.0)
    sel2 = ne_2 > 0
    if not np.any(sel2):
        return np.zeros(ct.N_channels), np.zeros(ct.N_channels)
    j = np.where(sel2)[0]
    t12 = march_3d(x1[j], x2[j])
    mu_e1 = phantom.materials.mu_table(e_1[j])  # [K, m]
    l_12 = np.einsum("nk,kn->n", t12, mu_e1)
    w3 = w2[j] * t_max[j] * ne_2[j] * np.exp(-l_12)

    # --- NEE from the second vertex to every element ----------------
    tally = np.zeros(ct.N_channels)
    tally2 = np.zeros(ct.N_channels)
    det3 = np.concatenate([det2, np.zeros((ct.N_channels, 1))], -1)
    u1j = u1[j]
    for c in range(ct.N_channels):
        dvec = det3[c][None, :] - x2[j]
        r_d = np.linalg.norm(dvec, axis=-1)
        u_out = dvec / r_d[:, None]
        cos2 = np.einsum("nd,nd->n", u1j, u_out)
        e_2 = compton_energy(e_1[j], cos2)
        kn2 = klein_nishina_differential(e_1[j], cos2)
        nrm = (src2 - det2[c]) / ct.SDD
        cos_inc = np.abs(u_out[:, :2] @ nrm)
        d_omega = a_det * cos_inc / r_d**2
        t_ex = march_3d(x2[j], np.broadcast_to(det3[c],
                                               (len(j), 3)))
        mu_e2 = phantom.materials.mu_table(e_2)
        l_ex = np.einsum("nk,kn->n", t_ex, mu_e2)
        resp = ct.detector_response(e_2)
        w = w3 * kn2 * d_omega * np.exp(-l_ex) * resp
        tally[c] = w.sum()
        tally2[c] = (w * w).sum() * n_samples
    stderr = np.sqrt(np.maximum(tally2 - tally**2, 0.0) / n_samples)
    return tally, stderr


def mc_multi_order_reference(phantom, ct, spec, beta, n_samples, *,
                             orders=8, seed=0, march_step=None,
                             z_index=None, n_rows=None, nee_channels=16,
                             e_cut_keV=10.0):
    """Host float64 deep-order Compton random walk for ONE view:
    per-order detected-scatter TOTALS ``(totals [orders], stderr
    [orders])`` in detected units.

    Round-5 VERDICT item 3: the ``multiple_factor`` closure was fitted
    at order 2 and extrapolated, but the protocol study's own
    measurement (MC 2nd/1st ~ 12 at 4-cm collimation on a 45-cm
    habitus) sits in a multiple-dominated regime where orders >= 3
    carry most of the energy.  This walk measures the order series
    directly so the applied tail can be CONVERGED instead of assumed.

    Transport model matches :func:`mc_second_order_reference` (extruded
    slice, collimated ``n_rows`` slab, KN phase-function sampling,
    importance-sampled inter-vertex distances inside the xy hull,
    Rayleigh chains excluded); next-event estimation runs at EVERY
    vertex.  Two estimator economies keep deep orders tractable:

    * NEE connects each vertex to a random ``nee_channels``-subset of
      detector elements per order, scaled by ``C/len(subset)`` — an
      unbiased TOTAL (scatter is broad and structureless across
      channels, the same smoothness the flat multiplier relies on);
    * photons below ``e_cut_keV`` after a scatter are killed (the
      detector response and exit transmission make their contribution
      negligible at CT energies; the truncation only LOWERS the tail,
      and the convergence curve shows where it no longer matters).

    The order-1 total reproduces
    ``mc_single_scatter_reference(coherent=False)`` and the order-2
    total reproduces :func:`mc_second_order_reference` within MC error
    (pinned in tests) — same physics, one consistent sampler.
    """
    rng = np.random.default_rng(seed)
    labels2d = np.asarray(phantom.slice_labels(z_index), np.int32)
    ny, nx = labels2d.shape
    if march_step is None:
        march_step = 0.5 * min(phantom.dx, phantom.dy)

    e = np.asarray(spec.E, np.float64)
    n0 = np.asarray(spec.I0, np.float64) * spec.bin_widths()
    live = n0 > 0
    e, n0 = e[live], n0[live]
    p_e = n0 / n0.sum()
    mu_of_e = phantom.materials.mu_table  # (E[n]) -> [K, n]
    mu_table = mu_of_e(e)
    ne_img = electron_density_image(phantom, z_index)

    src2 = ct.SID * np.array([np.cos(beta), np.sin(beta)])
    ang = beta + ct.gammas
    det2 = src2[None, :] - ct.SDD * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    det3 = np.concatenate([det2, np.zeros((ct.N_channels, 1))], -1)
    h_det = ct.h_iso * ct.SDD / ct.SID
    a_det = (ct.SDD * ct.dgamma) * h_det
    r_img = 0.5 * float(np.hypot(nx * phantom.dx, ny * phantom.dy))
    r0, r1 = ct.SID - r_img, ct.SID + r_img
    seg_len = r1 - r0
    if n_rows is None:
        n_rows = getattr(ct, "N_rows", 1)
    diag = 2.0 * r_img
    hx, hy = (nx / 2) * phantom.dx, (ny / 2) * phantom.dy

    def march_xy(p0, p1):
        segv = p1 - p0
        lens = np.linalg.norm(segv, axis=-1)
        n_steps = max(int(np.ceil(max(lens.max(), 1e-9) / march_step)),
                      2)
        fr = (np.arange(n_steps) + 0.5) / n_steps
        pts = p0[:, None, :] + segv[:, None, :] * fr[None, :, None]
        fx = pts[..., 0] / phantom.dx + (nx / 2 - 0.5)
        fy = pts[..., 1] / phantom.dy + (ny / 2 - 0.5)
        ix = np.clip(np.round(fx).astype(int), 0, nx - 1)
        iy = np.clip(np.round(fy).astype(int), 0, ny - 1)
        inside = ((fx > -0.5) & (fx < nx - 0.5)
                  & (fy > -0.5) & (fy < ny - 0.5))
        lab = np.where(inside, labels2d[iy, ix], -1)
        K = phantom.n_materials
        occ = np.zeros((len(p0), K))
        for kmat in range(K):
            occ[:, kmat] = (lab == kmat).sum(1)
        return occ * (lens / n_steps)[:, None]

    def march_3d(p0_xyz, p1_xyz):
        d2 = np.linalg.norm(p1_xyz[:, :2] - p0_xyz[:, :2], axis=-1)
        d3 = np.linalg.norm(p1_xyz - p0_xyz, axis=-1)
        t = march_xy(p0_xyz[:, :2], p1_xyz[:, :2])
        degen = d2 < 1e-9
        if np.any(degen):
            fx = np.clip(np.round(p0_xyz[degen, 0] / phantom.dx
                                  + (nx / 2 - 0.5)).astype(int),
                         0, nx - 1)
            fy = np.clip(np.round(p0_xyz[degen, 1] / phantom.dy
                                  + (ny / 2 - 0.5)).astype(int),
                         0, ny - 1)
            t[degen] = 0.0
            t[degen, labels2d[fy, fx]] = d3[degen]
        scale = np.where(degen, 1.0, d3 / np.maximum(d2, 1e-12))
        return t * scale[:, None]

    def ne_at(xy):
        fx = xy[:, 0] / phantom.dx + (nx / 2 - 0.5)
        fy = xy[:, 1] / phantom.dy + (ny / 2 - 0.5)
        inside = ((fx > 0) & (fx < nx - 1) & (fy > 0) & (fy < ny - 1))
        return np.where(
            inside,
            ne_img[np.clip(np.round(fy).astype(int), 0, ny - 1),
                   np.clip(np.round(fx).astype(int), 0, nx - 1)], 0.0)

    # KN inverse-CDF bank on a log-energy grid (post-scatter energies
    # are continuous; nearest-row lookup, 128 rows over the CT band)
    e_bank = np.geomspace(max(e_cut_keV * 0.5, 1.0), float(e.max()), 128)
    cgrid = np.linspace(-1.0, 1.0, 513)
    cmid = 0.5 * (cgrid[1:] + cgrid[:-1])
    kn_bank = klein_nishina_differential(e_bank[:, None], cmid[None, :])
    sig_bank = 2.0 * np.pi * kn_bank.sum(1) * (cgrid[1] - cgrid[0])
    cdf_bank = np.cumsum(kn_bank, 1)
    cdf_bank /= cdf_bank[:, -1:]

    def sample_kn(e_ph):
        rows = np.clip(np.searchsorted(e_bank, e_ph), 0,
                       len(e_bank) - 1)
        u = rng.random(len(e_ph))
        ic = np.array([np.searchsorted(cdf_bank[r], uu)
                       for r, uu in zip(rows, u)])
        cos1 = cmid[np.clip(ic, 0, len(cmid) - 1)]
        return cos1, sig_bank[rows]

    # --- first Compton vertex (same sampling as the 2nd-order MC) ----
    g_half = 0.5 * ct.gamma_fan
    gam = rng.uniform(-g_half, g_half, n_samples)
    ei = rng.choice(len(e), n_samples, p=p_e)
    s = r0 + seg_len * rng.random(n_samples)
    angv = beta + gam
    u_in2 = -np.stack([np.cos(angv), np.sin(angv)], -1)
    vtx = src2[None, :] + u_in2 * s[:, None]
    ne_v = ne_at(vtx)
    sel = ne_v > 0
    z = np.zeros(orders)
    if not np.any(sel):
        return z, z.copy()
    idx = np.where(sel)[0]
    t_in = march_xy(np.broadcast_to(src2, (len(idx), 2)), vtx[idx])
    l_in = np.einsum("nk,kn->n", t_in, mu_table[:, ei[idx]])
    # illuminated column at the vertex radius: the total weight
    # integrates the per-z fluence over the diverging collimated slab
    # (h_v * fluence-per-height), and the vertex HEIGHT is sampled
    # uniformly in that slab so the detector-band acceptance per order
    # falls out of the NEE geometry instead of a flat n_rows factor
    # (the flat factor scaled every order identically — it is the
    # order-2 closure's approximation, not transport)
    h_v = n_rows * ct.h_iso * s[idx] / ct.SID
    n_tot = n0.sum()
    w = (ct.N_channels * seg_len / n_samples) * n_tot \
        * np.exp(-l_in) * ne_v[idx] * h_v * ct.SID \
        / (ct.h_iso * s[idx])
    z1 = (rng.random(len(idx)) - 0.5) * h_v
    x = np.concatenate([vtx[idx], z1[:, None]], -1)
    u = np.concatenate([u_in2[idx], np.zeros((len(idx), 1))], -1)
    e_ph = e[ei[idx]]

    totals = np.zeros(orders)
    tot2 = np.zeros(orders)
    C = ct.N_channels
    for order in range(orders):
        if len(w) == 0:
            break
        # --- NEE to nee_channels PER-PHOTON random channels (unbiased
        # total; per-photon draws fold the channel-sampling variance
        # into the per-photon stderr, unlike a shared subset) ---------
        k_nee = min(nee_channels, C)
        w_ord = np.zeros(len(w))
        for _ in range(k_nee):
            c = rng.integers(0, C, len(w))
            dvec = det3[c] - x
            r_d = np.linalg.norm(dvec, axis=-1)
            u_out = dvec / r_d[:, None]
            cos_t = np.einsum("nd,nd->n", u, u_out)
            e_d = compton_energy(e_ph, cos_t)
            kn = klein_nishina_differential(e_ph, cos_t)
            nrm = (src2[None, :] - det2[c]) / ct.SDD
            cos_inc = np.abs(np.einsum("nd,nd->n", u_out[:, :2], nrm))
            d_omega = a_det * cos_inc / r_d**2
            t_ex = march_3d(x, det3[c])
            l_ex = np.einsum("nk,kn->n", t_ex, mu_of_e(e_d))
            resp = ct.detector_response(e_d)
            w_ord += w * kn * d_omega * np.exp(-l_ex) * resp
        w_ord *= C / k_nee
        totals[order] = w_ord.sum()
        tot2[order] = (w_ord * w_ord).sum() * n_samples
        if order == orders - 1:
            break
        # --- walk one more Compton scatter ---------------------------
        cos1, sig = sample_kn(e_ph)
        phi = rng.uniform(0.0, 2.0 * np.pi, len(w))
        sin1 = np.sqrt(np.maximum(1.0 - cos1**2, 0.0))
        # orthonormal frame about u
        a_ref = np.where(np.abs(u[:, 2:3]) < 0.9,
                         np.broadcast_to([0.0, 0.0, 1.0], u.shape),
                         np.broadcast_to([1.0, 0.0, 0.0], u.shape))
        e2v = np.cross(u, a_ref)
        e2v /= np.linalg.norm(e2v, axis=-1, keepdims=True)
        e3v = np.cross(u, e2v)
        u_new = (cos1[:, None] * u
                 + (sin1 * np.cos(phi))[:, None] * e2v
                 + (sin1 * np.sin(phi))[:, None] * e3v)
        e_new = compton_energy(e_ph, cos1)
        w = w * sig
        # next vertex along the scattered ray inside the xy hull
        # (t_exit is a 3-D ray parameter; 4*diag caps the z-extruded
        # support — ADVICE round 4)
        t_exit = np.full(len(w), np.inf)
        for axis, h in ((0, hx), (1, hy)):
            ua = u_new[:, axis]
            pa = x[:, axis]
            with np.errstate(divide="ignore"):
                t_hi = np.where(np.abs(ua) > 1e-12,
                                np.maximum((h - pa) / ua,
                                           (-h - pa) / ua), np.inf)
            t_exit = np.minimum(t_exit, t_hi)
        t_max = np.clip(t_exit, 1e-6, 4.0 * diag)
        t2 = t_max * rng.random(len(w))
        x_new = x + u_new * t2[:, None]
        ne_2 = ne_at(x_new[:, :2])
        alive = (ne_2 > 0) & (e_new > e_cut_keV)
        if not np.any(alive):
            break
        j = np.where(alive)[0]
        t12 = march_3d(x[j], x_new[j])
        l_12 = np.einsum("nk,kn->n", t12, mu_of_e(e_new[j]))
        w = w[j] * t_max[j] * ne_2[j] * np.exp(-l_12)
        x, u, e_ph = x_new[j], u_new[j], e_new[j]
    stderr = np.sqrt(np.maximum(tot2 - totals**2, 0.0) / n_samples)
    return totals, stderr


def multiple_to_single_factor(phantom, ct, spec, *, beta=0.0,
                              n_samples=40000, seed=0, z_index=None,
                              n_rows=None, orders=2, tail_bound=None):
    """Measured multiple-to-single detected-scatter ratio for a protocol.

    ``orders=2``: runs the single- and second-order MC references and
    returns ``sum(second) / (n_rows * sum(first))``.  The ``n_rows``
    normalization is a round-5 FIX: :func:`mc_second_order_reference`
    illuminates the full ``n_rows`` slab (w1 scales with n_rows) while
    :func:`mc_single_scatter_reference` is inherently 1-row, yet the
    deterministic estimator the factor multiplies models the full
    collimated slab — central-row detected single scatter also scales
    ~linearly with collimation (the slab subtends a small angle at the
    detector), so the round-4 ratio ``S2(R rows)/S1(1 row)`` ~ 12 at
    R=64 overstated the per-slab multiple fraction by ~R.  The
    deep-order walk below measures both at the true collimation and
    confirms the per-slab ratio is collimation-insensitive (~0.2 for a
    pelvis habitus at 120 kV).

    ``orders >= 3`` (round-5): runs the deep-order walk
    (:func:`mc_multi_order_reference`) and returns the CONVERGED
    multiple factor ``(sum_k>=2 S_k + geometric tail) / S_1``, where
    the tail extrapolates the measured last-order ratio
    ``r = S_K / S_{K-1}`` as ``S_K * r / (1 - r)``.  Pass a dict via
    ``tail_bound`` to receive the convergence diagnostics:
    ``series`` (per-order totals), ``stderr``, ``tail_fraction`` (the
    extrapolated remainder as a fraction of the returned multiple sum
    — the stated convergence bound), and ``r_last``.
    """
    if orders <= 2:
        s1, _ = mc_single_scatter_reference(
            phantom, ct, spec, beta, n_samples, seed=seed,
            z_index=z_index)
        s2, _ = mc_second_order_reference(
            phantom, ct, spec, beta, n_samples, seed=seed + 1,
            z_index=z_index, n_rows=n_rows)
        rows = (getattr(ct, "N_rows", 1) if n_rows is None
                else max(int(n_rows), 1))
        return float(s2.sum() / (rows * s1.sum()))
    totals, err = mc_multi_order_reference(
        phantom, ct, spec, beta, n_samples, orders=orders, seed=seed,
        z_index=z_index, n_rows=n_rows)
    s1 = totals[0]
    multi = float(totals[1:].sum())
    r_last = float(totals[-1] / totals[-2]) if totals[-2] > 0 else 0.0
    tail = (totals[-1] * r_last / (1.0 - r_last)
            if 0.0 < r_last < 1.0 else 0.0)
    if tail_bound is not None:
        tail_bound["series"] = totals
        tail_bound["stderr"] = err
        tail_bound["r_last"] = r_last
        tail_bound["tail_fraction"] = (float(tail / (multi + tail))
                                       if multi + tail > 0 else 0.0)
    return float((multi + tail) / s1)


# ---------------------------------------------------------------------------
# Cone-beam (3-D) single scatter — the regime where scatter matters:
# SPR grows ~linearly with collimation width (thin-fan scatter immunity
# is exactly what wide-cone scanners give up)

# ---------------------------------------------------------------------------
# Cone-beam (3-D) single scatter — the regime where scatter matters:
# SPR grows ~linearly with collimation width (thin-fan scatter immunity
# is exactly what wide-cone scanners give up)
# ---------------------------------------------------------------------------

def _scatter_scan_cone(labels3, ne_w, f2w, cell_xyz, mu_gE, mu_fine,
                       resp_fine, resp_g, n0_g, betas, det_gk, scalars, *,
                       n_mats, s_in, s_out, coherent, x_block=1024,
                       d_block=32):
    """Cone-beam single scatter: [V, D] float32.

    The JAX program ``dexct_tpu.ops.scatter_physics._scatter_scan_cone``
    on tensors of one device: uint8 ``labels3`` [nz, ny, nx]; ``det_gk``
    [D, 2] the evaluated detector elements as (fan angle gamma, axial
    tangent t); ``cell_xyz`` [X, 3] 3-D vertices, ``ne_w`` electrons per
    unit z (cell xy-area folded); ``f2w`` [X, Q] the cells' coherent
    weight; the spectral tables as for :func:`_scatter_scan`; the host
    float32 ``scalars`` (sid, sdd, dx, dy, dz, geom_const, e_fine0,
    de_fine, a_det, g_half_fan, t_half_beam, half_cell_z, dq_inv) + e_g.
    The axial beam gate is FRACTIONAL: each cell contributes its overlap
    length with the collimated slab |z| < t_half * r, with the scatter
    geometry evaluated at the overlap midpoint — a hard gate zeroes every
    vertex when the beam is thinner than a cell (the N_rows=1 anchor
    case).  CUDA tensors run kernel K27 (counted in
    ``_scatter_scan_cone.launches``); CPU tensors run
    :func:`_scatter_plain` in ``x_block`` x ``d_block`` blocks."""
    return _scatter_dispatch(True, labels3, ne_w, f2w, cell_xyz, mu_gE,
                             mu_fine, resp_fine, resp_g, n0_g, betas, det_gk,
                             scalars, n_mats=n_mats, s_in=s_in, s_out=s_out,
                             x_block=x_block, d_block=d_block,
                             coherent=coherent)


_scatter_scan_cone.launches = 0


def _conebeam_prep(phantom, ct, spec, *, coarse, n_energy, n_fine, s_in,
                   s_out, views, channel_sub, row_sub, coherent, n_q, device):
    """Host set-up of :func:`single_scatter_conebeam`, as the JAX package
    does it: the arguments of :func:`_scatter_scan_cone` on ``device``,
    its keywords, and (row tangents, evaluated rows, fan angles, evaluated
    channels)."""
    labels3 = np.asarray(phantom.labels, np.int32)
    nz, ny, nx = labels3.shape
    n_mats = phantom.n_materials
    # the marches slab-clip to the grid hull, so every step lands
    # in-grid: half the PRE-CLIP step counts keep the old in-grid
    # sampling density (the clip fraction of a source/detector segment
    # is ~0.3-0.5) at half the march cost — accuracy pinned by the MC
    # cross-validation tests
    if s_in is None:
        s_in = max(nx, ny) // 2
    if s_out is None:
        s_out = max(nx, ny) // 4
    betas = np.asarray(ct.betas if views is None else views, np.float64)

    # coarse 3-D vertex grid (pad, never crop)
    ne3 = (phantom.materials.densities * np.array(
        [m.electrons_per_gram() for m in phantom.materials]))[labels3]
    cf = int(coarse)
    ncz, ncy, ncx = -(-nz // cf), -(-ny // cf), -(-nx // cf)
    ne_pad = np.pad(ne3, ((0, ncz * cf - nz), (0, ncy * cf - ny),
                          (0, ncx * cf - nx)))
    ne_cells = ne_pad.reshape(ncz, cf, ncy, cf, ncx, cf).mean((1, 3, 5))
    xs = ((np.arange(ncx) + 0.5) * cf - nx / 2) * phantom.dx
    ys = ((np.arange(ncy) + 0.5) * cf - ny / 2) * phantom.dy
    zs = ((np.arange(ncz) + 0.5) * cf - nz / 2) * phantom.dz
    vz, vy, vx = np.meshgrid(zs, ys, xs, indexing="ij")
    cell_xyz = np.stack([vx.ravel(), vy.ravel(), vz.ravel()], -1)
    keep = ne_cells.ravel() > 0
    cell_xyz = cell_xyz[keep]
    cell_area = (cf * phantom.dx) * (cf * phantom.dy)
    # electrons per unit z: the axial extent enters via the in-kernel
    # fractional beam-cell overlap
    ne_w = ne_cells.ravel()[keep] * cell_area
    e_g, n0_g = _rebin_spectrum(spec, n_energy)
    if coherent:
        lab_blk = np.pad(labels3, ((0, ncz * cf - nz),
                                   (0, ncy * cf - ny),
                                   (0, ncx * cf - nx))).reshape(
            ncz, cf, ncy, cf, ncx, cf)
        f2_mat, q_grid = _material_f2_tables(phantom.materials,
                                             e_g.max(), n_q)
        f2_cells = np.zeros((ncz, ncy, ncx, n_q))
        for k in range(len(f2_mat)):
            if not np.any(f2_mat[k]):
                continue
            occ = (lab_blk == k).mean((1, 3, 5))
            f2_cells += occ[..., None] * f2_mat[k][None, None, None, :]
        f2w = f2_cells.reshape(-1, n_q)[keep] * cell_area
        dq_inv = 1.0 / (q_grid[1] - q_grid[0])
    else:
        f2w = np.zeros((len(ne_w), 1))
        dq_inv = 1.0
    # evaluated detector elements: subsampled rows x channels
    gam_all = np.asarray(ct.gammas, np.float64)
    t_all = np.asarray(ct.z_iso, np.float64) / ct.SID  # row tangents
    cs = max(int(channel_sub), 1)
    rs_ = max(int(row_sub), 1)
    ci = np.unique(np.append(np.arange(0, len(gam_all), cs),
                             len(gam_all) - 1))
    ri = np.unique(np.append(np.arange(0, len(t_all), rs_),
                             len(t_all) - 1))
    gg, tt = np.meshgrid(gam_all[ci], t_all[ri], indexing="xy")
    det_gk = np.stack([gg.ravel(), tt.ravel()], -1)  # [D, 2]

    mu_gE = phantom.materials.mu_table(e_g)
    e_min_p = float(compton_energy(e_g.min(), -1.0)) * 0.95
    e_fine = np.linspace(e_min_p, float(e_g.max()) * 1.001, n_fine)
    mu_fine = phantom.materials.mu_table(e_fine)
    resp_fine = np.asarray(ct.detector_response(e_fine), np.float64)
    resp_g = np.asarray(ct.detector_response(e_g), np.float64)

    h_det = ct.h_iso * ct.SDD / ct.SID
    a_det = (ct.SDD * ct.dgamma) * h_det
    geom_const = ct.SID / (ct.dgamma * ct.h_iso)
    t_half = 0.5 * ct.N_rows * ct.h_iso / ct.SID

    scalars = np.concatenate([
        [ct.SID, ct.SDD, phantom.dx, phantom.dy, phantom.dz, geom_const,
         float(e_fine[0]), float(e_fine[1] - e_fine[0]), a_det,
         0.5 * ct.gamma_fan, t_half, 0.5 * cf * phantom.dz, dq_inv],
        e_g])
    args = (labels_u8(labels3, device), _f32(ne_w, device),
            _f32(f2w, device), _f32(cell_xyz, device), _f32(mu_gE, device),
            _f32(mu_fine, device), _f32(resp_fine, device),
            _f32(resp_g, device), _f32(n0_g, device), _f32(betas, device),
            _f32(det_gk, device), np.asarray(scalars, np.float32))
    kw = dict(n_mats=n_mats, s_in=int(s_in), s_out=int(s_out),
              coherent=bool(coherent))
    return args, kw, (t_all, ri, gam_all, ci)


def single_scatter_conebeam(phantom, ct, spec, *, coarse=4, n_energy=10,
                            n_fine=96, s_in=None, s_out=None, views=None,
                            channel_sub=8, row_sub=2, x_block=1024,
                            d_block=32, view_chunk=4, coherent=True,
                            n_q=48, multiple_factor=0.0, device=None):
    """Cone-beam scatter sinogram [V, N_rows, N_channels]
    (single Compton + single Rayleigh + optional multiple tail — see
    :func:`single_scatter_sinogram`).

    ``ct`` is a circular :class:`~dexct_tpu_torch.system.geometry.
    ConeBeamGeometry` (helical: pass explicit ``views`` of a circular
    proxy — scatter varies slowly along z).  Same physics and
    discretization strategy as :func:`single_scatter_sinogram`, with
    3-D vertices filling the collimated slab, trilinear path marching,
    fully 3-D Compton geometry, and (row, channel) subsampling +
    bilinear upsampling of the smooth scatter surface.

    Thin-collimation anchor: with ``N_rows=1`` this reproduces the
    MC-validated fan-beam estimator (pinned by test).  Runs on ``device``
    (default: the card: kernel K27); ``x_block``/``d_block`` block the
    plain twin, ``view_chunk`` is accepted and ignored.
    """
    del view_chunk
    args, kw, (t_all, ri, gam_all, ci) = _conebeam_prep(
        phantom, ct, spec, coarse=coarse, n_energy=n_energy, n_fine=n_fine,
        s_in=s_in, s_out=s_out, views=views, channel_sub=channel_sub,
        row_sub=row_sub, coherent=coherent, n_q=n_q,
        device=torch.device("cuda" if device is None else device))
    s_eval = _scatter_scan_cone(*args, **kw, x_block=x_block,
                                d_block=d_block
                                ).cpu().numpy().astype(np.float64)
    n_views = s_eval.shape[0]
    s_eval = s_eval * (1.0 + float(multiple_factor))
    s_eval = s_eval.reshape(n_views, len(ri), len(ci))

    # bilinear upsample (rows, then channels) of the smooth surface
    out = np.empty((n_views, ct.N_rows, ct.N_channels))
    for i in range(n_views):
        tmp = np.empty((ct.N_rows, len(ci)))
        for j in range(len(ci)):
            tmp[:, j] = np.interp(t_all, t_all[ri], s_eval[i, :, j])
        for r in range(ct.N_rows):
            out[i, r] = np.interp(gam_all, gam_all[ci], tmp[r])
    return out
