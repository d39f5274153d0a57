"""Rigid patient motion: artifact simulation, motion-compensated
reconstruction and sinogram-domain motion estimation.

Port of :mod:`dexct_tpu.ops.motion`.  A rigid object pose at view v
(rotation ``phi_v`` about the isocentre, translation ``d_v``) maps
object-frame points to the world, ``x_world = R(phi_v) x_obj + d_v``.

* **Simulation** is exact: the view's rays are mapped into the object frame
  (:func:`rays_in_object_frame`, host float64) and traced through the static
  phantom by the exact trace, K1 in 2-D and K10 in 3-D.  One exact per-ray
  trace serves every grid, so the JAX package's ``method`` choice
  ('dominant' packed fast path or the DDA walk) is accepted and ignored.
* **Motion-compensated reconstruction**: each view evaluates a pixel at its
  posed world position ``x_v = R(phi_v) x + d_v``.  Three kernels, each
  behind a wrapper that dispatches on the device of its tensors (CUDA
  tensors launch the kernel, CPU tensors run the plain PyTorch version
  beside it):

  - :func:`fan_backproject_motion`: K30 (``csrc/fan_backproject.cu``), K4
    with the pose; at ``phi = d = 0`` it is K4 bit for bit;
  - :func:`_fdk_backproject_motion`: K32 (``csrc/cone_backproject.cu``),
    circular FDK with posed voxels (z + dz_v) and the accumulated-coverage
    normalisation;
  - :func:`_helical_backproject_motion`: K33 (the same source), the 'full'
    generalized-Feldkamp helical backprojection with posed voxels and each
    view's 2 pi window centred on the source's passage of the posed z.

* **Estimation**: :func:`estimate_translation` fits a smooth translation
  track to the fan-angle centroid of each view (host float64 Gauss-Newton);
  :func:`estimate_motion_joint` fits an image and the track jointly through
  the differentiable motion-forward model (the Fourier-slice Radon
  transform, K7 with its adjoint K21 in autograd's backward pass, then the
  plain PyTorch fan resampler :func:`_radon_resample_fan`) with Adam.

The JAX module's measured limits (compensation floors, estimator
accuracy) are its docstring's; they hold for the port's plain versions,
which its tests hold to the JAX functions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import kernels
from ..utils.devices import as_float, device_of, upload

__all__ = ["MotionProfile", "rays_in_object_frame",
           "material_path_sinogram_motion", "fan_backproject_motion",
           "fbp_recon_motion", "estimate_translation",
           "estimate_motion_joint", "cosine_motion_basis",
           "MotionProfile3D", "cone_material_paths_motion",
           "fdk_reconstruct_motion", "helical_fdk_reconstruct_motion"]


# --------------------------------------------------------------------------
# motion profiles (host NumPy, as the JAX module's)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MotionProfile:
    """Rigid in-plane object pose per view.

    ``phi``: [V] rotation about isocenter [rad]; ``disp``: [V, 2]
    translation (dx, dy) [cm].  Pose maps object-frame points to world:
    ``x_world(v) = R(phi_v) x_obj + disp_v``.
    """

    phi: np.ndarray
    disp: np.ndarray

    def __post_init__(self):
        self.phi = np.asarray(self.phi, dtype=np.float64)
        self.disp = np.asarray(self.disp, dtype=np.float64)
        if self.phi.ndim != 1 or self.disp.shape != (len(self.phi), 2):
            raise ValueError("phi must be [V], disp [V, 2]")

    @property
    def n_views(self):
        return len(self.phi)

    @classmethod
    def static(cls, n_views):
        return cls(np.zeros(n_views), np.zeros((n_views, 2)))

    @classmethod
    def breathing(cls, n_views, amplitude_cm=0.5, cycles=1.5,
                  direction=(0.0, 1.0), phase=0.0):
        """Smooth quasi-periodic drift: raised-cosine displacement along
        ``direction`` with ``cycles`` periods over the scan (respiratory
        drift is ~0.2-0.3 Hz vs a 0.25-1 s rotation)."""
        s = np.arange(n_views) / max(n_views - 1, 1)
        a = 0.5 * amplitude_cm * (1.0 - np.cos(2 * np.pi * cycles * s
                                                + phase))
        d = np.asarray(direction, dtype=np.float64)
        d = d / np.linalg.norm(d)
        return cls(np.zeros(n_views), a[:, None] * d[None, :])

    @classmethod
    def jerk(cls, n_views, at_frac=0.5, disp_cm=(0.3, 0.0), width_frac=0.02):
        """Step displacement at ``at_frac`` of the scan, smoothed over
        ``width_frac`` of the views (an involuntary patient shift)."""
        s = np.arange(n_views) / max(n_views - 1, 1)
        w = max(width_frac, 1e-6)
        ramp = np.clip((s - at_frac) / w + 0.5, 0.0, 1.0)
        return cls(np.zeros(n_views),
                   ramp[:, None] * np.asarray(disp_cm, np.float64)[None, :])

    @classmethod
    def rotation_drift(cls, n_views, total_rad=0.02):
        """Linear rotation drift over the scan (gantry-synchronized
        rolling motion)."""
        s = np.arange(n_views) / max(n_views - 1, 1)
        return cls(total_rad * s, np.zeros((n_views, 2)))


@dataclasses.dataclass
class MotionProfile3D:
    """Rigid 3-D object pose per view: rotation ``phi_v`` about the z
    axis through isocenter plus translation ``disp_v = (dx, dy, dz)``
    [cm].  Pose maps object-frame points to world:
    ``x_world(v) = R_z(phi_v) x_obj + disp_v``.  The z component is the
    clinical case for cone/helical scans (respiratory drift)."""

    phi: np.ndarray
    disp: np.ndarray

    def __post_init__(self):
        self.phi = np.asarray(self.phi, dtype=np.float64)
        self.disp = np.asarray(self.disp, dtype=np.float64)
        if self.phi.ndim != 1 or self.disp.shape != (len(self.phi), 3):
            raise ValueError("phi must be [V], disp [V, 3]")

    @property
    def n_views(self):
        return len(self.phi)

    @classmethod
    def static(cls, n_views):
        return cls(np.zeros(n_views), np.zeros((n_views, 3)))

    @classmethod
    def breathing_z(cls, n_views, amplitude_cm=0.5, cycles=1.5, phase=0.0):
        """Raised-cosine axial drift — respiration along the scanner
        axis during a cone-beam rotation."""
        s = np.arange(n_views) / max(n_views - 1, 1)
        a = 0.5 * amplitude_cm * (1.0 - np.cos(2 * np.pi * cycles * s
                                                + phase))
        d = np.zeros((n_views, 3))
        d[:, 2] = a
        return cls(np.zeros(n_views), d)

    @classmethod
    def from_2d(cls, motion2d):
        """Lift a :class:`MotionProfile` into the z=0 plane."""
        d = np.zeros((motion2d.n_views, 3))
        d[:, :2] = motion2d.disp
        return cls(motion2d.phi.copy(), d)


# --------------------------------------------------------------------------
# simulation: rays into the object frame
# --------------------------------------------------------------------------

def rays_in_object_frame(src, dirs, phi, disp):
    """Map world-frame rays into the moving object's frame (host,
    float64).

    src, dirs: [V, ..., D] with D = 2 (fan) or 3 (cone; rotation about
    z); phi: [V]; disp: [V, D].  Returns (src', dirs') with
    ``x_obj = R_z(-phi_v) (x_world - d_v)`` applied per view — the
    object is static in its own frame, so the static exact tracers see
    the motion-blurred acquisition exactly.
    """
    src = np.asarray(src, np.float64)
    dirs = np.asarray(dirs, np.float64)
    extra = src.ndim - 2  # batch dims beyond the view axis
    shape = (-1,) + (1,) * extra
    c = np.cos(np.asarray(phi, np.float64)).reshape(shape)
    s = np.sin(np.asarray(phi, np.float64)).reshape(shape)
    d = np.asarray(disp, np.float64).reshape(
        (len(phi),) + (1,) * extra + (src.shape[-1],))

    def rot_neg(p):  # R_z(-phi) p, per view; z (if any) untouched
        out = [c * p[..., 0] + s * p[..., 1],
               -s * p[..., 0] + c * p[..., 1]]
        if p.shape[-1] == 3:
            out.append(p[..., 2])
        return np.stack(out, axis=-1)

    return rot_neg(src - d), rot_neg(dirs)


def _check_views(motion, geometry):
    if motion.n_views != geometry.N_proj:
        raise ValueError(
            f"motion has {motion.n_views} views, geometry {geometry.N_proj}")


def material_path_sinogram_motion(phantom, geometry, motion, *, device=None,
                                  dtype=torch.float32, method="auto"):
    """Material-path sinogram [V, C, M] of a rigidly moving phantom.

    Exact Siddon (K1 on the card) on per-view object-frame rays, on
    ``device`` (default: the card).  Voxel phantoms only.  ``method`` (the
    JAX package's choice of tracer) is accepted and ignored: one exact
    trace serves every grid.
    """
    del method
    from .siddon import labels_tensor, trace_paths

    _check_views(motion, geometry)
    if not hasattr(phantom, "slice_labels"):
        raise ValueError(
            "material_path_sinogram_motion supports voxel phantoms only "
            f"(got {type(phantom).__name__}); rasterize analytic "
            "phantoms first")
    dev = device_of(None, device)
    src, dirs = geometry.ray_geometry()
    src_o, dirs_o = rays_in_object_frame(src, dirs, motion.phi, motion.disp)
    return trace_paths(labels_tensor(phantom, dev),
                       upload(src_o, dev, dtype), upload(dirs_o, dev, dtype),
                       float(phantom.dx), float(phantom.dy),
                       n_materials=phantom.n_materials)


def cone_material_paths_motion(phantom, geometry, motion, *, device=None,
                               dtype=torch.float32, method="auto"):
    """Exact cone-beam material paths of a rigidly moving phantom:
    [N_proj, N_rows, N_channels, n_materials], traced by K10 on the
    object-frame rays on ``device`` (default: the card).  ``method`` is
    accepted and ignored (one exact trace)."""
    del method
    from .conebeam import labels_u8, trace_paths_3d

    _check_views(motion, geometry)
    dev = device_of(None, device)
    src, dirs = geometry.ray_geometry_3d()  # [V, R, C, 3] float64
    src_o, dirs_o = rays_in_object_frame(src, dirs, motion.phi, motion.disp)
    return trace_paths_3d(
        labels_u8(np.asarray(phantom.labels), dev),
        upload(src_o, dev, dtype), upload(dirs_o, dev, dtype),
        phantom.dx, phantom.dy, phantom.dz, n_materials=phantom.n_materials)


# --------------------------------------------------------------------------
# K30: motion-compensated fan backprojection
# --------------------------------------------------------------------------

def _pose(phi, disp, dev):
    """cos phi, sin phi and the displacement columns as contiguous float32
    tensors on ``dev`` (cos and sin taken there in float32, as the JAX
    programs do)."""
    phi, disp = as_float(phi, dev).float(), as_float(disp, dev).float()
    return (torch.cos(phi).contiguous(), torch.sin(phi).contiguous(),
            *(disp[:, i].contiguous() for i in range(disp.shape[1])))


def fan_backproject_motion_plain(q, betas, sid, dgamma, n_matrix, fov, phi,
                                 disp, dbeta, *, view_block=64):
    """The JAX program ``fan_backproject_motion`` in torch: blocks of
    ``view_block`` views, every pixel at once."""
    from .fbp_fast import _pixel_coords

    dtype, dev = q.dtype, q.device
    n_proj, n_ch = q.shape
    X, Y = _pixel_coords(n_matrix, fov, dtype, dev)
    betas = betas.to(device=dev, dtype=dtype)
    phi = torch.as_tensor(phi, dtype=dtype, device=dev)
    disp = torch.as_tensor(disp, dtype=dtype, device=dev)
    img = torch.zeros(n_matrix * n_matrix, dtype=dtype, device=dev)
    for v0 in range(0, n_proj, view_block):
        sl = slice(v0, v0 + view_block)
        ph, d = phi[sl, None], disp[sl]
        cp, sp = torch.cos(ph), torch.sin(ph)
        Xv = cp * X[None] - sp * Y[None] + d[:, 0:1]
        Yv = sp * X[None] + cp * Y[None] + d[:, 1:2]
        beta = betas[sl, None]
        cb, sb = torch.cos(beta), torch.sin(beta)
        vr = Xv * cb + Yv * sb - sid
        vt = -Xv * sb + Yv * cb
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
        img += torch.where(inside, qi / L2, torch.zeros_like(qi)).sum(0)
    return (img * dbeta).reshape(n_matrix, n_matrix)


def _fan_motion_cuda(q, betas, sid, dgamma, n_matrix, fov, phi, disp, dbeta):
    dev = q.device
    V, C = q.shape
    kernels.require(q, "q", dev, torch.float32)
    betas = betas.to(device=dev, dtype=torch.float32)
    if betas.shape != (V,):
        raise ValueError(f"betas must be [{V}], got {tuple(betas.shape)}")
    cos_b, sin_b = torch.cos(betas).contiguous(), torch.sin(betas).contiguous()
    cos_p, sin_p, dx, dy = _pose(phi, disp, dev)
    out = torch.empty((n_matrix, n_matrix), dtype=torch.float32, device=dev)
    rc = kernels.library().dexct_fan_backproject_motion(
        q.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), cos_p.data_ptr(),
        sin_p.data_ptr(), dx.data_ptr(), dy.data_ptr(), out.data_ptr(), V, C,
        n_matrix, fov / n_matrix, n_matrix / 2.0, sid, dgamma, dbeta,
        kernels.stream_ptr(dev))
    kernels.check(rc, "fan_backproject_motion")
    fan_backproject_motion.launches += 1
    return out


def fan_backproject_motion(q, betas, sid, dgamma, n_matrix, fov, phi, disp,
                           *, view_block=64, dbeta=None):
    """Motion-compensated distance-weighted equiangular backprojection.

    As :func:`~dexct_tpu_torch.ops.fbp.fan_backproject` except that each
    view evaluates the pixel at its world position under the view's pose,
    ``x_v = R(phi_v) x + d_v``.  q: [V, C] filtered sinogram; betas, phi:
    [V]; disp: [V, 2]; ``dbeta`` defaults to 2 pi / V.  Returns [N, N].
    CUDA tensors run kernel K30 (counted in
    ``fan_backproject_motion.launches``; ``phi = disp = 0`` gives K4's image
    bit for bit); CPU tensors run :func:`fan_backproject_motion_plain`
    (``view_block`` views at a time).
    """
    n_proj, n_ch = q.shape
    if n_ch < 2:
        raise ValueError("fan backprojection needs at least 2 channels")
    _check_pose(phi, disp, n_proj, 2)
    if dbeta is None:
        dbeta = 2.0 * np.pi / n_proj if n_proj else 0.0
    args = (q, betas, float(sid), float(dgamma), int(n_matrix), float(fov),
            phi, disp, float(dbeta))
    if q.is_cuda:
        return _fan_motion_cuda(*args)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return fan_backproject_motion_plain(*args, view_block=view_block)


fan_backproject_motion.launches = 0


def fbp_recon_motion(sino_log, geometry, n_matrix, fov, motion, ramp=0.8,
                     window="sinc", mu_water_eff=None, dtype=torch.float32,
                     *, device=None):
    """Motion-compensated fan-beam FBP: (recon_raw, recon_HU or None).

    Filter and Parker weighting exactly as the static
    :func:`~dexct_tpu_torch.ops.fbp.fbp_recon`; the backprojection (K30)
    along the motion-transformed rays.  Runs on the device of
    ``sino_log`` when it is a tensor, else on ``device`` (default: the
    card).
    """
    from .fbp import filter_sinogram, hu_image, parker_weights

    _check_views(motion, geometry)
    dev = device_of(sino_log, device)
    sino_log = as_float(sino_log, dev).to(dtype)
    if geometry.rotation_total < 2.0 * np.pi - 1e-6:
        sino_log = sino_log * torch.as_tensor(parker_weights(geometry),
                                              dtype=dtype, device=dev)
    q = filter_sinogram(sino_log, geometry, ramp, window).contiguous()
    img = fan_backproject_motion(
        q, upload(geometry.betas, dev, dtype),
        float(geometry.SID), float(geometry.dgamma), int(n_matrix),
        float(fov), motion.phi, motion.disp,
        dbeta=float(geometry.rotation_total) / geometry.N_proj)
    if mu_water_eff is None:
        return img, None
    return img, hu_image(img, mu_water_eff)


# --------------------------------------------------------------------------
# estimation (host float64, as the JAX module's)
# --------------------------------------------------------------------------

def _host64(x):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def cosine_motion_basis(n_views, n_modes=6):
    """Smooth temporal basis B [V, K]: DC-free raised cosines
    cos(pi k s), k=1..K, s in [0,1] — zero at s=0 so the fitted track
    is anchored to the scan start (the DC component is degenerate with
    the unknown static center of mass)."""
    s = np.arange(n_views) / max(n_views - 1, 1)
    k = np.arange(1, n_modes + 1)
    return 1.0 - np.cos(np.pi * k[None, :] * s[:, None])


def estimate_translation(sino_log, geometry, *, n_modes=6, n_iters=25,
                         basis=None, reg=0.01):
    """Estimate a rigid translation track from the sinogram alone.

    Fits ``d_v = B_v @ coeffs`` (B a smooth ``cosine_motion_basis``) and
    the static center of mass ``c0`` to the measured fan-angle centroid
    track by Gauss-Newton on the exact point-projection model
    ``g_v = atan2(-w_v·t̂_v, SID - w_v·û_v)``, ``w_v = c0 + d_v``, on the
    host in float64 (a tensor ``sino_log`` is copied there).  The
    coefficient block carries a relative Tikhonov ridge ``reg`` (fraction
    of the block's mean diagonal) that pins the unobservable
    instantaneous-radial directions at zero.

    Returns a :class:`MotionProfile` (phi=0) and the fitted ``c0``.
    """
    p = _host64(sino_log)
    V, C = p.shape
    gam = (np.arange(C) + 0.5 - C / 2.0) * geometry.dgamma
    mass = np.maximum(p.sum(axis=1), 1e-12)
    g_meas = (p * gam[None, :]).sum(axis=1) / mass  # [V]

    betas = np.asarray(geometry.betas, dtype=np.float64)
    u = np.stack([np.cos(betas), np.sin(betas)], -1)   # [V,2] radial
    t = np.stack([-np.sin(betas), np.cos(betas)], -1)  # [V,2] tangential
    B = (np.asarray(basis, np.float64) if basis is not None
         else cosine_motion_basis(V, n_modes))
    K = B.shape[1]
    sid = float(geometry.SID)

    theta = np.zeros(2 + 2 * K)  # [c0x, c0y, ax(1..K), ay(1..K)]

    def track(th):
        c0 = th[:2]
        d = np.stack([B @ th[2:2 + K], B @ th[2 + K:]], axis=-1)
        w = c0[None, :] + d  # [V,2]
        wt = (w * t).sum(1)
        wu = (w * u).sum(1)
        return np.arctan2(-wt, sid - wu), w, wt, wu

    for _ in range(n_iters):
        g, w, wt, wu = track(theta)
        r = g - g_meas
        # d g / d w = -((sid - wu) t + wt u) / L2
        L2 = wt * wt + (sid - wu) ** 2
        dg_dw = -((sid - wu)[:, None] * t + wt[:, None] * u) / L2[:, None]
        # d w / d theta: c0 -> I; ax_k -> B[:,k] e_x; ay_k -> B[:,k] e_y
        J = np.empty((V, 2 + 2 * K))
        J[:, 0:2] = dg_dw
        J[:, 2:2 + K] = B * dg_dw[:, :1]
        J[:, 2 + K:] = B * dg_dw[:, 1:2]
        JtJ = J.T @ J
        damp = np.zeros(2 + 2 * K)
        damp[2:] = reg * np.mean(np.diag(JtJ)[2:])
        JtJ += np.diag(damp) + 1e-14 * np.eye(2 + 2 * K)
        step = np.linalg.solve(JtJ, J.T @ r + damp * theta)
        theta = theta - step
        if np.max(np.abs(step)) < 1e-12:
            break

    c0 = theta[:2]
    d = np.stack([B @ theta[2:2 + K], B @ theta[2 + K:]], axis=-1)
    return MotionProfile(np.zeros(V), d), c0


# --------------------------------------------------------------------------
# K32 / K33: motion-compensated circular FDK and helical gFDK
# --------------------------------------------------------------------------

def _z_grid(nz_out, dz_out, z0, device):
    """Slice centres z0 + k dz_out, in float64 on the host and then rounded
    to float32, as the JAX motion programs build them (uploaded: no
    synchronisation)."""
    return upload((z0 + np.arange(nz_out) * dz_out).astype(np.float32),
                  device)


def _posed_inplane(X, Y, beta, ph, d, sid, dgamma, C):
    """Per-(view, pixel) tap geometry [B, P] of the JAX motion programs:
    the posed (x, y), then channel tap, 1/sqrt(h^2) and w_in / h^2."""
    cp, sp = torch.cos(ph)[:, None], torch.sin(ph)[:, None]
    Xv = cp * X[None] - sp * Y[None] + d[:, 0:1]
    Yv = sp * X[None] + cp * Y[None] + d[:, 1:2]
    cb, sb = torch.cos(beta)[:, None], torch.sin(beta)[:, None]
    ell = sid - (Xv * cb + Yv * sb)
    vt = -Xv * sb + Yv * cb
    gam = torch.atan2(-vt, ell)
    h2 = ell * ell + vt * vt
    inv_h = torch.ones_like(h2) / torch.sqrt(h2)
    cidx = gam / torch.full_like(gam, dgamma) - 0.5 + C / 2.0
    c0 = torch.clamp(torch.floor(cidx), 0, C - 2)
    fc = torch.clamp(cidx - c0, 0.0, 1.0)
    w_in = ((cidx >= 0.0) & (cidx <= C - 1.0)).to(h2.dtype)
    return c0.to(torch.int64), fc, inv_h, w_in / h2


def _motion_backproject_plain(q, betas, phi, disp, sid, dgamma, row_h,
                              n_matrix, nz_out, fov, dz_out, z0, view_block,
                              window=None, terms=None):
    """The JAX motion FDK (``window`` None) or helical 'full' program
    (``window`` = (src_z [V], beta_mid, pitch)) in torch: blocks of
    ``view_block`` views over every (disc pixel, slice).  q: [K, V, R, C];
    returns [K, nz_out, N, N].  A dict ``terms`` gets the count of the
    work that the program needs: ``pixel_views``, the (disc pixel, view)
    pairs whose in-plane geometry some slice takes (for the helix, the
    views inside some slice's window); ``terms``, the (pixel, slice, view)
    rows evaluated (every view, or those inside the slice's window);
    ``taps``, those of them on the detector inside the fan."""
    from .conebeam import _bilinear, _disc, _place

    K, V, R, C = q.shape
    dev = q.device
    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _z_grid(nz_out, dz_out, z0, dev)
    betas, phi, disp = (as_float(x, dev).float() for x in (betas, phi, disp))
    if window is not None:
        src_z, beta_mid, pitch = window
        src_z = as_float(src_z, dev).float()
    qf = q.to(torch.float32).reshape(K, -1)
    num = qf.new_zeros((K, nz_out, X.shape[0]))
    den = qf.new_zeros((nz_out, X.shape[0]))
    for v0 in range(0, V, view_block):
        sl = slice(v0, v0 + view_block)
        beta, d = betas[sl], disp[sl]
        c0, fc, inv_h, w_amp = _posed_inplane(X, Y, beta, phi[sl], d, sid,
                                              dgamma, C)
        zv = zc[None, :] + d[:, 2:3]  # posed world z [B, nz]
        if window is None:
            zt = (zv * sid)[:, :, None] * inv_h[:, None, :]
        else:
            zt = ((zv - src_z[sl, None]) * sid)[:, :, None] \
                * inv_h[:, None, :]
        ridx = zt / torch.full_like(zt, row_h) - 0.5 + R / 2.0
        base = (torch.arange(v0, v0 + beta.shape[0], device=dev)
                * (R * C))[:, None, None]
        val, w = _bilinear(qf, base, c0[:, None, :], fc[:, None, :], ridx,
                           R, C)
        inside = torch.ones_like(zv, dtype=torch.bool)  # [B, nz]
        if window is not None:
            # the 2 pi window centred on the source's passage of the
            # voxel's posed z
            bc = beta_mid + (2.0 * np.pi) * zv / torch.full_like(zv, pitch)
            inside = (beta[:, None] - bc).abs() <= np.pi
            w = w * inside.to(w.dtype)[:, :, None]
        if terms is not None:
            n_px = X.shape[0]
            for key, n in (("pixel_views", n_px * int(inside.any(1).sum())),
                           ("terms", n_px * int(inside.sum())),
                           ("taps", int(((w != 0) & (w_amp[:, None, :] != 0))
                                        .sum()))):
                terms[key] = terms.get(key, 0) + n
        num += (val * w_amp[:, None, :] * w).sum(1)
        den += w.sum(0)
    out = torch.where(den > 0, num / torch.clamp_min(den, 1e-30),
                      torch.zeros_like(num))
    return _place(out * (2.0 * np.pi), sel, n_matrix)


def _motion_stack(q, name):
    """``[V, R, C]`` or ``[K, V, R, C]`` -> (4-D stack, was it 3-D), with
    the port's limits on K, R and C."""
    from .conebeam import _check_stack

    single = q.dim() == 3
    q = q[None] if single else q
    _check_stack(q, name)
    return q, single


def _motion_cuda_args(q, betas, phi, disp, n_matrix, fov, nz_out, dz_out,
                      z0):
    dev = q.device
    K, V, R, C = q.shape
    kernels.require(q, "q", dev, torch.float32)
    betas = as_float(betas, dev).float().contiguous()
    if betas.shape != (V,):
        raise ValueError(f"betas must be [{V}], got {tuple(betas.shape)}")
    from .conebeam import _disc

    X, Y, sel = _disc(n_matrix, fov, dev)
    zc = _z_grid(nz_out, dz_out, z0, dev)
    out = torch.zeros((K, nz_out, n_matrix, n_matrix), dtype=torch.float32,
                      device=dev)
    return (betas, torch.cos(betas), torch.sin(betas), _pose(phi, disp, dev),
            (X, Y, sel, zc), out)


def _fdk_motion_cuda(q, betas, phi, disp, sid, dgamma, row_h, n_matrix,
                     nz_out, fov, dz_out, z0):
    K, V, R, C = q.shape
    _, cos_b, sin_b, pose, grid, out = _motion_cuda_args(
        q, betas, phi, disp, n_matrix, fov, nz_out, dz_out, z0)
    rc = kernels.library().dexct_fdk_backproject_motion(
        q.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
        *(t.data_ptr() for t in pose), *(t.data_ptr() for t in grid),
        out.data_ptr(), K, V, R, C, grid[0].shape[0], nz_out,
        n_matrix * n_matrix, sid, dgamma, row_h, kernels.stream_ptr(q.device))
    kernels.check(rc, "fdk_backproject_motion")
    _fdk_backproject_motion.launches += 1
    return out


def _check_pose(phi, disp, V, D):
    """Raise unless phi is [V] and disp [V, D] (arrays or tensors, whose
    shapes are read without a copy)."""
    if tuple(np.shape(phi)) != (V,) or tuple(np.shape(disp)) != (V, D):
        raise ValueError(f"phi must be [{V}] and disp [{V}, {D}]")


def _fdk_backproject_motion(q, betas, phi, disp, sid, dgamma, row_h, n_rows,
                            n_matrix, nz_out, fov, dz_out, z0, *,
                            view_block=8):
    """Motion-compensated circular-FDK backprojection.

    q: [V, R, C] (or [K, V, R, C], all volumes in one pass) filtered
    stacks; betas, phi: [V]; disp: [V, 3].  Each view evaluates every disc
    voxel at its posed world position (x, y rotated and shifted, z + dz_v)
    and adds its bilinear tap times 1 / h^2 inside the fan; the sum is
    normalised by the number of views whose row reached the detector and
    scaled by 2 pi.  Slices at z0 + k dz_out.  Returns [nz_out, N, N] (or
    [K, nz_out, N, N]), 0 off the FOV disc.  CUDA tensors run kernel K32
    (counted in ``_fdk_backproject_motion.launches``); CPU tensors run
    :func:`_motion_backproject_plain` (``view_block`` views at a time).
    """
    q, single = _motion_stack(q, "q")
    if q.shape[2] != n_rows:
        raise ValueError(f"q has {q.shape[2]} rows, n_rows={n_rows}")
    _check_pose(phi, disp, q.shape[1], 3)
    args = (q, betas, phi, disp, float(sid), float(dgamma), float(row_h),
            int(n_matrix), int(nz_out), float(fov), float(dz_out), float(z0))
    if q.is_cuda:
        out = _fdk_motion_cuda(*args)
    elif q.device.type == "cpu":
        out = _motion_backproject_plain(*args, view_block=int(view_block))
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out[0] if single else out


_fdk_backproject_motion.launches = 0


def _window_shifts(disp_z, pitch):
    """The least and largest shift 2 pi dz_v / pitch of the window centre
    over the views (host float64)."""
    s = 2.0 * np.pi * np.asarray(disp_z, np.float64) / pitch
    return float(s.min()), float(s.max())


def _host_f32(x):
    """``x``'s float32 values as a host float64 array: host data is cast
    on the host; a tensor on the card is read back (a synchronising
    copy)."""
    if torch.is_tensor(x):
        x = x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32).astype(np.float64)


def _helical_motion_cuda(q, betas, src_z, beta_mid, phi, disp, sid, dgamma,
                         row_h, pitch, n_matrix, nz_out, fov, dz_out, z0):
    K, V, R, C = q.shape
    dev = q.device
    # the view spacing and its check, and the window's shifts, from host
    # arrays; betas or disp given only on the card are read back once
    b = _host_f32(betas)
    lo, hi = _window_shifts(_host64(disp)[:, 2], pitch)
    betas, cos_b, sin_b, pose, grid, out = _motion_cuda_args(
        q, betas, phi, disp, n_matrix, fov, nz_out, dz_out, z0)
    src_z = as_float(src_z, dev).float().contiguous()
    if src_z.shape != (V,):
        raise ValueError(f"src_z must be [{V}], got {tuple(src_z.shape)}")
    dbeta = float(b[1] - b[0]) if V > 1 else 1.0
    if V > 1 and not np.allclose(np.diff(b), dbeta, rtol=1e-4, atol=1e-6):
        raise ValueError("the views must be uniformly spaced (each slice "
                         "visits only the views its window can reach)")
    # the kernel reads betas[0], the views' origin, on the card
    rc = kernels.library().dexct_helical_backproject_motion(
        q.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), betas.data_ptr(),
        src_z.data_ptr(), *(t.data_ptr() for t in pose),
        *(t.data_ptr() for t in grid), out.data_ptr(), K, V, R, C,
        grid[0].shape[0], nz_out, n_matrix * n_matrix, sid, dgamma, row_h,
        pitch, beta_mid, dbeta, lo, hi, kernels.stream_ptr(dev))
    kernels.check(rc, "helical_backproject_motion")
    _helical_backproject_motion.launches += 1
    return out


def _helical_backproject_motion(q, betas, src_z, beta_mid, phi, disp, sid,
                                dgamma, row_h, n_rows, pitch, n_matrix,
                                nz_out, fov, dz_out, z0, *, view_block=8):
    """Motion-compensated generalized-Feldkamp helical backprojection
    ('full' 2 pi window, every voxel posed per view).

    q: [V, R, C] (or [K, V, R, C]); betas, src_z, phi: [V], the views
    uniformly spaced with ``betas[v] = betas[0] + v dbeta``, dbeta > 0;
    disp: [V, 3].  Host arrays are cast to float32 on the host; on the
    card, betas or disp given only as card tensors are read back once (the
    view spacing and the window's reach are host figures).  A view adds to
    a voxel when its row is on the detector and |beta_v - bc_v| <= pi with
    bc_v = beta_mid + 2 pi (z + dz_v) / pitch; num / den x 2 pi as
    :func:`_fdk_backproject_motion`.  Returns
    [nz_out, N, N] (or [K, nz_out, N, N]).  CUDA tensors run kernel K33
    (counted in ``_helical_backproject_motion.launches``; each slice visits
    the views its window reaches under the track's least and largest dz);
    CPU tensors run :func:`_motion_backproject_plain`.
    """
    q, single = _motion_stack(q, "q")
    if q.shape[2] != n_rows:
        raise ValueError(f"q has {q.shape[2]} rows, n_rows={n_rows}")
    _check_pose(phi, disp, q.shape[1], 3)
    if abs(pitch) < 1e-12:
        raise ValueError("helical backprojection needs a nonzero pitch")
    grid = (int(n_matrix), int(nz_out), float(fov), float(dz_out), float(z0))
    if q.is_cuda:
        out = _helical_motion_cuda(
            q, betas, src_z, float(beta_mid), phi, disp, float(sid),
            float(dgamma), float(row_h), float(pitch), *grid)
    elif q.device.type == "cpu":
        out = _motion_backproject_plain(
            q, betas, phi, disp, float(sid), float(dgamma), float(row_h),
            *grid, view_block=int(view_block),
            window=(src_z, float(beta_mid), float(pitch)))
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out[0] if single else out


_helical_backproject_motion.launches = 0


def _cone_filtered(sino_log, ct, ramp, window, device):
    """The FDK pre-weight and windowed ramp of the static reconstructors
    on a [V, R, C] or [K, V, R, C] stack on its device (or ``device``)."""
    from .conebeam import _fdk_filter, _fdk_weights, _stack

    dev = device_of(sino_log, device)
    stack, single = _stack(as_float(sino_log, dev))
    if stack.shape[-2] != ct.N_rows:
        raise ValueError(f"sinogram has {stack.shape[-2]} rows, geometry "
                         f"{ct.N_rows}")
    return _fdk_filter(stack, _fdk_weights(ct), ct, ramp, window), single


def fdk_reconstruct_motion(sino_log, geometry, n_matrix, fov, ramp, motion,
                           *, nz_out=None, dz_out=None, window="sinc",
                           view_block=8, device=None):
    """Motion-compensated circular FDK -> volume [nz_out, N, N] cm^-1
    (``[K, nz_out, N, N]`` for a stack [K, V, R, C], one K32 pass).

    Filtering (FDK cone pre-weight + windowed ramp) is that of the static
    :func:`~dexct_tpu_torch.ops.conebeam.fdk_reconstruct`; the
    backprojection (K32) evaluates each voxel at its posed world position
    per view and normalizes by the accumulated row coverage.  Circular full
    2 pi orbits with a static focal spot only.  Runs on the device of
    ``sino_log`` when it is a tensor, else on ``device`` (default: the
    card).
    """
    ct = geometry
    if abs(getattr(ct, "pitch", 0.0)) > 1e-12:
        raise ValueError("motion-compensated FDK supports circular "
                         "orbits (pitch=0) only")
    if getattr(ct, "ffs", "none") != "none":
        raise ValueError("motion-compensated FDK does not support "
                         "flying-focal-spot geometries")
    if abs(float(ct.rotation_total) - 2.0 * np.pi) > 1e-6:
        # the accumulated-weight normalization scales by the full-turn
        # 2*pi; a short scan would come out silently rescaled and without
        # Parker redundancy weighting
        raise ValueError(
            "motion-compensated FDK requires a full 2*pi rotation "
            f"(got rotation_total={float(ct.rotation_total):.4f})")
    _check_views(motion, ct)
    q, single = _cone_filtered(sino_log, ct, ramp, window, device)
    R = q.shape[2]
    nz = R if nz_out is None else int(nz_out)
    dz = float(ct.h_iso if dz_out is None else dz_out)
    z0 = (0.5 - nz / 2.0) * dz
    out = _fdk_backproject_motion(
        q, upload(ct.betas, q.device, torch.float32),
        motion.phi, motion.disp, float(ct.SID), float(ct.dgamma),
        float(ct.h_iso), int(R), int(n_matrix), nz, float(fov), dz, float(z0),
        view_block=view_block)
    return out[0] if single else out


def helical_fdk_reconstruct_motion(sino_log, geometry, n_matrix, fov, ramp,
                                   motion, *, z_out=None, window="sinc",
                                   view_block=8, device=None):
    """Motion-compensated helical generalized-Feldkamp reconstruction ->
    [nz, N, N] cm^-1 (``[K, nz, N, N]`` for a stack, one K33 pass).

    Filtering matches the static
    :func:`~dexct_tpu_torch.ops.conebeam.helical_fdk_reconstruct` ('full'
    weighting); the backprojection (K33) poses every voxel per view and
    re-centres its 2 pi window on the source's passage of the posed z.
    ``z_out``: uniformly spaced slices, by default one per ``h_iso`` over
    the central 80 % of the source travel.  Static focal spot only.  Runs
    on the device of ``sino_log`` when it is a tensor, else on ``device``
    (default: the card).
    """
    ct = geometry
    if abs(getattr(ct, "pitch", 0.0)) < 1e-12:
        raise ValueError("geometry has no pitch; use "
                         "fdk_reconstruct_motion for circular orbits")
    if getattr(ct, "ffs", "none") != "none":
        raise ValueError("motion-compensated helical reconstruction "
                         "supports static focal spots only")
    from .conebeam import helical_slices

    _check_views(motion, ct)
    z_out, dz = helical_slices(ct, z_out)
    q, single = _cone_filtered(sino_log, ct, ramp, window, device)
    out = _helical_backproject_motion(
        q, np.asarray(ct.betas, np.float64),
        np.asarray(ct.source_z, np.float64), float(0.5 * ct.rotation_total),
        motion.phi, motion.disp, float(ct.SID), float(ct.dgamma),
        float(ct.h_iso), int(q.shape[2]), float(ct.pitch), int(n_matrix),
        len(z_out), float(fov), dz, float(z_out[0]), view_block=view_block)
    return out[0] if single else out


# --------------------------------------------------------------------------
# joint (image, track) motion estimation
# --------------------------------------------------------------------------

def fan_line_coords(geometry, device=None):
    """Static (theta_w, t_w) parallel-line coordinates of every fan ray
    [V, C] (host float64, then float32 on ``device``, default the card),
    including the geometry's detector offset (``det_offset_ch`` shifts every
    gamma): the meta of the motion resampler (here and in
    :mod:`~dexct_tpu_torch.ops.onestep`)."""
    dev = device_of(None, device)
    betas = np.asarray(geometry.betas, np.float64)
    gam = np.asarray(geometry.gammas, np.float64)
    th_w = betas[:, None] + gam[None, :] - np.pi / 2.0
    t_w = geometry.SID * np.sin(gam)[None, :] * np.ones((len(betas), 1))
    return (torch.as_tensor(th_w, dtype=torch.float32, device=dev),
            torch.as_tensor(t_w, dtype=torch.float32, device=dev))


def _radon_resample_fan(radon, th_w, t_w, disp, n_theta, nt, t0, dt,
                        phi=None):
    """Differentiable fan sampling of a parallel Radon image under a
    per-view rigid object pose.

    The fan ray (v, c) is the line (theta_w, t_w); in the object frame the
    same line is ``(theta_w - phi_v, t_w - d_v . n_hat(theta_w))``.
    Bilinear sampling of ``radon`` [n_theta, nt] with the theta mod-pi wrap
    flipping t, kept in plain PyTorch so that autograd reaches ``radon``,
    ``disp`` and ``phi`` (four taps per ray, gathered by index).
    """
    nx, ny = torch.cos(th_w), torch.sin(th_w)
    t = t_w - (disp[:, 0:1] * nx + disp[:, 1:2] * ny)
    th = th_w if phi is None else th_w - phi[:, None]
    k = torch.floor(th / np.pi)
    thm = th - k * np.pi
    sgn = torch.where(torch.remainder(k, 2.0) != 0, -1.0, 1.0)
    t = t * sgn
    ft = thm / (np.pi / n_theta)
    i0f = torch.clamp(torch.floor(ft), 0, n_theta - 1)
    fth = ft - i0f
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    wrap = i1 >= n_theta
    i1 = torch.where(wrap, torch.zeros_like(i1), i1)
    tb = torch.where(wrap, -t, t)

    def taps(tq):
        f = (tq - t0) / dt
        j0f = torch.clamp(torch.floor(f), 0, nt - 2)
        return j0f.to(torch.int64), torch.clamp(f - j0f, 0.0, 1.0)

    ja, fa = taps(t)
    jb, fb = taps(tb)
    flat = radon.reshape(-1)
    v00 = flat[i0 * nt + ja]
    v01 = flat[i0 * nt + ja + 1]
    v10 = flat[i1 * nt + jb]
    v11 = flat[i1 * nt + jb + 1]
    return ((1 - fth) * ((1 - fa) * v00 + fa * v01)
            + fth * ((1 - fb) * v10 + fb * v11))


def estimate_motion_joint(sino_log, geometry, n_matrix, fov, *,
                          n_modes=6, n_iters=800, beta_tv=3e-3,
                          lr_image=2e-3, lr_track=8e-3, n_theta=512,
                          init=None, basis=None, fit_rotation=False,
                          device=None):
    """Joint (image, translation-track) inversion — the tight motion
    estimator.

    Fits a regularized image x and the rigid track ``d_v = B_v @ coeffs``
    to the measured log sinogram through the differentiable motion-forward
    model ``fan_sample(Radon(x); d)``, minimizing

        || F_d(x) - y ||^2 / ||y||^2  +  beta_tv * TV(x) / N^2

    with Adam on both blocks, from the centroid estimate
    (:func:`estimate_translation`, or ``init``) and its motion-compensated
    FBP.  The Radon transform is the Fourier-slice projector's (K7, and
    K21 in autograd's backward pass on the card); the resampler is plain
    PyTorch.  ``fit_rotation=True`` adds a rotation track on the same
    basis.  Runs on the device of ``sino_log`` when it is a tensor, else
    on ``device`` (default: the card).  Returns ``(MotionProfile, image)``.
    """
    from ..physics.materials import AIR, MaterialTable
    from ..system.phantom import VoxelPhantom
    from ..utils.optim import adam_step
    from .fourier import fourier_radon, plan_fourier_projector

    V, C = sino_log.shape
    if V != geometry.N_proj:
        raise ValueError(f"sinogram has {V} views, geometry "
                         f"{geometry.N_proj}")
    dev = device_of(sino_log, device)
    y = as_float(sino_log, dev).to(torch.float32)
    B_host = np.asarray(basis if basis is not None
                        else cosine_motion_basis(V, n_modes), np.float32)
    B = torch.as_tensor(B_host, device=dev)
    K = B.shape[1]

    dx = float(fov) / int(n_matrix)
    dummy = VoxelPhantom("moco_grid",
                         np.zeros((int(n_matrix), int(n_matrix)), np.uint8),
                         MaterialTable([AIR]), dx, dx, dx)
    plan = plan_fourier_projector(dummy, geometry, n_theta=int(n_theta),
                                  device=dev)
    th_w, t_w = fan_line_coords(geometry, dev)

    if init is None:
        init, _ = estimate_translation(y, geometry, n_modes=K, basis=B_host)
    cd0 = np.linalg.lstsq(B_host, init.disp, rcond=None)[0]
    if fit_rotation:
        cp0 = np.linalg.lstsq(B_host, init.phi, rcond=None)[0]
        c = np.concatenate([cd0.ravel(), cp0])
    else:
        c = cd0.ravel()
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    x, _ = fbp_recon_motion(y, geometry, int(n_matrix), float(fov), init)
    norm = torch.sum(y * y)

    def track(c):
        disp = B @ c[:2 * K].reshape(K, 2)
        phi = B @ c[2 * K:] if fit_rotation else None
        return disp, phi

    def loss(x, c):
        radon = fourier_radon(plan, x[None])[0]
        disp, phi = track(c)
        pred = _radon_resample_fan(radon, th_w, t_w, disp, plan.n_theta,
                                   plan.nt, plan.t0, plan.dt, phi=phi)
        data = torch.sum((pred - y) ** 2) / norm
        dgx = x[:, 1:] - x[:, :-1]
        dgy = x[1:] - x[:-1]
        tv = torch.sum(torch.sqrt(dgx[:-1] ** 2 + dgy[:, :-1] ** 2 + 1e-6))
        return data + beta_tv * tv / x.numel()

    z = torch.zeros_like
    mx, vx, mc, vc = z(x), z(x), z(c), z(c)
    for i in range(int(n_iters)):
        xg = x.detach().requires_grad_(True)
        cg = c.detach().requires_grad_(True)
        gx, gc = torch.autograd.grad(loss(xg, cg), (xg, cg))
        x, mx, vx = adam_step(x, gx, mx, vx, float(i), lr_image)
        c, mc, vc = adam_step(c, gc, mc, vc, float(i), lr_track)
    with torch.no_grad():
        disp_f, phi_f = track(c)
    disp = disp_f.double().cpu().numpy()
    phi = (phi_f.double().cpu().numpy() if fit_rotation else np.zeros(V))
    return MotionProfile(phi, disp), x
