"""Iterative reconstruction: CG least-squares, SIRT and PWLS.

Port of :mod:`dexct_tpu.ops.iterative`.  The 2-D entry points
(:func:`cg_recon`, :func:`sirt_recon`, :func:`pwls_recon`) solve on the
linear monoenergetic fan-beam projection A of an image, the Fourier-slice
projector (:func:`make_projection_operator`; K7 and K8 on the card).  The
JAX package obtains A^T from ``jax.linear_transpose``; here the loops take
an explicit adjoint: the fan resample's adjoint (K22), the adjoint of the
radial ``irfft`` and of the phases, the sampler's adjoint (K21), then the
adjoint of the 2-D FFT, roll, zero pad and deapodization
(:func:`_projection_adjoint`).  Each A^T costs one K22 and one K21 launch.

The loops take any linear projector with its adjoint (``adjoint=``): the
3-D reconstructors :func:`~dexct_tpu_torch.ops.conebeam.cone_cg_recon`
and :func:`~dexct_tpu_torch.ops.conebeam.cone_pwls_recon` run them on the
exact 3-D projector (K18) and its adjoint (K19).  The power iterations
start from a normal draw of a ``torch.Generator`` seeded 0 (the JAX
package draws from ``PRNGKey(0)``; the two give other numbers, and the
private ``_v0`` takes the start vector instead).  The 2-D entry points run
on the device of the plan's tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import _scalar
from .fourier import (FourierProjectorPlan, fourier_project_images,
                      kb_sample_adjoint, kb_transpose, plan_fan_adjoint)

__all__ = ["make_projection_operator", "cg_recon", "sirt_recon",
           "pwls_recon", "pwls_weights"]


def pwls_weights(counts, *, sigma_e=0.0, var_ratio=1.0):
    """Inverse log-domain noise-variance weights for PWLS, normalized to
    mean 1: w = N^2 / (var_ratio N + sigma_e^2) (the delta method on
    y = -ln(N / N0) with var(N) = var_ratio N + sigma_e^2), in float32 on
    the device of ``counts``."""
    c = torch.clamp_min(torch.as_tensor(counts).to(torch.float32), 1e-30)
    sig = _scalar(sigma_e, c)
    w = c * c / (_scalar(var_ratio, c) * c + sig * sig)
    return w / torch.clamp_min(w.mean(), 1e-30)


def make_projection_operator(plan: FourierProjectorPlan, view_shape):
    """A(x): [N, N] image -> [V, C] line-integral sinogram (linear), the
    Fourier-slice projector of one image."""
    vs = tuple(int(n) for n in view_shape)

    def apply(img):
        return fourier_project_images(plan, img[None], vs)[..., 0]

    return apply


def _projection_adjoint(plan: FourierProjectorPlan, view_shape):
    """A^T(y): [V, C] sinogram -> [N, N] image, the exact adjoint of
    :func:`make_projection_operator` taken stage by stage in reverse: the
    fan resample's adjoint (K22, over the plan's cached transposed taps on
    the card), the scale, the adjoint of the radial
    ``irfft`` at n = nt (an ``rfft`` / nt of which the nl = G/2 + 1 bins
    are kept, bins 1..nl-1 weighted twice for their conjugate halves and
    the imaginary part of DC dropped), the sampler's adjoint (K21, the
    conjugate phase, over the plan's cached transposed taps on the card),
    then the adjoint of the 2-D FFT of a real image (the
    real part of an unnormalized inverse FFT), of the roll, of the zero pad
    (a crop) and of the deapodization."""
    v, c = (int(n) for n in view_shape)
    n, grid, nt = plan.n_img, plan.grid, plan.nt
    nl = grid // 2 + 1
    half = n // 2

    def adjoint(y):
        radon = plan_fan_adjoint(plan, y.reshape(v, c, 1),
                                 (1, plan.n_theta, nt))
        spec = torch.fft.rfft(radon * plan.scale, dim=-1)[..., :nl] / nt
        spec = torch.cat([spec[..., :1].real.to(spec.dtype),
                          2.0 * spec[..., 1:]], -1)
        F = kb_sample_adjoint(spec, plan.slice_idx, plan.slice_w,
                              plan.phase_cos, plan.phase_sin, grid,
                              kb_t=kb_transpose(plan) if spec.is_cuda
                              else None)
        img = torch.fft.ifft2(F, norm="forward").real
        img = torch.roll(img, (half, half), dims=(-2, -1))[0, :n, :n]
        return img / plan.deapod

    return adjoint


def _image_start(plan, x0):
    dev = plan.deapod.device
    if x0 is None:
        return torch.zeros((plan.n_img, plan.n_img), dtype=torch.float32,
                           device=dev)
    return torch.as_tensor(x0, dtype=torch.float32, device=dev)


def cg_recon(plan: FourierProjectorPlan, sino, view_shape, *, n_iters=30,
             lam=0.0, x0=None):
    """Conjugate-gradient least-squares reconstruction on the Fourier-slice
    projector: solves (A^T A + lam L) x = A^T b (L the 2-D Laplacian).
    ``sino``: [V, C] line-integral (log) sinogram.  Runs on the device of
    the plan's tables.  Returns ([N, N] image in 1/cm, residual-norm
    history [n_iters])."""
    apply_fn = make_projection_operator(plan, view_shape)
    b = torch.as_tensor(sino, dtype=torch.float32, device=plan.deapod.device)
    return _cg(apply_fn, b, _image_start(plan, x0), int(n_iters), float(lam),
               adjoint=_projection_adjoint(plan, view_shape))


def _start_vector(shape, device, _v0):
    """The power iteration's start: a normal draw of a ``torch.Generator``
    seeded 0, or the given ``_v0``."""
    f32 = dict(dtype=torch.float32, device=device)
    if _v0 is None:
        gen = torch.Generator(device=device).manual_seed(0)
        return torch.randn(tuple(shape), generator=gen, **f32)
    return torch.as_tensor(np.array(_v0), **f32)


def sirt_recon(plan: FourierProjectorPlan, sino, view_shape, *, n_iters=50,
               relax=1.6, nonneg=True, x0=None, power_iters=12, _v0=None):
    """SIRT-style projected Landweber iteration,
    x <- max(0, x + (relax / lmax) A^T (b - A x)), with lmax = ||A^T A||
    from ``power_iters`` power iterations (the Fourier-slice operator has
    signed entries, so the classic row/column normalization does not
    apply).  Runs on the device of the plan's tables; ``_v0``: the power
    iteration's start vector.  Returns the [N, N] image in 1/cm."""
    apply_fn = make_projection_operator(plan, view_shape)
    adjoint = _projection_adjoint(plan, view_shape)
    b = torch.as_tensor(sino, dtype=torch.float32, device=plan.deapod.device)
    x = _image_start(plan, x0)

    def normal(z):
        return adjoint(apply_fn(z))

    v = _start_vector(x.shape, x.device, _v0)
    for _ in range(int(power_iters)):
        v = normal(v)
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-30)
    lmax = torch.clamp_min(_vdot(v, normal(v)), 1e-30)
    omega = relax / lmax
    for _ in range(int(n_iters)):
        x = x + omega * adjoint(b - apply_fn(x))
        if nonneg:
            x = torch.clamp_min(x, 0.0)
    return x


def pwls_recon(plan: FourierProjectorPlan, sino_log, counts, view_shape, *,
               n_iters=60, beta=1e-3, delta=5e-3, nonneg=True, x0=None,
               power_iters=12, sigma_e=0.0, var_ratio=1.0, _v0=None):
    """Penalized weighted least-squares reconstruction on the Fourier-slice
    projector: minimizes 1/2 ||A x - y||^2_W + beta R(x), W the
    :func:`pwls_weights` of ``counts``, R the 4-neighbour Huber roughness
    (``beta`` relative to ||A^T W A||), by FISTA with a power-iteration
    Lipschitz step from ``x0`` (warm-start it from the FBP image).  Runs on
    the device of the plan's tables; ``_v0``: the power iteration's start
    vector.  Returns the [N, N] image in 1/cm."""
    dev = plan.deapod.device
    apply_fn = make_projection_operator(plan, view_shape)
    y = torch.as_tensor(sino_log, dtype=torch.float32, device=dev)
    w = pwls_weights(torch.as_tensor(counts, device=dev), sigma_e=sigma_e,
                     var_ratio=var_ratio)
    return _pwls_fista(apply_fn, y, w, _image_start(plan, x0), int(n_iters),
                       float(beta), float(delta), bool(nonneg),
                       int(power_iters),
                       adjoint=_projection_adjoint(plan, view_shape),
                       _v0=_v0)


def _laplacian(x):
    return (4.0 * x
            - torch.roll(x, 1, 0) - torch.roll(x, -1, 0)
            - torch.roll(x, 1, 1) - torch.roll(x, -1, 1))


def _vdot(a, b):
    return (a * b).sum()


def _cg(apply_fn, b, x0, n_iters, lam, *, adjoint):
    """Conjugate gradients on the normal equations (A^T A + lam L) x =
    A^T b from ``x0`` (L the 2-D Laplacian; ``adjoint`` applies A^T).
    Returns ``(x, history of ||r||^2 [n_iters])``."""

    def normal(x):
        out = adjoint(apply_fn(x))
        if lam:
            out = out + lam * _laplacian(x)
        return out

    r = adjoint(b) - normal(x0)
    x, p = x0, r
    rs = _vdot(r, r)
    hist = []
    for _ in range(int(n_iters)):
        ap = normal(p)
        alpha = rs / torch.clamp_min(_vdot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = r + beta * p
        rs = rs_new
        hist.append(rs_new)
    return x, torch.stack(hist) if hist else b.new_zeros(0)


def _huber_grad(d, delta):
    """Gradient of the Huber potential (quadratic core, linear tails)."""
    return torch.clamp(d, -delta, delta)


def _neighbor_penalty_grad(x, delta):
    """Gradient of the 2*ndim-neighbour edge-preserving Huber roughness
    penalty R(x) = sum_j sum_{k in N(j)} huber(x_j - x_k) (4 neighbours for
    images, 6 for volumes), with edge-clamped differences, not circulant:
    the boundary sample's missing neighbour is replicated, so its
    difference term is exactly zero."""
    g = torch.zeros_like(x)
    for ax in range(x.dim()):
        n = x.shape[ax]
        first = x.narrow(ax, 0, 1)
        last = x.narrow(ax, n - 1, 1)
        nxt = torch.cat([x.narrow(ax, 1, n - 1), last], dim=ax)
        prv = torch.cat([first, x.narrow(ax, 0, n - 1)], dim=ax)
        g = g + _huber_grad(x - nxt, delta) + _huber_grad(x - prv, delta)
    return g


def _pwls_fista(apply_fn, y, w, x0, n_iters, beta, delta, nonneg,
                power_iters, *, adjoint, _v0=None):
    """FISTA on 1/2 ||A x - y||^2_W + beta_abs R(x), the JAX program's
    schedule: the Lipschitz bound ||A^T W A|| by ``power_iters`` power
    iterations (plus the penalty's curvature bound 4 ndim beta_abs,
    beta_abs = beta ||A^T W A||), then ``n_iters`` accelerated steps from
    ``x0``, clipped at 0 when ``nonneg``; ``adjoint`` applies A^T.
    ``_v0``: the power iteration's start vector (default: a normal draw of
    a ``torch.Generator`` seeded 0)."""
    f32 = dict(dtype=torch.float32, device=x0.device)

    def grad_data(x):
        return adjoint(w * (apply_fn(x) - y))

    v = _start_vector(x0.shape, x0.device, _v0)
    for _ in range(int(power_iters)):
        nv = adjoint(w * apply_fn(v))
        v = nv / torch.clamp_min(torch.linalg.vector_norm(nv), 1e-30)
    nv = adjoint(w * apply_fn(v))
    lmax = torch.clamp_min(_vdot(v, nv), 1e-30)
    beta_abs = beta * lmax
    step = 1.0 / (lmax + 4.0 * x0.dim() * beta_abs)

    x, z = x0, x0
    t = torch.ones((), **f32)
    for _ in range(int(n_iters)):
        g = grad_data(z)
        if beta:
            g = g + beta_abs * _neighbor_penalty_grad(z, delta)
        x_new = z - step * g
        if nonneg:
            x_new = torch.clamp_min(x_new, 0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x
