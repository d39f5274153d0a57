"""Iterative reconstruction: the operator-generic loops.

Port of the parts of :mod:`dexct_tpu.ops.iterative` that take any linear
projector: the PWLS noise weights, conjugate gradients on the normal
equations, the edge-preserving Huber roughness penalty and FISTA on the
penalized weighted least-squares objective.  They need no kernel of their
own; the 3-D reconstructors :func:`~dexct_tpu_torch.ops.conebeam.
cone_cg_recon` and :func:`~dexct_tpu_torch.ops.conebeam.cone_pwls_recon`
run them on the exact 3-D projector (K18) and its adjoint (K19).

The JAX package obtains A^T from ``jax.linear_transpose``; here every loop
takes the adjoint explicitly (``adjoint=``).  The power iteration's
start vector is a normal draw from a ``torch.Generator`` seeded 0 (the JAX
package draws from ``PRNGKey(0)``; the two give other numbers, and the
private ``_v0`` takes the start vector instead).  The 2-D entry points
(``make_projection_operator``, ``cg_recon``, ``sirt_recon``,
``pwls_recon``) wait for the adjoints of the Fourier projector's kernels.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pwls_weights"]


def pwls_weights(counts, *, sigma_e=0.0, var_ratio=1.0):
    """Inverse log-domain noise-variance weights for PWLS, normalized to
    mean 1: w = N^2 / (var_ratio N + sigma_e^2) (the delta method on
    y = -ln(N / N0) with var(N) = var_ratio N + sigma_e^2), in float32 on
    the device of ``counts``."""
    c = torch.clamp_min(torch.as_tensor(counts).to(torch.float32), 1e-30)
    f32 = dict(dtype=torch.float32, device=c.device)
    sig = torch.tensor(sigma_e, **f32)
    w = c * c / (torch.tensor(var_ratio, **f32) * c + sig * sig)
    return w / torch.clamp_min(w.mean(), 1e-30)


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

    if _v0 is None:
        gen = torch.Generator(device=x0.device).manual_seed(0)
        v = torch.randn(x0.shape, generator=gen, **f32)
    else:
        v = torch.as_tensor(np.array(_v0), **f32)
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
