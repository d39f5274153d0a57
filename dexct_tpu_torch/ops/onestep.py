"""One-step spectral reconstruction: basis-material images fitted directly
to multi-bin or multi-spectrum counts.

Port of :mod:`dexct_tpu.ops.onestep`.  The basis images x [K, N, N] are
fitted to the counts through the nonlinear spectral forward model

    lambda_m(x) = sum_E i0_m(E) exp(-sum_k mu_k(E) [A x_k]),

with Poisson weighted least squares and an edge-preserving Huber
roughness penalty, by Adam with a nonnegativity projection, from the
two-step solution.  A is the differentiable Fourier-slice projector
(:func:`~dexct_tpu_torch.ops.fourier.fourier_project_images`: K7 and K8
forward, their adjoints K21 and K22 in the backward pass on the card); the
energy stage is plain ``torch.matmul`` and ``exp``, as the JAX module's
``jnp.matmul``.  The gradient comes from ``torch.autograd`` through the
whole chain, as the JAX package's from ``jax.grad``.

With a translation track (``motion=``), the forward model takes the line
integrals along the motion-transformed rays: the Fourier-slice Radon
transform of each basis image (K7, K21 in the backward pass) resampled per
view by :func:`~dexct_tpu_torch.ops.motion._radon_resample_fan` (plain
PyTorch): motion-compensated spectral MBIR.

The gradient holds a [V, C, E] intermediate: at the reference protocol
(1000 x 800 rays, ~180 energy bins) about 0.6 GB per float32 copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import xcom
from ..utils.optim import adam_step
from .fourier import FourierProjectorPlan, fourier_project_images

__all__ = ["onestep_spectral_recon", "spectral_forward_images"]


def spectral_forward_images(plan: FourierProjectorPlan, x, mus, i0s,
                            view_shape, disp=None, resample_meta=None):
    """Expected counts [M, V, C] from basis images x [K, N, N]: the line
    integrals [V, C, K] of the Fourier-slice projector, contracted with
    ``mus`` [K, E], attenuated (exponent clipped to [-700, 2]) and
    contracted with ``i0s`` [M, E], in full float32.  With ``disp`` [V, 2]
    (and ``resample_meta``, the fan-line coordinates of
    :func:`~dexct_tpu_torch.ops.motion.fan_line_coords`) the line
    integrals are taken along the motion-transformed rays: each basis
    image's Radon transform resampled per view with a t-shift."""
    if disp is None:
        L = fourier_project_images(plan, x, tuple(view_shape))  # [V, C, K]
    else:
        from .fourier import fourier_radon
        from .motion import _radon_resample_fan

        th_w, t_w = resample_meta
        radon = fourier_radon(plan, x)  # [K, ntheta, nt]
        L = torch.stack([
            _radon_resample_fan(radon[k], th_w, t_w, disp, plan.n_theta,
                                plan.nt, plan.t0, plan.dt)
            for k in range(x.shape[0])], dim=-1)  # [V, C, K]
    E = torch.matmul(L, mus)  # [V, C, E]
    atten = torch.exp(torch.clamp(-E, -700.0, 2.0))
    lam = torch.matmul(atten, i0s.T)  # [V, C, M]
    return lam.permute(2, 0, 1)


def _huber(d, delta):
    a = torch.abs(d)
    return torch.where(a <= delta, 0.5 * d * d, delta * (a - 0.5 * delta))


def _roughness(x, delta):
    """Edge-clamped 4-neighbour Huber roughness, summed over bases."""
    r = 0.0
    for ax in (1, 2):
        r = r + torch.sum(_huber(torch.diff(x, dim=ax), delta))
    return r


def _objective(forward_fn, counts, mus, i0s, beta, delta):
    """The fit's loss of x: the Poisson-weighted squared error of the
    expected counts, normalized to O(1), plus beta R(x) / x.size."""
    w = 1.0 / torch.clamp_min(counts, 1.0)  # Poisson WLS weights
    norm = torch.sum(w * counts * counts)  # makes the loss O(1)

    def loss(x):
        lam = forward_fn(x, mus, i0s)
        data = 0.5 * torch.sum(w * (lam - counts) ** 2) / norm
        return data + beta * _roughness(x, delta) / x.numel()

    return loss


def _fit(forward_fn, counts, mus, i0s, x0, n_iters, beta, delta, lr,
         nonneg):
    """Adam on :func:`_objective` (the JAX program's schedule: the
    gradient, Adam at iteration i, then the clip at 0)."""
    loss = _objective(forward_fn, counts, mus, i0s, beta, delta)
    x, m, v = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    for i in range(int(n_iters)):
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(xg), xg)
        x, m, v = adam_step(x, g, m, v, float(i), lr)
        if nonneg:
            x = torch.clamp_min(x, 0.0)
    return x


def onestep_spectral_recon(counts, ee, i0s, basis, plan, view_shape, *,
                           x0=None, n_iters=300, beta=3e-3, delta=1e-2,
                           lr=2e-3, nonneg=True, dtype=torch.float32,
                           motion=None, geometry=None):
    """Fit basis images [K, N, N] to multi-bin counts [M, V, C].

    ``counts``: measured counts; ``ee`` [E] and ``i0s`` [M, E]: the
    working energy grid and per-measurement effective fluences (the tables
    the two-step decomposition consumes); ``basis``: K Materials; ``plan``:
    :func:`~dexct_tpu_torch.ops.fourier.plan_fourier_projector` built on the
    reconstruction grid.  ``x0``: the start [K, N, N], the two-step result
    clipped nonnegative (zeros by default); ``beta`` weighs the Huber
    penalty against the normalized data term; ``lr`` is Adam's step in
    g/cm^3; ``dtype`` a torch dtype.  Runs on the device of the plan's
    tables.  ``motion`` (a :class:`~dexct_tpu_torch.ops.motion.
    MotionProfile` translation track; needs ``geometry``) fits the images in
    the object frame through the motion-transformed rays.  Returns the
    basis images [K, N, N].
    """
    dev = plan.deapod.device
    dt = dict(dtype=dtype, device=dev)
    counts = torch.as_tensor(counts, **dt)
    mus = torch.as_tensor(
        np.stack([xcom.mixatten(b.matcomp, np.asarray(ee)) for b in basis]),
        **dt)  # [K, E]
    if x0 is None:
        x0 = torch.zeros((len(basis), plan.n_img, plan.n_img), **dt)
    else:
        x0 = torch.as_tensor(x0, **dt)
    vs = tuple(view_shape)
    disp = meta = None
    if motion is not None:
        if geometry is None:
            raise ValueError("motion-compensated fit needs geometry")
        if np.any(motion.phi):
            raise ValueError("the motion-forward resampler supports "
                             "translation tracks (phi = 0) only")
        from .motion import fan_line_coords

        meta = fan_line_coords(geometry, dev)
        disp = torch.as_tensor(motion.disp, **dt)

    def forward_fn(x, mu_t, i0_t):
        return spectral_forward_images(plan, x, mu_t, i0_t, vs, disp=disp,
                                       resample_meta=meta)

    return _fit(forward_fn, counts, mus, torch.as_tensor(i0s, **dt), x0,
                int(n_iters), float(beta), float(delta), float(lr),
                bool(nonneg))
