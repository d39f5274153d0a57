"""Synthetic dose reduction: turn one acquired scan into a lower-dose one.

Port of :mod:`dexct_tpu.ops.lowdose`.  Given the detected counts of a scan
at dose D0, synthesize a statistically correct realization at f*D0:

* **poisson**: binomial thinning (Binomial(y, f) of a Poisson(lam) count
  is Poisson(f lam)); above 1e5 counts the Gaussian limit N(f y, f (1-f)
  y);
* **compound** (EID): ``y_f = f y + N(0, f (1-f) var_q + sigma_e^2 - f^2
  sigma_e0^2)``, which matches the mean and variance of a real f-dose
  scan, electronic floor included.

Draws take a ``torch.Generator`` on the device of the counts (the JAX
package takes a PRNG key).  Elementwise PyTorch on the device of the
counts when they are a tensor, else on ``device`` (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.devices import as_float, device_of
from .spectral import effective_fluence, second_moment_fluence

__all__ = ["synthesize_low_dose", "quantum_var_ratio"]

_BIG = 1e5  # same discrete->Gaussian threshold as spectral.sample_noise


def quantum_var_ratio(spec, geometry):
    """Air-spectrum quantum variance-to-mean ratio r = sum(i2)/sum(i0):
    var_q ~= r * y for an EID ray (exact in air)."""
    i0 = np.sum(effective_fluence(spec, geometry))
    i2 = np.sum(second_moment_fluence(spec, geometry))
    return float(i2 / np.maximum(i0, 1e-300))


def synthesize_low_dose(generator, counts, f, *, mode="poisson",
                        var_q=None, sigma_e=0.0, sigma_e0=0.0, device=None):
    """Synthesize a dose-f*D0 realization from a dose-D0 scan.

    generator: a ``torch.Generator`` on the counts' device; f: dose
    fraction in (0, 1]; mode: 'poisson' (exact thinning) or 'compound'
    (EID second-moment match, needs ``var_q``, the input's per-ray quantum
    variance); sigma_e / sigma_e0: electronic noise std of the target and
    of the input.  Returns a tensor shaped like ``counts``.
    """
    if not 0.0 < f <= 1.0:
        raise ValueError(f"dose fraction f must be in (0, 1], got {f}")
    dev = device_of(counts, device)
    y = as_float(counts, dev)
    ff = torch.full((), float(f), dtype=y.dtype, device=dev)

    def normal():
        return torch.randn(y.shape, generator=generator, dtype=y.dtype,
                           device=dev)

    if mode == "poisson":
        if float(sigma_e) or float(sigma_e0):
            raise ValueError(
                "electronic noise is an EID effect; use mode='compound'")
        big = y > _BIG
        n_small = torch.where(big, torch.zeros_like(y),
                              torch.clamp_min(y, 0.0))
        small = torch.binomial(n_small.to(torch.float32),
                               torch.full_like(n_small, float(f),
                                               dtype=torch.float32),
                               generator=generator).to(y.dtype)
        gauss = ff * y + torch.sqrt(torch.clamp_min(
            ff * (1.0 - ff) * y, 0.0)) * normal()
        return torch.where(big, torch.clamp_min(gauss, 0.0), small)
    if mode == "compound":
        if var_q is None:
            raise ValueError("compound mode requires the per-ray var_q "
                             "(quantum variance of the input scan)")
        vq = as_float(var_q, dev).to(y.dtype)
        se = torch.tensor(float(sigma_e), dtype=y.dtype, device=dev)
        se0 = torch.tensor(float(sigma_e0), dtype=y.dtype, device=dev)
        var_add = ff * (1.0 - ff) * vq + se ** 2 - ff * ff * se0 ** 2
        sigma_add = torch.sqrt(torch.clamp_min(var_add, 0.0))
        return torch.clamp_min(ff * y + sigma_add * normal(), 0.0)
    raise ValueError(f"unknown mode {mode!r}")
