"""Tube current modulation (TCM / "auto-mA").

Port of :mod:`dexct_tpu.pipeline.tcm`.  Real scanners vary the tube output
per view (more photons through the patient's long axis), equalizing the
per-view noise around the rotation.  Modulation is one [V] vector
broadcast over the counts: the shared trace, the spectral chain (K2), the
decomposition (K3) and the FBP are unchanged.  The acquired counts scale
by m_v and reconstruction consumes the output-normalized counts (counts /
m_v, the scanner's own correction), so the only physical effect is on the
noise realization.  The profile and the pipeline run on ``device``
(default: the card); the z profile is host NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import spectral as sp_ops
from ..ops.siddon import material_path_sinogram
from ..utils.devices import _scalar, as_float, device_of, upload
from .api import DectResult, get_basismat_sinos, get_recon

__all__ = ["auto_tcm_profile", "simulate_tcm_dect", "normalize_counts",
           "z_profile_from_volume"]


def auto_tcm_profile(ct, phantom, spec, *, strength=1.0, m_min=0.2,
                     m_max=4.0, paths=None, normalize="output",
                     channel_window=None, report=False, device=None):
    """Noise-optimal modulation profile m[V] (float32, on the device of
    ``paths`` when given, else on ``device``).

    The scout model: a view's variance after log + reconstruction is
    ``W_v / m_v`` with ``W_v = mean_c 1/T_vc``; minimizing ``sum_v
    W_v/m_v`` at fixed ``sum_v m_v`` gives ``m_v ∝ sqrt(W_v)``
    (``strength=1``; the exponent is ``strength/2``), clipped to
    ``[m_min, m_max]``.  ``channel_window``: fraction of central channels
    for ``W_v`` (None: all).  ``normalize='output'``: mean(m) = 1;
    ``'noise'``: the predicted variance ``mean(W/m)`` equals the
    unmodulated ``mean(W)``.  Both iterate clip + rescale 16 times; the
    final clip wins.  ``report=True`` returns ``(m, info)`` with
    ``var_ratio``, ``dose_ratio`` and the potential ``W``.
    """
    dev = device_of(paths, device)
    if paths is None:
        paths = material_path_sinogram(phantom, ct, device=dev)
    paths = paths.to(torch.float32)
    mu_t = upload(phantom.materials.mu_table(spec.E), paths)
    i0_h = sp_ops.effective_fluence(spec, ct)
    counts = sp_ops.counts_from_paths(paths, mu_t, upload(i0_h, paths))
    air = float(np.sum(i0_h))
    floor = _scalar(air * 1e-8, counts)
    inv_t = air / torch.maximum(counts, floor)  # [V, C] = e^L
    if channel_window is not None:
        C = inv_t.shape[-1]
        w = max(int(round(C * float(channel_window))), 1)
        lo = (C - w) // 2
        inv_t = inv_t[..., lo:lo + w]
    w_v = torch.mean(inv_t, dim=-1)  # [V]
    m = w_v ** (0.5 * float(strength))
    m = m / torch.mean(m)
    for _ in range(16):
        m_c = torch.clamp(m, m_min, m_max)
        if normalize == "output":
            m = m_c / torch.mean(m_c)
        elif normalize == "noise":
            m = m_c * (torch.mean(w_v / m_c) / torch.mean(w_v))
        else:
            raise ValueError(f"unknown normalize={normalize!r}")
    m = torch.clamp(m, m_min, m_max)
    if not report:
        return m
    info = {
        "var_ratio": float(torch.mean(w_v / m) / torch.mean(w_v)),
        "dose_ratio": float(torch.mean(m)),
        "potential": w_v.cpu().numpy(),
    }
    return m, info


def normalize_counts(counts, m, *, device=None):
    """Divide modulated counts by the known per-view output scale ``m``
    (broadcast over trailing channel/row axes), on the device of
    ``counts`` when it is a tensor, else on ``device``.  The result feeds
    the decomposition unchanged: a per-ray fluence scale shared by every
    energy bin leaves the Poisson-MLE stationary point where it was."""
    c = as_float(counts, device_of(counts, device))
    m = upload(m, c)
    return c / m.reshape(tuple(m.shape) + (1,) * (c.ndim - 1))


def z_profile_from_volume(phantom, ct, spec=None):
    """Longitudinal (z) modulation seed (host, float64): water-equivalent
    diameter per slice, mapped to the per-view potential along the table
    trajectory.  Returns ``(W_view [V], d_weq [nz])``."""
    from ..physics.materials import WATER

    labels = np.asarray(phantom.labels)
    if labels.ndim != 3:
        raise ValueError("z_profile_from_volume needs a 3-D phantom")
    nz = labels.shape[0]
    e_ref = 70.0 if spec is None else float(
        np.average(spec.E, weights=np.maximum(spec.I0, 0)))
    mu_tab = phantom.materials.mu_table(np.asarray([e_ref]))[:, 0]
    mu_w = float(WATER.linear_atten(np.asarray([e_ref]))[0])
    area_w = (mu_tab[labels] / mu_w).sum(axis=(1, 2)) * phantom.dx \
        * phantom.dy
    d_weq = 2.0 * np.sqrt(np.maximum(area_w, 0.0) / np.pi)
    src_z = getattr(ct, "source_z", None)
    betas = np.asarray(ct.betas, np.float64)
    if src_z is None or np.ndim(src_z) == 0:
        zi = np.full(len(betas), nz // 2)
    else:
        zs = (np.arange(nz) + 0.5 - nz / 2) * phantom.dz
        zi = np.clip(np.searchsorted(zs, np.asarray(src_z)), 0, nz - 1)
    W_view = np.exp(mu_w * d_weq[zi])
    return W_view, d_weq


def simulate_tcm_dect(ct, phantom, spec1, spec2, N_matrix, FOV, ramp, *,
                      m=None, strength=1.0, n_iters=50, noise="none",
                      generator=None, window="sinc", do_recon=True,
                      sigma_e=0.0, device=None):
    """The full DE pipeline with per-view tube current modulation, on
    ``device`` (default: the card).

    ``m``: [V] modulation (mean ~1), or None to derive it from the first
    spectrum's scout (:func:`auto_tcm_profile`).  With ``noise='none'``
    the result is the unmodulated ``simulate_dect``'s; with noise, the
    acquired counts and their compound variance scale with m_v
    (``forward_counts(tcm=m, sigma_e=)``) and the normalized counts enter
    the log and the decomposition.  Draws come from ``generator``
    (spectrum 1 first).  ``sigma_e``, the electronic noise floor of
    compound mode, is one value or a pair (one per spectrum, e.g. ``1e-4``
    of each spectrum's air signal); 0, the default, is the JAX package's
    model.
    """
    dev = torch.device("cuda" if device is None else device)
    paths = material_path_sinogram(phantom, ct, device=dev)
    if m is None:
        m = auto_tcm_profile(ct, phantom, spec1, strength=strength,
                             paths=paths)
    m = upload(m, paths, torch.float32)
    mv = m[:, None]
    if noise != "none" and generator is None:
        raise ValueError("noise sampling requires a torch.Generator")

    sig = (tuple(sigma_e) if isinstance(sigma_e, (tuple, list))
           else (sigma_e, sigma_e))
    raws, logs = [], []
    for spec, sigma in zip((spec1, spec2), sig):
        counts, _ = sp_ops.forward_counts(paths, phantom, spec, ct,
                                          noise=noise, generator=generator,
                                          tcm=m, sigma_e=sigma)
        air = float(np.sum(sp_ops.effective_fluence(spec, ct)))
        norm = counts / mv  # the scanner's output normalization
        raws.append(norm)
        logs.append(sp_ops.log_sinogram(norm, air))

    mat1, mat2 = get_basismat_sinos(ct, raws[0], raws[1], spec1, spec2,
                                    n_iters=n_iters)
    if not do_recon:
        return DectResult(tuple(raws), tuple(logs), (None, None),
                          (None, None), (mat1, mat2), (None, None))
    r1, h1 = get_recon(logs[0], ct, spec1, N_matrix, FOV, ramp,
                       window=window)
    r2, h2 = get_recon(logs[1], ct, spec2, N_matrix, FOV, ramp,
                       window=window)
    m1r, _ = get_recon(mat1, ct, None, N_matrix, FOV, ramp, window=window)
    m2r, _ = get_recon(mat2, ct, None, N_matrix, FOV, ramp, window=window)
    return DectResult(tuple(raws), tuple(logs), (r1, r2), (h1, h2),
                      (mat1, mat2), (m1r, m2r))
