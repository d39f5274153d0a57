"""Composable scanner-realism chain: ordered artifact application and
reverse-ordered correction around the clean DE pipeline.

Port of :mod:`dexct_tpu.pipeline.realism`.  Each realism subsystem is a
counts-domain transform with a matching correction, applied by the
hardware in a definite order:

    primary counts
      -> focal spot / crosstalk blur        (ops/mtf.py)
      -> scatter background                 (ops/scatter.py)
      -> pulse pileup                       (physics/pileup.py)
      -> channel gains                      (ops/rings.py)
      -> afterglow lag                      (ops/afterglow.py)
      -> counting noise

and the scanner's preprocessing inverts them in reverse order before the
log.  A ``Stage`` is an (apply, correct) pair of [.., V, C] counts
transforms; ``apply_chain`` runs the stages in order, ``correct_chain`` in
reverse.  :func:`simulate_dect_realistic` wraps the DE pipeline (one
shared trace, K1; counts, K2 or with a bowtie K28; the decomposition, K3
or with a bowtie K29; FBP, K4) with a chain per acquisition and returns a
:class:`~dexct_tpu_torch.pipeline.api.DectResult`.  Stages run on the
device of the counts they are given.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..ops import spectral as sp_ops
from ..ops.siddon import material_path_sinogram
from ..utils.devices import _scalar, as_float, device_of, upload
from .api import DectResult, get_basismat_sinos, get_recon

__all__ = ["Stage", "apply_chain", "correct_chain",
           "stage_gains", "stage_scatter", "stage_physics_scatter",
           "stage_afterglow", "stage_mtf", "stage_pileup",
           "simulate_dect_realistic"]


@dataclasses.dataclass
class Stage:
    """One realism subsystem: ``apply(counts) -> counts`` (simulation)
    and ``correct(counts) -> counts`` (scanner preprocessing).  A
    ``correct=None`` stage is simulation-only (an uncorrected
    artifact)."""

    name: str
    apply: typing.Callable
    correct: typing.Callable | None = None


def apply_chain(counts, stages):
    for st in stages:
        counts = st.apply(counts)
    return counts


def correct_chain(counts, stages):
    for st in reversed(stages):
        if st.correct is not None:
            counts = st.correct(counts)
    return counts


def _on(x, like):
    """``x`` (scalar, array or tensor) as a float tensor on the device of
    ``like``; scalars stay Python numbers."""
    return x if np.isscalar(x) else as_float(x, like.device)


def stage_gains(gains, air, n_cal_views=256):
    """Per-channel gain errors; correction = air-scan calibration (the
    estimator sees a noiseless air scan of ``n_cal_views`` views)."""
    from ..ops.rings import air_calibration_gains, apply_channel_gains

    g = as_float(gains, device_of(gains, "cpu"))
    air_t = _on(air, g)
    g_hat = air_calibration_gains(
        air_t * g.expand(int(n_cal_views), g.shape[-1]), air_t)

    return Stage("gains",
                 lambda c: apply_channel_gains(c, upload(g, c.device)),
                 lambda c: c / upload(g_hat, c.device))


def stage_scatter(air, kernel, *, spr=0.2, grid_p=0.95, grid_s=0.2,
                  n_iters=3):
    from ..ops.scatter import add_scatter, correct_scatter

    if torch.is_tensor(kernel):
        def k(c):
            return kernel
    else:
        host, kept = torch.as_tensor(np.asarray(kernel)), {}

        def k(c):  # a NumPy kernel goes to each device (and dtype) once
            key = (c.device, c.dtype)
            if key not in kept:
                kept[key] = upload(host, c)
            return kept[key]

    return Stage(
        "scatter",
        lambda c: add_scatter(c, _on(air, c), k(c), spr=spr, grid_p=grid_p,
                              grid_s=grid_s),
        lambda c: correct_scatter(c, _on(air, c), k(c), spr=spr,
                                  grid_p=grid_p, grid_s=grid_s,
                                  n_iters=n_iters))


def stage_physics_scatter(scatter_sino, *, grid_p=1.0, grid_s=1.0,
                          corrected=True, estimate=None):
    """Additive single-scatter background from the first-principles
    estimator (``ops.scatter_physics.single_scatter_sinogram``) for the
    SAME views as the acquisition; ``grid_p``/``grid_s`` are the
    anti-scatter grid's transmissions.  The correction divides out
    ``grid_p`` and subtracts ``estimate`` (default: the true scatter),
    clamped at zero."""
    s_true = scatter_sino
    s_est = s_true if estimate is None else estimate

    def corr(c):
        c = c if c.is_floating_point() else c.to(torch.float32)
        s = _on(s_est, c)
        return torch.clamp_min(
            c / _scalar(grid_p, c) - (grid_s / grid_p) * s, 0.0)

    return Stage("physics_scatter",
                 lambda c: grid_p * c + grid_s * _on(s_true, c),
                 corr if corrected else None)


def stage_afterglow(fractions, decay, *, warm_start=True):
    from ..ops.afterglow import apply_afterglow, correct_afterglow

    return Stage(
        "afterglow",
        lambda c: apply_afterglow(c, fractions, decay,
                                  warm_start=warm_start),
        lambda c: correct_afterglow(c, fractions, decay,
                                    warm_start=warm_start))


def stage_mtf(kernel, *, nsr=1e-4):
    from ..ops.mtf import apply_detector_mtf, wiener_restore_channels

    k = np.asarray(kernel)
    return Stage("mtf",
                 lambda c: apply_detector_mtf(c, k),
                 lambda c: wiener_restore_channels(c, k, nsr=nsr))


def stage_pileup(tau_ratio, model="nonparalyzable"):
    """Total-rate dead time on an EID/PCD single-counts stream."""
    from ..physics.pileup import recorded_rate, true_rate

    return Stage(
        "pileup",
        lambda c: recorded_rate(c * tau_ratio, model) / _scalar(tau_ratio, c),
        lambda c: true_rate(c * tau_ratio, model) / _scalar(tau_ratio, c))


def simulate_dect_realistic(ct, phantom, spec1, spec2, N_matrix, FOV,
                            ramp, stages1, stages2=None, *, n_iters=50,
                            noise="none", generator=None, window="sinc",
                            correct=True, do_recon=True, bowtie=None,
                            device=None):
    """Full DE pipeline through a realism chain, on ``device`` (default:
    the card).

    ``stages1`` / ``stages2``: the artifact chains of the two acquisitions
    (``stages2=None`` reuses ``stages1``).  Artifacts apply in order, then
    noise (drawn from ``generator``, spectrum 1 first; compound noise takes
    the clean second moment rate-scaled by what the chain did to the mean
    counts); correction (if ``correct``) runs the chain inverse before the
    log.  ``bowtie`` (ops/bowtie.py) puts beam-shaping filtration under the
    whole chain: per-channel fluence in the clean counts and the second
    moment (K28), per-channel air normalization and the thickness-grouped
    decomposition (K29).
    """
    if stages2 is None:
        stages2 = stages1
    if noise != "none" and generator is None:
        raise ValueError("noise requires a torch.Generator")
    dev = torch.device("cuda" if device is None else device)
    paths = material_path_sinogram(phantom, ct, device=dev)
    if bowtie is not None:
        from ..ops.bowtie import bowtie_fluence, bowtie_second_moment
    out_raw, out_log = [], []
    for spec, stages in ((spec1, stages1), (spec2, stages2)):
        mu_t = upload(phantom.materials.mu_table(spec.E), dev,
                      torch.float32)
        if bowtie is not None:
            i0_h = bowtie_fluence(spec, ct, bowtie)
            air = as_float(i0_h.sum(-1), dev)
            i2_h = bowtie_second_moment(spec, ct, bowtie)
        else:
            i0_h = sp_ops.effective_fluence(spec, ct)
            air = float(np.sum(i0_h))
            i2_h = sp_ops.second_moment_fluence(spec, ct)
        # compound noise: the physically correct EID model, the clean
        # second moment from the same pass as the clean counts
        clean = sp_ops.counts_from_paths(
            paths, mu_t, as_float(i0_h, dev),
            as_float(i2_h, dev) if noise == "compound" else None,
            per_channel=bowtie is not None)
        clean, var = clean if noise == "compound" else (clean, None)
        meas = apply_chain(clean, stages)
        if noise != "none":
            if var is not None:
                # rate-scaled by what the chain did to the mean counts
                var = var * meas / torch.clamp_min(clean, 1e-30)
            meas = sp_ops.sample_noise(generator, meas, noise, var=var)
        prim = correct_chain(meas, stages) if correct else meas
        out_raw.append((meas, prim))
        out_log.append(sp_ops.log_sinogram(prim, air))

    (m1, p1), (m2, p2) = out_raw
    log1, log2 = out_log
    if bowtie is not None:
        from ..ops.bowtie import decompose_sinograms_bowtie

        mat1, mat2 = decompose_sinograms_bowtie(ct, p1, p2, spec1, spec2,
                                                bowtie, n_iters=n_iters)
    else:
        mat1, mat2 = get_basismat_sinos(ct, p1, p2, spec1, spec2,
                                        n_iters=n_iters)
    if not do_recon:
        return DectResult((m1, m2), (log1, log2), (None, None),
                          (None, None), (mat1, mat2), (None, None))
    r1, h1 = get_recon(log1, ct, spec1, N_matrix, FOV, ramp,
                       window=window)
    r2, h2 = get_recon(log2, ct, spec2, N_matrix, FOV, ramp,
                       window=window)
    m1r, _ = get_recon(mat1, ct, None, N_matrix, FOV, ramp,
                       window=window)
    m2r, _ = get_recon(mat2, ct, None, N_matrix, FOV, ramp,
                       window=window)
    return DectResult((m1, m2), (log1, log2), (r1, r2), (h1, h2),
                      (mat1, mat2), (m1r, m2r))
