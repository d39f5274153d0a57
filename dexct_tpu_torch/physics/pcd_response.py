"""Photon-counting detector spectral response: electronic noise,
charge sharing, K-escape.

The reference's PCD model is a pure absorption-efficiency curve
(``eta_pcd_Si_30mm.bin``, matdecomp.py:146-148): every detected photon
is recorded at its true energy.  Real counting detectors blur the
recorded energy — Gaussian electronic/Fano noise on the pulse height,
a low-energy tail from charge shared across pixel boundaries, and (for
high-Z sensors) a displaced peak at ``E - E_K`` when a fluorescence
photon escapes.  All three degrade the bin separation that multi-bin
material decomposition lives on, so a spectral-CT framework must model
them.

Everything reduces to a column-stochastic response matrix
``R[E_rec, E_true]`` = P(recorded at E_rec | detected, true energy
E_true).  Folding R into the threshold bins gives per-bin weights
``W[b, E_true]`` — EXACTLY the shape of the ideal bin fluences
(`ops.matdecomp.pcd_bin_fluences`), so realistic responses drop into
both the forward simulation and the decomposition's forward model
unchanged (consistent physics), or into only one of them (model-
mismatch studies).

Port of :mod:`dexct_tpu.physics.pcd_response`: host-side float64
construction; the result is a plain [M, E] array consumed by the
pipelines.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pcd_response_matrix", "bin_weights_from_response",
           "pcd_bin_fluences_realistic", "K_FLUORESCENCE_KEV"]

# K-shell fluorescence energies [keV] (K-alpha, dominant line) for the
# common PCD sensor elements.
K_FLUORESCENCE_KEV = {"Si": 1.74, "Cd": 23.17, "Te": 27.47}


def pcd_response_matrix(energies, *, sigma_e_keV=2.0, fano_keV2_per_keV=0.0,
                        share_frac=0.1, sensor="Si", escape_frac=None):
    """Column-stochastic spectral response R[E_rec, E_true].

    Per true energy (column), the recorded-energy distribution is:

    * a Gaussian photopeak at ``E_true`` with variance
      ``sigma_e^2 + fano * E_true`` (electronic + Fano/conversion
      statistics), truncated to the grid and renormalized;
    * a flat charge-sharing tail over ``(0, E_true)`` holding
      ``share_frac`` of events (the standard flat-tail model for the
      split-charge continuum of sub-mm pixels);
    * for CdTe/CZT sensors, K-escape peaks at ``E_true - E_K`` (Cd and
      Te lines, equal split) holding ``escape_frac`` of events above
      the K edge.  ``escape_frac=None`` picks 0 for Si (1.7 keV — the
      escape is unresolvable) and 0.15 for CdTe/CZT.

    Columns sum to 1 exactly: the response redistributes detected
    events, it does not change the detection efficiency (that stays in
    eta(E), `physics.detector`).
    """
    e = np.asarray(energies, np.float64)
    n = len(e)
    de = np.gradient(e)
    if escape_frac is None:
        escape_frac = 0.15 if sensor in ("CdTe", "CZT") else 0.0
    if not 0.0 <= share_frac + escape_frac < 1.0:
        raise ValueError("share_frac + escape_frac must be in [0, 1)")

    sig2 = sigma_e_keV ** 2 + fano_keV2_per_keV * e  # [E_true]
    sig = np.sqrt(np.maximum(sig2, 1e-12))

    # photopeak: Gaussian in E_rec around each E_true, grid-renormalized
    d = e[:, None] - e[None, :]  # [E_rec, E_true]
    peak = np.exp(-0.5 * (d / sig[None, :]) ** 2) * de[:, None]
    peak /= np.maximum(peak.sum(axis=0, keepdims=True), 1e-300)

    r = (1.0 - share_frac) * peak

    if share_frac:
        # flat tail over (0, E_true): weight de / E_true per row below
        # the diagonal (recorded strictly below the true energy)
        below = (e[:, None] < e[None, :]).astype(np.float64)
        tail = below * de[:, None] / np.maximum(e[None, :], 1e-12)
        tail /= np.maximum(tail.sum(axis=0, keepdims=True), 1e-300)
        # columns with no grid point below (lowest energy) keep peak
        has_tail = below.any(axis=0)
        r = r + np.where(has_tail[None, :], share_frac * tail,
                         share_frac * peak)

    if escape_frac:
        lines = [K_FLUORESCENCE_KEV["Cd"], K_FLUORESCENCE_KEV["Te"]] \
            if sensor in ("CdTe", "CZT") else \
            [K_FLUORESCENCE_KEV.get(sensor, 0.0)]
        lines = [el for el in lines if el > 0.0]
        esc = np.zeros((n, n))
        above_any = np.zeros(n, bool)
        for el in lines:
            above = e > el
            above_any |= above
            # escape peak: Gaussian at E_true - E_K with the same sigma
            desc = e[:, None] - (e[None, :] - el)
            pk = np.exp(-0.5 * (desc / sig[None, :]) ** 2) * de[:, None]
            pk /= np.maximum(pk.sum(axis=0, keepdims=True), 1e-300)
            esc += np.where(above[None, :], pk / len(lines), 0.0)
        # columns above the edge split (1 - escape_frac) / escape_frac
        # between the direct response and the escape peaks; below the
        # edge no escape happens and the direct response keeps weight 1
        keep = np.where(above_any, 1.0 - escape_frac, 1.0)
        r = r * keep[None, :] + escape_frac * esc

    # exact column normalization (guards the pile of grid truncations)
    r /= np.maximum(r.sum(axis=0, keepdims=True), 1e-300)
    return r


def bin_weights_from_response(response, energies, thresholds):
    """Per-bin recording probabilities W[b, E_true] = P(bin b | E_true):
    the response integrated over each threshold window (last bin
    open-ended).  Events recorded below the lowest threshold are NOT
    counted — exactly the counter's behavior (sum over b < 1 there)."""
    e = np.asarray(energies, np.float64)
    r = np.asarray(response, np.float64)
    thr = list(thresholds) + [np.inf]
    out = []
    for lo, hi in zip(thr[:-1], thr[1:]):
        sel = (e >= lo) & (e < hi)
        out.append(r[sel].sum(axis=0))
    return np.stack(out)


def pcd_bin_fluences_realistic(geometry, spec, thresholds, *,
                               response=None, **response_kw):
    """Realistic-bin effective fluences i0 [n_bins, E] — the drop-in
    replacement for :func:`~dexct_tpu_torch.ops.matdecomp.pcd_bin_fluences`
    with the spectral response folded in: ``i0[b, E] = base(E) *
    W[b, E]``.  ``response`` overrides the matrix (else built from
    ``response_kw`` on the spectrum's grid)."""
    from ..ops.spectral import effective_fluence

    base = effective_fluence(spec, geometry)
    if response is None:
        response = pcd_response_matrix(spec.E, **response_kw)
    w = bin_weights_from_response(response, spec.E, thresholds)
    return w * base[None, :]
