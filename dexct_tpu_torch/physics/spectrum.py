"""Polyenergetic x-ray spectrum model.

Host NumPy rebuild of the reference's ``xtomosim.system.xRaySpectrum``
(constructed at reference main.py:67; attributes ``.E``/``.I0`` read at
matdecomp.py:140,149-150; ``.rescale_counts`` called at main.py:68).

File format (decoded in SURVEY.md §2.4 from the shipped binaries):
``float32 concat(E[N], I0[N])`` with E in keV and I0 in photons/cm^2 per mGy
per scan (the ``_1mGy_`` filename convention, main.py:66).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import xcom

__all__ = ["xRaySpectrum", "Spectrum", "kramers_spectrum", "linac_spectrum"]


@dataclasses.dataclass
class Spectrum:
    """An x-ray spectrum: energy grid [keV] and per-bin photon counts.

    ``I0`` units depend on scaling state: as loaded from a ``*_1mGy_*`` file
    they are photons/cm^2/mGy; after :meth:`rescale_counts` they are photons
    per detector channel per view (see main.py:68 and SURVEY.md §2.3).
    """

    E: np.ndarray
    I0: np.ndarray
    name: str = ""

    def __post_init__(self):
        self.E = np.asarray(self.E, dtype=np.float64)
        self.I0 = np.asarray(self.I0, dtype=np.float64)
        if self.E.ndim != 1 or self.E.shape != self.I0.shape:
            raise ValueError("E and I0 must be matching 1-D arrays")

    # -- reference-compatible API -------------------------------------------
    def rescale_counts(self, total_counts):
        """Rescale I0 so that ``sum(I0) == total_counts`` (in place).

        The reference driver calls ``spec.rescale_counts(ct.A_iso * dose /
        ct.N_proj)`` (reference main.py:68) — but with I0 stored per
        cm^2 per mGy the product ``A_iso [cm^2] * dose [mGy] / N_proj`` is a
        *multiplier*, not a target sum.  Observed magnitudes (SURVEY.md §2.4)
        only fix the product, so we implement the multiplicative semantics:
        ``I0 *= factor`` when called via :meth:`scale_by`, and expose this
        method with reference-matching name/sig as the multiplier form.
        """
        self.I0 = self.I0 * float(total_counts)
        return self

    scale_by = rescale_counts

    # -- derived quantities --------------------------------------------------
    @property
    def total_counts(self):
        return float(self.I0.sum())

    def bin_widths(self):
        """Energy bin widths, first bin spanning 0..E[0] — the reference's
        convention (``dE[0] = ee[0]``, reference matdecomp.py:142)."""
        return np.append([self.E[0]], np.diff(self.E))

    def effective_water_mu(self, detector=None):
        """Fluence(+detector)-weighted effective linear attenuation of water
        [1/cm], used for the HU conversion of polyenergetic reconstructions
        (HU formula pinned at reference plots.py:140-143)."""
        w = self.I0 * self.bin_widths()
        if detector is not None:
            w = w * detector.response(self.E)
        mu_w = xcom.mixatten("H(11.2)O(88.8)", self.E)  # rho = 1.0
        s = w.sum()
        if s <= 0.0:
            raise ValueError("spectrum has no intensity")
        return float((w * mu_w).sum() / s)

    def copy(self):
        return Spectrum(self.E.copy(), self.I0.copy(), self.name)

    # -- IO -------------------------------------------------------------------
    @classmethod
    def from_file(cls, fname, name=""):
        """Load ``float32 concat(E[N], I0[N])`` (SURVEY.md §2.4)."""
        raw = np.fromfile(os.fspath(fname), dtype=np.float32)
        if len(raw) % 2:
            raise ValueError(f"odd-length spectrum file: {fname}")
        n = len(raw) // 2
        return cls(raw[:n].astype(np.float64), raw[n:].astype(np.float64),
                   name or os.path.basename(os.fspath(fname)))

    def to_file(self, fname):
        np.concatenate([self.E, self.I0]).astype(np.float32).tofile(
            os.fspath(fname)
        )


def xRaySpectrum(fname, name=""):
    """Reference-compatible constructor (reference main.py:67)."""
    return Spectrum.from_file(fname, name)


# ---------------------------------------------------------------------------
# Analytic spectrum generators (replace the absent input/phantom data chain;
# the five shipped spectrum binaries remain loadable via Spectrum.from_file)
# ---------------------------------------------------------------------------

# tungsten anode characteristic lines [keV] and relative intensities
_W_LINES = ((59.32, 0.50), (57.98, 0.29), (67.24, 0.15), (69.07, 0.06))
_W_K_EDGE = 69.5


def kramers_spectrum(kvp, n_bins=None, filtration_mm_al=2.5,
                     photons_per_cm2_per_mGy=None, name=None,
                     char_fraction=0.08):
    """Filtered Kramers bremsstrahlung model of a tungsten-anode kV spectrum.

    Produces the shipped kV file layout: E = 1..140 keV in 1 keV steps with
    zero intensity above the kVp (SURVEY.md §2.4).  Intensity follows
    Kramers' law I(E) ∝ (kVp - E)/E attenuated by ``filtration_mm_al`` of
    aluminium, plus tungsten K characteristic lines for kVp above the W
    K-edge (69.5 keV), carrying ``char_fraction`` of the filtered fluence
    at full overvoltage.  The absolute normalization is calibrated so
    integral photon fluence per mGy matches the decoded magnitudes of the
    shipped spectra (80 kV ≈ 7.8e11 photons/cm^2/mGy).
    """
    e_max = 140.0
    n = int(n_bins or e_max)
    E = np.arange(1.0, n + 1.0)
    I = np.clip(kvp - E, 0.0, None) / E
    mu_al = xcom.element_mu("Al", E) * 2.699  # [1/cm]
    I = I * np.exp(-mu_al * 0.1 * filtration_mm_al)
    I[E > kvp] = 0.0
    if kvp > _W_K_EDGE and char_fraction > 0.0:
        # K-line yield grows with overvoltage; simple (U-1)^1.65 activation
        u = kvp / _W_K_EDGE
        frac = char_fraction * min((u - 1.0) / (140.0 / _W_K_EDGE - 1.0),
                                   1.0) ** 0.5
        line_total = frac * I.sum() / max(1.0 - frac, 1e-6)
        for e_line, rel in _W_LINES:
            idx = int(round(e_line)) - 1
            if 0 <= idx < n:
                I[idx] += line_total * rel
    if photons_per_cm2_per_mGy is None:
        # Calibrated against the shipped 80kV file integral (SURVEY.md §2.4).
        photons_per_cm2_per_mGy = 7.8e11 * (kvp / 80.0)
    s = I.sum()
    if s > 0:
        I = I * (photons_per_cm2_per_mGy / s)
    return Spectrum(E, I, name or f"{int(kvp)}kV")


def linac_spectrum(mv=6.0, n_bins=100, e_min=100.0, detuned=True,
                   photons_per_cm2_per_mGy=7.4e6, name=None):
    """Analytic MV linac bremsstrahlung spectrum.

    Mirrors the shipped MV layout: N=100 linear energy grid from ``e_min`` to
    ``mv*1000`` keV (detunedMV: 100..6000 keV; SURVEY.md §2.4).  Shape is a
    thin-target bremsstrahlung ``ln(E_max/E)`` softened by an exponential
    beam-hardening roll-off; ``detuned`` lowers the effective filtration to
    give a softer (more low-energy weighted) beam.
    """
    e_max = mv * 1000.0
    E = np.linspace(e_min, e_max, int(n_bins))
    I = np.log(np.clip(e_max / E, 1.0, None) + 1e-12)
    hardening = 0.15 if detuned else 0.5
    mu_w = xcom.mixatten("H(11.2)O(88.8)", E)
    I = I * np.exp(-mu_w * hardening)
    s = I.sum()
    if s > 0:
        I = I * (photons_per_cm2_per_mGy / s)
    return Spectrum(E, I, name or ("detunedMV" if detuned else f"{int(mv)}MV"))
