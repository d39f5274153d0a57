"""Detector response model.

Rebuild of the detector-response portion of the reference's geometry object:
``ct.det_E`` / ``ct.det_eta_E`` / ``ct.eid`` are consumed by the material
decomposition (reference matdecomp.py:146-148) — the response is
interpolated onto the working energy grid and, for energy-integrating
detectors (``eid=True``), weighted by photon energy.

File format (SURVEY.md §2.4): ``float32 concat(E[N], eta[N])``, E on a 1 keV
grid up to 6 MeV, eta in (0, 1].
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import xcom

__all__ = ["DetectorResponse", "scintillator_response", "photon_counting_response"]


@dataclasses.dataclass
class DetectorResponse:
    """Energy-dependent detection efficiency eta(E)."""

    E: np.ndarray
    eta: np.ndarray
    name: str = ""

    def __post_init__(self):
        self.E = np.asarray(self.E, dtype=np.float64)
        self.eta = np.asarray(self.eta, dtype=np.float64)
        if self.E.ndim != 1 or self.E.shape != self.eta.shape:
            raise ValueError("E and eta must be matching 1-D arrays")

    def response(self, energy_keV, eid=False):
        """eta interpolated onto ``energy_keV``; multiplied by E when
        ``eid`` (energy-integrating detector, matdecomp.py:147-148)."""
        e = np.asarray(energy_keV, dtype=np.float64)
        r = np.interp(e, self.E, self.eta)
        return r * e if eid else r

    @classmethod
    def from_file(cls, fname, name=""):
        raw = np.fromfile(os.fspath(fname), dtype=np.float32)
        if len(raw) % 2:
            raise ValueError(f"odd-length detector file: {fname}")
        n = len(raw) // 2
        return cls(raw[:n].astype(np.float64), raw[n:].astype(np.float64),
                   name or os.path.basename(os.fspath(fname)))

    def to_file(self, fname):
        np.concatenate([self.E, self.eta]).astype(np.float32).tofile(
            os.fspath(fname)
        )

    @classmethod
    def ideal(cls, e_max_keV=6000.0):
        """Perfect detector (eta = 1 everywhere)."""
        e = np.arange(1.0, e_max_keV + 1.0)
        return cls(e, np.ones_like(e), "ideal")


def scintillator_response(matcomp="Cd(43.2)W(35.3)O(21.5)", density=7.9,
                          thickness_cm=1.0, e_max_keV=6000.0,
                          name="eid_scint"):
    """Absorption efficiency of a scintillator slab: 1 - exp(-mu t).

    Default composition approximates CdWO4 — an MV-imaging scintillator;
    reproduces the shape of the shipped ``eta_eid_mv.bin`` (eta -> 1 at low E
    falling to ~0.2 at 6 MeV, SURVEY.md §2.4).
    """
    e = np.arange(1.0, e_max_keV + 1.0)
    mu = xcom.mixatten(matcomp, e) * density
    return DetectorResponse(e, 1.0 - np.exp(-mu * thickness_cm), name)


def photon_counting_response(thickness_cm=3.0, e_max_keV=5999.0,
                             name="pcd_Si"):
    """Photon-counting silicon detector absorption efficiency (shape of the
    shipped ``eta_pcd_Si_30mm.bin``)."""
    e = np.arange(1.0, e_max_keV + 1.0)
    mu = xcom.element_mu("Si", e) * 2.329
    return DetectorResponse(e, 1.0 - np.exp(-mu * thickness_cm), name)
