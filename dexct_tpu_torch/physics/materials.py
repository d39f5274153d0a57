"""Material definitions and the label -> linear-attenuation LUT builder.

The reference maps uint8 voxel labels to materials through a CSV
(``matcomp_filename``, reference input/params.txt:9, used by
``VoxelPhantom`` at plots.py:124-126).  The CSV format is not in the
snapshot; this module fixes it as::

    label,name,density,matcomp
    0,air,0.001205,N(75.5)O(23.2)Ar(1.3)
    1,water,1.0,H(11.2)O(88.8)
    ...

Hardcoded basis/reference materials reproduce the reference constants
(reference matdecomp.py:12-17 tissue/bone; plots.py:140 water;
plots.py:487-498 implant alloys).
"""

from __future__ import annotations

import csv
import dataclasses
import io
import os

import numpy as np

from . import xcom

__all__ = [
    "Material",
    "MaterialTable",
    "TISSUE",
    "BONE",
    "WATER",
    "AIR",
    "BUILTIN_MATERIALS",
]


@dataclasses.dataclass(frozen=True)
class Material:
    name: str
    density: float  # [g/cm^3]
    matcomp: str  # composition string, e.g. 'H(11.2)O(88.8)'

    def mass_atten(self, energy_keV):
        """mu/rho [cm^2/g] on ``energy_keV``."""
        return xcom.mixatten(self.matcomp, energy_keV)

    def linear_atten(self, energy_keV):
        """mu [1/cm] on ``energy_keV``."""
        return self.density * self.mass_atten(energy_keV)

    def electrons_per_gram(self):
        """N_A * sum_i w_i Z_i / A_i [electrons/g] — the one source of
        truth for electron density (scatter physics, DE products)."""
        return xcom.AVOGADRO * sum(
            w * xcom.ELEMENT_Z[s] / xcom.ATOMIC_WEIGHT[s]
            for s, w in xcom.parse_matcomp(self.matcomp))

    def _z2_per_gram(self):
        """sum_i w_i Z_i^2 / A_i — the coherent-scatter mixture weight
        (Rayleigh scales ~Z^2 per atom at fixed E in the CT band)."""
        return sum(w * xcom.ELEMENT_Z[s] ** 2 / xcom.ATOMIC_WEIGHT[s]
                   for s, w in xcom.parse_matcomp(self.matcomp))

    def mass_energy_absorption(self, energy_keV):
        """Mass energy-absorption coefficient mu_en/rho [cm^2/g].

        Per-process construction, calibrated on the vendored NIST water
        mu_en anchors (:data:`WATER_MUEN_ANCHORS`):

        * Compton: free-electron Klein-Nishina cross-section times the
          exact mean recoil fraction f_tr(E)
          (:func:`~dexct_tpu_torch.physics.xcom.klein_nishina_transfer_fraction`)
          — electrons/g is exact per material.
        * Coherent (transfers nothing): inferred FROM the water anchors
          (coh_w = mu_w - muC_w - photo_w with photo_w = muen_w -
          muC_w f_tr) and transferred to other media by the Z^2/A
          mixture rule.
        * Photoelectric (+pair above 1.022 MeV): the residual
          mu - muC - coh, scored as full local transfer (fluorescence
          yields are small and the photons are reabsorbed locally for
          the low-Z study media; pair's 2 m_e c^2 escape fraction is a
          few % at linac energies).

        Water reproduces the NIST anchors exactly by construction;
        air/tissue/bone ride the same calibration through their exact
        Compton terms and Z^2-scaled coherent (a few % — the residual
        photo term dominates wherever the scaling is roughest).  For
        high-Z metals treat it as a transfer-model estimate.
        """
        e = np.atleast_1d(np.asarray(energy_keV, np.float64))
        f = xcom.klein_nishina_transfer_fraction(e)
        sig = xcom.klein_nishina_cross_section(e)
        mu_c = self.electrons_per_gram() * sig
        mu = self.mass_atten(e)
        # water calibration curves
        mu_w = xcom.mixatten(WATER.matcomp, e)
        mu_c_w = WATER.electrons_per_gram() * sig
        muen_w = water_mu_en_over_rho(e)
        photo_w = np.maximum(muen_w - mu_c_w * f, 0.0)
        coh_w = np.maximum(mu_w - mu_c_w - photo_w, 0.0)
        coh = coh_w * (self._z2_per_gram() / WATER._z2_per_gram())
        photo = np.maximum(mu - mu_c - coh, 0.0)
        out = np.clip(photo + mu_c * f, 0.0, mu)
        return out if np.ndim(energy_keV) else float(out[0])

    def linear_energy_absorption(self, energy_keV):
        """mu_en [1/cm]."""
        return self.density * self.mass_energy_absorption(energy_keV)


# NIST mass energy-absorption anchors for LIQUID WATER (Hubbell &
# Seltzer tables; mu_en/rho [cm^2/g]) — the calibration dataset for
# Material.mass_energy_absorption.  Log-log interpolated between
# anchors (the curve is smooth: no edges above 1 keV in water).
WATER_MUEN_ANCHORS = (
    (10.0, 4.944), (15.0, 1.374), (20.0, 0.5503), (30.0, 0.1557),
    (40.0, 0.0695), (50.0, 0.04188), (60.0, 0.03190), (80.0, 0.02583),
    (100.0, 0.02546), (150.0, 0.02764), (200.0, 0.02967),
    (300.0, 0.03192), (500.0, 0.03279), (1000.0, 0.03103),
    (1250.0, 0.02965), (2000.0, 0.02608), (3000.0, 0.02281),
    (4000.0, 0.02066), (6000.0, 0.01806),
)


def water_mu_en_over_rho(energy_keV):
    """NIST water mu_en/rho [cm^2/g], log-log anchor interpolation."""
    e = np.asarray(energy_keV, np.float64)
    ea = np.array([a[0] for a in WATER_MUEN_ANCHORS])
    va = np.array([a[1] for a in WATER_MUEN_ANCHORS])
    return np.exp(np.interp(np.log(np.clip(e, ea[0], ea[-1])),
                            np.log(ea), np.log(va)))


# Reference-pinned materials (matdecomp.py:12-17, plots.py:140, 487-498).
TISSUE = Material(
    "ICRU tissue",
    1.06,
    "H(10.2)C(14.3)N(3.4)O(70.8)Na(0.2)P(0.3)S(0.3)Cl(0.2)K(0.3)",
)
BONE = Material(
    "ICRU bone",
    1.92,
    "H(3.4)C(15.5)N(4.2)O(43.5)Na(0.1)Mg(0.2)P(10.3)S(0.3)Ca(22.5)",
)
WATER = Material("water", 1.0, "H(11.2)O(88.8)")
AIR = Material("air", 0.001205, "N(75.5)O(23.2)Ar(1.3)")

TITANIUM = Material("titanium", 4.5, "Ti(100.0)")
TI_6AL_4V = Material("Ti-6Al-4V", 4.43, "Al(6)Ti(90)V(4)")
STEEL_316L = Material(
    "steel 316L",
    8.0,
    "C(0.5)N(0.1)P(0.0025)S(0.01)Fe(64.335)Cr(17.0)Ni(13.0)Mo(2.25)"
    "Mn(2.0)Si(0.75)Cu(0.5)",
)
COCRMO = Material("Co-28Cr-6Mo", 8.5, "Co(66)Cr(28)Mo(6)")
# ICRU-44 red bone marrow (the trabecular interior of the 3-D
# pelvis; cortical bone = BONE above)
MARROW = Material(
    "red marrow", 1.03,
    "H(10.5)C(41.4)N(3.4)O(43.9)P(0.1)S(0.2)Cl(0.2)K(0.2)Fe(0.1)",
)
ADIPOSE = Material(
    "adipose", 0.95, "H(11.4)C(59.8)N(0.7)O(27.8)Na(0.1)S(0.1)Cl(0.1)"
)
MUSCLE = Material(
    "muscle", 1.05,
    "H(10.2)C(14.3)N(3.4)O(71.0)Na(0.1)P(0.2)S(0.3)Cl(0.1)K(0.4)",
)
# ICRU-44 whole brain and cerebrospinal fluid (the head phantom's
# interior; CSF is within 1% of water radiologically)
BRAIN = Material(
    "brain", 1.04,
    "H(10.7)C(14.5)N(2.2)O(71.2)Na(0.2)P(0.4)S(0.2)Cl(0.3)K(0.3)",
)
CSF = Material("csf", 1.007, "H(11.1)O(88.0)Na(0.5)Cl(0.4)")
# ICRU-44 lung tissue at the inflated (in-vivo) bulk density — the
# thorax phantom's parenchyma (~-740 HU)
LUNG = Material(
    "lung (inflated)", 0.26,
    "H(10.3)C(10.5)N(3.1)O(74.9)Na(0.2)P(0.2)S(0.3)Cl(0.3)K(0.2)",
)
# ICRU-44 whole blood (heart chambers / great vessels)
BLOOD = Material(
    "blood", 1.06,
    "H(10.2)C(11.0)N(3.3)O(74.5)Na(0.1)P(0.1)S(0.2)Cl(0.3)K(0.2)"
    "Fe(0.1)",
)

BUILTIN_MATERIALS = {
    m.name: m
    for m in [AIR, WATER, TISSUE, BONE, TITANIUM, TI_6AL_4V, STEEL_316L,
              COCRMO, ADIPOSE, MUSCLE, MARROW]
}


class MaterialTable:
    """Ordered label -> Material mapping (label i = row i)."""

    def __init__(self, materials):
        self.materials = list(materials)
        if not self.materials:
            raise ValueError("empty material table")

    def __len__(self):
        return len(self.materials)

    def __getitem__(self, label):
        return self.materials[label]

    def __iter__(self):
        return iter(self.materials)

    @property
    def names(self):
        return [m.name for m in self.materials]

    @property
    def densities(self):
        return np.array([m.density for m in self.materials])

    def mu_table(self, energy_keV):
        """Linear attenuation LUT mu[label, energy] [1/cm] (float64).

        This is the array that becomes a device-resident LUT: the forward
        model contracts material path lengths against it on the MXU
        (SURVEY.md §7 step 1).
        """
        e = np.asarray(energy_keV, dtype=np.float64)
        return np.stack([m.linear_atten(e) for m in self.materials])

    def mass_atten_table(self, energy_keV):
        """Mass attenuation LUT (mu/rho)[label, energy] [cm^2/g]."""
        e = np.asarray(energy_keV, dtype=np.float64)
        return np.stack([m.mass_atten(e) for m in self.materials])

    def mu_en_table(self, energy_keV):
        """Linear energy-absorption LUT mu_en[label, energy] [1/cm] —
        the KERMA deposition weights (ops/dose.py scoring='kerma')."""
        e = np.asarray(energy_keV, dtype=np.float64)
        return np.stack(
            [m.linear_energy_absorption(e) for m in self.materials])

    # -- CSV round trip ------------------------------------------------------
    @classmethod
    def from_csv(cls, fname_or_text):
        """Load a materials CSV (path or literal CSV text).

        Columns: ``label,name,density,matcomp``; labels must be the
        contiguous range 0..N-1 (rows may appear in any order).
        """
        if os.path.exists(str(fname_or_text)):
            with open(fname_or_text, newline="") as f:
                rows = list(csv.DictReader(f))
        else:
            rows = list(csv.DictReader(io.StringIO(str(fname_or_text))))
        if not rows:
            raise ValueError("empty materials CSV")
        by_label = {}
        for r in rows:
            label = int(r["label"])
            if label in by_label:
                raise ValueError(f"duplicate label {label} in materials CSV")
            by_label[label] = Material(
                r["name"].strip(), float(r["density"]), r["matcomp"].strip()
            )
        n = len(by_label)
        if sorted(by_label) != list(range(n)):
            raise ValueError(
                f"labels must be contiguous 0..{n - 1}, got {sorted(by_label)}"
            )
        return cls([by_label[i] for i in range(n)])

    def to_csv(self, fname):
        with open(fname, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["label", "name", "density", "matcomp"])
            for i, m in enumerate(self.materials):
                w.writerow([i, m.name, m.density, m.matcomp])
