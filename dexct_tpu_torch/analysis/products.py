"""Clinical dual-energy products: VNC, iodine maps, Z_eff, electron
density.

The reference's analysis synthesizes VMIs from the basis pair
(plots.py:136-144); clinical DECT consoles derive three more standard
products from the same basis-density images, all closed-form in the
decomposition output:

* **VNC** (virtual non-contrast): the image with the iodine basis
  component removed — what the scan would have looked like before
  contrast injection.
* **Iodine map**: the iodine basis density in mg/mL — contrast
  quantification (perfusion, lesion enhancement).
* **Electron density** (relative to water): the radiotherapy-planning
  quantity; exact from basis densities because electron density mixes
  linearly.
* **Effective atomic number** Z_eff: the Mayneord power-law mean
  ``(sum f_e Z^m)^(1/m)`` with m = 2.94 over the mixture's electron
  fractions.
* **Proton stopping-power ratio (SPR)**: the proton-therapy planning
  quantity — relative (to water) mass stopping power via the Bethe
  formula, with per-voxel electron density and Bragg-additivity mean
  excitation energy both exact in the basis densities.

All functions take basis-density images ``a`` (one per basis material,
g/cm^3 — the ``mat*_recon`` outputs) and the matching
:class:`~dexct_tpu_torch.physics.materials.Material` list.
"""

from __future__ import annotations

import numpy as np

from ..physics import xcom
from ..physics.materials import WATER

__all__ = ["vnc_image", "iodine_map", "electron_density_map",
           "zeff_image", "WATER_ELECTRON_DENSITY",
           "ELEMENT_I_EV", "WATER_I_EV", "mean_excitation_energy",
           "proton_spr", "spr_image"]

WATER_ELECTRON_DENSITY = 3.3428e23  # electrons/cm^3

_ZEFF_EXPONENT = 2.94


def _find_iodine_index(materials):
    names = [m.name.lower() for m in materials]
    idx = [i for i, n in enumerate(names) if "iodine" in n]
    if len(idx) != 1:
        raise ValueError(
            f"cannot identify the iodine basis among {names}; pass "
            "iodine_index")
    return idx[0]


def vnc_image(a_imgs, materials, e0_keV, *, iodine_index=None, HU=True):
    """Virtual non-contrast image at ``e0_keV``.

    a_imgs: list/array of basis-density images [g/cm^3];
    materials: matching Material list; the iodine basis (detected by
    name containing 'iodine' unless ``iodine_index`` given) is
    dropped and the remaining components are synthesized
    monoenergetically (the same construction as a VMI, plots.py:
    136-144, minus the contrast term).
    """
    a_imgs = [np.asarray(a, np.float64) for a in a_imgs]
    if iodine_index is None:
        iodine_index = _find_iodine_index(materials)
    e = np.atleast_1d(np.float64(e0_keV))
    mu = np.zeros_like(a_imgs[0])
    for i, (a, m) in enumerate(zip(a_imgs, materials)):
        if i == iodine_index:
            continue
        mu = mu + a * float(m.mass_atten(e)[0])
    if not HU:
        return mu
    mu_w = float(WATER.linear_atten(e)[0])
    return 1000.0 * (mu - mu_w) / mu_w


def iodine_map(a_imgs, materials, *, iodine_index=None, clip_negative=True):
    """Iodine concentration map [mg/mL] from the basis densities."""
    if iodine_index is None:
        iodine_index = _find_iodine_index(materials)
    conc = np.asarray(a_imgs[iodine_index], np.float64) * 1000.0
    return np.clip(conc, 0.0, None) if clip_negative else conc


def electron_density_map(a_imgs, materials, *, relative=True):
    """Electron density [electrons/cm^3], or relative to water.

    Exact from basis densities: rho_e = sum_m a_m * (N_A sum w Z/A)_m —
    electron density is linear in mass, which is why the (rho_e, Z_eff)
    parametrization is an equivalent basis pair.
    """
    out = np.zeros_like(np.asarray(a_imgs[0], np.float64))
    for a, m in zip(a_imgs, materials):
        out = out + np.asarray(a, np.float64) * m.electrons_per_gram()
    return out / WATER_ELECTRON_DENSITY if relative else out


def zeff_image(a_imgs, materials, *, m_exp=_ZEFF_EXPONENT, floor=0.05):
    """Effective atomic number map (Mayneord power law).

    Z_eff = (sum_i f_e,i Z_i^m)^(1/m) over the voxel mixture's
    electron fractions f_e,i; pixels whose total electron density is
    below ``floor`` of water's return 0 (air — Z_eff undefined).
    """
    a_imgs = [np.asarray(a, np.float64) for a in a_imgs]
    num = np.zeros_like(a_imgs[0])
    den = np.zeros_like(a_imgs[0])
    for a, mat in zip(a_imgs, materials):
        for s, w in xcom.parse_matcomp(mat.matcomp):
            z = xcom.ELEMENT_Z[s]
            e_per_g = xcom.AVOGADRO * w * z / xcom.ATOMIC_WEIGHT[s]
            num = num + np.clip(a, 0.0, None) * e_per_g * z ** m_exp
            den = den + np.clip(a, 0.0, None) * e_per_g
    ok = den > floor * WATER_ELECTRON_DENSITY
    zeff = np.zeros_like(num)
    zeff[ok] = (num[ok] / den[ok]) ** (1.0 / m_exp)
    return zeff


# ---------------------------------------------------------------------------
# Proton stopping-power ratio (radiotherapy planning)
# ---------------------------------------------------------------------------

#: Mean excitation energies I [eV] of the elements (ICRU report 37, the
#: values NIST ESTAR/PSTAR tabulate).  Covers every element in the
#: package's materials (physics/nist_data*.py anchor set).
ELEMENT_I_EV = {
    "H": 19.2, "He": 41.8, "Li": 40.0, "Be": 63.7, "B": 76.0,
    "C": 78.0, "N": 82.0, "O": 95.0, "F": 115.0, "Ne": 137.0,
    "Na": 149.0, "Mg": 156.0, "Al": 166.0, "Si": 173.0, "P": 173.0,
    "S": 180.0, "Cl": 174.0, "Ar": 188.0, "K": 190.0, "Ca": 191.0,
    "Ti": 233.0, "V": 245.0, "Cr": 257.0, "Mn": 272.0, "Fe": 286.0,
    "Co": 297.0, "Ni": 311.0, "Cu": 322.0, "Zn": 330.0, "Mo": 424.0,
    "Sn": 488.0, "I": 491.0, "Ba": 491.0, "Gd": 591.0, "W": 727.0,
    "Pb": 823.0,
}

#: ICRU 37 compound value for liquid water.  Bragg additivity over
#: H/O elemental values gives ~71 eV — the well-known ~5 % additivity
#: defect for water; pass ``i_water_eV=None`` to the SPR functions for
#: a self-consistent (additivity/additivity) ratio instead, which is
#: what makes a water voxel read SPR == 1 exactly.
WATER_I_EV = 75.0

_M_E_C2_MEV = 0.51099895
_M_P_C2_MEV = 938.27209


def _water_rho_e():
    """Electron density of water [e/cm^3] from the package's own
    composition model (vs the rounded literature constant)."""
    return WATER.density * WATER.electrons_per_gram()


def mean_excitation_energy(matcomp):
    """Bragg-additivity mean excitation energy I [eV] of a mixture.

    ln I = sum_i (w_i Z_i/A_i) ln I_i / sum_i (w_i Z_i/A_i) — the
    electron-fraction-weighted log mean (ICRU 37 additivity rule; the
    same rule NIST ESTAR applies to compounds without measured values).
    """
    num = 0.0
    den = 0.0
    for s, w in xcom.parse_matcomp(matcomp):
        f_e = w * xcom.ELEMENT_Z[s] / xcom.ATOMIC_WEIGHT[s]
        num += f_e * np.log(ELEMENT_I_EV[s])
        den += f_e
    return float(np.exp(num / den))


def _bethe_L(i_eV, energy_MeV):
    """Bethe stopping number L = ln(2 m_e c^2 beta^2 gamma^2 / I) - beta^2.

    First-order Bethe only: shell, Barkas, and density-effect
    corrections are omitted — they cancel to <0.5 % in the water RATIO
    for tissues at therapeutic energies (70-250 MeV), which is the only
    way this module uses L.
    """
    gamma = 1.0 + energy_MeV / _M_P_C2_MEV
    beta2 = 1.0 - 1.0 / (gamma * gamma)
    arg = 2.0 * _M_E_C2_MEV * 1e6 * beta2 * gamma * gamma / i_eV
    return np.log(arg) - beta2


def proton_spr(material, *, energy_MeV=100.0, density=None,
               i_water_eV=None):
    """Ground-truth proton stopping-power ratio (to water) of a material.

    SPR = rho_e,rel * L(I_material) / L(I_water) — the Bethe ratio the
    DECT estimate is judged against.  ``density`` overrides the
    material's nominal density; ``i_water_eV=None`` uses the
    Bragg-additivity water I (self-consistent: water -> exactly 1.0),
    or pass :data:`WATER_I_EV` (75 eV) for the ICRU compound value.
    """
    rho = material.density if density is None else float(density)
    # denominator from the same composition model as the numerator, so
    # water is exactly 1.0 (the rounded WATER_ELECTRON_DENSITY literature
    # constant would leave a 1e-4 offset)
    rho_e = rho * material.electrons_per_gram() / _water_rho_e()
    i_mat = mean_excitation_energy(material.matcomp)
    i_w = (mean_excitation_energy(WATER.matcomp)
           if i_water_eV is None else float(i_water_eV))
    return rho_e * _bethe_L(i_mat, energy_MeV) / _bethe_L(i_w, energy_MeV)


def spr_image(a_imgs, materials, *, energy_MeV=100.0, i_water_eV=None,
              floor=0.05):
    """Proton stopping-power-ratio map from DECT basis densities.

    Per voxel: relative electron density is linear in the basis
    densities (:func:`electron_density_map`), and the mean excitation
    energy follows electron-weighted Bragg additivity over the basis
    mixture — ln I = sum_m a_m e_m ln I_m / sum_m a_m e_m with e_m the
    material's electrons/gram, which equals full elemental additivity
    exactly.  SPR = rho_e,rel * L(I)/L(I_w) at ``energy_MeV`` (default
    100 MeV, the conventional reporting energy; the ratio moves <1 %
    across 70-250 MeV for soft tissue).

    Because the basis materials' compositions are known, this is the
    *exact* basis-image route (no Z_eff power-law calibration step, the
    usual clinical approximation); with a (tissue, bone) basis its
    accuracy is limited only by the decomposition itself.  Voxels whose
    electron density falls below ``floor`` of water's return 0 (air).
    """
    a_imgs = [np.asarray(a, np.float64) for a in a_imgs]
    rho_e = np.zeros_like(a_imgs[0])
    num = np.zeros_like(a_imgs[0])
    den = np.zeros_like(a_imgs[0])
    for a, mat in zip(a_imgs, materials):
        e_per_g = mat.electrons_per_gram()
        rho_e = rho_e + a * e_per_g
        ln_i = np.log(mean_excitation_energy(mat.matcomp))
        # additivity weights must be nonnegative; rho_e stays signed
        # (it is linear) so small decomposition noise does not bias it
        w = np.clip(a, 0.0, None) * e_per_g
        num = num + w * ln_i
        den = den + w
    i_w = (mean_excitation_energy(WATER.matcomp)
           if i_water_eV is None else float(i_water_eV))
    l_w = _bethe_L(i_w, energy_MeV)
    w_rho_e = _water_rho_e()
    ok = (rho_e > floor * w_rho_e) & (den > 0.0)
    spr = np.zeros_like(rho_e)
    i_vox = np.exp(num[ok] / den[ok])
    spr[ok] = rho_e[ok] / w_rho_e * _bethe_L(i_vox, energy_MeV) / l_w
    return spr
