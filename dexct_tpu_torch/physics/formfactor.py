"""Atomic form factors for coherent (Rayleigh) scattering.

Port of :mod:`dexct_tpu.physics.formfactor` (host float64 NumPy, copied
as it is).  The first-principles scatter estimator
(:mod:`dexct_tpu_torch.ops.scatter_physics`) needs, for coherent scatter,
the elastic differential cross-section

    dSigma_R/dOmega = (r_e^2 / 2) (1 + cos^2 theta) * F(q, Z)^2

with F the atomic form factor and ``q = sin(theta/2) / lambda`` [1/A]
the momentum-transfer variable (the crystallographic ``s = sin th/lam``
with 2*th the scattering angle).

Data: the standard 4-Gaussian Cromer-Mann parameterization

    F(s) = sum_i a_i exp(-b_i s^2) + c

for every vendored anchor element this framework's materials touch.
The coefficient sets are validated by the exact sum rule **F(0) = Z**
(electron count), which every set below satisfies to <= 0.1 % — a
sharp integrity check, since independently wrong coefficients cannot
sum to the atomic number.  The fits are tabulated for s <= 2 1/A;
beyond, F continues with a power-law taper matched to the fit's
log-slope at s = 2 (coherent scatter there is negligible: F^2 has
fallen by > 4 orders).  Elements without a coefficient set use
Thomas-Fermi Z-scaling of the nearest tabulated neighbor
(F_Z(q) = (Z/Z0) F_Z0(q (Z0/Z)^(1/3)) — the universal-profile
approximation, adequate for trace constituents).

All host-side float64 NumPy; only contracted per-material tables reach
the device (ops/scatter_physics.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import xcom

__all__ = ["atomic_form_factor", "rayleigh_differential",
           "coherent_cross_section", "material_f2_per_volume",
           "CM_COEFFS", "momentum_transfer"]

# Cromer-Mann 4-Gaussian coefficients (a[4], b[4], c); s in 1/Angstrom.
CM_COEFFS = {
    "H": ([0.489918, 0.262003, 0.196767, 0.049879],
          [20.6593, 7.74039, 49.5519, 2.20159], 0.001305),
    "C": ([2.31000, 1.02000, 1.58860, 0.865000],
          [20.8439, 10.2075, 0.568700, 51.6512], 0.215600),
    "N": ([12.2126, 3.13220, 2.01250, 1.16630],
          [0.005700, 9.89330, 28.9975, 0.582600], -11.529),
    "O": ([3.04850, 2.28680, 1.54630, 0.867000],
          [13.2771, 5.70110, 0.323900, 32.9089], 0.250800),
    "Na": ([4.76260, 3.17360, 1.26740, 1.11280],
           [3.28500, 8.84220, 0.313600, 129.424], 0.676000),
    "Mg": ([5.42040, 2.17350, 1.22690, 2.30730],
           [2.82750, 79.2611, 0.380800, 7.19370], 0.858400),
    "Al": ([6.42020, 1.90020, 1.59360, 1.96460],
           [3.03870, 0.742600, 31.5472, 85.0886], 1.11510),
    "Si": ([6.29150, 3.03530, 1.98910, 1.54100],
           [2.43860, 32.3337, 0.678500, 81.6937], 1.14070),
    "P": ([6.43450, 4.17910, 1.78000, 1.49080],
          [1.90670, 27.1570, 0.526000, 68.1645], 1.11490),
    "S": ([6.90530, 5.20340, 1.43790, 1.58630],
          [1.46790, 22.2151, 0.253600, 56.1720], 0.866900),
    "Cl": ([11.4604, 7.19640, 6.25560, 1.64550],
           [0.010400, 1.16620, 18.5194, 47.7784], -9.5574),
    "K": ([8.21860, 7.43980, 1.05190, 0.865900],
          [12.7949, 0.774800, 213.187, 41.6841], 1.42280),
    "Ca": ([8.62660, 7.38730, 1.58990, 1.02110],
           [10.4421, 0.659900, 85.7484, 178.437], 1.37510),
    "Ti": ([9.75950, 7.35580, 1.69910, 1.90210],
           [7.85080, 0.500000, 35.6338, 116.105], 1.28070),
    "V": ([10.2971, 7.35110, 2.07030, 2.05710],
          [6.86570, 0.438500, 26.8938, 102.478], 1.21990),
    "Cr": ([10.6406, 7.35370, 3.32400, 1.49220],
           [6.10380, 0.392000, 20.2626, 98.7399], 1.18320),
    "Mn": ([11.2819, 7.35730, 3.01930, 2.24410],
           [5.34090, 0.343200, 17.8674, 83.7543], 1.08960),
    "Fe": ([11.7695, 7.35730, 3.52220, 2.30450],
           [4.76110, 0.307200, 15.3535, 76.8805], 1.03690),
    "Co": ([12.2841, 7.34090, 4.00340, 2.34880],
           [4.27910, 0.278400, 13.5359, 71.1692], 1.01180),
    "Ni": ([12.8376, 7.29200, 4.44380, 2.38000],
           [3.87850, 0.256500, 12.1763, 66.3421], 1.03410),
    "Cu": ([13.3380, 7.16760, 5.61580, 1.67350],
           [3.58280, 0.247000, 11.3966, 64.8126], 1.19100),
    "Zr": ([17.8765, 10.9480, 5.41732, 3.65721],
           [1.27618, 11.9160, 0.117622, 87.6627], 2.06929),
    "Mo": ([3.70250, 17.2356, 12.8876, 3.74290],
           [0.277200, 1.09580, 11.0040, 61.6584], 4.38750),
    "Sn": ([19.1889, 19.1005, 4.45850, 2.46630],
           [5.83030, 0.503100, 26.8909, 83.9571], 4.78210),
    "I": ([20.1472, 18.9949, 7.51380, 2.27350],
          [4.34700, 0.381400, 27.7660, 66.8776], 4.07120),
    "Ba": ([20.3361, 19.2970, 10.8880, 2.69590],
           [3.21600, 0.275600, 20.2073, 167.202], 2.77310),
    "Ce": ([21.1671, 19.7695, 11.8513, 3.33049],
           [2.81219, 0.226836, 17.6083, 127.113], 1.86264),
    "Gd": ([25.0709, 19.0798, 13.8518, 3.54545],
           [2.25341, 0.181951, 12.9331, 101.398], 2.41960),
    "W": ([29.0818, 15.4300, 14.4327, 5.11982],
          [1.72029, 9.22590, 0.321703, 57.0560], 9.88750),
    "Pb": ([31.0617, 13.0637, 18.4420, 5.96960],
           [0.690200, 2.35760, 8.61800, 47.2579], 13.4118),
}

_S_MAX = 2.0  # Cromer-Mann validity bound [1/A]
HC_KEV_A = 12.398420  # h*c [keV * Angstrom]


def momentum_transfer(energy_keV, cos_theta):
    """q = sin(theta/2)/lambda [1/A] for scattering angle theta."""
    e = np.asarray(energy_keV, np.float64)
    half = np.sqrt(np.clip((1.0 - np.asarray(cos_theta, np.float64)) / 2.0,
                           0.0, 1.0))
    return e * half / HC_KEV_A


def _cm_eval(symbol, s):
    a, b, c = CM_COEFFS[symbol]
    s2 = np.asarray(s, np.float64) ** 2
    out = np.full_like(np.asarray(s, np.float64), float(c))
    for ai, bi in zip(a, b):
        out = out + ai * np.exp(-bi * s2)
    return out


@lru_cache(maxsize=None)
def _taper_params(symbol):
    """(F(s_max), power) for the beyond-fit power-law continuation,
    matched to the fit's log-slope at s_max (keeps F C^0-continuous and
    monotone; F^2 there is < 1e-4 of F(0)^2, so the tail is cosmetic)."""
    f2 = float(_cm_eval(symbol, _S_MAX))
    eps = 1e-4
    f2e = float(_cm_eval(symbol, _S_MAX * (1 + eps)))
    f2 = max(f2, 1e-12)
    slope = (np.log(max(f2e, 1e-15)) - np.log(f2)) / np.log(1 + eps)
    return f2, float(np.clip(-slope, 1.5, 6.0))


def atomic_form_factor(symbol, q):
    """F(q) [electrons] for one element; q = sin(theta/2)/lambda [1/A].

    Cromer-Mann fit for q <= 2; matched power-law taper beyond; nearest-
    neighbor Thomas-Fermi Z-scaling for untabulated elements."""
    q = np.asarray(q, np.float64)
    if symbol not in CM_COEFFS:
        if symbol not in xcom.ELEMENT_Z:
            raise ValueError(f"unknown element symbol: {symbol!r}")
        z = xcom.ELEMENT_Z[symbol]
        near = min(CM_COEFFS, key=lambda s: abs(np.log(
            xcom.ELEMENT_Z[s] / z)))
        z0 = xcom.ELEMENT_Z[near]
        return (z / z0) * atomic_form_factor(near,
                                             q * (z0 / z) ** (1.0 / 3.0))
    fmax, p = _taper_params(symbol)
    core = np.clip(_cm_eval(symbol, np.minimum(q, _S_MAX)), 0.0, None)
    tail = fmax * (_S_MAX / np.maximum(q, _S_MAX)) ** p
    return np.where(q <= _S_MAX, core, tail)


def rayleigh_differential(symbol, energy_keV, cos_theta):
    """dSigma_R/dOmega [cm^2/sr/atom] for one element."""
    q = momentum_transfer(energy_keV, cos_theta)
    f = atomic_form_factor(symbol, q)
    c = np.asarray(cos_theta, np.float64)
    return 0.5 * xcom.ELECTRON_RADIUS_CM ** 2 * (1.0 + c * c) * f * f


def coherent_cross_section(symbol, energy_keV, n_theta=2048):
    """Total Rayleigh cross-section per atom [cm^2] (midpoint quadrature
    over cos theta; the integrand is smooth)."""
    e = np.atleast_1d(np.asarray(energy_keV, np.float64))
    ct = np.cos((np.arange(n_theta) + 0.5) * np.pi / n_theta)
    st_dt = np.sin((np.arange(n_theta) + 0.5) * np.pi / n_theta) \
        * (np.pi / n_theta)
    out = np.empty(e.shape)
    for i, ei in enumerate(e):
        d = rayleigh_differential(symbol, ei, ct)
        out[i] = 2.0 * np.pi * np.sum(d * st_dt)
    return out if np.ndim(energy_keV) else float(out[0])


def material_f2_per_volume(material, density, q):
    """Sum_i n_i F_i(q)^2 [electrons^2 / cm^3] for a material.

    ``material`` carries a ``matcomp`` composition string (weight
    percents); ``n_i = rho w_i N_A / A_i`` is the atom number density.
    This is the per-unit-volume coherent angular weight: the Rayleigh
    signal of a voxel is (r_e^2/2)(1+cos^2) * f2 * dV.
    """
    q = np.asarray(q, np.float64)
    out = np.zeros_like(q)
    for sym, w in xcom.parse_matcomp(material.matcomp):
        n_i = density * w * xcom.AVOGADRO / xcom.ATOMIC_WEIGHT[sym]
        f = atomic_form_factor(sym, q)
        out = out + n_i * f * f
    return out
