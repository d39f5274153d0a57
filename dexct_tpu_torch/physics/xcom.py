"""Elemental x-ray mass-attenuation tables and the mixture rule.

Host NumPy replacement for the reference's vendored ``xcompy`` package
(imported at reference matdecomp.py:7 and plots.py:16; the package
itself lives in the missing ``xtomosim`` submodule).  The public entry point
``mixatten(matcomp, energy_keV)`` reproduces the reference call signature
(reference matdecomp.py:158, plots.py:138-140, plots.py:514): it maps a
composition string like ``'H(11.2)O(88.8)'`` (element symbols with
weight-percents) and an energy grid in keV to the mass attenuation
coefficient mu/rho in cm^2/g of the mixture.

The elemental curves come from two sources (see
:mod:`dexct_tpu_torch.physics.nist_data`):

* **Anchor elements** (30: H, C, N, O, Na, Mg, Al, Si, P, S,
  Cl, K, Ca, Ti, V, Cr, Mn, Fe, Co, Ni, Cu, Zr, Mo, Sn, I, Ba, Ce, Gd, W,
  Pb): vendored NIST-grid mass-attenuation tables with exact
  absorption-edge rows — accurate to ~1-2 % over 5 keV - 10 MeV (<=1 %
  for Ca/P/I and the ICRU tissue/bone compound closures; see
  :mod:`nist_data_ext`; ~1-1.5 % for the contrast/filter set
  Zr/Sn/Ba/Ce/Gd, see :mod:`nist_data_r4`).  This covers every element
  appearing in the reference study's materials plus the contrast agents
  (I, Gd, Ba, Ce), beam-filter metals (Sn, Mo, Cu, Al) and implant
  ceramics (Zr) the framework's own features advertise.
* **Every other element**: edge-aligned log-Z interpolation between the two
  bracketing anchors.  The Compton part is exact Klein-Nishina times Z/A;
  the non-Compton residual (photoelectric + coherent + pair + binding
  corrections) is interpolated geometrically in ln Z — below ~200 keV in
  *reduced energy* u = E/E_K (so every anchor's K edge maps onto the
  target's exact tabulated K-edge energy), above ~400 keV at fixed E (pair
  production has no edge structure), with a smooth log-E crossfade between.
  Accuracy ~1-3 % at diagnostic energies with this anchor set (the
  widest remaining gaps are Cu-Zr, Ce-Gd, Gd-W and W-Pb — none containing
  an element any shipped feature quantifies).

The framework remains internally self-consistent (simulation and
decomposition share these tables), and exact per-element tables can still be
dropped in via :func:`register_element_table`.

All computation here is host-side float64 NumPy: attenuation lookup tables
are built once at setup time and only the resulting per-material LUT arrays
are moved to the device as tensors.
"""

from __future__ import annotations

import re
from functools import lru_cache

import numpy as np

__all__ = [
    "mixatten",
    "parse_matcomp",
    "element_mu",
    "element_symbols",
    "ELEMENT_Z",
    "ATOMIC_WEIGHT",
    "ENERGY_GRID_KEV",
    "register_element_table",
]

# ---------------------------------------------------------------------------
# Element identity data (exact, public constants)
# ---------------------------------------------------------------------------

_SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca "
    "Sc Ti V Cr Mn Fe Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr "
    "Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te I Xe Cs Ba La Ce Pr Nd "
    "Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir Pt Au Hg "
    "Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U"
).split()

ELEMENT_Z = {s: i + 1 for i, s in enumerate(_SYMBOLS)}

ATOMIC_WEIGHT = dict(
    zip(
        _SYMBOLS,
        [
            1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999,
            18.998, 20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06,
            35.45, 39.948, 39.098, 40.078, 44.956, 47.867, 50.942, 51.996,
            54.938, 55.845, 58.933, 58.693, 63.546, 65.38, 69.723, 72.630,
            74.922, 78.971, 79.904, 83.798, 85.468, 87.62, 88.906, 91.224,
            92.906, 95.95, 98.0, 101.07, 102.91, 106.42, 107.87, 112.41,
            114.82, 118.71, 121.76, 127.60, 126.90, 131.29, 132.91, 137.33,
            138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96, 157.25,
            158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
            180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59,
            204.38, 207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0,
            232.04, 231.04, 238.03,
        ],
    )
)

AVOGADRO = 6.02214076e23  # 1/mol
ELECTRON_RADIUS_CM = 2.8179403262e-13  # classical electron radius [cm]
ELECTRON_REST_KEV = 510.99895  # m_e c^2 [keV]
PAIR_THRESHOLD_KEV = 2.0 * ELECTRON_REST_KEV


def element_symbols():
    """Ordered element symbols Z=1..92."""
    return list(_SYMBOLS)


# ---------------------------------------------------------------------------
# Vendored NIST anchor data (tables + exact edge energies)
# ---------------------------------------------------------------------------

from .nist_data import (  # noqa: E402
    ANCHOR_TABLES,
    K_EDGE_KEV,
)

# Sub-keV K edges for the light anchor elements, used only for the
# reduced-energy warp of interpolated neighbors (X-Ray Data Booklet).
_LIGHT_K_EDGE_KEV = {
    "H": 0.0136, "He": 0.0246, "Li": 0.0547, "Be": 0.1117, "B": 0.1880,
    "C": 0.2838, "N": 0.4016, "O": 0.5320, "F": 0.6854, "Ne": 0.8669,
}


def k_edge_keV(Z):
    """K absorption edge energy [keV] from the vendored exact edge table
    (:mod:`nist_data`); sub-keV light-element edges from the booklet values.
    Accepts a scalar or array of atomic numbers."""
    by_z = {}
    for sym, e in {**_LIGHT_K_EDGE_KEV, **K_EDGE_KEV}.items():
        by_z[ELEMENT_Z[sym]] = e
    zs = np.asarray(Z)
    out = np.asarray(
        [by_z[int(z)] for z in np.atleast_1d(zs)], dtype=np.float64
    )
    return float(out[0]) if zs.ndim == 0 else out.reshape(zs.shape)


def klein_nishina_cross_section(energy_keV):
    """Exact Klein-Nishina total cross-section per electron [cm^2]."""
    k = np.asarray(energy_keV, dtype=np.float64) / ELECTRON_REST_KEV
    one_p_2k = 1.0 + 2.0 * k
    log_term = np.log1p(2.0 * k)
    t1 = (1.0 + k) / k**2 * (2.0 * (1.0 + k) / one_p_2k - log_term / k)
    t2 = log_term / (2.0 * k)
    t3 = (1.0 + 3.0 * k) / one_p_2k**2
    return 2.0 * np.pi * ELECTRON_RADIUS_CM**2 * (t1 + t2 - t3)


def klein_nishina_transfer_fraction(energy_keV, n_theta=4096):
    """Mean fraction of photon energy transferred to the recoil electron
    per Klein-Nishina interaction: f_tr(E) = sigma_tr / sigma_KN.

    Exact quadrature of (1 - E'/E) dSigma/dOmega over the sphere (the
    closed form exists but is error-prone; the integrand is smooth so
    midpoint quadrature at 4096 angles is exact to ~1e-10).  This is
    the Compton piece of the mass energy-TRANSFER coefficient: at CT
    energies in low-Z media, mu_tr = mu_photo (full local transfer,
    fluorescence yield ~0) + mu_C * f_tr (recoil electrons), with
    coherent scatter transferring nothing.  f_tr rises from ~0 at low
    E (Thomson limit: elastic) through 0.34 at m_e c^2 to 0.53 at
    2 MeV.
    """
    e = np.atleast_1d(np.asarray(energy_keV, np.float64))
    k = e[:, None] / ELECTRON_REST_KEV  # [E, 1]
    ct = np.cos((np.arange(n_theta) + 0.5) * np.pi / n_theta)[None, :]
    st_dt = np.sin((np.arange(n_theta) + 0.5) * np.pi / n_theta)[None, :] \
        * (np.pi / n_theta)
    ratio = 1.0 / (1.0 + k * (1.0 - ct))  # E'/E
    dsdo = 0.5 * ELECTRON_RADIUS_CM**2 * ratio**2 * (
        ratio + 1.0 / ratio - (1.0 - ct * ct))
    w = 2.0 * np.pi * dsdo * st_dt
    sigma = np.sum(w, -1)
    sigma_tr = np.sum(w * (1.0 - ratio), -1)
    out = sigma_tr / sigma
    return out if np.ndim(energy_keV) else float(out[0])


# ---------------------------------------------------------------------------
# Element construction: anchors + edge-aligned bracket interpolation
# ---------------------------------------------------------------------------

# Dense internal energy grid [keV] (kept for the public surface; element
# evaluation itself interpolates each element's own exact anchor grid so
# absorption edges stay sharp).
ENERGY_GRID_KEV = np.logspace(0.0, 4.0, 512)

# Ordered element anchors in Z order (water is a validation curve, not an
# element).  Round 3 widened this from 11 to 25 vendored elements
# (nist_data_ext), so bracket interpolation now only serves elements the
# reference study never touches — and with much tighter brackets (e.g. Nb
# from Mo-Cu, Ba/Gd from I-W instead of Cu-W).
_ANCHOR_SYMBOLS = (
    "H", "C", "N", "O", "Na", "Mg", "Al", "Si", "P", "S", "Cl", "K", "Ca",
    "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zr", "Mo", "Sn", "I",
    "Ba", "Ce", "Gd", "W", "Pb",
)

# Reduced-energy warp applies below ~200 keV (all edges sit below 116 keV),
# fixed-energy interpolation above ~400 keV; log-E crossfade between.
_WARP_FULL_KEV = 200.0
_WARP_ZERO_KEV = 400.0


def _loglog_interp(e, e_ref, mu_ref):
    """Log-log linear interpolation, clamped at the grid ends."""
    le = np.log(np.clip(e, e_ref[0], e_ref[-1]))
    return np.exp(np.interp(le, np.log(e_ref), np.log(mu_ref)))


@lru_cache(maxsize=None)
def _anchor_grid(symbol):
    """(E, mu) anchor arrays with edge-doubled rows made strictly increasing."""
    e, mu = ANCHOR_TABLES[symbol]
    e = e.copy()
    for i in range(1, len(e)):
        if e[i] <= e[i - 1]:
            e[i] = e[i - 1] * (1.0 + 1e-9)
    return e, mu


def _anchor_mu(symbol, energy_keV):
    e_ref, mu_ref = _anchor_grid(symbol)
    return _loglog_interp(np.asarray(energy_keV, np.float64), e_ref, mu_ref)


def _edge_for_warp(symbol):
    """K-edge energy used for reduced-energy alignment (None = no warp)."""
    e_k = K_EDGE_KEV.get(symbol) or _LIGHT_K_EDGE_KEV.get(symbol)
    # H/He have no bound-shell edge structure worth aligning; everything
    # from Li up warps so that photoabsorption curves compare at matched
    # distance from their (possibly sub-grid) K edges.
    return e_k if (e_k is not None and e_k >= 0.05) else None


def _anchor_tau(symbol, energy_keV):
    """Per-atom non-Klein-Nishina residual cross-section [cm^2].

    tau = mu * A / N_A - Z * sigma_KN: photoelectric + coherent + pair +
    incoherent binding corrections, the part that is interpolated in Z.
    """
    e = np.asarray(energy_keV, np.float64)
    z = ELEMENT_Z[symbol]
    a = ATOMIC_WEIGHT[symbol]
    kn = z * klein_nishina_cross_section(e)
    tau = _anchor_mu(symbol, e) * a / AVOGADRO - kn
    # Binding corrections can drive the residual slightly negative for the
    # lightest elements near 1 MeV; floor it for the geometric interp.
    return np.clip(tau, 1e-4 * kn, None)


def _bracketing_anchors(Z):
    """(symbol_lo, symbol_hi, w) with w the ln-Z interpolation weight.

    Z beyond the anchor range extrapolates from the outermost pair
    (w < 0 below H — unused — or w > 1 above Pb, clamped at 2.2 which
    covers U)."""
    anchor_z = [ELEMENT_Z[s] for s in _ANCHOR_SYMBOLS]
    if Z >= anchor_z[-1]:
        lo, hi = _ANCHOR_SYMBOLS[-2], _ANCHOR_SYMBOLS[-1]
    else:
        idx = next(i for i, az in enumerate(anchor_z) if az > Z)
        lo, hi = _ANCHOR_SYMBOLS[max(idx - 1, 0)], _ANCHOR_SYMBOLS[idx]
    z1, z2 = ELEMENT_Z[lo], ELEMENT_Z[hi]
    w = (np.log(Z) - np.log(z1)) / (np.log(z2) - np.log(z1))
    return lo, hi, float(np.clip(w, -0.5, 2.2))


def _interp_element_mu(symbol, energy_keV):
    """mu/rho for a non-anchor element by edge-aligned bracket interpolation."""
    e = np.atleast_1d(np.asarray(energy_keV, np.float64))
    z = ELEMENT_Z[symbol]
    a = ATOMIC_WEIGHT[symbol]
    lo, hi, w = _bracketing_anchors(z)

    def tau_at(warp):
        """Geometric ln-Z mix of anchor residuals, optionally edge-warped."""
        e_k_x = _edge_for_warp(symbol) if warp else None
        parts = []
        for sym in (lo, hi):
            e_k_a = _edge_for_warp(sym) if warp else None
            if e_k_x is not None and e_k_a is not None:
                e_eval = e * (e_k_a / e_k_x)
            else:
                e_eval = e
            parts.append(np.log(_anchor_tau(sym, e_eval)))
        return np.exp((1.0 - w) * parts[0] + w * parts[1])

    tau_w = tau_at(True)
    tau_f = tau_at(False)
    s = np.clip(
        (np.log(_WARP_ZERO_KEV) - np.log(e))
        / (np.log(_WARP_ZERO_KEV) - np.log(_WARP_FULL_KEV)),
        0.0, 1.0,
    )
    tau = np.exp(s * np.log(tau_w) + (1.0 - s) * np.log(tau_f))
    mu = AVOGADRO / a * (z * klein_nishina_cross_section(e) + tau)
    return mu if np.ndim(energy_keV) else float(mu[0])


# User-registered exact tables (e.g. real NIST data), keyed by symbol.
_REGISTERED: dict = {}


def register_element_table(symbol, energy_keV, mu_over_rho):
    """Override the model for one element with an exact (E, mu/rho) table."""
    if symbol not in ELEMENT_Z:
        raise ValueError(f"unknown element symbol: {symbol!r}")
    e = np.asarray(energy_keV, dtype=np.float64)
    m = np.asarray(mu_over_rho, dtype=np.float64)
    if e.ndim != 1 or e.shape != m.shape or len(e) < 2:
        raise ValueError("expected matching 1-D energy/mu arrays")
    _REGISTERED[symbol] = (e, m)
    _element_table_cached.cache_clear()


@lru_cache(maxsize=None)
def _element_table_cached(symbol):
    """mu/rho [cm^2/g] for one element on ENERGY_GRID_KEV (float64).

    Kept for the public surface; prefer :func:`element_mu`, which evaluates
    the element's own exact grid so absorption edges stay sharp."""
    return np.asarray(element_mu(symbol, ENERGY_GRID_KEV), np.float64)


@lru_cache(maxsize=None)
def _full_table_grid(symbol):
    """(E, mu) frozen full-table arrays, edge rows strictly increasing."""
    from .nist_data_full import FULL_TABLES

    e, mu = FULL_TABLES[symbol]
    e = e.copy()
    for i in range(1, len(e)):
        if e[i] <= e[i - 1]:
            e[i] = e[i - 1] * (1.0 + 1e-9)
    return e, mu


def element_mu(symbol, energy_keV):
    """Mass attenuation mu/rho [cm^2/g] of one element at ``energy_keV``.

    Resolution order: user-registered table (:func:`register_element_table`)
    -> vendored NIST anchor table -> frozen full-periodic-table set
    (:mod:`dexct_tpu_torch.physics.nist_data_full` — the validated bracket
    construction sampled onto an exact-edge grid, with per-element
    held-out-anchor uncertainty) -> live edge-aligned interpolation
    (fallback only; reachable when the frozen set is unavailable)."""
    e = np.asarray(energy_keV, dtype=np.float64)
    if symbol in _REGISTERED:
        e_ref, mu_ref = _REGISTERED[symbol]
        return _loglog_interp(e, e_ref, mu_ref)
    if symbol in ANCHOR_TABLES:
        return _anchor_mu(symbol, e)
    if symbol not in ELEMENT_Z:
        raise ValueError(f"unknown element symbol: {symbol!r}")
    try:
        e_ref, mu_ref = _full_table_grid(symbol)
    except (ImportError, KeyError):
        return _interp_element_mu(symbol, e)
    return _loglog_interp(e, e_ref, mu_ref)


# ---------------------------------------------------------------------------
# Composition strings and the mixture rule
# ---------------------------------------------------------------------------

_MATCOMP_RE = re.compile(r"([A-Z][a-z]?)\(([-+0-9.eE]+)\)")


def parse_matcomp(matcomp):
    """Parse ``'H(10.2)C(14.3)...'`` into ``[(symbol, weight_fraction)]``.

    Weight values are percents that are renormalized to sum to 1, matching
    the reference's composition-string convention
    (reference matdecomp.py:13-16, plots.py:487-498).
    """
    pairs = _MATCOMP_RE.findall(matcomp)
    if not pairs:
        raise ValueError(f"unparseable material composition: {matcomp!r}")
    leftover = _MATCOMP_RE.sub("", matcomp).strip()
    if leftover:
        raise ValueError(
            f"unparseable fragment {leftover!r} in composition {matcomp!r}"
        )
    symbols, weights = zip(*pairs)
    for s in symbols:
        if s not in ELEMENT_Z:
            raise ValueError(f"unknown element {s!r} in {matcomp!r}")
    w = np.asarray(weights, dtype=np.float64)
    if np.any(w < 0.0) or w.sum() <= 0.0:
        raise ValueError(f"invalid weights in composition {matcomp!r}")
    w = w / w.sum()
    return list(zip(symbols, w))


def mixatten(matcomp, energy_keV):
    """Mass attenuation mu/rho [cm^2/g] of a mixture.

    Drop-in equivalent of the reference's ``xcompy.mixatten``
    (reference matdecomp.py:158: mass attenuation, multiplied by
    density at call sites to obtain linear attenuation, plots.py:514).

    Parameters
    ----------
    matcomp : str
        Composition string, e.g. ``'H(11.2)O(88.8)'``.
    energy_keV : array_like
        Photon energies [keV]; values are clamped to [1, 10000] keV.

    Returns
    -------
    ndarray (float64) of mu/rho [cm^2/g], same shape as ``energy_keV``.
    """
    e = np.asarray(energy_keV, dtype=np.float64)
    out = np.zeros_like(e)
    for symbol, w in parse_matcomp(matcomp):
        out = out + w * element_mu(symbol, e)
    return out
