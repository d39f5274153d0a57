"""One-call spectral photon-counting CT pipeline.

Port of the single-device part of :mod:`dexct_tpu.pipeline.spectralct`.
The reference is a two-scan dual-energy simulator (main.py:106-170); its
spectral generalization (ONE scan, one spectrum, M counting bins, K <= 4
basis materials) is assembled from the port's pieces: threshold bin
fluences (:func:`~dexct_tpu_torch.ops.matdecomp.pcd_bin_fluences`), the
exact projectors (K1, K10), the M bins' counts from one exp per (ray,
energy) (K34), optional pulse pileup
(:mod:`dexct_tpu_torch.physics.pileup`) and Poisson counting noise, the
multi-measurement Newton decomposition (K35) and one FBP per basis
material (K4 fan, K5 + K6 parallel, K11 FDK, K12 helical gFDK).

Physics ordering: pileup distorts the arriving photon stream, so it is
applied to the EXPECTED per-bin counts; Poisson noise then samples the
recorded events.  The correction chain mirrors acquisition in reverse:
pileup inversion on counts, then decomposition.

Entry points run on ``device`` (default: the card); noise draws come from
``generator``, a ``torch.Generator`` on that device (the JAX package's
``key``), or, in the packed pipelines, from the pack's ``seed``.

Typical use::

    res = simulate_pcd_spectral(
        ct, phantom, spec, thresholds=[20, 34, 50, 70],
        basis=(WATER, BONE), n_matrix=256, fov=20.0,
        pileup_tau=2e-5, noise="poisson", generator=gen)
    res.basis_recons   # [K, N, N] densities [g/cm^3]
    res.vmi(70.0)      # virtual monoenergetic image [1/cm]
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fbp as fbp_ops
from ..ops import matdecomp as md_ops
from ..ops import spectral as sp_ops
from ..ops.siddon import material_path_sinogram
from ..physics import xcom
from ..utils.devices import upload
from ..physics.pileup import (apply_pileup_bins, bin_mean_energies,
                              bin_sum_redistribution, correct_pileup_bins)
from ..utils.devices import check_float32, device_of

__all__ = ["SpectralResult", "simulate_pcd_spectral",
           "simulate_pcd_spectral_cone", "PcdMeta", "pack_pcd_spectral",
           "pcd_step", "make_jitted_pcd_step", "pack_pcd_spectral_cone",
           "pcd_cone_step", "make_jitted_pcd_cone_step"]

# the dual-energy keys of the DE packs that a PCD step must not read
_DE_KEYS = ("mu_t2", "i0_2", "i2_1", "i2_2", "dec_i0", "dec_mus")


@dataclasses.dataclass
class SpectralResult:
    """Outputs of one spectral PCD acquisition + reconstruction."""

    counts: torch.Tensor            # [M, V, C] recorded bin counts
    counts_corrected: torch.Tensor  # [M, V, C] after pileup inversion
    basis_sinos: torch.Tensor       # [K, V, C] basis line integrals [g/cm^2]
    basis_recons: torch.Tensor      # [K, N, N] basis densities [g/cm^3]
    air_mask: torch.Tensor          # [V, C]
    thresholds: np.ndarray          # [M] lower bin edges [keV]
    bin_energies: np.ndarray        # [M] mean detected energy per bin
    basis: tuple                    # K Materials

    def vmi(self, energy_keV):
        """Virtual monoenergetic image [1/cm] at ``energy_keV``:
        sum_k (mu/rho)_k(E0) * rho_k(x), for any K."""
        img = torch.zeros_like(self.basis_recons[0])
        for k, mat in enumerate(self.basis):
            u = float(xcom.mixatten(mat.matcomp,
                                    np.array([float(energy_keV)]))[0])
            img = img + u * self.basis_recons[k]
        return img


def _check(geometry, thresholds, basis):
    if geometry.eid:
        raise ValueError("spectral PCD pipeline requires eid=False "
                         "(photon-counting response)")
    if len(thresholds) < len(basis):
        raise ValueError(f"{len(basis)} basis materials need >= that "
                         f"many bins (got {len(thresholds)})")


def _bin_fluences(geometry, spec, thresholds, response):
    """The bins' effective fluences i0 [M, E] (host float64), with a
    detector spectral-response matrix folded in when given."""
    if response is not None:
        from ..physics.pcd_response import pcd_bin_fluences_realistic

        return pcd_bin_fluences_realistic(geometry, spec, thresholds,
                                          response=response)
    return md_ops.pcd_bin_fluences(geometry, spec, thresholds)


def _acquire(counts, route, pileup_tau, pileup_model, correct_pileup,
             noise, generator):
    """Pileup on the expected counts [M, ...], Poisson (or other) noise,
    then the pileup inversion: (recorded, corrected)."""
    if pileup_tau > 0.0:
        route = upload(route, counts)  # once for both pileup stages
        counts = apply_pileup_bins(counts, pileup_tau, route, pileup_model)
    if noise != "none":
        if generator is None:
            raise ValueError("noise sampling requires a torch.Generator")
        counts = sp_ops.sample_noise(generator, counts, noise)
    corrected = counts
    if pileup_tau > 0.0 and correct_pileup:
        corrected = correct_pileup_bins(counts, pileup_tau, route,
                                        pileup_model)
    return counts, corrected


def _bin_counts(paths, phantom, spec, i0s):
    """The bins' expected counts with the bin axis first: [M, ...] (K34)."""
    dev = paths.device
    mu_table = torch.as_tensor(phantom.materials.mu_table(spec.E),
                               dtype=torch.float32, device=dev)
    i0_T = torch.as_tensor(np.asarray(i0s).T, dtype=torch.float32,
                           device=dev)
    counts = sp_ops.counts_from_paths(paths.to(torch.float32), mu_table,
                                      i0_T)
    return torch.movedim(counts, -1, 0).contiguous()


def simulate_pcd_spectral(geometry, phantom, spec, thresholds, basis,
                          n_matrix, fov, ramp=0.8, *, window="sinc",
                          n_iters=30, mask_thresh=0.95, noise="none",
                          generator=None, pileup_tau=0.0,
                          pileup_model="paralyzable", correct_pileup=True,
                          response=None, paths=None, dtype=None,
                          a_bounds=(-20.0, 500.0), device=None):
    """Simulate and reconstruct one multi-bin PCD spectral scan, on the
    device of ``paths`` when given, else on ``device`` (default: the
    card), in float32 (``dtype`` must be float32 or None).

    geometry must be photon-counting (``eid=False``): bin fluences weight
    by eta(E) only.  ``thresholds`` are ascending lower bin edges [keV]
    (last bin open-ended); ``pileup_tau`` is the dimensionless
    resolving-time fraction tau/T_view (0 disables); ``noise`` as in
    :func:`~dexct_tpu_torch.ops.spectral.sample_noise`, drawn from
    ``generator``.  ``response`` folds a detector spectral-response
    matrix (:func:`~dexct_tpu_torch.physics.pcd_response.
    pcd_response_matrix`) into the bin fluences, for simulation and
    decomposition alike.  ``paths`` reuses a traced material-path
    sinogram.
    """
    _check(geometry, thresholds, basis)
    check_float32(dtype)
    dev = device_of(paths, device)
    i0s = _bin_fluences(geometry, spec, thresholds, response)  # [M, E]
    if paths is None:
        paths = material_path_sinogram(phantom, geometry, device=dev)
    counts = _bin_counts(paths, phantom, spec, i0s)  # [M, V, C]
    mean_e = bin_mean_energies(i0s, spec.E)
    route = (bin_sum_redistribution(thresholds, mean_e)
             if pileup_tau > 0.0 else None)
    counts, corrected = _acquire(counts, route, pileup_tau, pileup_model,
                                 correct_pileup, noise, generator)
    mats, mask = md_ops.decompose_multibin_grid(
        corrected, spec.E, i0s, basis, n_iters=n_iters,
        mask_thresh=mask_thresh, a_bounds=a_bounds)
    recons = torch.stack([
        fbp_ops.fbp_recon(mats[k], geometry, int(n_matrix), float(fov),
                          float(ramp), window)[0]
        for k in range(len(basis))
    ])
    return SpectralResult(counts, corrected, mats, recons, mask,
                          np.asarray(thresholds, np.float64), mean_e,
                          tuple(basis))


def simulate_pcd_spectral_cone(geometry, phantom, spec, thresholds, basis,
                               n_matrix, fov, ramp=0.8, *, nz_out=None,
                               dz_out=None, window="sinc", n_iters=30,
                               mask_thresh=0.95, noise="none",
                               generator=None, pileup_tau=0.0,
                               pileup_model="paralyzable",
                               correct_pileup=True, response=None,
                               paths=None, dtype=None,
                               a_bounds=(-20.0, 500.0), view_block=8,
                               device=None):
    """3-D spectral photon-counting cone-beam scan -> basis VOLUMES.

    The cone-beam composition of :func:`simulate_pcd_spectral`: exact 3-D
    tracing (K10), the bins' counts (K34), optional pileup, response and
    noise exactly as in 2-D (the bin axis leads, so every spectral op
    applies unchanged to [M, V, R, C]), the multi-bin decomposition on the
    flattened ray grid (K35) and one FDK per basis material (circular
    orbits, K11, as the JAX function's ``fdk_reconstruct``).
    ``view_block`` (a TPU layout) is accepted and ignored.

    Returns a :class:`SpectralResult` whose ``basis_sinos`` are
    [K, V, R, C] and ``basis_recons`` volumes [K, nz, N, N].
    """
    from ..ops.conebeam import cone_material_paths, fdk_reconstruct

    del view_block
    _check(geometry, thresholds, basis)
    check_float32(dtype)
    dev = device_of(paths, device)
    i0s = _bin_fluences(geometry, spec, thresholds, response)
    if paths is None:
        paths = cone_material_paths(phantom, geometry, device=dev)
    counts = _bin_counts(paths, phantom, spec, i0s)  # [M, V, R, C]
    mean_e = bin_mean_energies(i0s, spec.E)
    route = (bin_sum_redistribution(thresholds, mean_e)
             if pileup_tau > 0.0 else None)
    counts, corrected = _acquire(counts, route, pileup_tau, pileup_model,
                                 correct_pileup, noise, generator)
    m, v, r, c = corrected.shape
    mats_flat, mask = md_ops.decompose_multibin_grid(
        corrected.reshape(m, v, r * c), spec.E, i0s, basis,
        n_iters=n_iters, mask_thresh=mask_thresh, a_bounds=a_bounds)
    mats = mats_flat.reshape(len(basis), v, r, c)
    recons = fdk_reconstruct(mats, geometry, int(n_matrix), float(fov),
                             float(ramp), nz_out=nz_out, dz_out=dz_out,
                             window=window)
    return SpectralResult(counts, corrected, mats, recons,
                          mask.reshape(v, r, c),
                          np.asarray(thresholds, np.float64), mean_e,
                          tuple(basis))


class PcdMeta(NamedTuple):
    """Static parameters of a packed PCD step (wraps the DE pack's meta,
    whose ``seed`` seeds the noise)."""

    base: tuple  # DectMeta or ConeDectMeta (projector/recon/mask statics)
    n_bins: int
    n_basis: int
    n_iters: int
    pileup_tau: float
    pileup_model: str
    correct_pileup: bool
    a_lo: float
    a_hi: float
    noise: str


def _pcd_arrays(arrays, ct, spec, thresholds, basis, response, pileup_tau,
                noise, device):
    """Swap a DE pack's two-spectra tables for the bins' tables: the
    [E, M] bin fluence ``i0_bins_T``, the decomposition's ``dec_i0`` [M, E]
    and ``dec_mus`` [K, E], and the pileup routing when pileup is on.
    Returns the bins' fluences i0s [M, E] (host float64)."""
    if noise == "compound":
        raise ValueError("compound noise is the EID second-moment "
                         "model; PCD bins are Poisson")
    for k in _DE_KEYS:
        arrays.pop(k, None)
    i0s = _bin_fluences(ct, spec, thresholds, response)  # [M, E] float64
    mus = np.stack([xcom.mixatten(b.matcomp, np.asarray(spec.E))
                    for b in basis])

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    arrays["i0_bins_T"] = f32(np.asarray(i0s).T)
    arrays["dec_i0"] = f32(i0s)
    arrays["dec_mus"] = f32(mus)
    if pileup_tau > 0.0:
        arrays["pileup_route"] = f32(bin_sum_redistribution(
            thresholds, bin_mean_energies(i0s, spec.E)))
    return i0s


def _pcd_meta(base, i0s, basis, n_iters, pileup_tau, pileup_model,
              correct_pileup, a_bounds, noise):
    return PcdMeta(
        base=base, n_bins=len(np.asarray(i0s)), n_basis=len(basis),
        n_iters=int(n_iters), pileup_tau=float(pileup_tau),
        pileup_model=str(pileup_model),
        correct_pileup=bool(correct_pileup),
        a_lo=float(a_bounds[0]), a_hi=float(a_bounds[1]),
        noise=str(noise))


def pack_pcd_spectral(ct, phantom, spec, thresholds, basis, n_matrix,
                      fov, ramp=0.8, *, n_iters=10,
                      projector="siddon_dominant", recon="parallel",
                      noise="none", seed=0, pileup_tau=0.0,
                      pileup_model="paralyzable", correct_pileup=True,
                      response=None, mask_thresh=0.95,
                      a_bounds=(-20.0, 500.0), device=None, **pack_kw):
    """Lower a multi-bin PCD scan to ``(arrays, meta)`` for
    :func:`pcd_step`, every array on ``device`` (default: the card).

    Reuses :func:`~dexct_tpu_torch.pipeline.fused.pack_dect`'s projector
    and reconstruction planning, swapping the two DE spectra for M
    threshold-bin fluences and the two-spectra decomposition tables for
    the bins' ones.  ``response``/``pileup_tau`` as in
    :func:`simulate_pcd_spectral`; ``seed`` seeds the step's noise.
    """
    from .fused import pack_dect

    _check(ct, thresholds, basis)
    dev = torch.device("cuda" if device is None else device)
    arrays, dmeta = pack_dect(
        ct, phantom, spec, spec, n_matrix, fov, ramp, device=dev,
        n_iters=n_iters, projector=projector, recon=recon, noise="none",
        seed=seed, mask_thresh=mask_thresh, **pack_kw)
    i0s = _pcd_arrays(arrays, ct, spec, thresholds, basis, response,
                      pileup_tau, noise, dev)
    return arrays, _pcd_meta(dmeta, i0s, basis, n_iters, pileup_tau,
                             pileup_model, correct_pileup, a_bounds, noise)


def _pcd_decompose(counts, corrected, a, meta, pixel_block=65536):
    """The bins' decomposition (K35) and the air mask on the RECORDED
    first bin: (basis sinograms [K, ...], mask [...])."""
    M = meta.n_bins
    ab = md_ops.gauss_newton_solve(
        corrected.reshape(M, -1), a["dec_i0"], a["dec_mus"],
        n_iters=meta.n_iters, pixel_block=pixel_block,
        a_bounds=(meta.a_lo, meta.a_hi),
        warm_nodes=meta.base.gn_warm_nodes)
    mask = counts[0] >= meta.base.mask_thresh * counts[0].max()
    zero = torch.zeros((), dtype=ab.dtype, device=ab.device)
    mats = torch.where(mask[None], zero,
                       ab.T.reshape((meta.n_basis,) + counts.shape[1:]))
    return mats.contiguous(), mask


def _pcd_tail(counts, a, meta):
    """Pileup, noise (seeded by the pack's seed) and inversion of the
    expected bin counts [M, ...]: (recorded, corrected)."""
    gen = None
    if meta.noise != "none":
        gen = torch.Generator(device=counts.device).manual_seed(
            meta.base.seed)
    return _acquire(counts, a.get("pileup_route"), meta.pileup_tau,
                    meta.pileup_model, meta.correct_pileup, meta.noise, gen)


def pcd_step(arrays, meta: PcdMeta):
    """One packed PCD step: trace -> M-bin counts -> (pileup, noise,
    inversion) -> multi-bin decomposition -> K basis FBPs.

    Returns the :class:`SpectralResult` field dict (arrays only: the
    thresholds, bin energies and basis live on the pack side)."""
    from .fused import _project_paths, reconstruct_stack

    a = arrays
    bm = meta.base
    paths = a["paths"] if "paths" in a else _project_paths(a, bm)
    cb = sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_bins_T"])
    counts, corrected = _pcd_tail(torch.movedim(cb, -1, 0).contiguous(), a,
                                  meta)
    mats, mask = _pcd_decompose(counts, corrected, a, meta, bm.pixel_block)
    return {
        "counts": counts,
        "counts_corrected": corrected,
        "basis_sinos": mats,
        "basis_recons": reconstruct_stack(mats, a, bm),
        "air_mask": mask,
    }


def make_jitted_pcd_step(meta: PcdMeta):
    """:func:`pcd_step` closed over the meta (the JAX package's name;
    PyTorch runs eagerly, so this is a plain callable of the arrays)."""

    def step(arrays):
        return pcd_step(arrays, meta)

    return step


def pack_pcd_spectral_cone(ct, phantom, spec, thresholds, basis,
                           n_matrix, fov, ramp=0.8, *, n_iters=10,
                           noise="none", seed=0, pileup_tau=0.0,
                           pileup_model="paralyzable",
                           correct_pileup=True, response=None,
                           mask_thresh=0.95, a_bounds=(-20.0, 500.0),
                           device=None, **pack_kw):
    """Packed cone-beam PCD: lower to ``(arrays, meta)`` for
    :func:`pcd_cone_step`, on ``device`` (default: the card).

    The 3-D analog of :func:`pack_pcd_spectral`, on
    :func:`~dexct_tpu_torch.pipeline.cone.pack_cone_dect`'s trace and
    multi-volume FDK/gFDK stage (circular and helical orbits).  Returns K
    basis VOLUMES.
    """
    from .cone import pack_cone_dect

    _check(ct, thresholds, basis)
    dev = torch.device("cuda" if device is None else device)
    arrays, cmeta = pack_cone_dect(
        ct, phantom, spec, spec, n_matrix, fov, ramp, device=dev,
        n_iters=n_iters, noise="none", seed=seed, mask_thresh=mask_thresh,
        **pack_kw)
    i0s = _pcd_arrays(arrays, ct, spec, thresholds, basis, response,
                      pileup_tau, noise, dev)
    return arrays, _pcd_meta(cmeta, i0s, basis, n_iters, pileup_tau,
                             pileup_model, correct_pileup, a_bounds, noise)


def pcd_cone_step(arrays, meta: PcdMeta):
    """One packed cone PCD step: trace (K10) -> M-bin counts (K34) ->
    (pileup, noise, inversion) -> multi-bin decomposition (K35) -> K basis
    volumes (K11, or K12 on a helix)."""
    from .cone import cone_paths, cone_reconstruct_stack

    a = arrays
    cm = meta.base
    cols = sp_ops.counts_from_paths(cone_paths(a, cm), a["mu_t1"],
                                    a["i0_bins_T"])  # [V, R, C, M]
    counts, corrected = _pcd_tail(torch.movedim(cols, -1, 0).contiguous(),
                                  a, meta)
    mats, mask = _pcd_decompose(counts, corrected, a, meta)
    return {
        "counts": counts,
        "counts_corrected": corrected,
        "basis_sinos": mats,
        "basis_recons": cone_reconstruct_stack(mats, a, cm),
        "air_mask": mask,
    }


def make_jitted_pcd_cone_step(meta: PcdMeta):
    """:func:`pcd_cone_step` closed over the meta (the JAX package's
    name; a plain callable of the arrays)."""

    def step(arrays):
        return pcd_cone_step(arrays, meta)

    return step
