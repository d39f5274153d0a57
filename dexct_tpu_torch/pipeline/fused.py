"""The fused dual-energy pipeline step (``--engine fused``).

Port of :mod:`dexct_tpu.pipeline.fused` for one device: projection ->
two polyenergetic acquisitions (K2) -> Gauss-Newton decomposition (K3) ->
FBP of both single-energy images and both basis images through one packed
4-image backprojection.  ``pack_dect`` lowers the host system model to a
dict of device tensors plus a hashable :class:`DectMeta`; :func:`dect_step`
is a function of the two.  PyTorch runs eagerly, so there is no compiled
program to cache.

Projectors: ``'fourier'`` (the default of the CLI) is the Fourier-slice
projector (:mod:`dexct_tpu_torch.ops.fourier`: cuFFT, KB sampler K7, fan
resample K8); ``'siddon'`` the exact trace K1.  ``'siddon_dominant'`` runs
the same exact per-ray kernel as ``'siddon'``: on the card one per-ray walk
replaces the TPU's whole packed-plan family, and its output is already in
natural [V, C, M] order.  ``'analytic'`` traces an
:class:`~dexct_tpu_torch.system.analytic.AnalyticPhantom`'s ellipses in
closed form (K9); it is a library choice, as in the JAX package, and no
CLI flag selects it.

Reconstructions: ``'parallel'`` (the default of the CLI) rebins the fan
data to a (θ, t) parallel grid (K5), filters it and backprojects it over
the FOV disc (K6); ``'fan'`` backprojects the fan data directly (K4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import matdecomp as md_ops
from ..ops import spectral as sp_ops
from ..ops.fbp import filter_views, hu_image
from ..ops.fbp_fast import (fan_backproject_multi, pack_filtered,
                             parallel_backproject_multi, parallel_rebin_plan,
                             rebin_to_parallel)
from ..ops.filters import filter_frequency_response
from ..ops.fourier import (fourier_paths_from_arrays, plan_arrays,
                           plan_fourier_projector)
from ..ops.siddon import labels_tensor, trace_paths
from ..system.analytic import AnalyticPhantom, analytic_paths
from ..utils.devices import check_float32

__all__ = ["DectMeta", "PROJECTORS", "pack_dect", "dect_step",
           "make_jitted_step", "decompose_counts", "reconstruct_stack",
           "arrays_from_numpy", "check_choices"]

PROJECTORS = ("fourier", "siddon", "siddon_dominant", "analytic")
RECONS = ("parallel", "fan")

# the arrays dect_step reads, with their dtypes
_ARRAY_DTYPES = {
    "labels": torch.uint8,
    "src": torch.float32, "dirs": torch.float32, "betas": torch.float32,
    "mu_t1": torch.float32, "mu_t2": torch.float32,
    "i0_1": torch.float32, "i0_2": torch.float32,
    "i2_1": torch.float32, "i2_2": torch.float32,
    "dec_i0": torch.float32, "dec_mus": torch.float32,
    "filt_H": torch.float32, "cos_w": torch.float32,
}
# the arrays of the fourier projector and the parallel recon, present when
# the meta selects them
_OPTIONAL_DTYPES = {
    "fp_deapod": torch.float32, "fp_slice_idx": torch.int32,
    "fp_slice_w": torch.float32, "fp_phase_cos": torch.float32,
    "fp_phase_sin": torch.float32, "fp_fan_idx": torch.int32,
    "fp_fan_w": torch.float32,
    "rb_idx": torch.int32, "rb_w": torch.float32,
    "par_thetas": torch.float32, "par_H": torch.float32,
    "an_params": torch.float32, "an_labels": torch.int32,
    # the photon-counting packs' bin tables (pipeline/spectralct.py)
    "i0_bins_T": torch.float32, "pileup_route": torch.float32,
}


class DectMeta(NamedTuple):
    """Static parameters of a fused DE pipeline step (the fields of the JAX
    package's ``DectMeta`` that this port reads, plus the noise seed).

    ``par_sym`` is kept so that a JAX meta copies over field by field, and
    selects nothing: in the JAX package it picks the symmetry-packed
    parallel backprojectors, TPU gather-count layouts that compute the
    image kernel K6 computes directly."""

    n_materials: int
    n_matrix: int
    fft_len: int
    n_iters: int
    dx: float
    dy: float
    sid: float
    dgamma: float
    dbeta: float
    fov: float
    air1: float
    air2: float
    mu_w1: float
    mu_w2: float
    mask_thresh: float
    pixel_block: int
    projector: str = "siddon"
    fp_meta: tuple = ()  # (n_materials, n_theta, nt, grid, n_img, scale)
    recon: str = "fan"
    par_meta: tuple = ()  # (n_theta, nt, t0, dt, fft_len)
    noise: str = "none"  # 'none' | 'poisson' | 'gaussian' | 'compound'
    par_sym: bool = True
    gn_warm_nodes: int = 32
    seed: int = 0


def check_choices(projector, recon):
    """Raise for a projector or reconstruction this port does not run."""
    if projector not in PROJECTORS:
        raise ValueError(f"unknown projector {projector!r}")
    if recon not in RECONS:
        raise ValueError(f"unknown recon {recon!r}")


def pack_dect(ct, phantom, spec1, spec2, n_matrix, fov, ramp, *, device,
              n_iters=50, window="sinc", dtype=None, mask_thresh=0.95,
              pixel_block=65536, projector="siddon", n_theta=1024,
              recon="fan", recon_n_theta=512, recon_nt=1024, noise="none",
              seed=0, par_sym=True, trace_group=16, trace_bundle=8):
    """Lower the system model to (arrays, meta) for :func:`dect_step`, with
    every array on ``device``.

    ``n_theta`` is the Fourier projector's angle count
    (``projector='fourier'``); ``recon_n_theta`` x ``recon_nt`` is the
    parallel grid of ``recon='parallel'``.  The plans are host float64
    NumPy, built anew on each call; the arrays are float32 (``dtype`` must
    be float32 or None).  ``par_sym``, ``trace_group`` and
    ``trace_bundle`` choose TPU layouts of the same arrays (the symmetric
    parallel backprojection, the packed trace's ray plan); they are
    accepted and ignored."""
    del par_sym, trace_group, trace_bundle
    from .api import effective_water_mu

    check_float32(dtype)

    check_choices(projector, recon)
    if getattr(ct, "ffs", "none") != "none":
        raise ValueError(
            "the fused pipeline's recon tables assume a static focal spot")
    analytic = isinstance(phantom, AnalyticPhantom)
    if (projector == "analytic") != analytic:
        raise ValueError(
            "projector='analytic' requires an AnalyticPhantom, and an "
            "AnalyticPhantom requires projector='analytic'")
    src, dirs = ct.ray_geometry()
    i0_1 = sp_ops.effective_fluence(spec1, ct)
    i0_2 = sp_ops.effective_fluence(spec2, ct)
    _, dec_i0, dec_mus = md_ops.prepare_decomposition(ct, spec1, spec2)
    H, m = filter_frequency_response(ct.N_channels, ct.dgamma, ramp, window,
                                     "fan")
    host = {
        "src": src, "dirs": dirs, "betas": ct.betas,
        "mu_t1": phantom.materials.mu_table(spec1.E),
        "mu_t2": phantom.materials.mu_table(spec2.E),
        "i0_1": i0_1, "i0_2": i0_2,
        "i2_1": sp_ops.second_moment_fluence(spec1, ct),
        "i2_2": sp_ops.second_moment_fluence(spec2, ct),
        "dec_i0": dec_i0, "dec_mus": dec_mus,
        "filt_H": H,  # real response
        "cos_w": np.cos(ct.gammas) * ct.SID,
    }
    arrays = {k: torch.as_tensor(np.asarray(v), dtype=_ARRAY_DTYPES[k],
                                 device=device) for k, v in host.items()}
    if analytic:
        # analytic phantoms carry shapes instead of a label grid
        params, labs = phantom.shape_arrays()
        arrays["labels"] = torch.zeros((2, 2), dtype=torch.uint8,
                                       device=device)
        arrays["an_params"] = torch.as_tensor(params, dtype=torch.float32,
                                              device=device)
        arrays["an_labels"] = torch.as_tensor(labs, dtype=torch.int32,
                                              device=device)
    else:
        arrays["labels"] = labels_tensor(phantom, device)
    fp_meta = ()
    if projector == "fourier":
        plan = plan_fourier_projector(phantom, ct, n_theta=n_theta,
                                      device=device)
        arrays.update(plan_arrays(plan, (ct.N_proj, ct.N_channels)))
        fp_meta = (plan.n_materials, plan.n_theta, plan.nt, plan.grid,
                   plan.n_img, plan.scale)
    par_meta = ()
    if recon == "parallel":
        rb_idx, rb_w, par_t0, par_dt = parallel_rebin_plan(
            ct, recon_n_theta, recon_nt)
        Hp, mp = filter_frequency_response(recon_nt, par_dt, ramp, window,
                                           "parallel")
        par = {"rb_idx": rb_idx, "rb_w": rb_w,
               "par_thetas": (np.arange(recon_n_theta)
                              * (np.pi / recon_n_theta)),
               "par_H": Hp}
        arrays.update({k: torch.as_tensor(v, dtype=_OPTIONAL_DTYPES[k],
                                          device=device)
                       for k, v in par.items()})
        par_meta = (recon_n_theta, recon_nt, float(par_t0), float(par_dt),
                    int(mp))
    meta = DectMeta(
        n_materials=phantom.n_materials,
        n_matrix=int(n_matrix),
        fft_len=int(m),
        n_iters=int(n_iters),
        dx=float(getattr(phantom, "dx", 1.0)),
        dy=float(getattr(phantom, "dy", 1.0)),
        sid=float(ct.SID),
        dgamma=float(ct.dgamma),
        dbeta=float(ct.rotation_total / ct.N_proj),
        fov=float(fov),
        air1=float(np.sum(i0_1)),
        air2=float(np.sum(i0_2)),
        mu_w1=float(effective_water_mu(spec1, ct)),
        mu_w2=float(effective_water_mu(spec2, ct)),
        mask_thresh=float(mask_thresh),
        pixel_block=int(pixel_block),
        projector=projector,
        fp_meta=fp_meta,
        recon=recon,
        par_meta=par_meta,
        noise=noise,
        seed=int(seed),
    )
    return arrays, meta


def arrays_from_numpy(arrays_np, device):
    """The JAX package's ``pack_dect`` (or ``pack_pcd_spectral``) arrays
    (as numpy) -> this port's tensor dict on ``device``, so both steps can
    run on identical inputs.  Every key the port's steps read is carried
    when present (the PCD pack has no second spectrum; the Fourier-
    projector, parallel-recon and bin tables belong to their choices);
    keys this port does not read are dropped; labels become uint8 after a
    range check."""
    out = {}
    for k, dtype in {**_ARRAY_DTYPES, **_OPTIONAL_DTYPES}.items():
        if k not in arrays_np:
            continue
        a = np.array(arrays_np[k])  # a writable copy
        if k == "labels" and a.size and (a.min() < 0 or a.max() > 255):
            raise ValueError("material labels must lie in 0..255")
        out[k] = torch.as_tensor(a.astype(np.uint8) if k == "labels" else a,
                                 dtype=dtype, device=device)
    return out


def reconstruct_stack(sinos, a, meta: DectMeta):
    """FBP a ``[K, V, C]`` fan-sinogram stack through the pipeline's
    reconstruction: ``recon='fan'`` filters and backprojects the fan data
    (K4); ``'parallel'`` rebins it to the parallel grid (K5), filters, and
    backprojects over the FOV disc (K6).  Returns ``[K, n_matrix,
    n_matrix]`` in cm^-1."""
    check_choices(meta.projector, meta.recon)
    n_img = sinos.shape[0]
    if meta.recon == "parallel":
        n_th, nt, par_t0, par_dt, par_m = meta.par_meta
        par = rebin_to_parallel(sinos, a["rb_idx"], a["rb_w"], nt)
        qs = filter_views(par, 1.0, a["par_H"], par_m, par_dt)
        return parallel_backproject_multi(
            pack_filtered(qs), n_img, a["par_thetas"], par_t0, par_dt, nt,
            meta.n_matrix, meta.fov, np.pi / n_th)
    qs = filter_views(sinos, a["cos_w"], a["filt_H"], meta.fft_len,
                      meta.dgamma)
    return fan_backproject_multi(
        pack_filtered(qs), n_img, a["betas"], meta.sid, meta.dgamma,
        sinos.shape[-1], meta.n_matrix, meta.fov, meta.dbeta)


def _project_paths(a, meta: DectMeta):
    """Material paths [V, C, M] from the meta's projector."""
    if meta.projector == "fourier":
        return fourier_paths_from_arrays(a, a["labels"], meta.fp_meta)
    if meta.projector == "analytic":
        return analytic_paths(a["an_params"], a["an_labels"], a["src"],
                              a["dirs"], n_materials=meta.n_materials)
    return trace_paths(a["labels"], a["src"], a["dirs"], meta.dx, meta.dy,
                       n_materials=meta.n_materials)


def decompose_counts(counts1, counts2, a, meta, pixel_block=65536):
    """Gauss-Newton decomposition (K3) of a counts pair of any shape, with
    the air mask against the maximum of ``counts1`` over the whole
    sinogram: the (mat1, mat2) basis sinograms [g/cm^2].  Shared by the
    fan and cone steps (``meta`` gives n_iters, mask_thresh and
    gn_warm_nodes)."""
    flat = torch.stack([counts1.reshape(-1), counts2.reshape(-1)])
    ab = md_ops.gauss_newton_solve(
        flat, a["dec_i0"], a["dec_mus"], n_iters=meta.n_iters,
        pixel_block=pixel_block, warm_nodes=meta.gn_warm_nodes)
    mask = counts1 >= meta.mask_thresh * counts1.max()
    zero = torch.zeros((), dtype=ab.dtype, device=ab.device)
    return (torch.where(mask, zero, ab[:, 0].reshape(counts1.shape)),
            torch.where(mask, zero, ab[:, 1].reshape(counts1.shape)))


def dect_step(arrays, meta: DectMeta):
    """The fused DE pipeline on the device of ``arrays``.  Returns the
    JAX package's output dict: sino_raw, sino_log, mat_sinos, recon_raw,
    recon_HU and mat_recons, each a pair of tensors.

    Precomputed material paths ``arrays["paths"]`` [V, C, M] replace the
    projector, as in the JAX step (the z-stack traces every slice before
    its per-slice steps, :mod:`dexct_tpu_torch.pipeline.zstack`)."""
    a = arrays
    check_choices(meta.projector, meta.recon)
    paths = a["paths"] if "paths" in a else _project_paths(a, meta)
    if meta.noise == "none":
        counts1 = sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_1"])
        counts2 = sp_ops.counts_from_paths(paths, a["mu_t2"], a["i0_2"])
    else:
        gen = torch.Generator(device=paths.device).manual_seed(meta.seed)
        c1, v1 = sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_1"],
                                          a["i2_1"])
        c2, v2 = sp_ops.counts_from_paths(paths, a["mu_t2"], a["i0_2"],
                                          a["i2_2"])
        counts1 = sp_ops.sample_noise(gen, c1, meta.noise, var=v1)
        counts2 = sp_ops.sample_noise(gen, c2, meta.noise, var=v2)
    log1 = sp_ops.log_sinogram(counts1, meta.air1)
    log2 = sp_ops.log_sinogram(counts2, meta.air2)

    mat1, mat2 = decompose_counts(counts1, counts2, a, meta,
                                  meta.pixel_block)

    imgs = reconstruct_stack(torch.stack([log1, log2, mat1, mat2]), a, meta)
    r1, r2, m1r, m2r = imgs[0], imgs[1], imgs[2], imgs[3]
    return {
        "sino_raw": (counts1, counts2),
        "sino_log": (log1, log2),
        "mat_sinos": (mat1, mat2),
        "recon_raw": (r1, r2),
        "recon_HU": (hu_image(r1, meta.mu_w1), hu_image(r2, meta.mu_w2)),
        "mat_recons": (m1r, m2r),
    }


def make_jitted_step(meta: DectMeta):
    """:func:`dect_step` closed over the meta (the JAX package's name;
    PyTorch runs eagerly, so this is a plain callable of the arrays)."""

    def step(arrays):
        return dect_step(arrays, meta)

    return step
