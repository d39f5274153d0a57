"""The fused 3-D cone-beam dual-energy pipeline step.

Port of :mod:`dexct_tpu.pipeline.cone` for one device: exact 3-D trace
(K10) -> two polyenergetic acquisitions (K2) -> Gauss-Newton decomposition
(K3) -> filtered backprojection of both single-energy volumes and both
basis volumes through one 4-volume pass: the circular FDK (K11) or, for a
helical orbit, the generalized Feldkamp (K12).  :func:`pack_cone_dect`
lowers the host system model to device tensors plus a hashable
:class:`ConeDectMeta`; :func:`cone_dect_step` is a function of the two.

The JAX pack's label packs, ray plans and bundles are TPU layouts for its
packed dominant-axis tracer, and its capability guards (packing limits,
the table-size and HBM guards) bound those layouts.  One per-ray kernel has
none of them, so this pack keeps only the rules that are physics or
protocol: flat-panel, tilted and flying-focal-spot geometries are refused
(they run the stateless branch,
:func:`dexct_tpu_torch.ops.conebeam.simulate_cone_dect`), and the helical z
grid, window centres, view weightings and FDK weights are the JAX
package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import matdecomp as md_ops
from ..ops import spectral as sp_ops
from ..ops.conebeam import (WEIGHTINGS, _fdk_backproject_multi,
                            _fdk_weights, _helical_backproject, labels_u8,
                            trace_paths_3d)
from ..ops.fbp import filter_views, hu_image
from ..ops.filters import filter_frequency_response
from ..utils.devices import upload
from .fused import decompose_counts

__all__ = ["ConeDectMeta", "pack_cone_dect", "unsupported_geometry",
           "cone_paths", "cone_dect_from_paths", "cone_dect_step",
           "make_jitted_cone_step", "cone_reconstruct_stack",
           "cone_arrays_from_numpy"]

# the arrays the step reads besides labels/src/dirs, with their dtypes;
# the helical and compound-noise ones are present when the meta needs them
_ARRAY_DTYPES = {
    "mu_t1": torch.float32, "mu_t2": torch.float32,
    "i0_1": torch.float32, "i0_2": torch.float32,
    "dec_i0": torch.float32, "dec_mus": torch.float32,
    "fdk_w": torch.float32, "filt_H": torch.float32,
    "betas": torch.float32,
}
_OPTIONAL_DTYPES = {
    "src_z": torch.float32, "row_off": torch.float32,
    "beta_c": torch.float32, "i2_1": torch.float32, "i2_2": torch.float32,
    # the photon-counting packs' bin tables (pipeline/spectralct.py)
    "i0_bins_T": torch.float32, "pileup_route": torch.float32,
}


class ConeDectMeta(NamedTuple):
    """Static parameters of a fused cone DE step (the fields of the JAX
    package's ``ConeDectMeta`` that this port reads, plus the noise
    seed)."""

    n_materials: int
    n_matrix: int
    nz_out: int
    fov: float
    dz_out: float
    n_iters: int
    dx: float
    dy: float
    dz: float
    labels_shape: tuple  # (nz, ny, nx)
    vrc: tuple  # (V, R, C)
    sid: float
    dgamma: float
    row_h: float
    dbeta: float
    fft_len: int
    air1: float
    air2: float
    mu_w1: float
    mu_w2: float
    mask_thresh: float
    noise: str
    gn_warm_nodes: int = 32
    do_recon: bool = True
    pitch: float = 0.0
    z0: float = 0.0
    helical_weighting: str = "full"
    seed: int = 0


def unsupported_geometry(ct):
    """``(kind, assumption, where it runs)`` of a geometry the fused cone
    pipeline does not model (the JAX pack's own refusals), or ``None``."""
    if getattr(ct, "flat_panel", False):
        return ("flat-panel", "its FDK assumes equiangular columns",
                "ops.flatpanel.fdk_flat_reconstruct")
    if abs(float(getattr(ct, "tilt", 0.0))) > 1e-12:
        return ("gantry-tilted", "its FDK assumes a z=0 orbit",
                "ops.conebeam.fdk_tilted_reconstruct")
    if getattr(ct, "ffs", "none") != "none":
        return ("flying-focal-spot",
                "its FDK assumes one shared detector-row grid",
                "ops.conebeam.fdk_reconstruct's z-FFS branch")
    return None


def pack_cone_dect(ct, phantom, spec1, spec2, n_matrix, fov, ramp, *,
                   device, n_iters=10, nz_out=None, dz_out=None,
                   window="sinc", noise="none", seed=0, group=16,
                   mask_thresh=0.95, do_recon=True, trace_bundle=8,
                   weighting="full", _ray_plan=True, _n_zslab=1):
    """Lower a cone-beam DE scan to ``(arrays, meta)`` for
    :func:`cone_dect_step`, every array on ``device``.

    Helical geometries (``ct.pitch != 0``) reconstruct on a z grid centred
    on the scan's mid-travel z = 0: ``nz_out`` slices of ``dz_out``
    (default ``h_iso``) or, without ``nz_out``, the JAX package's default
    of one slice per ``h_iso`` across the central 80 % of the source
    travel (the ends lack a full 2 pi window); ``weighting`` picks the
    generalized Feldkamp's view window (``ops.conebeam.WEIGHTINGS``).  The
    circular grid is ``nz_out`` (default ``N_rows``) slices of ``dz_out``
    (default ``h_iso``).  ``group``, ``trace_bundle``, ``_ray_plan`` and
    ``_n_zslab`` choose the JAX package's TPU trace layouts and z-slab
    sharding; they are accepted and ignored.
    """
    del group, trace_bundle, _ray_plan, _n_zslab
    from .api import effective_water_mu

    bad = unsupported_geometry(ct)
    if bad:
        raise ValueError(f"{bad[0]} geometries are not supported by the "
                         f"fused cone pipeline ({bad[1]}); use "
                         "ops.conebeam.simulate_cone_dect, which routes "
                         f"them through {bad[2]}")
    pitch = float(getattr(ct, "pitch", 0.0))
    helical = abs(pitch) > 1e-12
    if weighting not in WEIGHTINGS:
        raise ValueError(f"unknown helical weighting {weighting!r}")
    nz, ny, nx = np.asarray(phantom.labels).shape
    z0 = 0.0
    if helical:
        if nz_out is None:
            travel = pitch * ct.rotation_total / (2.0 * np.pi)
            half = 0.4 * travel
            nz_out = max(int(2.0 * half / ct.h_iso), 1)
            dz_out = 2.0 * half / nz_out
        elif dz_out is None:
            dz_out = ct.h_iso
        z0 = (0.5 - int(nz_out) / 2.0) * float(dz_out)
    nz_out = int(ct.N_rows if nz_out is None else nz_out)
    dz_out = float(ct.h_iso if dz_out is None else dz_out)

    src, dirs = ct.ray_geometry_3d()
    i0_1 = sp_ops.effective_fluence(spec1, ct)
    i0_2 = sp_ops.effective_fluence(spec2, ct)
    _, dec_i0, dec_mus = md_ops.prepare_decomposition(ct, spec1, spec2)
    V, R, C = ct.N_proj, ct.N_rows, ct.N_channels
    H, m = filter_frequency_response(C, ct.dgamma, ramp, window, "fan")
    host = {
        "mu_t1": phantom.materials.mu_table(spec1.E),
        "mu_t2": phantom.materials.mu_table(spec2.E),
        "i0_1": i0_1, "i0_2": i0_2,
        "dec_i0": dec_i0, "dec_mus": dec_mus,
        "fdk_w": _fdk_weights(ct),
        "filt_H": H,
        "betas": ct.betas,
    }
    if helical:
        zv = z0 + dz_out * np.arange(int(nz_out))
        host["src_z"] = ct.source_z
        host["row_off"] = np.zeros(V)  # no flying focal spot here
        host["beta_c"] = 0.5 * ct.rotation_total + 2.0 * np.pi * zv / pitch
    if noise == "compound":
        host["i2_1"] = sp_ops.second_moment_fluence(spec1, ct)
        host["i2_2"] = sp_ops.second_moment_fluence(spec2, ct)
    # host tables and float64 rays cast to float32 on the host, then up
    # through pinned memory (NumPy's and torch's roundings are the same)
    dtypes = {**_ARRAY_DTYPES, **_OPTIONAL_DTYPES}
    arrays = {k: upload(np.asarray(v), device, dtypes[k])
              for k, v in host.items()}
    arrays["labels"] = labels_u8(np.asarray(phantom.labels), device)
    arrays["src"] = upload(src, device, torch.float32)
    arrays["dirs"] = upload(dirs, device, torch.float32)
    meta = ConeDectMeta(
        n_materials=int(phantom.n_materials),
        n_matrix=int(n_matrix),
        nz_out=int(nz_out),
        fov=float(fov),
        dz_out=float(dz_out),
        n_iters=int(n_iters),
        dx=float(phantom.dx), dy=float(phantom.dy), dz=float(phantom.dz),
        labels_shape=(int(nz), int(ny), int(nx)),
        vrc=(int(V), int(R), int(C)),
        sid=float(ct.SID), dgamma=float(ct.dgamma),
        row_h=float(ct.h_iso),
        dbeta=float(ct.rotation_total / V),
        fft_len=int(m),
        air1=float(np.sum(i0_1)), air2=float(np.sum(i0_2)),
        mu_w1=float(effective_water_mu(spec1, ct)),
        mu_w2=float(effective_water_mu(spec2, ct)),
        mask_thresh=float(mask_thresh),
        noise=str(noise),
        do_recon=bool(do_recon),
        pitch=pitch, z0=float(z0),
        helical_weighting=str(weighting),
        seed=int(seed),
    )
    return arrays, meta


def cone_arrays_from_numpy(arrays_np, device, labels, src, dirs):
    """The JAX package's ``pack_cone_dect`` (or ``pack_pcd_spectral_cone``)
    arrays (as numpy) -> this port's tensor dict on ``device``, so both
    steps run on identical inputs; every key the port's steps read is
    carried when present.  The JAX pack keeps the label volume and the rays
    only in its TPU layouts (``pack_*``, ``src_*``/``dirs_*`` ray plans and
    bundles, ``inv``), which are dropped; ``labels`` [nz, ny, nx] and
    ``src``, ``dirs`` [V, R, C, 3] come from the host model instead."""
    out = {}
    for k, dtype in {**_ARRAY_DTYPES, **_OPTIONAL_DTYPES}.items():
        if k in arrays_np:
            out[k] = upload(np.array(arrays_np[k]), device, dtype)
    out["labels"] = labels_u8(np.asarray(labels), device)
    out["src"] = upload(np.asarray(src), device, torch.float32)
    out["dirs"] = upload(np.asarray(dirs), device, torch.float32)
    return out


def cone_paths(a, meta: ConeDectMeta):
    """Material paths [V, R, C, M] of every detector ray (K10)."""
    return trace_paths_3d(a["labels"], a["src"], a["dirs"], meta.dx,
                          meta.dy, meta.dz, n_materials=meta.n_materials)


def cone_reconstruct_stack(sinos, a, meta: ConeDectMeta):
    """Filter and backproject a ``[K, V, R, C]`` sinogram stack: FDK
    weights, the shared ramp filter along channels (times dgamma), then
    the circular FDK (K11) or the helical gFDK (K12, in the meta's
    ``helical_weighting``) of all K volumes in one pass.  Returns
    ``[K, nz, N, N]`` in the sinograms' units per cm."""
    V, R, C = meta.vrc
    qs = filter_views(sinos, a["fdk_w"], a["filt_H"], meta.fft_len,
                      meta.dgamma).contiguous()
    if abs(meta.pitch) > 1e-12:
        return _helical_backproject(
            qs, a["betas"], a["src_z"], a["row_off"], a["beta_c"],
            meta.sid, meta.dgamma, meta.row_h, R, meta.pitch, meta.n_matrix,
            meta.nz_out, meta.fov, meta.dz_out, meta.z0, dbeta=meta.dbeta,
            weighting=meta.helical_weighting)
    return _fdk_backproject_multi(
        qs, a["betas"], meta.sid, meta.dgamma, meta.row_h, R, meta.n_matrix,
        meta.nz_out, meta.fov, meta.dz_out, meta.dbeta)


def cone_dect_from_paths(paths, arrays, meta: ConeDectMeta):
    """Every stage after the trace: counts of both spectra (K2), noise,
    log, decomposition (K3) with the air mask, and the 4-volume
    reconstruction.  Returns the JAX package's output dict, each entry a
    pair of tensors ([V, R, C] sinograms, [nz, N, N] volumes; volumes are
    None when ``meta.do_recon`` is false)."""
    a = arrays
    if meta.noise == "none":
        counts1 = sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_1"])
        counts2 = sp_ops.counts_from_paths(paths, a["mu_t2"], a["i0_2"])
    else:
        gen = torch.Generator(device=paths.device).manual_seed(meta.seed)
        if meta.noise == "compound":
            c1, v1 = sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_1"],
                                              a["i2_1"])
            c2, v2 = sp_ops.counts_from_paths(paths, a["mu_t2"], a["i0_2"],
                                              a["i2_2"])
        else:
            c1 = sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_1"])
            c2 = sp_ops.counts_from_paths(paths, a["mu_t2"], a["i0_2"])
            v1 = v2 = None
        counts1 = sp_ops.sample_noise(gen, c1, meta.noise, var=v1)
        counts2 = sp_ops.sample_noise(gen, c2, meta.noise, var=v2)
    log1 = sp_ops.log_sinogram(counts1, meta.air1)
    log2 = sp_ops.log_sinogram(counts2, meta.air2)
    mat1, mat2 = decompose_counts(counts1, counts2, a, meta)
    out = {"sino_raw": (counts1, counts2), "sino_log": (log1, log2),
           "mat_sinos": (mat1, mat2)}
    if not meta.do_recon:  # forward-projection-only config
        none = (None, None)
        return {**out, "recon_raw": none, "recon_HU": none,
                "mat_recons": none}
    vols = cone_reconstruct_stack(torch.stack([log1, log2, mat1, mat2]), a,
                                  meta)
    return {**out, "recon_raw": (vols[0], vols[1]),
            "recon_HU": (hu_image(vols[0], meta.mu_w1),
                         hu_image(vols[1], meta.mu_w2)),
            "mat_recons": (vols[2], vols[3])}


def cone_dect_step(arrays, meta: ConeDectMeta):
    """One fused cone DE step on the device of ``arrays``: the trace, then
    :func:`cone_dect_from_paths`."""
    return cone_dect_from_paths(cone_paths(arrays, meta), arrays, meta)


def make_jitted_cone_step(meta: ConeDectMeta):
    """:func:`cone_dect_step` closed over the meta (the JAX package's name;
    PyTorch runs eagerly, so this is a plain callable of the arrays)."""

    def step(arrays):
        return cone_dect_step(arrays, meta)

    return step
