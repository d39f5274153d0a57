"""The pipeline driver: configs -> simulated acquisitions -> output files.

Port of :mod:`dexct_tpu.pipeline.runner`: loops over the run configs of a
params file and the dual-energy spectrum pairs, runs trace ->
acquisitions -> decomposition -> reconstruction on ``device``, and writes
the §2.6 output contract (flat float32 ``.bin`` files) with the same names
and layout as the JAX package.  Cone-beam and helical configs run the fused
cone pipeline (:mod:`dexct_tpu_torch.pipeline.cone`), or, for flat panels,
tilted gantries, z flying focal spots and ``--recon3d katsevich``, the
stateless 3-D branch (:func:`dexct_tpu_torch.ops.conebeam.
simulate_cone_dect`), and write the natural volume extension of the
contract: the same file names, [V, R, C] sinograms and [nz, N, N]
volumes.  As in the JAX runner, the fused engine runs the exact Siddon
projector for a non-square phantom (the Fourier projector needs a square
grid) and direct fan reconstruction for a partial rotation (rebinning
needs a full one).  Parallel-beam configs and in-plane flying focal spots
run the composed path, as the JAX runner sends them.  ``--bhc`` writes the
water- and bone-BHC reconstructions of 2-D configs, ``--denoise`` the
learned denoiser's images.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..system.config import RunConfig, read_parameter_file
from ..utils.io import StageWriter, acquisition_dir, matdecomp_dir
from . import api

__all__ = ["DEFAULT_SPEC_PAIRS", "fused_choices", "is_cone", "run_config",
           "run_parameter_file", "runs_fused_2d", "stateless_3d"]

# the reference's hardcoded protocol (main.py:101-102)
DEFAULT_SPEC_PAIRS = (
    ("detunedMV", "80kV", 9.0, 1.0),
)


@dataclasses.dataclass
class RunResult:
    run_id: str
    pair: tuple
    dect: api.DectResult
    wall_s: float


def _resolve_spectrum(spec_id, dose, ct, spectrum_dir, generators):
    """Load a spectrum binary if present, else synthesize analytically."""
    fname = os.path.join(spectrum_dir, f"{spec_id}_1mGy_float32.bin")
    if os.path.exists(fname):
        return api.load_spectrum(spec_id, dose, ct, spectrum_dir)
    if spec_id not in generators:
        raise FileNotFoundError(
            f"no spectrum file {fname} and no generator for {spec_id!r}"
        )
    spec = generators[spec_id]()
    spec.name = spec_id
    spec.rescale_counts(ct.A_iso * dose / ct.N_proj)
    return spec


def default_generators():
    from ..physics.spectrum import kramers_spectrum, linac_spectrum

    return {
        "80kV": lambda: kramers_spectrum(80.0),
        "120kV": lambda: kramers_spectrum(120.0),
        "140kV": lambda: kramers_spectrum(140.0),
        "6MV": lambda: linac_spectrum(detuned=False,
                                      e_min=157.56497,
                                      photons_per_cm2_per_mGy=4.6e6),
        "detunedMV": lambda: linac_spectrum(detuned=True),
    }


def _effective_noise(noise, ct):
    """EID detectors integrate energy-weighted counts, so their
    ``poisson`` request is the compound (energy-weighted Poisson) model."""
    return "compound" if noise == "poisson" and ct.eid else noise


RECON3D = ("auto", "fdk", "helical", "katsevich")


def _check_cone(cfg, recon3d):
    """The JAX runner's ``recon3d`` rules for a cone/helical config."""
    if recon3d not in RECON3D:
        raise ValueError(f"unknown recon3d {recon3d!r}")
    ct = cfg.ct
    helical = abs(getattr(ct, "pitch", 0.0)) > 1e-12
    if not helical and recon3d in ("helical", "katsevich"):
        raise ValueError(
            f"recon3d={recon3d!r} requires a helical config (pitch>0); "
            f"config {cfg.run_id!r} is a circular orbit")
    if helical and recon3d == "fdk":
        raise ValueError(
            "recon3d='fdk' (circular FDK) cannot reconstruct a helical "
            f"scan; config {cfg.run_id!r} has pitch "
            f"{getattr(ct, 'pitch', 0.0)!r} — use 'helical', "
            "'katsevich', or 'auto'")


def _check_supported(cfg, engine, projector, recon, recon3d="auto"):
    """Raise for a choice the runner refuses before anything runs: an
    unknown engine, the JAX runner's ``recon3d`` rules on a cone config,
    and an unknown projector or recon on the fused 2-D path."""
    from .fused import check_choices

    if engine not in ("fused", "composed"):
        raise ValueError(f"unknown engine {engine!r}")
    if is_cone(cfg.ct):
        _check_cone(cfg, recon3d)
    elif runs_fused_2d(cfg.ct, engine):
        check_choices(projector, recon)


def is_cone(ct):
    from ..system.geometry import ConeBeamGeometry

    return isinstance(ct, ConeBeamGeometry)


def runs_fused_2d(ct, engine):
    """Whether a 2-D config runs the fused engine: a fan beam with a static
    focal spot under ``engine='fused'``.  Parallel-beam geometries and
    in-plane flying focal spots take the composed path
    (:func:`~dexct_tpu_torch.pipeline.api.simulate_dect`), as the JAX runner
    sends them."""
    from ..system.geometry import FanBeamGeometry

    return (engine == "fused" and isinstance(ct, FanBeamGeometry)
            and not is_cone(ct) and getattr(ct, "ffs", "none") == "none")


def fused_choices(cfg, projector, recon):
    """The JAX runner's downgrades of the fused path's choices for a
    config: ``fourier`` becomes ``siddon`` for a non-square phantom grid,
    ``parallel`` becomes ``fan`` for a partial rotation."""
    if projector == "fourier" and cfg.phantom.Nx != cfg.phantom.Ny:
        projector = "siddon"
    if recon == "parallel" and abs(
            cfg.ct.rotation_total - 2.0 * np.pi) > 1e-3:
        recon = "fan"
    return projector, recon


def run_config(cfg: RunConfig, *, out_dir="./output", spec_pairs=None,
               spectrum_dir="./input/spectrum", noise="none", seed=0,
               n_iters=50, param_file=None, verbose=True, bhc=False,
               engine="fused", projector="fourier", recon="parallel",
               recon3d="auto", resume=False, denoise=False, device="cuda"):
    """Execute one run config over its DE spectrum pairs (main.py:90-178)
    on ``device``.

    engine='fused' runs :func:`~dexct_tpu_torch.pipeline.fused.dect_step`
    on fan beams with a static focal spot; engine='composed', parallel-beam
    geometries and in-plane flying focal spots run the reference-API op
    chain (:func:`~dexct_tpu_torch.pipeline.api.simulate_dect`).  Cone-beam and
    helical configs run :func:`~dexct_tpu_torch.pipeline.cone.cone_dect_step`
    or, where :func:`stateless_3d` says so,
    :func:`~dexct_tpu_torch.ops.conebeam.simulate_cone_dect`, whatever the
    engine, projector and recon (as in the JAX runner); ``recon3d`` must
    agree with the orbit.  Noise draws come from a
    ``torch.Generator`` seeded with ``seed``.

    ``bhc=True`` also writes water- and bone-BHC reconstructions of each
    acquisition on 2-D configs (:mod:`dexct_tpu_torch.ops.bhc`; cone
    configs warn and write none); ``denoise=True`` runs the vendored
    denoiser (:mod:`dexct_tpu_torch.learn.denoiser_io`) on every
    reconstructed HU image of the pair, both spectra and every slice in one
    forward pass, and writes ``recon_denoised_{raw,HU}_float32.bin``.
    """
    _check_supported(cfg, engine, projector, recon, recon3d)
    cone = is_cone(cfg.ct)
    fused = runs_fused_2d(cfg.ct, engine)
    projector, recon = fused_choices(cfg, projector, recon)
    device = torch.device(device)
    pairs = spec_pairs or DEFAULT_SPEC_PAIRS
    writer = StageWriter(out_dir, cfg.run_id, param_file)
    gens = default_generators()
    eff_noise = _effective_noise(noise, cfg.ct)
    bp = cfg.do_back_projection
    results = []
    for spec_id1, spec_id2, d1, d2 in pairs:
        t0 = time.time()
        if resume and _pair_complete(out_dir, cfg, spec_id1, spec_id2,
                                     d1, d2, denoise=denoise):
            if verbose:
                print(f"resume: skipping completed pair "
                      f"{spec_id1}-{spec_id2}")
            continue
        spec1 = _resolve_spectrum(spec_id1, d1, cfg.ct, spectrum_dir, gens)
        spec2 = _resolve_spectrum(spec_id2, d2, cfg.ct, spectrum_dir, gens)
        if cone:
            dect = _cone_dect(cfg, spec1, spec2, n_iters=n_iters,
                              noise=eff_noise, seed=seed, device=device,
                              recon3d=recon3d)
        elif fused:
            from .fused import dect_step, pack_dect

            arrays, meta = pack_dect(
                cfg.ct, cfg.phantom, spec1, spec2, cfg.N_matrix, cfg.FOV,
                cfg.ramp, device=device, n_iters=n_iters,
                projector=projector, recon=recon, noise=eff_noise,
                seed=seed)
            out = dect_step(arrays, meta)
            dect = api.DectResult(
                sino_raw=out["sino_raw"], sino_log=out["sino_log"],
                recon_raw=out["recon_raw"] if bp else (None, None),
                recon_HU=out["recon_HU"] if bp else (None, None),
                mat_sinos=out["mat_sinos"],
                mat_recons=out["mat_recons"] if bp else (None, None),
            )
        else:
            gen = (torch.Generator(device=device).manual_seed(seed)
                   if eff_noise != "none" else None)
            dect = api.simulate_dect(
                cfg.ct, cfg.phantom, spec1, spec2, cfg.N_matrix, cfg.FOV,
                cfg.ramp, device=device, n_iters=n_iters, noise=eff_noise,
                generator=gen, do_recon=bp)
        for i, (sid, dose) in enumerate(((spec_id1, d1), (spec_id2, d2))):
            writer.acquisition(
                sid, dose,
                sino_raw=dect.sino_raw[i], sino_log=dect.sino_log[i],
                recon_raw=dect.recon_raw[i], recon_HU=dect.recon_HU[i])
        writer.matdecomp(
            spec_id1, spec_id2, d1, d2, mat_sinos=list(dect.mat_sinos),
            mat_recons=(None if dect.mat_recons[0] is None
                        else list(dect.mat_recons)))
        if denoise and bp and dect.recon_HU[0] is not None:
            _write_denoised(writer, cfg, dect,
                            ((spec_id1, d1, spec1), (spec_id2, d2, spec2)))
        if bhc and bp and cone:
            import warnings

            warnings.warn(
                "bhc=True is ignored for cone/helical configs (the BHC "
                "polynomials are calibrated on the 2-D fan path); no "
                "recon_*BHC_* artifacts will be written", stacklevel=2)
        if bhc and bp and not cone:
            _write_bhc(writer, cfg, dect, ((spec_id1, spec1),
                                           (spec_id2, spec2)))
        wall = time.time() - t0
        if verbose:
            print(f"matdecomp finished for {spec_id1}-{spec_id2} : "
                  f"t={wall:.2f}s")
        results.append(RunResult(cfg.run_id, (spec_id1, spec_id2, d1, d2),
                                 dect, wall))
    return results


def stateless_3d(ct, recon3d):
    """Whether a cone config runs the stateless 3-D branch
    (:func:`~dexct_tpu_torch.ops.conebeam.simulate_cone_dect`) instead of
    the fused cone pipeline: flat panels, tilted gantries, z flying focal
    spots (the geometries the fused pack does not model) and
    ``recon3d='katsevich'`` on a helix, as the JAX runner sends them."""
    from .cone import unsupported_geometry

    helical = abs(getattr(ct, "pitch", 0.0)) > 1e-12
    return (unsupported_geometry(ct) is not None
            or (helical and recon3d == "katsevich"))


def _cone_dect(cfg, spec1, spec2, *, n_iters, noise, seed, device,
               recon3d):
    """A cone/helical config through the 3-D pipelines: the fused cone
    pipeline (circular FDK or, for a helical orbit, the 4-volume
    generalized Feldkamp) or, for what :func:`stateless_3d` names, the
    stateless branch with ``recon=recon3d``.  A ``back_project false``
    config skips the reconstruction."""
    bp = bool(cfg.do_back_projection)
    if stateless_3d(cfg.ct, recon3d):
        from ..ops.conebeam import simulate_cone_dect

        gen = (torch.Generator(device=device).manual_seed(seed)
               if noise != "none" else None)
        out = simulate_cone_dect(
            cfg.ct, cfg.phantom, spec1, spec2, cfg.N_matrix, cfg.FOV,
            cfg.ramp, device=device, n_iters=n_iters, noise=noise,
            generator=gen, do_recon=bp, recon=recon3d)
    else:
        from .cone import cone_dect_step, pack_cone_dect

        arrays, meta = pack_cone_dect(
            cfg.ct, cfg.phantom, spec1, spec2, cfg.N_matrix, cfg.FOV,
            cfg.ramp, device=device, n_iters=n_iters, noise=noise,
            seed=seed, do_recon=bp)
        out = cone_dect_step(arrays, meta)
    return api.DectResult(
        sino_raw=out["sino_raw"], sino_log=out["sino_log"],
        recon_raw=out["recon_raw"], recon_HU=out["recon_HU"],
        mat_sinos=out["mat_sinos"], mat_recons=out["mat_recons"])


def _write_denoised(writer, cfg, dect, acqs):
    """Denoise both spectra's HU images (every slice of a volume) in one
    forward pass and write ``recon_denoised_{raw,HU}`` per acquisition,
    the raw image as ``mu_w (1 + HU / 1000)``."""
    from ..learn.denoiser_io import denoise_hu_batch

    hu = [dect.recon_HU[i] for i in range(2)]
    dn = denoise_hu_batch(torch.cat([h.reshape(-1, *h.shape[-2:])
                                     for h in hu]))
    pos = 0
    for h, (sid, dose, spec) in zip(hu, acqs):
        n = int(np.prod(h.shape[:-2], initial=1))
        hu_dn = dn[pos:pos + n].reshape(h.shape)
        pos += n
        mu_w = float(api.effective_water_mu(spec, cfg.ct))
        writer.denoised(sid, dose, recon_raw=mu_w * (1.0 + hu_dn / 1000.0),
                        recon_HU=hu_dn)


def _write_bhc(writer, cfg, dect, acqs):
    """Water- and bone-BHC reconstructions of each acquisition's log
    sinogram, written as ``{phantom}_bhc_{spec}/recon_{water,bone}BHC_*``."""
    from ..ops.bhc import bone_bhc_recon, water_bhc_recon

    for i, (sid, spec) in enumerate(acqs):
        args = (dect.sino_log[i], cfg.ct, spec, cfg.N_matrix, cfg.FOV,
                cfg.ramp)
        writer.bhc(cfg.phantom.name, sid, "water", *water_bhc_recon(*args))
        writer.bhc(cfg.phantom.name, sid, "bone", *bone_bhc_recon(*args))


def _pair_complete(out_dir, cfg, spec_id1, spec_id2, d1, d2, denoise=False):
    """All stage artifacts of a DE pair already on disk (with
    ``denoise``, the denoised images too)."""
    want = []
    for sid, dose in ((spec_id1, d1), (spec_id2, d2)):
        d = acquisition_dir(out_dir, cfg.run_id, sid, dose)
        want += [os.path.join(d, "sino_raw_float32.bin"),
                 os.path.join(d, "sino_log_float32.bin")]
        if cfg.do_back_projection:
            want += [os.path.join(d, "recon_raw_float32.bin"),
                     os.path.join(d, "recon_HU_float32.bin")]
            if denoise:
                want += [os.path.join(d, "recon_denoised_raw_float32.bin"),
                         os.path.join(d, "recon_denoised_HU_float32.bin")]
    md = matdecomp_dir(out_dir, cfg.run_id, spec_id1, spec_id2, d1, d2)
    want += [os.path.join(md, "mat1_sino_float32.bin"),
             os.path.join(md, "mat2_sino_float32.bin")]
    return all(os.path.exists(p) for p in want)


def run_parameter_file(param_file, *, out_dir="./output", **kw):
    """``python -m dexct_tpu_torch.run`` entry: every config in the params
    file."""
    out = []
    for cfg in read_parameter_file(param_file):
        out.extend(run_config(cfg, out_dir=out_dir, param_file=param_file,
                              **kw))
    return out
