"""Reference-compatible pipeline API (``--engine composed``).

Port of :mod:`dexct_tpu.pipeline.api`: ``get_sino``, ``get_recon`` and
``get_basismat_sinos`` (the reference's main.py:120, 134, 153), plus
``simulate_dect``, which traces the phantom once and reuses the
material-path sinogram for both spectra.  Every function takes the host
system model (geometry, phantom, spectra) and an explicit ``device``; the
arrays it returns are tensors on that device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import fbp as fbp_ops
from ..ops import matdecomp as md_ops
from ..ops import spectral as sp_ops
from ..ops.siddon import material_path_sinogram
from ..physics.spectrum import Spectrum

__all__ = [
    "get_sino",
    "get_recon",
    "get_basismat_sinos",
    "effective_water_mu",
    "load_spectrum",
    "simulate_dect",
    "DectResult",
]


def effective_water_mu(spec, geometry, calibration_cm=10.0):
    """Effective water attenuation [1/cm] for HU conversion:
    ``-ln( sum i0 exp(-mu_w t) / sum i0 ) / t`` with the detector-weighted
    fluence and a ``calibration_cm`` water thickness (host, float64)."""
    from ..physics import xcom

    w = sp_ops.effective_fluence(spec, geometry)
    mu_w = xcom.mixatten("H(11.2)O(88.8)", spec.E)
    t = max(float(calibration_cm), 1e-6)
    trans = float(np.sum(w * np.exp(-mu_w * t)) / np.sum(w))
    return -np.log(max(trans, 1e-300)) / t


def get_sino(ct, phantom, spec, *, device, noise="none", generator=None,
             paths=None, bowtie=None, tcm=None, sigma_e=0.0):
    """Forward project one polyenergetic acquisition: returns
    ``(sino_raw, sino_log)``, both [N_proj, N_channels].  ``paths`` reuses
    a precomputed material-path sinogram (the DE driver traces once).
    ``bowtie`` (ops/bowtie.py) applies channel-dependent beam-shaping
    filtration with per-channel air normalization, ``tcm``
    (pipeline/tcm.py) modulates the tube output per view and ``sigma_e``
    adds the electronic noise floor in compound mode
    (:func:`~dexct_tpu_torch.ops.spectral.forward_counts`)."""
    if paths is None:
        paths = material_path_sinogram(phantom, ct, device=device)
    return sp_ops.forward_counts(paths, phantom, spec, ct, noise=noise,
                                 generator=generator, bowtie=bowtie,
                                 tcm=tcm, sigma_e=sigma_e)


def get_recon(sino_log, ct, spec, N_matrix, FOV, ramp, *, window="sinc"):
    """Fan-beam FBP on the device of ``sino_log``: ``(recon_raw,
    recon_HU)``; ``spec=None`` skips the HU conversion (the reference's
    filler spectrum for basis-material sinograms)."""
    mu_w = None if spec is None else effective_water_mu(spec, ct)
    return fbp_ops.fbp_recon(sino_log, ct, int(N_matrix), float(FOV),
                             float(ramp), window, mu_water_eff=mu_w)


def get_basismat_sinos(ct, sino_raw_1, sino_raw_2, spec1, spec2, n_iters=30,
                       mask_thresh=0.95, **kw):
    """Dual-energy basis material decomposition: two basis-material
    sinograms [N_proj, N_channels] in g/cm^2 (ICRU tissue, ICRU bone),
    air rays masked to zero."""
    return md_ops.decompose_sinograms(
        ct, sino_raw_1, sino_raw_2, spec1, spec2, n_iters=n_iters,
        mask_thresh=mask_thresh, **kw,
    )


@dataclasses.dataclass
class DectResult:
    """All artifacts of one dual-energy acquisition."""

    sino_raw: tuple  # (raw1, raw2) counts
    sino_log: tuple  # (log1, log2)
    recon_raw: tuple  # (raw1, raw2) [cm^-1]
    recon_HU: tuple  # (HU1, HU2)
    mat_sinos: tuple  # (mat1, mat2) [g/cm^2]
    mat_recons: tuple  # (mat1, mat2) [g/cm^3]


def simulate_dect(ct, phantom, spec1, spec2, N_matrix, FOV, ramp, *,
                  device, n_iters=50, noise="none", generator=None,
                  window="sinc", do_recon=True):
    """The full DE pipeline through the composed ops: trace once -> two
    acquisitions -> GN decomposition -> FBP of everything.  Noise draws
    come from ``generator`` (spectrum 1 first)."""
    paths = material_path_sinogram(phantom, ct, device=device)
    raw1, log1 = get_sino(ct, phantom, spec1, device=device, noise=noise,
                          generator=generator, paths=paths)
    raw2, log2 = get_sino(ct, phantom, spec2, device=device, noise=noise,
                          generator=generator, paths=paths)
    mat1, mat2 = get_basismat_sinos(ct, raw1, raw2, spec1, spec2,
                                    n_iters=n_iters)
    if not do_recon:
        return DectResult((raw1, raw2), (log1, log2), (None, None),
                          (None, None), (mat1, mat2), (None, None))
    r1, h1 = get_recon(log1, ct, spec1, N_matrix, FOV, ramp, window=window)
    r2, h2 = get_recon(log2, ct, spec2, N_matrix, FOV, ramp, window=window)
    m1r, _ = get_recon(mat1, ct, None, N_matrix, FOV, ramp, window=window)
    m2r, _ = get_recon(mat2, ct, None, N_matrix, FOV, ramp, window=window)
    return DectResult((raw1, raw2), (log1, log2), (r1, r2), (h1, h2),
                      (mat1, mat2), (m1r, m2r))


def load_spectrum(spec_id, dose, ct, spectrum_dir="./input/spectrum"):
    """Load a ``{spec_id}_1mGy_float32.bin`` spectrum scaled to the
    acquisition dose: counts per channel per view = fluence/mGy * A_iso *
    dose / N_proj (main.py:64-69)."""
    fname = f"{spectrum_dir}/{spec_id}_1mGy_float32.bin"
    spec = Spectrum.from_file(fname, spec_id)
    spec.rescale_counts(ct.A_iso * dose / ct.N_proj)
    return spec
