"""dexct_tpu_torch: the PyTorch / CUDA port of dexct_tpu for one NVIDIA H100.

A second package beside the JAX package ``dexct_tpu``, which stays the
reference it is tested against.  This package imports ``torch`` and never
``jax`` or ``dexct_tpu``.  It runs the dual-energy main path (projection ->
two polyenergetic acquisitions -> Gauss-Newton decomposition -> four
reconstructions -> the §2.6 output files) on the 2-D fan-beam paths (with
an in-plane flying focal spot), on parallel-beam configs, as a z-stack of
slices, on cone-beam, helical, flat-panel and gantry-tilted configs (with
a z flying focal spot and exact Katsevich helical reconstruction), and with
the analytic projector, optionally with beam-hardening correction and the
learned denoiser, through thirty-nine hand-written kernels on the card
(K1-K39, sources in ``csrc/``, ``ops/spectral.py`` and
``ops/katsevich.py``) with plain PyTorch versions of each on the CPU.  The
library also offers the helical study reconstructors (every gFDK
weighting, the cone-parallel PI method), exact 3-D iterative
reconstruction (CG, PWLS), 2-D iterative reconstruction on the Fourier
projector (CG, SIRT, PWLS), one-step spectral reconstruction, patient
dose maps with CTDI, DLP and organ reports, predicted FBP noise maps
(single and dual energy), first-principles scatter (fan and cone beam)
with the kernel-superposition scatter model and its correction, the
scanner-realism chain, patient motion and gating, spectral
photon-counting CT (2-D and cone, up to four basis materials and eight
bins), the kV-switching, dual-source and dual-layer acquisitions, and the
dose, ramp-filter and slice sweeps on one device.

Layer map (as in dexct_tpu):
    physics/   attenuation tables, spectra, detectors, materials, form
               factors (host NumPy)
    system/    scanner geometry, voxel and analytic phantoms (K9), run config
    ops/       siddon (K1, K17), spectral (K2, K28, K34), matdecomp (K3,
               K29, K35), fbp/fbp_fast
               (K4-K6), ffs (K5 at 16 taps), fourier (K7, K8), conebeam
               (K10-K12, K16, K18, K19), flatpanel (K13), katsevich (K14,
               K15), helical_pi (K5 at 4 taps, K20), fourier's adjoints
               (K21, K22), iterative, onestep, dose (K23, K24), noisemap
               (K25), scatter_physics (K26, K27), scatter, bhc, afterglow
               (K36, K37)
    pipeline/  reference-compatible API, fused 2-D, z-stack and cone steps,
               the sweeps, CLI runner
    analysis/  VMI, ROI metrics, NPS, DE products, QA, registration (host
               NumPy)
    compat     the reference's import names
    tools/     the gather-rate probe (K38, K39)
    learn/     the DnCNN denoiser (inference, cuDNN)
    utils/     output contract, kernel build, the Adam step
"""

__version__ = "0.1.0"

from . import analysis, ops, physics, pipeline, system, utils
from .physics import mixatten
from .pipeline import get_basismat_sinos, get_recon, get_sino, simulate_dect
from .system import (
    FanBeamGeometry,
    VoxelPhantom,
    read_parameter_file,
    water_cylinder_phantom,
)

__all__ = [
    "analysis",
    "physics",
    "system",
    "ops",
    "pipeline",
    "utils",
    "get_sino",
    "get_recon",
    "get_basismat_sinos",
    "simulate_dect",
    "mixatten",
    "FanBeamGeometry",
    "VoxelPhantom",
    "read_parameter_file",
    "water_cylinder_phantom",
]
