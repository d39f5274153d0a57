"""Device ops: exact Siddon trace (K1) and its slice-batched form (K17),
polyenergetic counts (K2), Gauss-Newton decomposition (K3), fan-beam and
rebinned parallel FBP (K4-K6), the in-plane flying-focal-spot FBP (K5 at
16 taps, K6), the Fourier projector (K7, K8), beam-hardening correction,
the cone-beam trace, FDK/helical backprojectors in every gFDK weighting and
tilted-gantry resample (K10-K12, K16), the flat-panel FDK (K13), the
Katsevich exact helical reconstruction (K14, K15), the exact 3-D projector
and its adjoint (K18, K19) with the iterative loops (CG, PWLS) on them, the
cone-parallel PI method (K5 at 4 taps, K20), the Fourier projector's
adjoints (K21, K22) under the 2-D CG, SIRT and PWLS and the one-step
spectral fit, the 2-D and 3-D dose maps (K23, K24), the FBP noise maps
(K25) and first-principles single scatter, fan beam (K26) and cone beam
(K27), with the kernel-superposition scatter model, and the scanner-realism
models: bowtie filtration and the anode heel (table-indexed counts K28,
the grouped Gauss-Newton solve K29), detector MTF, gains and rings,
afterglow, metal artifact reduction, synthetic dose reduction, truncation
completion, finite aperture and the anticorrelated basis denoiser; rigid
patient motion (the motion-compensated fan, FDK and helical
backprojections K30, K32, K33) and the host-only calibrations (detector
offset, bead geometry, empirical decomposition)."""

from . import afterglow, aperture, bhc, bowtie, calibration, conebeam
from . import denoise, dose, empirical, fbp, fbp_fast, ffs, filters
from . import flatpanel, fourier, geocal, heel, helical_pi, iterative
from . import katsevich, lowdose, mar, matdecomp, motion, mtf, noisemap
from . import onestep, rings, scatter, scatter_physics, siddon, spectral
from . import truncation

__all__ = ["afterglow", "aperture", "bhc", "bowtie", "calibration",
           "conebeam", "denoise", "dose", "empirical", "fbp", "fbp_fast",
           "ffs", "filters", "flatpanel", "fourier", "geocal", "heel",
           "helical_pi", "iterative", "katsevich", "lowdose", "mar",
           "matdecomp", "motion", "mtf", "noisemap", "onestep", "rings",
           "scatter", "scatter_physics", "siddon", "spectral", "truncation"]
