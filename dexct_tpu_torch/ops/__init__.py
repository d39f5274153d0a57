"""Device ops: exact Siddon trace (K1) and its slice-batched form (K17),
polyenergetic counts (K2), Gauss-Newton decomposition (K3), fan-beam and
rebinned parallel FBP (K4-K6), the in-plane flying-focal-spot FBP (K5 at
16 taps, K6), the Fourier projector (K7, K8), beam-hardening correction,
the cone-beam trace, FDK/helical backprojectors and tilted-gantry resample
(K10-K12, K16), the flat-panel FDK (K13) and the Katsevich exact helical
reconstruction (K14, K15)."""

from . import bhc, conebeam, fbp, fbp_fast, ffs, filters, flatpanel, fourier
from . import katsevich, matdecomp, siddon, spectral

__all__ = ["bhc", "conebeam", "fbp", "fbp_fast", "ffs", "filters",
           "flatpanel", "fourier", "katsevich", "matdecomp", "siddon",
           "spectral"]
