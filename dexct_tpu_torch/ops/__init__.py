"""Device ops: exact Siddon trace (K1), polyenergetic counts (K2),
Gauss-Newton decomposition (K3), fan-beam and rebinned parallel FBP
(K4-K6), the Fourier projector (K7, K8), the cone-beam trace, FDK/helical
backprojectors and tilted-gantry resample (K10-K12, K16), the flat-panel
FDK (K13) and the Katsevich exact helical reconstruction (K14, K15)."""

from . import conebeam, fbp, fbp_fast, filters, flatpanel, fourier
from . import katsevich, matdecomp, siddon, spectral

__all__ = ["conebeam", "fbp", "fbp_fast", "filters", "flatpanel",
           "fourier", "katsevich", "matdecomp", "siddon", "spectral"]
