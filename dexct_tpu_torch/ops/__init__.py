"""Device ops: exact Siddon trace (K1), polyenergetic counts (K2),
Gauss-Newton decomposition (K3), fan-beam and rebinned parallel FBP
(K4-K6), the Fourier projector (K7, K8) and the cone-beam trace and
FDK/helical backprojectors (K10-K12)."""

from . import conebeam, fbp, fbp_fast, filters, fourier, matdecomp, siddon
from . import spectral

__all__ = ["conebeam", "fbp", "fbp_fast", "filters", "fourier",
           "matdecomp", "siddon", "spectral"]
