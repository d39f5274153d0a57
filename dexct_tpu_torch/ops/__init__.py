"""Device ops: exact Siddon trace (K1), polyenergetic counts (K2),
Gauss-Newton decomposition (K3) and fan-beam FBP (K4)."""

from . import fbp, fbp_fast, filters, matdecomp, siddon, spectral

__all__ = ["fbp", "fbp_fast", "filters", "matdecomp", "siddon", "spectral"]
