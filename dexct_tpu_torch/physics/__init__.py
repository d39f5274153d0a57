"""Physics substrate: attenuation tables, spectra, detectors, materials
(host NumPy, shared with the JAX package's definitions)."""

from . import formfactor, pcd_response, pileup, xcom
from .detector import DetectorResponse, photon_counting_response, scintillator_response
from .duallayer import dual_layer_spectra, layer_absorptions, simulate_dual_layer_dect
from .materials import AIR, BONE, BUILTIN_MATERIALS, Material, MaterialTable, TISSUE, WATER
from .spectrum import Spectrum, kramers_spectrum, linac_spectrum, xRaySpectrum
from .spectrum_calibration import estimate_spectrum_em, wedge_transmissions

mixatten = xcom.mixatten

__all__ = [
    "xcom",
    "formfactor",
    "pileup",
    "pcd_response",
    "mixatten",
    "Spectrum",
    "xRaySpectrum",
    "estimate_spectrum_em",
    "wedge_transmissions",
    "kramers_spectrum",
    "linac_spectrum",
    "DetectorResponse",
    "scintillator_response",
    "photon_counting_response",
    "layer_absorptions",
    "dual_layer_spectra",
    "simulate_dual_layer_dect",
    "Material",
    "MaterialTable",
    "BUILTIN_MATERIALS",
    "TISSUE",
    "BONE",
    "WATER",
    "AIR",
]
