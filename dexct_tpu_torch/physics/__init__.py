"""Physics substrate: attenuation tables, spectra, detectors, materials
(host NumPy, shared with the JAX package's definitions)."""

from . import formfactor, pileup, xcom
from .detector import DetectorResponse, photon_counting_response, scintillator_response
from .materials import AIR, BONE, BUILTIN_MATERIALS, Material, MaterialTable, TISSUE, WATER
from .spectrum import Spectrum, kramers_spectrum, linac_spectrum, xRaySpectrum

mixatten = xcom.mixatten

__all__ = [
    "xcom",
    "formfactor",
    "pileup",
    "mixatten",
    "Spectrum",
    "xRaySpectrum",
    "kramers_spectrum",
    "linac_spectrum",
    "DetectorResponse",
    "scintillator_response",
    "photon_counting_response",
    "Material",
    "MaterialTable",
    "BUILTIN_MATERIALS",
    "TISSUE",
    "BONE",
    "WATER",
    "AIR",
]
