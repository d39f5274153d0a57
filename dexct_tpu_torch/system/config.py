"""Run configuration: JSON params files -> typed run configs.

Rebuild of the reference's ``read_parameter_file``
(reference main.py:19, main.py:89-94).  The params file is a JSON
object (input/params.txt:1-37) or a JSON list of such objects; the return
value is a list of :class:`RunConfig`, each of which ALSO unpacks like the
reference's 9-tuple::

    run_id, do_fp, do_bp = params[:3]     # main.py:91
    ct, phantom, spectrum = params[3:6]   # main.py:92
    N_matrix, FOV, ramp = params[6:9]     # main.py:93-94
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..physics.spectrum import Spectrum
from .geometry import GEOMETRY_REGISTRY, ScannerGeometry
from .phantom import VoxelPhantom

__all__ = ["RunConfig", "read_parameter_file"]


@dataclasses.dataclass
class RunConfig:
    run_id: str
    do_forward_projection: bool
    do_back_projection: bool
    ct: ScannerGeometry
    phantom: VoxelPhantom
    spectrum: Spectrum | None
    N_matrix: int
    FOV: float
    ramp: float
    raw: dict = dataclasses.field(default_factory=dict, repr=False)

    def _as_tuple(self):
        return (
            self.run_id,
            self.do_forward_projection,
            self.do_back_projection,
            self.ct,
            self.phantom,
            self.spectrum,
            self.N_matrix,
            self.FOV,
            self.ramp,
        )

    def __getitem__(self, idx):
        return self._as_tuple()[idx]

    def __iter__(self):
        return iter(self._as_tuple())

    def __len__(self):
        return 9


def _na(value):
    return value is None or (isinstance(value, str) and value.upper() == "NA")


def _build_geometry(cfg):
    kind = cfg.get("scanner_geometry", "fan_beam")
    if kind not in GEOMETRY_REGISTRY:
        raise ValueError(
            f"unknown scanner_geometry {kind!r}; known: "
            f"{sorted(GEOMETRY_REGISTRY)}"
        )
    common = dict(
        N_channels=int(cfg.get("N_channels", 800)),
        N_proj=int(cfg.get("N_projections", 1200)),
        rotation_total=float(cfg.get("rotation_angle_total", 2.0 * np.pi)),
        h_iso=float(cfg.get("detector_px_height", 1.0)),
        eid=str(cfg.get("detector_mode", "eid")).lower() == "eid",
        detector_file=(None if _na(cfg.get("detector_filename"))
                       else cfg.get("detector_filename")),
    )
    if kind in ("fan_beam", "cone_beam", "helical_cone_beam",
                "tilted_cone_beam", "flat_panel_cone_beam"):
        kw = dict(
            SID=float(cfg.get("SID", 60.0)),
            SDD=float(cfg.get("SDD", 100.0)),
            gamma_fan=float(cfg.get("fan_angle_total", 0.8230337)),
        )
        # 'inplane' on fan beams, 'z' on cone/helical; the geometry
        # constructors validate mode-vs-class
        kw["ffs"] = str(cfg.get("flying_focal_spot", "none")).lower()
        if not _na(cfg.get("ffs_delta")):
            kw["ffs_delta"] = float(cfg["ffs_delta"])
        if kind in ("cone_beam", "helical_cone_beam",
                    "tilted_cone_beam", "flat_panel_cone_beam"):
            kw["N_rows"] = int(cfg.get("N_rows", 16))
        if kind == "tilted_cone_beam":
            kw["tilt"] = float(cfg.get("gantry_tilt_rad", 0.0))
        if kind == "flat_panel_cone_beam" and not _na(
                cfg.get("detector_offset_channels")):
            # lateral panel shift [channels] — half-fan FOV enlargement
            kw["det_offset_ch"] = float(cfg["detector_offset_channels"])
        if kind == "helical_cone_beam":
            kw["pitch"] = float(cfg.get("pitch", 2.0))
        return GEOMETRY_REGISTRY[kind](**kw, **common)
    return GEOMETRY_REGISTRY[kind](
        detector_width=float(cfg.get("detector_width", 50.0)), **common
    )


def _build_phantom(cfg):
    if cfg.get("phantom_type", "voxel") != "voxel":
        raise ValueError(f"unknown phantom_type {cfg.get('phantom_type')!r}")
    return VoxelPhantom.from_file(
        name=cfg.get("phantom_id", "phantom"),
        filename=cfg["phantom_filename"],
        matcomp_csv=cfg["matcomp_filename"],
        Nx=int(cfg["Nx"]),
        Ny=int(cfg["Ny"]),
        Nz=int(cfg.get("Nz", 1)),
        dx=float(cfg.get("dx", 0.1)),
        dy=float(cfg.get("dy", 0.1)),
        dz=float(cfg.get("dz", 0.1)),
        z_index=int(cfg.get("z_index", 0)),
    )


def _build_spectrum(cfg):
    fname = cfg.get("spectrum_filename")
    if _na(fname):
        return None  # assigned later by the DECT driver (main.py:92)
    spec = Spectrum.from_file(fname, cfg.get("spectrum_id", ""))
    counts = cfg.get("N_photons_per_cm2_per_scan")
    if not _na(counts):
        spec.rescale_counts(float(counts) / max(spec.total_counts, 1e-300))
    return spec


_KNOWN_KEYS = frozenset({
    "RUN_ID", "forward_project", "back_project",
    "phantom_type", "phantom_id", "phantom_filename", "matcomp_filename",
    "Nx", "Ny", "Nz", "dx", "dy", "dz", "z_index",
    "scanner_geometry", "SID", "SDD", "N_channels", "N_projections",
    "N_rows", "pitch", "gantry_tilt_rad", "flying_focal_spot", "ffs_delta",
    "fan_angle_total", "rotation_angle_total", "detector_px_height",
    "detector_mode", "detector_filename", "detector_width",
    "spectrum_id", "spectrum_filename", "N_photons_per_cm2_per_scan",
    "N_recon_matrix", "FOV_recon", "ramp_filter_percent_Nyquist",
})


def parse_config_dict(cfg):
    """One JSON object -> RunConfig.

    Missing keys take the reference protocol's defaults (params.txt);
    unrecognized keys warn — a typo'd key (e.g. ``N_matrix`` for
    ``N_recon_matrix``) would otherwise silently run at the default.
    """
    unknown = set(cfg) - _KNOWN_KEYS
    if unknown:
        import warnings

        warnings.warn(
            f"unrecognized config keys (typo?): {sorted(unknown)}",
            stacklevel=2,
        )
    return RunConfig(
        run_id=str(cfg.get("RUN_ID", "run")),
        do_forward_projection=bool(cfg.get("forward_project", True)),
        do_back_projection=bool(cfg.get("back_project", True)),
        ct=_build_geometry(cfg),
        phantom=_build_phantom(cfg),
        spectrum=_build_spectrum(cfg),
        N_matrix=int(cfg.get("N_recon_matrix", 512)),
        FOV=float(cfg.get("FOV_recon", 50.0)),
        ramp=float(cfg.get("ramp_filter_percent_Nyquist", 0.8)),
        raw=dict(cfg),
    )


def read_parameter_file(path):
    """JSON params file -> list of RunConfig (main.py:89-90 contract).

    Relative paths inside the file resolve against the process CWD, matching
    the reference's ``./input/...`` convention (params.txt:8-9,28).
    """
    with open(os.fspath(path)) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [data]
    return [parse_config_dict(cfg) for cfg in data]
