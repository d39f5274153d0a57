"""Scanner geometry models.

Rebuild of the reference's (missing) ``xtomosim.system`` geometry class —
README.md:14 calls it "ScannerGeometry", the analysis script constructs
``FanBeamGeometry(N_channels=800, N_proj=1200, gamma_fan=0.8230337, SID=60.0,
SDD=100.0, h_iso=1.0, eid=True, detector_file=...)``
(reference plots.py:109-111).  Attribute surface pinned by call sites:
``.A_iso``/``.N_proj`` (main.py:68), ``.det_E``/``.det_eta_E``/``.eid``
(matdecomp.py:146-148).

Coordinate conventions (self-consistent across projector, backprojector and
phantom; SURVEY.md §3.3):

* World (x, y) in cm, isocenter at the origin.  Array index ``[iy, ix]``
  maps to ``x = (ix + 0.5 - Nx/2) dx``, ``y = (iy + 0.5 - Ny/2) dy``.
* Source at view angle beta: ``p_src = SID (cos beta, sin beta)``.
* Channel c has fan angle ``gamma_c = (c + 0.5 - N_channels/2) dgamma`` with
  ``dgamma = gamma_fan / N_channels``; its unit ray direction is
  ``-(cos(beta + gamma), sin(beta + gamma))``.
* ``A_iso = (SID dgamma) h_iso`` — effective channel area at isocenter used
  for the dose -> counts conversion (main.py:68; SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics.detector import DetectorResponse

__all__ = ["ScannerGeometry", "FanBeamGeometry", "ParallelBeamGeometry",
           "ConeBeamGeometry", "HelicalConeBeamGeometry",
           "TiltedConeBeamGeometry", "FlatPanelConeBeamGeometry",
           "GEOMETRY_REGISTRY"]


@dataclasses.dataclass
class ScannerGeometry:
    """Base CT acquisition geometry (shared channel/view bookkeeping)."""

    N_channels: int = 800
    N_proj: int = 1200
    rotation_total: float = 2.0 * np.pi  # JSON rotation_angle_total
    h_iso: float = 1.0  # detector row height at isocenter [cm]
    eid: bool = True  # energy-integrating (True) vs photon-counting
    detector_file: str | None = None
    detector: DetectorResponse | None = None

    def __post_init__(self):
        if self.detector is None:
            if self.detector_file:
                self.detector = DetectorResponse.from_file(self.detector_file)
            else:
                self.detector = DetectorResponse.ideal()

    # -- reference-compatible detector attributes (matdecomp.py:146) --------
    @property
    def det_E(self):
        return self.detector.E

    @property
    def det_eta_E(self):
        return self.detector.eta

    @property
    def betas(self):
        """View angles [rad], shape [N_proj]."""
        return (np.arange(self.N_proj) * self.rotation_total / self.N_proj)

    def detector_response(self, energy_keV):
        """eta(E) including EID energy weighting (matdecomp.py:146-148)."""
        return self.detector.response(energy_keV, eid=self.eid)


@dataclasses.dataclass
class FanBeamGeometry(ScannerGeometry):
    """Equiangular fan-beam geometry (params.txt:18-28).

    ``ffs='inplane'`` enables the in-plane flying focal spot: the focal
    spot alternates between two positions displaced tangentially by
    ``±ffs_delta/2`` on successive views (the anode-deflection trick of
    clinical scanners — beyond the reference, whose geometry is static).
    The detector arc stays centered on the NOMINAL focal spot, so the
    two view subsets sample interleaved radial positions; rebinning
    both subsets onto one parallel grid doubles the radial sampling
    density (see :mod:`dexct_tpu.ops.ffs`).  ``ffs_delta=None`` picks
    the quarter-offset optimum ``SID·dγ/2 · SDD/(SDD−SID)`` — the
    displacement whose central-ray interleave is exactly half a radial
    sample.
    """

    SID: float = 60.0  # source-isocenter distance [cm]
    SDD: float = 100.0  # source-detector distance [cm]
    gamma_fan: float = 0.8230337  # total fan angle [rad]
    ffs: str = "none"  # 'none' | 'inplane' ('z' on cone geometries)
    ffs_delta: float | None = None  # spot separation [cm]
    # detector arc offset in CHANNELS (miscalibration model / deliberate
    # quarter-channel offset): shifts every gamma by det_offset_ch*dgamma.
    # The calibration estimator (ops/calibration.py) recovers it from a
    # scan's conjugate-view consistency.
    det_offset_ch: float = 0.0

    _FFS_MODES = ("none", "inplane")

    def __post_init__(self):
        super().__post_init__()
        if self.ffs not in self._FFS_MODES:
            raise ValueError(
                f"unknown ffs mode {self.ffs!r} for "
                f"{type(self).__name__} (supports {self._FFS_MODES})")
        if self.ffs != "none":
            if self.N_proj % 2:
                raise ValueError(
                    "FFS alternates the spot per view; N_proj "
                    f"must be even (got {self.N_proj})")
            if self.ffs_delta is None:
                self.ffs_delta = self._ffs_default_delta()

    def _ffs_default_delta(self):
        """Quarter-offset optimum tangential spot separation [cm]: the
        displacement whose central-ray interleave is exactly half a
        radial sample (see class docstring)."""
        return (self.SID * self.dgamma / 2.0
                * self.SDD / (self.SDD - self.SID))

    @property
    def dgamma(self):
        return self.gamma_fan / self.N_channels

    @property
    def gammas(self):
        """Channel fan angles [rad], shape [N_channels]."""
        return (np.arange(self.N_channels) + 0.5 + self.det_offset_ch
                - self.N_channels / 2.0) * self.dgamma

    @property
    def A_iso(self):
        """Effective channel area at isocenter [cm^2] (SURVEY.md §2.3)."""
        return self.SID * self.dgamma * self.h_iso

    @property
    def fov_radius(self):
        """Radius of the fully-sampled field of view [cm]."""
        return self.SID * np.sin(self.gamma_fan / 2.0)

    @property
    def ffs_view_offsets(self):
        """Per-view focal-spot displacement [cm] (tangential for
        ffs='inplane', axial for ffs='z'), shape [N_proj]: even views
        +delta/2, odd views -delta/2 (zeros when ffs='none')."""
        if self.ffs == "none":
            return np.zeros(self.N_proj)
        half = 0.5 * float(self.ffs_delta)
        return np.where(np.arange(self.N_proj) % 2 == 0, half, -half)

    def ray_geometry(self):
        """All source points and unit ray directions.

        Returns ``(src, dirs)``, both shaped [N_proj, N_channels, 2]
        (float64) — the uniform contract shared by all geometries.
        With ``ffs='inplane'`` the source is displaced tangentially per
        view while the detector cells stay at their nominal positions
        (``p_det = SID·û(β) − SDD·û(β+γ)``), so rays are exact for the
        deflected spot.
        """
        betas = self.betas
        ang = betas[:, None] + self.gammas[None, :]
        if self.ffs == "none":
            src = self.SID * np.stack([np.cos(betas), np.sin(betas)], -1)
            src = np.broadcast_to(
                src[:, None, :], (self.N_proj, self.N_channels, 2)
            ).copy()
            dirs = -np.stack([np.cos(ang), np.sin(ang)], -1)
            return src, dirs
        u = np.stack([np.cos(betas), np.sin(betas)], -1)  # radial
        t_hat = np.stack([-np.sin(betas), np.cos(betas)], -1)
        src = self.SID * u + self.ffs_view_offsets[:, None] * t_hat
        det = (self.SID * u)[:, None, :] - self.SDD * np.stack(
            [np.cos(ang), np.sin(ang)], -1)
        d = det - src[:, None, :]
        dirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
        src = np.broadcast_to(
            src[:, None, :], (self.N_proj, self.N_channels, 2)
        ).copy()
        return src, dirs


@dataclasses.dataclass
class ParallelBeamGeometry(ScannerGeometry):
    """Parallel-beam geometry (extension; not in the reference snapshot).

    Channels are uniformly spaced detector positions spanning
    ``detector_width`` at the isocenter; all rays of a view share direction.
    """

    detector_width: float = 50.0  # [cm]
    source_radius: float = 100.0  # ray start offset [cm], outside any phantom

    def __post_init__(self):
        super().__post_init__()
        if self.rotation_total == 2.0 * np.pi:
            # parallel data is 180-degree complete; default accordingly
            self.rotation_total = np.pi

    @property
    def ds(self):
        return self.detector_width / self.N_channels

    @property
    def s_positions(self):
        """Lateral channel offsets [cm], shape [N_channels]."""
        return (np.arange(self.N_channels) + 0.5
                - self.N_channels / 2.0) * self.ds

    @property
    def A_iso(self):
        return self.ds * self.h_iso

    def ray_geometry(self):
        betas = self.betas
        n = np.stack([np.cos(betas), np.sin(betas)], -1)  # toward source
        t = np.stack([-np.sin(betas), np.cos(betas)], -1)  # lateral
        src = (self.source_radius * n[:, None, :]
               + self.s_positions[None, :, None] * t[:, None, :])
        dirs = np.broadcast_to(-n[:, None, :], src.shape).copy()
        return src, dirs


@dataclasses.dataclass
class ConeBeamGeometry(FanBeamGeometry):
    """Circular cone-beam geometry (3-D extension; the reference is
    strictly 2-D slice-based — plots.py:124-126 scans one z_index).

    A cylindrical detector centered on the source: ``N_channels`` columns
    at equiangular fan angles (inherited) and ``N_rows`` flat rows at
    heights ``z_iso`` (measured at the isocenter; ``h_iso`` is the row
    pitch there, matching the 2-D convention).  The central row (z=0) is
    exactly the parent fan-beam geometry, which anchors the test
    strategy: single-row cone scans must reproduce the fan pipeline.

    ``ffs='z'`` enables the Z flying focal spot (the longitudinal
    anode-deflection trick of clinical multi-row scanners): the focal
    spot alternates axially by ``±ffs_delta/2`` on successive views
    while the detector rows stay at their nominal gantry positions.
    The two view subsets sample row grids offset at the isocenter by
    ``∓(δ/2)·(SDD−SID)/SDD``, interleaving the longitudinal samples —
    the z-resolution/anti-aliasing analog of the in-plane FFS.
    ``ffs_delta=None`` picks ``h_iso·SDD / (2(SDD−SID))``, whose
    isocenter interleave is exactly half a row pitch.  (The in-plane
    mode stays 2-D-only: the packed cone tracer and FDK paths assume a
    circular in-plane orbit.)
    """

    N_rows: int = 16
    # axial detector offset in ROWS (misalignment model, the z analog
    # of det_offset_ch): shifts every z_iso by det_offset_row*h_iso.
    # The geometric-calibration estimator (ops/geocal.py) recovers it
    # from bead-phantom trajectories.
    det_offset_row: float = 0.0

    _FFS_MODES = ("none", "z")

    def _ffs_default_delta(self):
        """Axial spot separation [cm] whose isocenter row interleave is
        exactly half the row pitch ``h_iso``."""
        return self.h_iso * self.SDD / (2.0 * (self.SDD - self.SID))

    @property
    def z_iso(self):
        """Detector row heights at the isocenter [cm], shape [N_rows]."""
        return (np.arange(self.N_rows) + 0.5 + self.det_offset_row
                - self.N_rows / 2.0) * self.h_iso

    @property
    def cone_half_angle(self):
        """Largest |kappa| of any detector row [rad]."""
        return float(np.arctan2(np.abs(self.z_iso).max(), self.SID))

    def ray_geometry_3d(self):
        """All source points and unit ray directions in 3-D.

        Returns ``(src, dirs)``, both [N_proj, N_rows, N_channels, 3]
        (float64).  The source circles in the z=0 plane; a detector
        element at (row r, channel gamma) sits at
        ``S - SDD*e(beta+gamma) + (0,0, z_iso[r]*SDD/SID)``.

        With ``ffs='z'`` the source of view v is displaced axially by
        ``delta_v = ±ffs_delta/2`` while the detector element stays at
        its nominal gantry height, so the deflected ray's axial slope
        is ``(z_det[r] − delta_v)/SDD`` — exact, not a grid shift.
        """
        betas = self.betas
        V, R, C = self.N_proj, self.N_rows, self.N_channels
        src2 = self.SID * np.stack([np.cos(betas), np.sin(betas)], -1)
        off = self.ffs_view_offsets  # axial for ffs='z' (zeros if none)
        src = np.zeros((V, R, C, 3))
        src[..., :2] = src2[:, None, None, :]
        src[..., 2] = off[:, None, None]
        ang = betas[:, None] + self.gammas[None, :]  # [V, C]
        e = np.stack([np.cos(ang), np.sin(ang)], -1)  # [V, C, 2]
        z_det = self.z_iso * self.SDD / self.SID  # [R]
        d = np.zeros((V, R, C, 3))
        d[..., :2] = -self.SDD * e[:, None, :, :]
        d[..., 2] = z_det[None, :, None] - off[:, None, None]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return src, d


@dataclasses.dataclass
class TiltedConeBeamGeometry(ConeBeamGeometry):
    """Gantry-tilted circular cone-beam geometry: the whole gantry
    (source orbit + detector) is rotated by ``tilt`` radians about the
    patient x-axis — the clinical head-CT configuration (tilting out of
    the orbits / reducing posterior-fossa artifacts; typical |tilt| up
    to ~30°).  The scan is EXACTLY a standard circular cone-beam scan
    of the rigidly rotated patient, which is how the reconstruction
    works (:func:`~dexct_tpu.ops.conebeam.fdk_tilted_reconstruct`:
    gantry-frame FDK + one affine shear-resample back to the patient
    grid).  ``tilt = 0`` degenerates to :class:`ConeBeamGeometry`
    exactly (pinned in tests).
    """

    tilt: float = 0.0  # gantry tilt about the patient x-axis [rad]

    _FFS_MODES = ("none",)  # keep the first version static-spot

    def untilted(self):
        """The gantry-frame twin: the same scanner with ``tilt = 0``
        (used by the tilted FDK, which reconstructs in gantry
        coordinates)."""
        return dataclasses.replace(self, tilt=0.0)

    def ray_geometry_3d(self):
        """Parent rays rigidly rotated by R_x(tilt): (x, y, z) ->
        (x, c*y - s*z, s*y + c*z)."""
        src, d = super().ray_geometry_3d()
        c, s = np.cos(self.tilt), np.sin(self.tilt)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, c, -s],
                        [0.0, s, c]])
        return src @ rot.T, d @ rot.T


@dataclasses.dataclass
class HelicalConeBeamGeometry(ConeBeamGeometry):
    """Helical (spiral) cone-beam geometry: the source advances axially
    by ``pitch`` cm per 2*pi rotation while circling.  ``rotation_total``
    may exceed 2*pi for multi-turn scans; the trajectory is centered so
    the mid-scan source sits at z = 0.  ``pitch = 0`` degenerates to the
    circular :class:`ConeBeamGeometry` exactly (the tests pin it).
    """

    pitch: float = 2.0  # table feed per rotation [cm]

    @property
    def source_z(self):
        """Source z per view [cm], shape [N_proj]."""
        b = self.betas
        return (b - 0.5 * self.rotation_total) * self.pitch / (2.0 * np.pi)

    def ray_geometry_3d(self):
        """As the circular cone geometry, with source AND detector
        translated axially per view (the detector rides the gantry)."""
        src, d = super().ray_geometry_3d()
        src = src.copy()
        src[..., 2] += self.source_z[:, None, None]
        return src, d


@dataclasses.dataclass
class FlatPanelConeBeamGeometry(ConeBeamGeometry):
    """Flat-panel (equidistant-column) circular cone-beam geometry —
    the standard CBCT bench / C-arm configuration, beyond the
    reference's strictly equiangular fan (params.txt:18).

    The detector is a PLANE perpendicular to the central ray at
    distance ``SDD``: ``N_channels`` columns equally spaced on the
    panel (fan angles ``atan(u/SDD)`` — NOT equiangular) and
    ``N_rows`` equally spaced rows.  ``gamma_fan`` keeps its meaning
    as the TOTAL fan angle subtended, so the panel half-width at the
    isocenter scale is ``SID*tan(gamma_fan/2)`` and the column pitch
    is ``du_iso = 2*SID*tan(gamma_fan/2)/N_channels``; rows keep the
    ``h_iso``-at-isocenter convention.  ``det_offset_ch`` /
    ``det_offset_row`` shift the grids in pitch units, as for the
    cylindrical detector.

    Reconstruction goes through the flat-detector Feldkamp
    (:func:`dexct_tpu.ops.flatpanel.fdk_flat_reconstruct` — panel
    cosine pre-weight, equidistant ramp, ``SID^2/ell^2``
    backprojection weight); the equiangular FDK/FBP paths refuse this
    geometry.  Exact ray tracing is shared: :meth:`ray_geometry_3d`
    emits the exact per-element rays, and every sinogram-domain stage
    (spectral chain, decomposition, noise) is detector-agnostic.
    """

    flat_panel = True
    _FFS_MODES = ("none",)  # focal-spot deflection not modeled here

    @property
    def du_iso(self):
        """Column pitch at the isocenter scale [cm]."""
        return (2.0 * self.SID * np.tan(self.gamma_fan / 2.0)
                / self.N_channels)

    @property
    def u_iso(self):
        """Column positions at the isocenter scale [cm], [N_channels]."""
        return (np.arange(self.N_channels) + 0.5 + self.det_offset_ch
                - self.N_channels / 2.0) * self.du_iso

    @property
    def gammas(self):
        """Exact per-column fan angles [rad] — atan, not equiangular."""
        return np.arctan(self.u_iso / self.SID)

    @property
    def A_iso(self):
        """Central-channel effective area at isocenter [cm^2]."""
        return self.du_iso * self.h_iso

    def ray_geometry_3d(self):
        """Exact rays to the flat panel's element centers.

        A panel element (column u, row v) sits at
        ``src - SDD*e(beta) + u_p*t(beta) + (0, 0, v_p)`` with
        ``u_p = u_iso*SDD/SID``, ``v_p = z_iso*SDD/SID`` — so the
        in-plane direction angle is ``beta + atan(u_p/SDD)`` and the
        axial slope is ``v_p / hypot(SDD, u_p)`` (column-dependent,
        unlike the cylindrical detector's constant ``z_det/SDD``).
        """
        betas = self.betas
        V, R, C = self.N_proj, self.N_rows, self.N_channels
        u_p = self.u_iso * self.SDD / self.SID  # [C] panel coords
        gam = np.arctan(u_p / self.SDD)
        rho = np.hypot(self.SDD, u_p)  # [C] in-plane src->element
        z_p = self.z_iso * self.SDD / self.SID  # [R]
        src2 = self.SID * np.stack([np.cos(betas), np.sin(betas)], -1)
        src = np.zeros((V, R, C, 3))
        src[..., :2] = src2[:, None, None, :]
        ang = betas[:, None] + gam[None, :]  # [V, C]
        d = np.zeros((V, R, C, 3))
        d[..., 0] = -(rho * np.cos(ang))[:, None, :]
        d[..., 1] = -(rho * np.sin(ang))[:, None, :]
        d[..., 2] = z_p[None, :, None]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return src, d


GEOMETRY_REGISTRY = {
    "fan_beam": FanBeamGeometry,
    "parallel_beam": ParallelBeamGeometry,
    "cone_beam": ConeBeamGeometry,
    "helical_cone_beam": HelicalConeBeamGeometry,
    "tilted_cone_beam": TiltedConeBeamGeometry,
    "flat_panel_cone_beam": FlatPanelConeBeamGeometry,
}
