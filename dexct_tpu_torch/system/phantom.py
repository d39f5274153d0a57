"""Voxel phantoms: label volumes + material tables + analytic generators.

Rebuild of the reference's (missing) ``xtomosim.system.VoxelPhantom``
(constructed at reference plots.py:124-126 as
``VoxelPhantom(name, filename, matcomp_csv, Nx, Ny, Nz, z_index=0)``; JSON
keys incl. voxel sizes at params.txt:6-16).  The voxel file is a uint8
material-label volume (filename convention ``*_uint8_512_512_1_1mm.bin``,
SURVEY.md §2.4) whose labels index a materials CSV
(:mod:`dexct_tpu_torch.physics.materials`).

The reference's XCAT pelvis phantoms are not in the snapshot (SURVEY.md
§0.2); the generators at the bottom of this module synthesize equivalent
anthropomorphic and calibration phantoms from analytic shapes.

``M_mono(E0)`` is the analytic monoenergetic ground-truth HU image used as
the test oracle (plots.py:252, 290-301; SURVEY.md §4 item 1).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..physics import xcom
from ..physics.materials import (
    ADIPOSE,
    AIR,
    BONE,
    Material,
    MaterialTable,
    MUSCLE,
    STEEL_316L,
    TISSUE,
    TITANIUM,
    WATER,
)

__all__ = [
    "VoxelPhantom",
    "water_cylinder_phantom",
    "pelvis_phantom",
    "pelvis_phantom_3d",
    "head_phantom",
    "head_phantom_3d",
    "thorax_phantom",
    "thorax_phantom_3d",
    "contrast_rods_phantom",
    "qa_phantom",
]


@dataclasses.dataclass
class VoxelPhantom:
    """A voxelized object: uint8 labels [Nz, Ny, Nx] + material table.

    ``dx, dy, dz`` are voxel sizes in cm (params.txt:11-15); the grid is
    centered on the isocenter (geometry.py conventions).
    """

    name: str
    labels: np.ndarray  # uint8 [Nz, Ny, Nx]
    materials: MaterialTable
    dx: float = 0.1
    dy: float = 0.1
    dz: float = 0.1
    z_index: int = 0

    def __post_init__(self):
        self.labels = np.asarray(self.labels)
        if self.labels.ndim == 2:
            self.labels = self.labels[None]
        if self.labels.ndim != 3:
            raise ValueError("labels must be [Nz, Ny, Nx] or [Ny, Nx]")
        if self.labels.dtype != np.uint8:
            if self.labels.max(initial=0) > 255 or self.labels.min(initial=0) < 0:
                raise ValueError("labels out of uint8 range")
            self.labels = self.labels.astype(np.uint8)
        if int(self.labels.max()) >= len(self.materials):
            raise ValueError(
                f"label {int(self.labels.max())} exceeds material table size "
                f"{len(self.materials)}"
            )

    # -- shape properties ----------------------------------------------------
    @property
    def Nz(self):
        return self.labels.shape[0]

    @property
    def Ny(self):
        return self.labels.shape[1]

    @property
    def Nx(self):
        return self.labels.shape[2]

    @property
    def n_materials(self):
        return len(self.materials)

    def slice_labels(self, z_index=None):
        """The working 2-D label slice [Ny, Nx] (params.txt:16 z_index)."""
        z = self.z_index if z_index is None else z_index
        return self.labels[z]

    # -- physics -------------------------------------------------------------
    def mu_image(self, energy_keV, z_index=None):
        """Linear attenuation image(s) [1/cm].

        Scalar energy -> [Ny, Nx]; energy grid of length E -> [E, Ny, Nx].
        """
        e = np.atleast_1d(np.asarray(energy_keV, dtype=np.float64))
        lut = self.materials.mu_table(e)  # [n_mat, E]
        img = lut.T[:, self.slice_labels(z_index)]  # [E, Ny, Nx]
        return img[0] if np.isscalar(energy_keV) or np.ndim(energy_keV) == 0 else img

    def M_mono(self, E0, z_index=None):
        """Monoenergetic ground-truth HU image at energy ``E0`` keV.

        The analytic oracle of the reference (plots.py:252; air-mask
        threshold -900 HU at plots.py:226-231 confirms HU units).
        """
        mu = self.mu_image(float(E0), z_index)
        mu_w = float(xcom.mixatten("H(11.2)O(88.8)", float(E0)))
        return 1000.0 * (mu - mu_w) / mu_w

    def density_image(self, z_index=None):
        """Mass density image [g/cm^3]."""
        return self.materials.densities[self.slice_labels(z_index)]

    # -- IO (reference binary contract, SURVEY.md §2.4) ----------------------
    @classmethod
    def from_file(cls, name, filename, matcomp_csv, Nx, Ny, Nz=1,
                  dx=0.1, dy=0.1, dz=0.1, z_index=0):
        """Reference-compatible constructor (plots.py:124-126)."""
        labels = np.fromfile(os.fspath(filename), dtype=np.uint8)
        if labels.size != Nx * Ny * Nz:
            raise ValueError(
                f"{filename}: got {labels.size} voxels, expected "
                f"{Nx}*{Ny}*{Nz}"
            )
        labels = labels.reshape(Nz, Ny, Nx)
        materials = MaterialTable.from_csv(matcomp_csv)
        return cls(name, labels, materials, dx, dy, dz, z_index)

    def to_file(self, filename, matcomp_csv=None):
        self.labels.astype(np.uint8).tofile(os.fspath(filename))
        if matcomp_csv:
            self.materials.to_csv(matcomp_csv)


# ---------------------------------------------------------------------------
# Analytic generators (fill the missing input/phantom/ gap, SURVEY.md §0.2)
# ---------------------------------------------------------------------------

def _grid(N, d):
    """Pixel-center world coordinates for an N-wide axis."""
    return (np.arange(N) + 0.5 - N / 2.0) * d


def _ellipse_mask(N, d, cx, cy, rx, ry, angle=0.0):
    x = _grid(N, d)[None, :] - cx
    y = _grid(N, d)[:, None] - cy
    c, s = np.cos(angle), np.sin(angle)
    xr = c * x + s * y
    yr = -s * x + c * y
    return (xr / rx) ** 2 + (yr / ry) ** 2 <= 1.0


def water_cylinder_phantom(N=128, dx=0.1, radius_cm=None, name="water_cyl"):
    """Uniform water cylinder in air — the config-1 calibration phantom
    (BASELINE.json configs[0])."""
    radius = radius_cm if radius_cm is not None else 0.4 * N * dx
    labels = _ellipse_mask(N, dx, 0.0, 0.0, radius, radius).astype(np.uint8)
    return VoxelPhantom(name, labels, MaterialTable([AIR, WATER]),
                        dx, dx, dx)


def contrast_rods_phantom(N=256, dx=0.1, name="contrast_rods"):
    """Water cylinder with tissue/bone/adipose rod inserts — a CT
    quality-assurance style phantom for contrast/CNR studies."""
    body_r = 0.42 * N * dx
    rod_r = 0.07 * N * dx
    ring_r = 0.25 * N * dx
    labels = _ellipse_mask(N, dx, 0, 0, body_r, body_r).astype(np.uint8)
    rods = [TISSUE, BONE, ADIPOSE, MUSCLE]
    for i, _ in enumerate(rods):
        ang = 2.0 * np.pi * i / len(rods)
        cx, cy = ring_r * np.cos(ang), ring_r * np.sin(ang)
        labels[_ellipse_mask(N, dx, cx, cy, rod_r, rod_r)] = i + 2
    return VoxelPhantom(
        name, labels, MaterialTable([AIR, WATER] + rods), dx, dx, dx
    )


def pelvis_phantom(N=512, dx=0.1, implant=None, name=None):
    """Synthetic anthropomorphic pelvis slice.

    Replaces the reference's absent XCAT pelvis phantoms
    (``xcat_pelvis*_uint8_512_512_1_1mm.bin``, plots.py:120-127).  Label map:
    0 air, 1 adipose (subcutaneous), 2 soft tissue, 3 muscle, 4 bone,
    5 water (bladder), and optionally 6 = metal implant
    (``implant in {'titanium', 'steel'}`` mirrors the pelvis_titanium /
    pelvis_steel variants at plots.py:124-127).
    """
    half = N * dx / 2.0
    body_rx, body_ry = 0.82 * half, 0.58 * half
    labels = np.zeros((N, N), dtype=np.uint8)

    labels[_ellipse_mask(N, dx, 0, 0, body_rx, body_ry)] = 1  # adipose shell
    labels[_ellipse_mask(N, dx, 0, 0, 0.92 * body_rx, 0.88 * body_ry)] = 2

    # gluteal / paraspinal muscle masses
    for sx in (-1, 1):
        labels[_ellipse_mask(N, dx, sx * 0.45 * body_rx, -0.35 * body_ry,
                             0.30 * body_rx, 0.38 * body_ry,
                             angle=sx * 0.3)] = 3

    # bladder
    labels[_ellipse_mask(N, dx, 0.0, 0.12 * body_ry, 0.22 * body_rx,
                         0.30 * body_ry)] = 5

    # iliac wings
    for sx in (-1, 1):
        wing = _ellipse_mask(N, dx, sx * 0.52 * body_rx, 0.18 * body_ry,
                             0.16 * body_rx, 0.42 * body_ry,
                             angle=-sx * 0.5)
        inner = _ellipse_mask(N, dx, sx * 0.52 * body_rx, 0.18 * body_ry,
                              0.10 * body_rx, 0.34 * body_ry,
                              angle=-sx * 0.5)
        labels[wing & ~inner] = 4
    # sacrum
    labels[_ellipse_mask(N, dx, 0.0, -0.52 * body_ry, 0.18 * body_rx,
                         0.22 * body_ry)] = 4
    # femoral heads
    for sx in (-1, 1):
        labels[_ellipse_mask(N, dx, sx * 0.62 * body_rx, -0.30 * body_ry,
                             0.085 * body_rx, 0.12 * body_ry)] = 4

    mats = [AIR, ADIPOSE, TISSUE, MUSCLE, BONE, WATER]
    if implant:
        metal = {"titanium": TITANIUM, "steel": STEEL_316L}[implant]
        mats.append(metal)
        # implant replaces the right femoral head
        labels[_ellipse_mask(N, dx, 0.62 * body_rx, -0.30 * body_ry,
                             0.06 * body_rx, 0.09 * body_ry)] = 6

    default_name = "pelvis" + (f"_{implant}" if implant else "")
    return VoxelPhantom(name or default_name, labels, MaterialTable(mats),
                        dx, dx, dx)


def pelvis_phantom_3d(N=256, nz=32, dx=0.2, dz=None, implant=None,
                      name=None):
    """Z-varying anthropomorphic pelvis volume (a structurally richer
    stand-in for the reference's absent XCAT volumes, params.txt:8-9).

    Adds over :func:`pelvis_phantom`:

    * **cortical / trabecular split**: every bone is a cortical shell
      (ICRU cortical bone) around a red-marrow interior — the
      structure dual-energy decomposition actually has to separate;
    * **z-varying anatomy**: the body cross-section tapers toward the
      caudal end, the iliac wings exist only in the cranial half and
      flare with z, the femoral heads/necks appear caudally and turn
      into cortical-shaft + marrow-core cylinders, the bladder is a
      true ellipsoid, and a rectal gas pocket gives an interior air
      cavity (the hard case for helical/cone recon at sloped
      boundaries);
    * optional metal ``implant`` ('titanium' | 'steel') replacing the
      right femoral head across its slices.

    Labels: 0 air, 1 adipose, 2 soft tissue, 3 muscle, 4 cortical
    bone, 5 water (bladder), 6 red marrow, 7 implant.
    """
    from ..physics.materials import MARROW

    dz = dx if dz is None else dz
    half = N * dx / 2.0
    L = nz * dz
    zc = (np.arange(nz) + 0.5 - nz / 2.0) * dz
    labels = np.zeros((nz, N, N), dtype=np.uint8)

    for iz, z in enumerate(zc):
        u = z / (L / 2.0)  # -1 (caudal) .. +1 (cranial)
        lab = labels[iz]
        body_rx = 0.82 * half * (1.0 - 0.10 * max(-u, 0.0))
        body_ry = 0.58 * half * (1.0 - 0.14 * max(-u, 0.0))
        lab[_ellipse_mask(N, dx, 0, 0, body_rx, body_ry)] = 1
        lab[_ellipse_mask(N, dx, 0, 0, 0.92 * body_rx,
                          0.88 * body_ry)] = 2
        for sx in (-1, 1):
            lab[_ellipse_mask(N, dx, sx * 0.45 * body_rx,
                              -0.35 * body_ry, 0.30 * body_rx,
                              0.38 * body_ry, angle=sx * 0.3)] = 3

        # bladder: ellipsoid centered slightly cranial
        bz = (z - 0.1 * L / 2.0) / (0.45 * L / 2.0)
        if abs(bz) < 1.0:
            f = np.sqrt(1.0 - bz * bz)
            lab[_ellipse_mask(N, dx, 0.0, 0.12 * body_ry,
                              f * 0.22 * body_rx,
                              f * 0.30 * body_ry)] = 5

        # rectal gas pocket (interior air cavity, z-limited)
        rz = (z + 0.15 * L / 2.0) / (0.35 * L / 2.0)
        if abs(rz) < 1.0:
            f = np.sqrt(1.0 - rz * rz)
            wall = _ellipse_mask(N, dx, 0.0, -0.42 * body_ry,
                                 f * 0.10 * body_rx + 0.02 * body_rx,
                                 f * 0.10 * body_ry + 0.02 * body_ry)
            gas = _ellipse_mask(N, dx, 0.0, -0.42 * body_ry,
                                f * 0.08 * body_rx, f * 0.08 * body_ry)
            lab[wall] = 3
            lab[gas] = 0

        def shelled_bone(cx, cy, rx, ry, angle=0.0, shell=0.22):
            outer = _ellipse_mask(N, dx, cx, cy, rx, ry, angle=angle)
            inner = _ellipse_mask(N, dx, cx, cy, (1 - shell) * rx,
                                  (1 - shell) * ry, angle=angle)
            lab[outer] = 4       # cortical shell
            lab[inner] = 6       # trabecular marrow

        if u > -0.2:  # iliac wings flare cranially
            g = (u + 0.2) / 1.2
            for sx in (-1, 1):
                shelled_bone(sx * (0.42 + 0.12 * g) * body_rx,
                             0.18 * body_ry,
                             (0.10 + 0.07 * g) * body_rx,
                             (0.30 + 0.14 * g) * body_ry,
                             angle=-sx * 0.5, shell=0.30)
        # sacrum through most of the volume
        if u > -0.6:
            shelled_bone(0.0, -0.52 * body_ry, 0.18 * body_rx,
                         0.22 * body_ry, shell=0.35)
        if u < 0.1:  # femoral heads -> neck/shaft caudally
            g = min((0.1 - u) / 1.1, 1.0)
            for sx in (-1, 1):
                r_head = (0.085 - 0.02 * g) * body_rx
                if implant and sx > 0:
                    lab[_ellipse_mask(N, dx, 0.62 * body_rx,
                                      -0.30 * body_ry, r_head,
                                      1.3 * r_head)] = 7
                else:
                    shelled_bone(sx * 0.62 * body_rx, -0.30 * body_ry,
                                 r_head, 1.3 * r_head, shell=0.28)

    mats = [AIR, ADIPOSE, TISSUE, MUSCLE, BONE, WATER, MARROW]
    if implant:
        mats.append({"titanium": TITANIUM,
                     "steel": STEEL_316L}[implant])
    default_name = "pelvis3d" + (f"_{implant}" if implant else "")
    return VoxelPhantom(name or default_name, labels, MaterialTable(mats),
                        dx, dx, dz)


def head_phantom(N=512, dx=0.05, implant=None, name=None):
    """Synthetic anthropomorphic head slice — the classic
    beam-hardening / posterior-fossa testbed (beyond the reference's
    pelvis-only phantom set, plots.py:122-127).

    Label map: 0 air, 1 soft tissue (scalp), 2 cortical bone (skull
    shell + petrous ridges), 3 diploe (marrow between the skull
    tables), 4 brain (ICRU-44), 5 CSF (lateral ventricles + a thin
    subarachnoid rim), 6 frontal sinus air is label 0 again, and
    optionally 7 = dental/clip metal (``implant in {'titanium',
    'steel'}``).  Geometry is head-shaped (anterior-posterior long
    ellipse) with the thick-skull/petrous features that drive the
    classic interpetrous (Hounsfield-bar) hardening streaks.
    """
    from ..physics.materials import BRAIN, CSF, MARROW

    half = N * dx / 2.0
    rx, ry = 0.62 * half, 0.80 * half  # head: long axis anterior-post.
    labels = np.zeros((N, N), dtype=np.uint8)

    # scalp -> outer skull table
    labels[_ellipse_mask(N, dx, 0, 0, rx, ry)] = 1
    outer = _ellipse_mask(N, dx, 0, 0, 0.92 * rx, 0.94 * ry)
    inner = _ellipse_mask(N, dx, 0, 0, 0.80 * rx, 0.85 * ry)
    diplo = _ellipse_mask(N, dx, 0, 0, 0.86 * rx, 0.90 * ry)
    labels[outer] = 2           # outer table
    labels[diplo] = 3           # diploe (marrow)
    labels[_ellipse_mask(N, dx, 0, 0, 0.82 * rx, 0.87 * ry)] = 2
    labels[inner] = 4           # brain
    # thin subarachnoid CSF rim inside the inner table
    rim_out = _ellipse_mask(N, dx, 0, 0, 0.80 * rx, 0.85 * ry)
    rim_in = _ellipse_mask(N, dx, 0, 0, 0.76 * rx, 0.81 * ry)
    labels[rim_out & ~rim_in] = 5
    labels[rim_in] = 4

    # petrous ridges (dense bone wedges either side of the posterior
    # fossa — the interpetrous streak generator)
    for sx in (-1, 1):
        labels[_ellipse_mask(N, dx, sx * 0.42 * rx, -0.35 * ry,
                             0.22 * rx, 0.10 * ry,
                             angle=sx * 0.35)] = 2
    # lateral ventricles (CSF)
    for sx in (-1, 1):
        labels[_ellipse_mask(N, dx, sx * 0.16 * rx, 0.10 * ry,
                             0.10 * rx, 0.22 * ry,
                             angle=-sx * 0.25)] = 5
    # frontal sinus (interior air)
    labels[_ellipse_mask(N, dx, 0.0, 0.80 * ry, 0.14 * rx,
                         0.055 * ry)] = 0

    mats = [AIR, TISSUE, BONE, MARROW, BRAIN, CSF]
    if implant:
        metal = {"titanium": TITANIUM, "steel": STEEL_316L}[implant]
        mats.append(metal)
        # dental fillings: two small anterior metal blobs
        for sx in (-1, 1):
            labels[_ellipse_mask(N, dx, sx * 0.12 * rx, 0.64 * ry,
                                 0.030 * rx, 0.022 * ry)] = 6

    default_name = "head" + (f"_{implant}" if implant else "")
    return VoxelPhantom(name or default_name, labels,
                        MaterialTable(mats), dx, dx, dx)


def head_phantom_3d(N=256, nz=32, dx=0.1, dz=None, implant=None,
                    name=None):
    """Z-varying anthropomorphic head volume (cranial vault dome).

    Adds over :func:`head_phantom`: the head cross-section and skull
    shell follow an ellipsoidal vault (shrinking toward the vertex with
    the brain disappearing into diploe/table bone), the lateral
    ventricles and frontal sinus are z-limited bodies, the petrous
    ridges live only in the skull-base slices, and above the vertex the
    slices go to air — the hard z-gradient case for cone/helical
    reconstruction.  Labels as :func:`head_phantom`.
    """
    from ..physics.materials import BRAIN, CSF, MARROW

    dz = dx if dz is None else dz
    half = N * dx / 2.0
    L = nz * dz
    zc = (np.arange(nz) + 0.5 - nz / 2.0) * dz
    labels = np.zeros((nz, N, N), dtype=np.uint8)
    rx0, ry0 = 0.62 * half, 0.80 * half

    for iz, z in enumerate(zc):
        u = z / (0.5 * L)  # -1 skull base .. +1 vertex
        # vault: full section through the lower half, ellipsoidal
        # shrink toward the vertex, air above it
        f = 1.0 if u <= 0.1 else np.sqrt(max(
            1.0 - ((u - 0.1) / 0.85) ** 2, 0.0))
        if f <= 0.05:
            continue
        rx, ry = f * rx0, f * ry0
        lab = labels[iz]
        lab[_ellipse_mask(N, dx, 0, 0, rx, ry)] = 1
        lab[_ellipse_mask(N, dx, 0, 0, 0.92 * rx, 0.94 * ry)] = 2
        lab[_ellipse_mask(N, dx, 0, 0, 0.86 * rx, 0.90 * ry)] = 3
        lab[_ellipse_mask(N, dx, 0, 0, 0.82 * rx, 0.87 * ry)] = 2
        # the brain is its own, slightly smaller ellipsoid — it
        # vanishes BEFORE the vault cap (top slices are solid
        # table/diploe bone, as anatomically)
        fb = np.sqrt(max(1.0 - ((u - 0.05) / 0.72) ** 2, 0.0)) \
            if u > 0.05 else 1.0
        if fb > 0.05:
            lab[_ellipse_mask(N, dx, 0, 0,
                              min(fb * 0.80 * rx0, 0.80 * rx),
                              min(fb * 0.85 * ry0, 0.85 * ry))] = 5
            lab[_ellipse_mask(N, dx, 0, 0,
                              min(fb * 0.76 * rx0, 0.76 * rx),
                              min(fb * 0.81 * ry0, 0.81 * ry))] = 4
        if u < -0.45:  # petrous ridges at the skull base
            for sx in (-1, 1):
                lab[_ellipse_mask(N, dx, sx * 0.42 * rx0, -0.35 * ry0,
                                  0.22 * rx0, 0.10 * ry0,
                                  angle=sx * 0.35)] = 2
        vz = (z + 0.05 * L) / (0.22 * L)  # ventricles: mid-head band
        if abs(vz) < 1.0:
            g = np.sqrt(1.0 - vz * vz)
            for sx in (-1, 1):
                lab[_ellipse_mask(N, dx, sx * 0.16 * rx0, 0.10 * ry0,
                                  g * 0.10 * rx0, g * 0.22 * ry0,
                                  angle=-sx * 0.25)] = 5
        sz_ = (z + 0.28 * L / 2.0) / (0.12 * L)  # frontal sinus band
        if abs(sz_) < 1.0 and f > 0.8:
            lab[_ellipse_mask(N, dx, 0.0, 0.80 * ry, 0.14 * rx,
                              0.055 * ry)] = 0
        if implant and -0.55 < u < -0.25:  # dental metal band
            for sx in (-1, 1):
                lab[_ellipse_mask(N, dx, sx * 0.12 * rx0, 0.64 * ry0,
                                  0.030 * rx0, 0.022 * ry0)] = 6

    mats = [AIR, TISSUE, BONE, MARROW, BRAIN, CSF]
    if implant:
        mats.append({"titanium": TITANIUM,
                     "steel": STEEL_316L}[implant])
    default_name = "head3d" + (f"_{implant}" if implant else "")
    return VoxelPhantom(name or default_name, labels,
                        MaterialTable(mats), dx, dx, dz)


def thorax_phantom(N=512, dx=0.1, implant=None, name=None):
    """Synthetic anthropomorphic thorax slice (mid-chest level).

    The missing anatomy class between the pelvis and head phantoms, and
    the natural testbed for the motion/gated subsystems (breathing) and
    for strong-contrast objects in air-like background (lung nodules,
    rib streaks).  Label map: 0 air, 1 adipose (subcutaneous), 2 soft
    tissue, 3 muscle (paraspinal), 4 bone (ribs, spine, sternum),
    5 lung parenchyma (ICRU-44 inflated, ~-740 HU), 6 blood (heart
    chambers + descending aorta), and optionally 7 = metal
    (``implant in {'titanium', 'steel'}`` — a fixation plate on the
    sternum, the classic cardiac-adjacent metal case).
    """
    from ..physics.materials import BLOOD, LUNG

    half = N * dx / 2.0
    rx, ry = 0.90 * half, 0.64 * half  # wide axial chest ellipse
    labels = np.zeros((N, N), dtype=np.uint8)

    labels[_ellipse_mask(N, dx, 0, 0, rx, ry)] = 1  # adipose shell
    labels[_ellipse_mask(N, dx, 0, 0, 0.93 * rx, 0.90 * ry)] = 2

    # paraspinal muscles
    for sx in (-1, 1):
        labels[_ellipse_mask(N, dx, sx * 0.16 * rx, -0.62 * ry,
                             0.14 * rx, 0.18 * ry, angle=sx * 0.2)] = 3

    # lungs (posterior-weighted, slightly rotated)
    for sx in (-1, 1):
        labels[_ellipse_mask(N, dx, sx * 0.42 * rx, -0.05 * ry,
                             0.34 * rx, 0.62 * ry, angle=-sx * 0.12)] = 5

    # heart: blood mass center-left, anterior — carved out of the left
    # lung (as anatomically), plus a soft-tissue myocardial rim
    heart_out = _ellipse_mask(N, dx, -0.14 * rx, 0.18 * ry,
                              0.24 * rx, 0.30 * ry, angle=0.45)
    heart_in = _ellipse_mask(N, dx, -0.14 * rx, 0.18 * ry,
                             0.19 * rx, 0.24 * ry, angle=0.45)
    labels[heart_out] = 2
    labels[heart_in] = 6
    # descending aorta (left of the spine)
    labels[_ellipse_mask(N, dx, -0.10 * rx, -0.52 * ry,
                         0.045 * rx, 0.065 * ry)] = 6

    # spine: vertebral body + posterior arch around a canal
    labels[_ellipse_mask(N, dx, 0.0, -0.60 * ry, 0.10 * rx,
                         0.16 * ry)] = 4
    labels[_ellipse_mask(N, dx, 0.0, -0.58 * ry, 0.030 * rx,
                         0.045 * ry)] = 2  # spinal canal
    # sternum (anterior midline)
    labels[_ellipse_mask(N, dx, 0.0, 0.86 * ry, 0.10 * rx,
                         0.045 * ry)] = 4

    # rib cross-sections along the chest wall (inside the adipose
    # shell, tangentially oriented)
    rib_ts = np.deg2rad([25, 55, 85, 115, 145, 170])
    for sx in (-1, 1):
        for t in rib_ts:
            cx = sx * 0.84 * rx * np.sin(t)
            cy = 0.82 * ry * np.cos(t)
            tang = np.arctan2(0.82 * ry * -np.sin(t) * sx,
                              0.84 * rx * np.cos(t) * sx)
            labels[_ellipse_mask(N, dx, cx, cy, 0.045 * rx, 0.018 * rx,
                                 angle=tang)] = 4

    mats = [AIR, ADIPOSE, TISSUE, MUSCLE, BONE, LUNG, BLOOD]
    if implant:
        metal = {"titanium": TITANIUM, "steel": STEEL_316L}[implant]
        mats.append(metal)
        # sternal fixation plate
        labels[_ellipse_mask(N, dx, 0.0, 0.87 * ry, 0.060 * rx,
                             0.012 * rx)] = 7

    default_name = "thorax" + (f"_{implant}" if implant else "")
    return VoxelPhantom(name or default_name, labels, MaterialTable(mats),
                        dx, dx, dx)


def thorax_phantom_3d(N=256, nz=32, dx=0.2, dz=None, implant=None,
                      name=None):
    """Z-varying anthropomorphic thorax volume.

    Adds over :func:`thorax_phantom`: ellipsoidal lung apices/bases, a
    diaphragm dome rising into the right lung base (the high-contrast
    z-gradient that stresses cone/helical recon and breathing-motion
    studies), a z-limited heart, and ribs that appear only in
    alternating z-bands with a per-band angular advance (the real
    oblique rib-cage sampling pattern along z).  Labels as
    :func:`thorax_phantom`.
    """
    from ..physics.materials import BLOOD, LUNG

    dz = dx if dz is None else dz
    half = N * dx / 2.0
    L = nz * dz
    zc = (np.arange(nz) + 0.5 - nz / 2.0) * dz
    labels = np.zeros((nz, N, N), dtype=np.uint8)
    rx, ry = 0.90 * half, 0.64 * half

    for iz, z in enumerate(zc):
        u = z / (0.5 * L)  # -1 base .. +1 apex
        lab = labels[iz]
        lab[_ellipse_mask(N, dx, 0, 0, rx, ry)] = 1
        lab[_ellipse_mask(N, dx, 0, 0, 0.93 * rx, 0.90 * ry)] = 2
        for sx in (-1, 1):
            lab[_ellipse_mask(N, dx, sx * 0.16 * rx, -0.62 * ry,
                              0.14 * rx, 0.18 * ry, angle=sx * 0.2)] = 3
        # lungs: ellipsoidal caps (apex at u=+1, base at u=-1)
        fl = np.sqrt(max(1.0 - (u / 1.05) ** 2, 0.0))
        if fl > 0.05:
            for sx in (-1, 1):
                lab[_ellipse_mask(N, dx, sx * 0.42 * rx, -0.05 * ry,
                                  fl * 0.34 * rx, fl * 0.62 * ry,
                                  angle=-sx * 0.12)] = 5
            # diaphragm dome: soft tissue (liver) rises into the right
            # lung base — intrusion radius grows below the dome apex
            u_dome = -0.30
            if u < u_dome:
                g = np.sqrt(min((u_dome - u) / 0.7, 1.0))
                lab[_ellipse_mask(N, dx, 0.42 * rx, -0.05 * ry,
                                  min(g * 0.32 * rx, fl * 0.33 * rx),
                                  min(g * 0.60 * ry, fl * 0.60 * ry),
                                  angle=-0.12)] = 2
        # heart: mid-lower band
        hz = (z + 0.15 * L) / (0.30 * L)
        if abs(hz) < 1.0:
            g = np.sqrt(1.0 - hz * hz)
            lab[_ellipse_mask(N, dx, -0.14 * rx, 0.18 * ry,
                              g * 0.24 * rx, g * 0.30 * ry,
                              angle=0.45)] = 2
            lab[_ellipse_mask(N, dx, -0.14 * rx, 0.18 * ry,
                              g * 0.19 * rx, g * 0.24 * ry,
                              angle=0.45)] = 6
        # aorta + spine + sternum run the whole volume
        lab[_ellipse_mask(N, dx, -0.10 * rx, -0.52 * ry,
                          0.045 * rx, 0.065 * ry)] = 6
        lab[_ellipse_mask(N, dx, 0.0, -0.60 * ry, 0.10 * rx,
                          0.16 * ry)] = 4
        lab[_ellipse_mask(N, dx, 0.0, -0.58 * ry, 0.030 * rx,
                          0.045 * ry)] = 2
        lab[_ellipse_mask(N, dx, 0.0, 0.86 * ry, 0.10 * rx,
                          0.045 * ry)] = 4
        # ribs: alternating z-bands, each band's ring advanced by half
        # an intercostal step (oblique rib-cage pattern)
        band = int(np.floor((z + 0.5 * L) / (0.125 * L)))
        if band % 2 == 0:
            shift = np.deg2rad(7.5 * (band // 2))
            for sx in (-1, 1):
                for t in np.deg2rad([25, 55, 85, 115, 145, 170]) + shift:
                    cx = sx * 0.84 * rx * np.sin(t)
                    cy = 0.82 * ry * np.cos(t)
                    tang = np.arctan2(0.82 * ry * -np.sin(t) * sx,
                                      0.84 * rx * np.cos(t) * sx)
                    lab[_ellipse_mask(N, dx, cx, cy, 0.045 * rx,
                                      0.018 * rx, angle=tang)] = 4
        if implant and abs(hz) < 0.6:
            lab[_ellipse_mask(N, dx, 0.0, 0.87 * ry, 0.060 * rx,
                              0.012 * rx)] = 7

    mats = [AIR, ADIPOSE, TISSUE, MUSCLE, BONE, LUNG, BLOOD]
    if implant:
        mats.append({"titanium": TITANIUM,
                     "steel": STEEL_316L}[implant])
    default_name = "thorax3d" + (f"_{implant}" if implant else "")
    return VoxelPhantom(name or default_name, labels,
                        MaterialTable(mats), dx, dx, dz)


def qa_phantom(N=256, dx=0.1, name="qa"):
    """Catphan-style image-quality phantom + its measurement spec.

    One slice combining the classic QA modules (the physical phantoms a
    scanner's acceptance tests use; the reference's contrast/noise
    studies at plots.py:334-418 measure the same quantities ad hoc):

    - CT-number linearity ring: air / adipose / muscle / tissue / bone
      rod inserts at known positions,
    - a LOW-CONTRAST insert: water at +1 % density (~+10 HU),
    - the bone rod doubles as the high-contrast disk for circular-edge
      MTF measurement (`analysis.nps.mtf_from_disk_edge`),
    - the uniform water background provides uniformity / noise /
      NPS ROIs.

    Returns ``(VoxelPhantom, spec)`` where ``spec`` maps each insert
    name to ``{"center": (cy, cx) [cm], "radius": r [cm],
    "material": Material}`` plus body geometry — everything
    `analysis.qa.qa_report` needs to locate its ROIs.
    """
    body_r = 0.42 * N * dx
    rod_r = 0.06 * N * dx
    ring_r = 0.26 * N * dx
    water_lc = Material("water+1%", 1.01, WATER.matcomp)
    # insert ORDER is deliberate: the low-contrast rod sits 120+ deg
    # from both high-contrast inserts (bone, air) — their residual
    # beam-hardening streaks otherwise depress its neighborhood by
    # ~-8 HU under an unfiltered/un-BHC'd beam (measured; the imprint
    # itself is +9 HU), drowning a +10 HU module
    inserts = [
        ("bone", BONE),
        ("air", Material("air", AIR.density, AIR.matcomp)),
        ("adipose", ADIPOSE),
        ("muscle", MUSCLE),
        ("low_contrast", water_lc),
        ("tissue", TISSUE),
    ]
    labels = _ellipse_mask(N, dx, 0.0, 0.0, body_r, body_r).astype(np.uint8)
    spec = {"body_radius": body_r, "dx": dx, "inserts": {}}
    for i, (nm, mat) in enumerate(inserts):
        ang = 2.0 * np.pi * i / len(inserts)
        cx, cy = ring_r * np.cos(ang), ring_r * np.sin(ang)
        labels[_ellipse_mask(N, dx, cx, cy, rod_r, rod_r)] = i + 2
        spec["inserts"][nm] = {"center": (cy, cx), "radius": rod_r,
                               "material": mat}
    mats = [AIR, WATER] + [m for _, m in inserts]
    return VoxelPhantom(name, labels, MaterialTable(mats), dx, dx, dx), spec
