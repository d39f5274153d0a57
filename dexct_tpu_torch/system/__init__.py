"""System models: scanner geometry, voxel and analytic phantoms, run
configuration."""

from .analytic import (
    AnalyticPhantom,
    Ellipse,
    pelvis_analytic,
    water_cylinder_analytic,
)
from .config import RunConfig, read_parameter_file
from .geometry import (
    ConeBeamGeometry,
    FanBeamGeometry,
    FlatPanelConeBeamGeometry,
    GEOMETRY_REGISTRY,
    HelicalConeBeamGeometry,
    ParallelBeamGeometry,
    ScannerGeometry,
    TiltedConeBeamGeometry,
)
from .phantom import (
    VoxelPhantom,
    contrast_rods_phantom,
    head_phantom,
    head_phantom_3d,
    pelvis_phantom,
    pelvis_phantom_3d,
    thorax_phantom,
    thorax_phantom_3d,
    water_cylinder_phantom,
)

__all__ = [
    "RunConfig",
    "read_parameter_file",
    "ScannerGeometry",
    "FanBeamGeometry",
    "ParallelBeamGeometry",
    "ConeBeamGeometry",
    "HelicalConeBeamGeometry",
    "TiltedConeBeamGeometry",
    "FlatPanelConeBeamGeometry",
    "GEOMETRY_REGISTRY",
    "VoxelPhantom",
    "water_cylinder_phantom",
    "contrast_rods_phantom",
    "pelvis_phantom",
    "pelvis_phantom_3d",
    "head_phantom",
    "head_phantom_3d",
    "thorax_phantom",
    "thorax_phantom_3d",
    "Ellipse",
    "AnalyticPhantom",
    "pelvis_analytic",
    "water_cylinder_analytic",
]
