"""Analysis: VMI synthesis, ROI metrics, registration, figure helpers.

Port of :mod:`dexct_tpu.analysis`: host NumPy, copied module by module
with the imports pointed at this package's ``physics`` and ``utils.io``
(``tests/test_torch_analysis.py`` holds every public function to the JAX
package's)."""

from .metrics import (
    Roi,
    cnr,
    contrast,
    crop_img,
    make_vmi,
    measure_roi,
    noise,
    nonair_mask,
    rmse,
    vmi_metric_curve,
)
from .loaders import load_basis_images, load_bhc_image, load_ct_image, load_sinogram
from .nps import (
    detectability_index,
    disk_task,
    mtf_from_disk_edge,
    neq,
    noise_power_spectrum,
    radial_average,
)
from .qa import format_qa_report, qa_report
from .products import (
    electron_density_map,
    iodine_map,
    vnc_image,
    zeff_image,
)
from .register import register_phantom_to_recon, rescale_shift

__all__ = [
    "vnc_image",
    "iodine_map",
    "electron_density_map",
    "zeff_image",
    "noise_power_spectrum",
    "radial_average",
    "mtf_from_disk_edge",
    "neq",
    "detectability_index",
    "disk_task",
    "make_vmi",
    "measure_roi",
    "Roi",
    "crop_img",
    "nonair_mask",
    "rmse",
    "cnr",
    "contrast",
    "noise",
    "vmi_metric_curve",
    "rescale_shift",
    "register_phantom_to_recon",
]
