"""Read-side of the output file contract (SURVEY.md §2.6).

Equivalents of the reference's binary loaders: ``get_img_ct``
(plots.py:173-181), ``get_img_basismats`` (plots.py:199-207), and
``get_img_ct_BHC`` (plots.py:184-195) — drop-in path conventions so
artifacts written by either pipeline are interchangeable.
"""

from __future__ import annotations

import os


from ..utils.io import acquisition_dir, matdecomp_dir, read_f32
from .metrics import crop_img

__all__ = ["load_ct_image", "load_basis_images", "load_bhc_image",
           "load_sinogram"]


def load_ct_image(out_dir, run_id, spec_id, dose_mGy, n_matrix=512,
                  units="HU", crop=None):
    """recon image loader (plots.py:173-181 conventions)."""
    if units not in ("HU", "raw"):
        raise ValueError("units must be 'HU' or 'raw'")
    d = acquisition_dir(out_dir, run_id, spec_id, dose_mGy)
    m = read_f32(os.path.join(d, f"recon_{units}_float32.bin"),
                 (n_matrix, n_matrix))
    return crop_img(m, crop) if crop else m


def load_sinogram(out_dir, run_id, spec_id, dose_mGy, shape, kind="log"):
    """sino_{raw,log} loader."""
    if kind not in ("raw", "log"):
        raise ValueError("kind must be 'raw' or 'log'")
    d = acquisition_dir(out_dir, run_id, spec_id, dose_mGy)
    return read_f32(os.path.join(d, f"sino_{kind}_float32.bin"), shape)


def load_basis_images(out_dir, run_id, spec_id1, spec_id2, d1, d2,
                      n_matrix=512, crop=None):
    """mat{1,2}_recon loader (plots.py:199-207)."""
    d = matdecomp_dir(out_dir, run_id, spec_id1, spec_id2, d1, d2)
    m1 = read_f32(os.path.join(d, "mat1_recon_float32.bin"),
                  (n_matrix, n_matrix))
    m2 = read_f32(os.path.join(d, "mat2_recon_float32.bin"),
                  (n_matrix, n_matrix))
    if crop:
        m1, m2 = crop_img(m1, crop), crop_img(m2, crop)
    return m1, m2


def load_bhc_image(out_dir, run_id, phantom_id, spec_id, kind="bone",
                   units="HU", n_matrix=512, crop=None):
    """recon_{bone,water}BHC loader (plots.py:184-195)."""
    if kind not in ("bone", "water"):
        raise ValueError("kind must be 'bone' or 'water'")
    d = os.path.join(out_dir, run_id, f"{phantom_id}_bhc_{spec_id}")
    m = read_f32(os.path.join(d, f"recon_{kind}BHC_{units}_float32.bin"),
                 (n_matrix, n_matrix))
    return crop_img(m, crop) if crop else m
