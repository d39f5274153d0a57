"""Binary IO and the output file contract.

The reference persists every stage as flat float32 row-major binaries with
a fixed naming convention (decoded in SURVEY.md §2.6 from
/root/reference/main.py:121-169 and plots.py:173-207).  These helpers
reproduce that contract byte-for-byte so analysis tooling is drop-in
compatible.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

__all__ = [
    "write_f32",
    "read_f32",
    "acquisition_dir",
    "matdecomp_dir",
    "StageWriter",
]


def write_f32(path, array):
    """Write a float32 row-major flat binary (main.py:121-122 convention).

    ``array`` is a NumPy array or a tensor on any device (copied to the
    host first).
    """
    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    if hasattr(array, "detach"):
        array = array.detach().cpu().numpy()
    np.ascontiguousarray(array, np.float32).tofile(os.fspath(path))


def read_f32(path, shape=None):
    a = np.fromfile(os.fspath(path), dtype=np.float32)
    return a.reshape(shape) if shape is not None else a


def acquisition_dir(out_dir, run_id, spec_id, dose_mGy):
    """``output/{run}/{spec}_{dose:04d}uGy/`` (main.py:111)."""
    return os.path.join(out_dir, run_id,
                        f"{spec_id}_{int(dose_mGy * 1000):04d}uGy")


def matdecomp_dir(out_dir, run_id, spec_id1, spec_id2, d1_mGy, d2_mGy):
    """``output/{run}/matdecomp_{s1}_{s2}_{d1:04d}uGy_{d2:04d}uGy/``
    (main.py:147)."""
    return os.path.join(
        out_dir, run_id,
        f"matdecomp_{spec_id1}_{spec_id2}_"
        f"{int(d1_mGy * 1000):04d}uGy_{int(d2_mGy * 1000):04d}uGy",
    )


class StageWriter:
    """Persists pipeline stage artifacts per the reference contract.

    Every stage output doubles as a checkpoint: a crashed run resumes from
    the last persisted stage (the reference's incidental resilience model,
    SURVEY.md §5 checkpoint/resume).
    """

    def __init__(self, out_dir, run_id, param_file=None):
        self.out_dir = out_dir
        self.run_id = run_id
        self.run_dir = os.path.join(out_dir, run_id)
        os.makedirs(self.run_dir, exist_ok=True)
        if param_file and os.path.exists(param_file):
            # config copied for provenance (main.py:98)
            shutil.copy(param_file, os.path.join(self.run_dir, "params.txt"))

    def acquisition(self, spec_id, dose, sino_raw=None, sino_log=None,
                    recon_raw=None, recon_HU=None):
        d = acquisition_dir(self.out_dir, self.run_id, spec_id, dose)
        os.makedirs(d, exist_ok=True)
        named = {
            "sino_raw_float32.bin": sino_raw,
            "sino_log_float32.bin": sino_log,
            "recon_raw_float32.bin": recon_raw,
            "recon_HU_float32.bin": recon_HU,
        }
        for fname, arr in named.items():
            if arr is not None:
                write_f32(os.path.join(d, fname), arr)
        return d

    def matdecomp(self, spec_id1, spec_id2, d1, d2, mat_sinos=None,
                  mat_recons=None):
        d = matdecomp_dir(self.out_dir, self.run_id, spec_id1, spec_id2,
                          d1, d2)
        os.makedirs(d, exist_ok=True)
        if mat_sinos is not None:
            for i, arr in enumerate(mat_sinos):
                write_f32(os.path.join(d, f"mat{i + 1}_sino_float32.bin"),
                          arr)
        if mat_recons is not None:
            for i, arr in enumerate(mat_recons):
                write_f32(os.path.join(d, f"mat{i + 1}_recon_float32.bin"),
                          arr)
        return d

    def denoised(self, spec_id, dose, recon_raw=None, recon_HU=None):
        """``recon_denoised_{raw,HU}_float32.bin`` alongside the §2.6
        acquisition outputs — the learned-denoiser product extension
        (round-5; same extension discipline as the BHC artifacts)."""
        d = acquisition_dir(self.out_dir, self.run_id, spec_id, dose)
        os.makedirs(d, exist_ok=True)
        if recon_raw is not None:
            write_f32(os.path.join(d, "recon_denoised_raw_float32.bin"),
                      recon_raw)
        if recon_HU is not None:
            write_f32(os.path.join(d, "recon_denoised_HU_float32.bin"),
                      recon_HU)
        return d

    def bhc(self, phantom_id, spec_id, kind, recon_raw=None, recon_HU=None):
        """``{phantom}_bhc_{spec}/recon_{kind}BHC_{units}_float32.bin``
        (read-side contract at plots.py:184-195)."""
        d = os.path.join(self.out_dir, self.run_id,
                         f"{phantom_id}_bhc_{spec_id}")
        os.makedirs(d, exist_ok=True)
        if recon_raw is not None:
            write_f32(os.path.join(d, f"recon_{kind}BHC_raw_float32.bin"),
                      recon_raw)
        if recon_HU is not None:
            write_f32(os.path.join(d, f"recon_{kind}BHC_HU_float32.bin"),
                      recon_HU)
        return d
