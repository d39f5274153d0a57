"""Learned image processing: inference of the vendored DnCNN denoiser.

Port of :mod:`dexct_tpu.learn` for inference only: `cnn` (the DnCNN
residual denoiser as a ``torch.nn.Module``), `train` (``HU_SCALE`` and the
HU-scaled inference wrapper) and `denoiser_io` (the flax checkpoint reader
and writer, and the vendored checkpoint the runner's ``--denoise`` stage
uses).
Training and the paired-scan dataset (``learn/train.py``'s loop,
``learn/data.py``) are not ported yet.
"""

from .cnn import DnCNN
from .denoiser_io import (default_weights_path, denoise_hu_batch,
                          load_default_denoiser, load_params, save_params)
from .train import HU_SCALE, apply_denoiser

__all__ = ["DnCNN", "HU_SCALE", "apply_denoiser", "load_params",
           "save_params",
           "load_default_denoiser", "default_weights_path",
           "denoise_hu_batch"]
