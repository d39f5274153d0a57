"""The learned denoiser's checkpoint and its batched inference.

Port of :mod:`dexct_tpu.learn.denoiser_io`:

* :func:`save_params` writes a :class:`DnCNN` as the JAX package's flax
  checkpoint ``.npz`` (the same keys, HWIO kernels, the architecture meta);
* :func:`load_params` reads a flax checkpoint ``.npz`` (path-keyed leaves
  such as ``['params']['Conv_0']['kernel']`` plus the ``__meta_features``
  and ``__meta_depth`` architecture entries) into a :class:`DnCNN`, turning
  the HWIO kernels into PyTorch's OIHW and checking every shape;
* :func:`load_default_denoiser` loads the port's copy of the vendored
  production checkpoint, ``learn/weights/dncnn_default.npz`` (byte-identical
  to the JAX package's; DnCNN features=48 depth=8), cached per process;
* :func:`denoise_hu_batch` denoises a [B, H, W] HU stack in one forward
  pass, as the runner's ``--denoise`` stage calls it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .cnn import DnCNN

__all__ = ["flax_key", "save_params", "load_params", "load_default_denoiser",
           "default_weights_path", "denoise_hu_batch"]

_META_PREFIX = "__meta_"
_CACHE = {}


def flax_key(layer, leaf):
    """The checkpoint key of ``leaf`` ('kernel' or 'bias') of the JAX
    model's ``Conv_{layer}``."""
    return f"['params']['Conv_{layer}']['{leaf}']"


def save_params(path, model, *, features=None, depth=None):
    """Write ``model`` (a :class:`DnCNN`) as one compressed ``.npz`` in the
    JAX package's checkpoint format, readable by :func:`load_params` and by
    ``dexct_tpu.learn.denoiser_io.load_params``: each ``Conv_i``'s HWIO
    kernel and bias under its flax key, plus ``__meta_features`` and
    ``__meta_depth``.  ``features`` and ``depth``, the JAX function's
    keywords, must match the model's when given."""
    for name, given in (("features", features), ("depth", depth)):
        if given is not None and int(given) != getattr(model, name):
            raise ValueError(f"{name}={given} but the model has "
                             f"{getattr(model, name)}")
    arrs = {}
    for i, conv in enumerate(model.convs):
        w = conv.weight.detach().to("cpu", torch.float32).numpy()
        arrs[flax_key(i, "kernel")] = np.ascontiguousarray(
            w.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        arrs[flax_key(i, "bias")] = conv.bias.detach().to(
            "cpu", torch.float32).numpy()
    arrs[_META_PREFIX + "features"] = np.asarray(model.features)
    arrs[_META_PREFIX + "depth"] = np.asarray(model.depth)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrs)


def load_params(path):
    """Load a checkpoint -> a :class:`DnCNN` holding its weights (CPU, eval
    mode).  Raises ``ValueError`` for a missing key or a shape the model
    does not take."""
    with np.load(path) as z:
        feats = int(z[_META_PREFIX + "features"])
        depth = int(z[_META_PREFIX + "depth"])
        stored = {k: z[k] for k in z.files
                  if not k.startswith(_META_PREFIX)}
    model = DnCNN(features=feats, depth=depth)
    state = {}
    for i, conv in enumerate(model.convs):
        o, c_in, kh, kw = conv.weight.shape
        for leaf, name, want, to_torch in (
                ("kernel", "weight", (kh, kw, c_in, o),
                 lambda a: a.transpose(3, 2, 0, 1)),  # HWIO -> OIHW
                ("bias", "bias", (o,), lambda a: a)):
            key = flax_key(i, leaf)
            if key not in stored:
                raise ValueError(f"checkpoint {path} is missing {key}")
            arr = stored[key]
            if arr.shape != want:
                raise ValueError(
                    f"checkpoint {path}: {key} has shape {arr.shape}, "
                    f"model expects {want}")
            state[f"convs.{i}.{name}"] = torch.as_tensor(
                np.ascontiguousarray(to_torch(arr)), dtype=torch.float32)
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


def default_weights_path():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "weights", "dncnn_default.npz")


def load_default_denoiser():
    """The vendored production checkpoint, cached per process."""
    path = default_weights_path()
    if path not in _CACHE:
        _CACHE[path] = load_params(path)
    return _CACHE[path]


def denoise_hu_batch(images_hu, *, model=None):
    """Denoise a [B, H, W] (or [H, W]) HU stack in one forward pass on the
    device of ``images_hu`` (a tensor; NumPy arrays run on the CPU), with
    the vendored default checkpoint unless ``model`` is given.  Returns a
    float32 tensor of the same shape on that device."""
    from .train import apply_denoiser

    if model is None:
        model = load_default_denoiser()
    return apply_denoiser(model, torch.as_tensor(images_hu))
