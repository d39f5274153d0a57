"""K4, the fan-beam backprojector, on the card: its time at the exact
path's shape, its bits on the pinned cases, and what nvcc made of it.

    python dexct_tpu_torch/tools/probe_fan_backproject.py [--root DIR]
        [--reps 20] [--sass] [--sass-dump FILE]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one script measures two commits on one card in one call.
The workload is the exact path's (``--projector siddon --recon fan``):
filtered sinograms of 1000 views x 800 channels, the reference protocol's
view angles (``input/params.txt``: 6.283185 rad over 1000 views), SID 60
cm, dgamma 0.8230337 / 800, backprojected onto 512^2 pixels over 50 cm;
K = 4 images as ``dect_step`` launches it, K = 1 as ``fbp_recon`` does.
The sinograms are drawn with ``numpy.random.default_rng`` (see
:func:`pin_case`).

Prints the card's name and power limit, then JSON lines:

- ``"k4_sass"`` (with ``--sass``): each K4 instance's registers,
  instructions by opcode and loops (``sass_stats.py``);
  ``--sass-dump FILE`` also writes their SASS there;
- ``"k4_time"``: at K = 4 and K = 1, K4's device time (20 calls in one
  CUDA graph) and its call (CUDA events over ``--reps`` calls), twice;
- ``"k4_bits"``: for each case of :data:`PIN_CASES`, the sha1 of K4's
  output and whether two launches are bit-equal.

Card only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

# the reference protocol (input/params.txt)
REF_SID = 60.0
REF_FAN = 0.8230337
REF_ROTATION = 6.283185

# name -> (K images, views, channels, n_matrix, FOV [cm], rotation [rad],
# seed): the exact path's shape at K = 1, 3 and 4, and a ragged case whose
# image is a multiple of no pixel tile
PIN_CASES = {
    "k1": (1, 1000, 800, 512, 50.0, REF_ROTATION, 191),
    "k3": (3, 1000, 800, 512, 50.0, REF_ROTATION, 193),
    "k4": (4, 1000, 800, 512, 50.0, REF_ROTATION, 194),
    "ragged": (4, 90, 96, 70, 24.0, 2.0 * np.pi, 195),
}


def pin_case(name):
    """One case of :data:`PIN_CASES`: (q [K, V, C] float32, betas [V]
    float32, the arguments of ``fan_backproject_multi`` after (packed,
    K, betas)).  q is standard normal from ``default_rng(seed)``; the view
    angles are ``arange(V) * rotation / V`` in float64, then float32, as
    ``pack_dect`` makes them."""
    K, V, C, N, fov, rot, seed = PIN_CASES[name]
    q = np.random.default_rng(seed).normal(size=(K, V, C)).astype(np.float32)
    betas = (np.arange(V) * rot / V).astype(np.float32)
    return q, betas, (REF_SID, REF_FAN / C, C, N, fov, rot / V)


def output_sha1(img):
    """sha1 of a float32 image stack's bytes (on the host, C order)."""
    return hashlib.sha1(
        np.ascontiguousarray(img.detach().cpu().numpy()).tobytes()).hexdigest()


def _helpers():
    """The card line and timing helpers of the sibling probe, from this
    file's directory (not the measured checkout's)."""
    path = Path(__file__).resolve().parent / "probe_cone_adjoint.py"
    spec = importlib.util.spec_from_file_location("_probe_cone", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k4(fbp_fast, name):
    """K4's call on the card for case ``name``, its packed table built."""
    import torch

    q, betas, args = pin_case(name)
    dev = torch.device("cuda")
    packed = fbp_fast.pack_filtered(torch.as_tensor(q, device=dev))
    b = torch.as_tensor(betas, device=dev)
    K = q.shape[0]
    return lambda: fbp_fast.fan_backproject_multi(packed, K, b, *args)


def _probe_time(h, fbp_fast, reps):
    import torch

    for name in ("k4", "k1"):
        call = _k4(fbp_fast, name)
        rec = {"probe": "k4_time", "case": name,
               "device_ms": [h._graph_ms(call), h._graph_ms(call)],
               "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)]}
        print(json.dumps(rec))
        del call
        torch.cuda.empty_cache()


def _probe_bits(fbp_fast):
    import torch

    for name in PIN_CASES:
        call = _k4(fbp_fast, name)
        a, b = call(), call()
        print(json.dumps({"probe": "k4_bits", "case": name,
                          "sha1": output_sha1(a),
                          "two_launches_equal": bool(torch.equal(a, b)),
                          "max_abs": float(a.abs().max())}))
        del call, a, b
        torch.cuda.empty_cache()


def _probe_sass(kernels, dump):
    """K4's registers, instructions and loops in the built library
    (``sass_stats.py`` beside this file)."""
    path = Path(__file__).resolve().parent / "sass_stats.py"
    spec = importlib.util.spec_from_file_location("_sass_stats", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.kernel_stats(kernels.build(), ("fan_backproject_kernel",),
                             dump)
    print(json.dumps({"probe": "k4_sass", "kernels": stats}))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--sass", action="store_true",
                        help="print K4's registers and loops from its SASS")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass, write the loops' SASS here")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    h = _helpers()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_fan_backproject: needs a CUDA device")
    from dexct_tpu_torch.ops import fbp_fast
    from dexct_tpu_torch.utils import kernels

    if Path(fbp_fast.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_fan_backproject: imported "
                         f"{fbp_fast.__file__}, not the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}")
    kernels.library()
    if args.sass:
        _probe_sass(kernels, dump)
    _probe_time(h, fbp_fast, args.reps)
    _probe_bits(fbp_fast)


if __name__ == "__main__":
    main()
