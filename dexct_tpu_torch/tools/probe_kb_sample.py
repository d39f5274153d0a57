"""K7, the Fourier projector's Kaiser-Bessel sampler, on the card: its
time at the four shapes the paths launch it at, its pinned bits, and the
time of its shallow and steep lines apart.

    python dexct_tpu_torch/tools/probe_kb_sample.py [--root DIR] [--reps 20]
        [--sass] [--sass-dump FILE]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one script measures two commits on one card in one call.
The sampler's tables depend only on the image grid and the number of
lines, so each case builds the Fourier plan of an N^2 grid at n_theta lines
(:func:`sampler_tables`); the spectra are standard normal from
``numpy.random.default_rng(seed)`` (:func:`pin_case`).  The cases
(:data:`PIN_CASES`): the reference protocol's phantom grid (G = 512,
n_theta = 1024) at M = 6 images (the default path) and M = 1
(``iterative_2d``), the 512^2 reconstruction grid (G = 1024) at n_theta =
1024, M = 2 (``onestep``) and at n_theta = 512, M = 1 (``motion``'s joint
fit), a ragged 50^2 grid (G = 100, not a multiple of the tile) at 90 lines,
M = 3, and the reference grid at M = 16 (a z-stack batch).

Prints the card's name and power limit, then JSON lines:

- ``"k7_sass"`` (with ``--sass``): K7's registers, instructions by opcode
  and loops in the built library's SASS (``sass_stats.py``);
- ``"k7_tiles"``: where the checkout bins the samples by spectrum tile
  (``fourier.kb_tiles``), the binning's build time (host clock,
  synchronised; the least of three after a first), its bytes, work items
  and their largest and median sizes, for each case;
- ``"k7_time"``: K7's device time (20 calls in one CUDA graph, twice) and
  call (CUDA events over ``--reps`` calls, twice) at each path's shape and
  the z-stack batch, with its bound (the function's bytes over 3.35 TB/s).
  The graph's calls find the tables and spectra of the call before in the
  card's 50 MB L2, so each call is also timed after a pass over 256 MB
  that evicts them: ``device_ms_after_read`` after a sum of a 256 MB
  tensor (L2 left holding clean lines), ``device_ms_after_memset`` after a
  256 MB memset (L2 left holding dirty lines, whose write-back the call
  then pays); each a graph of 20 pass-and-call pairs less a graph of 20
  passes, twice;
- ``"k7_split"``: the device time of the reference plan's shallow lines
  (|cos theta| >= |sin theta|) and of its steep lines apart, at M = 6 and
  M = 1, each set of lines as tables of their own;
- ``"k7_bits"``: for each case, the sha1 of K7's output, whether two
  launches are bit-equal, and its largest difference from the plain
  version on the card (``kb_sample_plain``) with the largest |plain|.

Card only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

# name: (N, n_theta, images M, seed); G = 2 N
PIN_CASES = {
    "ref6": (256, 1024, 6, 71),
    "ref1": (256, 1024, 1, 72),
    "onestep2": (512, 1024, 2, 73),
    "motion1": (512, 512, 1, 74),
    "ragged": (50, 90, 3, 75),
    "zstack16": (256, 1024, 16, 76),
}
# the shapes the paths launch K7 at: the default path, iterative_2d,
# onestep, motion
PATH_SHAPES = ("ref6", "ref1", "onestep2", "motion1")
PEAK_BYTES_S = 3.35e12


def sampler_tables(fourier, n_img, n_theta, device):
    """(slice_idx, slice_w, phase_cos, phase_sin) of the Fourier plan of an
    ``n_img``^2 grid at ``n_theta`` lines on ``device`` (the tables depend
    on neither the pixel size nor the fan, so both are nominal)."""
    from dexct_tpu_torch.system import FanBeamGeometry
    from dexct_tpu_torch.system.phantom import VoxelPhantom

    grid = VoxelPhantom("grid", np.zeros((1, n_img, n_img), np.uint8),
                        ["air"], 0.1, 0.1, 0.1)
    plan = fourier.plan_fourier_projector(
        grid, FanBeamGeometry(N_channels=8, N_proj=4), n_theta=n_theta,
        device=device)
    return plan.slice_idx, plan.slice_w, plan.phase_cos, plan.phase_sin


def pin_case(name):
    """(N, n_theta, F) of case ``name``: F [M, 2N, 2N] complex64, its real
    and imaginary parts standard normal from ``default_rng(seed)``."""
    n_img, n_theta, m, seed = PIN_CASES[name]
    g = 2 * n_img
    x = np.random.default_rng(seed).standard_normal((m, g, g, 2),
                                                    dtype=np.float32)
    return n_img, n_theta, np.ascontiguousarray(x).view(np.complex64)[..., 0]


def output_sha1(spec):
    """sha1 of a complex64 tensor's bytes (on the host, C order)."""
    return hashlib.sha1(np.ascontiguousarray(
        spec.detach().cpu().numpy()).tobytes()).hexdigest()


def _sibling(name):
    """The probe ``name`` beside this file (not the measured checkout's),
    as a module."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _helpers():
    """The card line and timing helpers of the sibling probes."""
    return _sibling("probe_cone_adjoint")


def _bound_ms(args, out):
    n = sum(t.numel() * t.element_size() for t in (*args, out))
    return n / PEAK_BYTES_S * 1e3


def _cases(fourier, names):
    """{name: (the kb_sample arguments on the card)}, tables shared
    between cases of one grid."""
    import torch

    dev = torch.device("cuda")
    tables, out = {}, {}
    for name in names:
        n_img, n_theta, F = pin_case(name)
        key = (n_img, n_theta)
        if key not in tables:
            tables[key] = sampler_tables(fourier, n_img, n_theta, dev)
        out[name] = (torch.as_tensor(F, device=dev), *tables[key])
    return out


def _probe_tiles(fourier, cases):
    import torch

    if not hasattr(fourier, "kb_tiles"):
        return
    seen = set()
    for name, args in cases.items():
        if id(args[1]) in seen:
            continue
        seen.add(id(args[1]))
        G = args[0].shape[-1]
        builds = []
        for _ in range(4):  # the first warms the allocator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tiles = fourier._kb_tiles_build(*args[1:], G)
            torch.cuda.synchronize()
            builds.append((time.perf_counter() - t0) * 1e3)
        size = (tiles.items[1:] - tiles.items[:-1]).cpu()
        print(json.dumps({
            "probe": "k7_tiles", "case": name, "grid": G,
            "tile": fourier.KB_TILE, "item": fourier.KB_ITEM,
            "samples": int(args[4].numel()),
            "build_ms": min(builds[1:]), "build_ms_all": builds,
            "bytes": tiles.nbytes, "items": tiles.n_items,
            "largest_item": int(size.max()),
            "median_item": float(size.float().median())}))


def _probe_time(h, fourier, cases, reps):
    import torch

    scratch = torch.ones(64 << 20, device="cuda")  # 256 MB

    def after_ms(evict, call):
        def both():
            evict()
            return call()

        return h._graph_ms(both) - h._graph_ms(evict)

    for name in (*PATH_SHAPES, "zstack16"):
        args = cases[name]

        def call(args=args):
            return fourier.kb_sample(*args)

        out = call()
        rec = {"probe": "k7_time", "case": name, "grid": args[0].shape[-1],
               "n_theta": args[3].shape[0], "images": args[0].shape[0],
               "device_ms": [h._graph_ms(call), h._graph_ms(call)],
               "device_ms_after_read": [after_ms(scratch.sum, call)
                                        for _ in range(2)],
               "device_ms_after_memset": [after_ms(scratch.zero_, call)
                                          for _ in range(2)],
               "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)],
               "bound_ms": _bound_ms(args, out)}
        print(json.dumps(rec))
        del out
    del scratch
    torch.cuda.empty_cache()


def _lines(args, keep):
    """The kb_sample arguments cut to the lines ``keep`` [n_theta] bool, as
    contiguous tables of their own."""
    F, idx, w, pc, ps = args
    n_theta, nl = pc.shape
    return (F, idx.reshape(n_theta, nl)[keep].reshape(-1).contiguous(),
            w.reshape(n_theta, nl * 16)[keep].reshape(-1).contiguous(),
            pc[keep].contiguous(), ps[keep].contiguous())


def _probe_split(h, fourier, cases):
    import torch

    for name in ("ref6", "ref1"):
        args = cases[name]
        n_theta = args[3].shape[0]
        th = torch.arange(n_theta, dtype=torch.float64) * (np.pi / n_theta)
        shallow = (th.cos().abs() >= th.sin().abs()).to(args[1].device)
        for half, keep in (("shallow", shallow), ("steep", ~shallow)):
            cut = _lines(args, keep)

            def call(cut=cut):
                return fourier.kb_sample(*cut)

            print(json.dumps({
                "probe": "k7_split", "case": name, "half": half,
                "lines": int(keep.sum()),
                "device_ms": [h._graph_ms(call), h._graph_ms(call)]}))


def _probe_bits(fourier, cases):
    import torch

    for name, args in cases.items():
        a, b = fourier.kb_sample(*args), fourier.kb_sample(*args)
        want = fourier.kb_sample_plain(*args)
        torch.cuda.synchronize()
        print(json.dumps({
            "probe": "k7_bits", "case": name, "sha1": output_sha1(a),
            "two_launches_equal": bool(torch.equal(a, b)),
            "plain_max_diff": float((a - want).abs().max()),
            "max_abs": float(want.abs().max())}))
        del a, b, want
        torch.cuda.empty_cache()


def _probe_sass(kernels, dump):
    """K7's registers, instructions and loops in the built library
    (``sass_stats.py`` beside this file)."""
    stats = _sibling("sass_stats").kernel_stats(
        kernels.build(), ("kb_sample_kernel", "kb_tile_kernel"), dump)
    print(json.dumps({"probe": "k7_sass", "kernels": stats}))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--sass", action="store_true",
                        help="print K7's registers and loops from its SASS")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass, write K7's SASS here")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    h = _helpers()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_kb_sample: needs a CUDA device")
    from dexct_tpu_torch.ops import fourier
    from dexct_tpu_torch.utils import kernels

    if Path(fourier.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_kb_sample: imported {fourier.__file__}, "
                         f"not the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}")
    kernels.library()
    if args.sass:
        _probe_sass(kernels, dump)
    cases = _cases(fourier, PIN_CASES)
    _probe_tiles(fourier, cases)
    _probe_time(h, fourier, cases, args.reps)
    _probe_split(h, fourier, cases)
    _probe_bits(fourier, cases)


if __name__ == "__main__":
    main()
