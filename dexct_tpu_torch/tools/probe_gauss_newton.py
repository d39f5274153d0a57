"""K3, the two-material Gauss-Newton decomposition, on the card: its time
at the three path shapes it is launched at, its bound, its SASS and the
sha1s of its pinned cases.

    python dexct_tpu_torch/tools/probe_gauss_newton.py [--root DIR]
        [--reps 20] [--sass] [--sass-dump FILE]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one script measures two commits on one card in one call.
The cases (:data:`PIN_CASES`, :func:`pin_case`): the counts of the three
paths' shapes, each made by the port's own trace (K1, or K10) and counts
(K2) from the reference protocol (``input/params.txt``, detunedMV at 9 mGy
and 80kV at 1 mGy): the exact path's 1000 x 800 rays (8e5 pixels, as
``chip_smoke.py``'s phase 3 solves them), the cone config's 360 x 16 x 256
(1.47M) and the helical config's 720 x 16 x 256 (2.95M), each solved with
its own pack's tables at 50 iterations; and the tests' golden case
(:func:`golden_case`, 4096 pixels under the linac / 80 kV pair) repeated
and cut to 1, 127, 129, 384 and 4097 pixels, ragged against any group of
128 x P pixels.

Prints the card's name and power limit, then JSON lines:

- ``"k3_sass"`` (with ``--sass``): K3's and K29's registers,
  instructions by opcode and loops in the built library's SASS
  (``sass_stats.py``); ``--sass-dump`` writes their SASS to a file;
- ``"k3_time"``: at each path shape, K3's device time (20 calls in one
  CUDA graph, twice) and call time (CUDA events over ``--reps`` calls,
  twice), its bound (17 float32 operations per pixel and table node, 40
  per pixel and iteration, over 67 TFLOP/s, as ``chip_smoke.py`` counts
  them) and the table nodes a pixel visits;
- ``"k3_bits"``: for each case, the sha1 of K3's output, whether two
  launches are bit-equal, and its largest difference from the plain
  version on the card relative to max(|a|, 1).

Card only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

# the paths' counts, then the golden case cut to ragged pixel counts
PIN_CASES = ("exact", "cone", "helical", "n1", "n127", "n129", "n384",
             "n4097")
PATH_SHAPES = ("exact", "cone", "helical")
PEAK_F32_S = 67e12
PEAK_BYTES_S = 3.35e12


def golden_case():
    """(counts [2, 4096], i0 [2, E], mus [2, E]) float32: 4096 pixels of
    two basis materials under the linac / 80 kV pair of a 64-channel EID
    fan (``_k3_golden_case`` of the card tests)."""
    from dexct_tpu_torch.ops.matdecomp import prepare_decomposition
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum
    from dexct_tpu_torch.system import FanBeamGeometry

    ct = FanBeamGeometry(N_channels=64, N_proj=64, eid=True)
    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    _, i0, mus = prepare_decomposition(ct, s1, s2)
    rng = np.random.default_rng(29)
    a = np.stack([rng.uniform(0, 40, 4096), rng.uniform(0, 6, 4096)], -1)
    counts = (np.exp(-a @ mus) @ i0.T).T.astype(np.float32)
    return counts, i0.astype(np.float32), mus.astype(np.float32)


def _spectra(ct, root):
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)

    gens = default_generators()
    return [_resolve_spectrum(s, d, ct, str(root / "input" / "spectrum"),
                              gens) for s, d in (("detunedMV", 9.0),
                                                 ("80kV", 1.0))]


def path_case(label, dev, root=_HERE):
    """(counts [2, P], i0, mus, keywords) of the path ``label`` ("exact",
    "cone" or "helical") on ``dev``: the pack's rays traced and counted
    by the port as ``chip_smoke.py``'s phase 3 does, and the pack's
    decomposition tables and schedule."""
    import torch

    from dexct_tpu_torch.ops import conebeam, siddon, spectral
    from dexct_tpu_torch.system.config import read_parameter_file

    root = Path(root)
    if label == "exact":
        from dexct_tpu_torch.pipeline.fused import pack_dect

        cfg = read_parameter_file(root / "input" / "params.txt")[0]
        a, meta = pack_dect(cfg.ct, cfg.phantom, *_spectra(cfg.ct, root),
                            cfg.N_matrix, cfg.FOV, cfg.ramp, device=dev,
                            n_iters=50, projector="siddon", recon="fan")
        paths = siddon.trace_paths(a["labels"], a["src"], a["dirs"],
                                   meta.dx, meta.dy,
                                   n_materials=meta.n_materials)
    else:
        from dexct_tpu_torch.pipeline.cone import pack_cone_dect

        with tempfile.TemporaryDirectory() as tmp:
            cfg = _sibling("probe_cone_adjoint")._cone_config(
                root, Path(tmp), label)
        a, meta = pack_cone_dect(cfg.ct, cfg.phantom,
                                 *_spectra(cfg.ct, root), cfg.N_matrix,
                                 cfg.FOV, cfg.ramp, device=dev, n_iters=50)
        paths = conebeam.trace_paths_3d(a["labels"], a["src"], a["dirs"],
                                        meta.dx, meta.dy, meta.dz,
                                        n_materials=meta.n_materials)
    counts = torch.stack([
        spectral.counts_from_paths(paths, a["mu_t" + s],
                                   a["i0_" + s]).reshape(-1)
        for s in ("1", "2")])
    kw = dict(n_iters=meta.n_iters, warm_nodes=meta.gn_warm_nodes)
    return counts, a["dec_i0"], a["dec_mus"], kw


def pin_case(name, dev, root=_HERE):
    """(counts, i0, mus, keywords) of the case ``name`` of
    :data:`PIN_CASES` on ``dev``: a path's counts, or the golden case
    repeated and cut to ``n`` pixels ("n<count>") at 50 iterations."""
    import torch

    if name in PATH_SHAPES:
        return path_case(name, dev, root)
    n = int(name[1:])
    counts, i0, mus = golden_case()
    counts = np.tile(counts, (1, -(-n // counts.shape[1])))[:, :n]
    return (*(torch.as_tensor(np.ascontiguousarray(x), device=dev)
              for x in (counts, i0, mus)), dict(n_iters=50))


def output_sha1(out):
    """sha1 of a tensor's bytes (on the host, C order)."""
    return hashlib.sha1(np.ascontiguousarray(
        out.detach().cpu().numpy()).tobytes()).hexdigest()


def nodes_per_pixel(e_full, n_iters=50, polish=4, warm_nodes=32):
    """(warm table nodes, table nodes a pixel visits) of the schedule:
    the warm phase on the moment-compressed table when the union grid has
    more than twice ``warm_nodes`` bins, then the polish on the full one
    (``matdecomp._tables``)."""
    e_warm = e_full
    if e_full > 2 * warm_nodes and n_iters > polish:
        seg = -(-e_full // warm_nodes)
        e_warm = -(-e_full // seg)
    n_pol = min(polish, n_iters)
    return e_warm, (n_iters - n_pol) * e_warm + n_pol * e_full


def bound_ms(counts, e_full, n_iters=50, warm_nodes=32):
    """(ms, "bytes" or "operations"): the larger of the bytes (counts read,
    areas written, tables read once) over 3.35 TB/s and the float32
    operations (17 a pixel and node, 40 a pixel and iteration) over 67
    TFLOP/s."""
    e_warm, nodes = nodes_per_pixel(e_full, n_iters, warm_nodes=warm_nodes)
    n_pix = counts.shape[1]
    t_bytes = (8 * n_pix + 8 * n_pix + 32 * (e_full + e_warm)) \
        / PEAK_BYTES_S * 1e3
    t_ops = n_pix * (17 * nodes + 40 * n_iters) / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sibling(name):
    """The probe ``name`` beside this file (not the measured checkout's),
    as a module."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_time(h, matdecomp, cases, reps):
    for name in PATH_SHAPES:
        counts, i0, mus, kw = cases[name]

        def call(args=(counts, i0, mus), kw=kw):
            return matdecomp.gauss_newton_solve(*args, **kw)

        b, by = bound_ms(counts, i0.shape[1], kw["n_iters"],
                         kw["warm_nodes"])
        print(json.dumps({
            "probe": "k3_time", "case": name, "pixels": counts.shape[1],
            "e_full": i0.shape[1],
            "e_warm": nodes_per_pixel(i0.shape[1], kw["n_iters"],
                                      warm_nodes=kw["warm_nodes"])[0],
            "nodes_per_pixel": nodes_per_pixel(
                i0.shape[1], kw["n_iters"], warm_nodes=kw["warm_nodes"])[1],
            "device_ms": [h._graph_ms(call), h._graph_ms(call)],
            "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)],
            "bound_ms": b, "bound_by": by}))


def _probe_bits(matdecomp, cases):
    import torch

    for name, (counts, i0, mus, kw) in cases.items():
        a = matdecomp.gauss_newton_solve(counts, i0, mus, **kw)
        b = matdecomp.gauss_newton_solve(counts, i0, mus, **kw)
        want = matdecomp.gauss_newton_solve_plain(counts, i0, mus, **kw)
        rel = ((a - want).abs() / want.abs().clamp_min(1.0)).max()
        torch.cuda.synchronize()
        print(json.dumps({
            "probe": "k3_bits", "case": name, "pixels": counts.shape[1],
            "sha1": output_sha1(a), "two_launches_equal": bool(
                torch.equal(a, b)),
            "plain_max_rel": float(rel)}))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--sass", action="store_true",
                        help="print K3's and K29's registers and loops")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass, write their SASS here")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    h = _sibling("probe_cone_adjoint")
    sys.path.insert(0, str(root))
    os.chdir(root)  # the params file names its inputs from the root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_gauss_newton: needs a CUDA device")
    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.utils import kernels

    if Path(matdecomp.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_gauss_newton: imported {matdecomp.__file__}"
                         f", not the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}")
    kernels.library()
    if args.sass:
        stats = _sibling("sass_stats").kernel_stats(
            kernels.build(), ("gauss_newton_kernel",
                              "gauss_newton_grouped_kernel"), dump)
        print(json.dumps({"probe": "k3_sass", "kernels": stats}))
    dev = torch.device("cuda")
    cases = {name: pin_case(name, dev, root) for name in PIN_CASES}
    _probe_time(h, matdecomp, cases, args.reps)
    _probe_bits(matdecomp, cases)


if __name__ == "__main__":
    main()
