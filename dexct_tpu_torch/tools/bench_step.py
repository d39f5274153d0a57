"""Wall time of one DE pair step of a 2-D path on the card, and the calls
of one step that synchronise the host with the card.

    python dexct_tpu_torch/tools/bench_step.py [--root DIR] [--reps 200]
        [--params P] [--projector fourier|siddon] [--recon parallel|fan]

Run it by path (or as ``python -m dexct_tpu_torch.tools.bench_step``)
from the repository root.  ``--root`` names the checkout whose
``dexct_tpu_torch`` is measured (default: the one holding this file), so
that one script measures two commits on one card in one call.  Packs the
first configuration of ``--params`` (default ``input/params.txt``) at the
reference protocol (detunedMV at 9 mGy and 80kV at 1 mGy, 50 Gauss-Newton
iterations) with ``pipeline.fused.pack_dect``: by default the Fourier
projector and the parallel reconstruction (the CLI's default path);
``--projector siddon --recon fan`` is the exact path (K1 and K4).  Calls
``dect_step`` once to warm up.  It then counts the calls of one more step
that synchronise the host with the card
(``torch.cuda.set_sync_debug_mode("warn")``), each named by the innermost
frames of the port that made it, and times ``--reps`` steps on the
host's clock, each ended by ``torch.cuda.synchronize()``.  Prints the
card's name and power limit, then one JSON line: ``{"path",
"syncs_per_step", "sync_sites", "mean_ms", "median_ms", "min_ms",
"max_ms", "reps"}``.  Card only.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

__all__ = ["main"]

_HERE = Path(__file__).resolve().parents[2]


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _site(stack, root):
    """The innermost two frames of the port in ``stack`` (this tool's
    left out), as ``file:line function`` from the checkout's root; where
    no frame of the port made the call, the innermost two of any file."""
    port = [f for f in stack
            if "dexct_tpu_torch" in f.filename
            and not f.filename.endswith("bench_step.py")]
    if not port:
        port = [f for f in stack if not f.filename.endswith("warnings.py")]
    names = []
    for f in reversed(port[-2:]):
        try:
            name = str(Path(f.filename).resolve().relative_to(root))
        except ValueError:
            name = f.filename
        names.append(f"{name}:{f.lineno} {f.name}")
    return " < ".join(names)


def _syncs(step, root):
    """The calls of one ``step`` that synchronise the host with the card:
    {site: count}, each site named by :func:`_site`.  Only warnings raised
    while ``step`` runs count: switching the debug mode on warns once
    itself."""
    import torch

    sites = collections.Counter()
    in_step = []

    def show(message, category, filename, lineno, file=None, line=None):
        if in_step and "synchroniz" in str(message):
            sites[_site(traceback.extract_stack()[:-1], root)] += 1

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        in_step.append(True)
        try:
            step()
        finally:
            in_step.clear()
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return dict(sites)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Wall time of a 2-D DE pair step on one CUDA device.")
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--params", default="input/params.txt")
    parser.add_argument("--spectrum-dir", default="input/spectrum")
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--projector", default="fourier",
                        choices=("fourier", "siddon"))
    parser.add_argument("--recon", default="parallel",
                        choices=("parallel", "fan"))
    args = parser.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)  # the params file names its inputs from the root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_step: needs a CUDA device")
    from dexct_tpu_torch.pipeline import fused
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.system.config import read_parameter_file

    if Path(fused.__file__).resolve().parents[2] != root:
        raise SystemExit(f"bench_step: imported {fused.__file__}, not the "
                         f"checkout {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"{_card_line()} | torch {torch.__version__} | {root}")
    cfg = read_parameter_file(args.params)[0]
    gens = default_generators()
    spectra = [_resolve_spectrum(s, d, cfg.ct, args.spectrum_dir, gens)
               for s, d in (("detunedMV", 9.0), ("80kV", 1.0))]
    arrays, meta = fused.pack_dect(
        cfg.ct, cfg.phantom, *spectra, cfg.N_matrix, cfg.FOV, cfg.ramp,
        device=dev, n_iters=50, projector=args.projector, recon=args.recon)

    def step():
        return fused.dect_step(arrays, meta)

    step()
    torch.cuda.synchronize()
    sites = _syncs(step, root)
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    result = {"path": f"{args.projector}/{args.recon}",
              "syncs_per_step": sum(sites.values()), "sync_sites": sites,
              "mean_ms": statistics.fmean(walls),
              "median_ms": statistics.median(walls), "min_ms": min(walls),
              "max_ms": max(walls), "reps": args.reps}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
