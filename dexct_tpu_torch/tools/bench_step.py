"""Wall time of one DE pair step of the default path on the card.

    python -m dexct_tpu_torch.tools.bench_step [--reps 200] [--params P]

Run from the repository root.  Packs the first configuration of
``--params`` (default ``input/params.txt``) at the reference protocol
(detunedMV at 9 mGy and 80kV at 1 mGy, the Fourier projector, the
parallel reconstruction and 50 Gauss-Newton iterations: the CLI's default
path) with ``pipeline.fused.pack_dect`` and calls ``dect_step`` once to
warm up.  It then counts the calls of one more step that synchronise the
host with the card (``torch.cuda.set_sync_debug_mode("warn")``) and times
``--reps`` steps on the host's clock, each ended by
``torch.cuda.synchronize()``.  Prints the card's name and power limit,
then one JSON line: ``{"syncs_per_step", "mean_ms", "median_ms", "min_ms",
"max_ms", "reps"}``.  Card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
import warnings

import torch

__all__ = ["main"]


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _syncs(step):
    """The number of synchronising calls that one call of ``step`` makes."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return sum("synchronizing" in str(w.message) for w in seen)


def main(argv=None):
    from ..pipeline.fused import dect_step, pack_dect
    from ..pipeline.runner import _resolve_spectrum, default_generators
    from ..system.config import read_parameter_file

    parser = argparse.ArgumentParser(
        description="Wall time of the default DE pair step on one CUDA "
                    "device.")
    parser.add_argument("--params", default="input/params.txt")
    parser.add_argument("--spectrum-dir", default="input/spectrum")
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(_card_line())
    cfg = read_parameter_file(args.params)[0]
    gens = default_generators()
    spectra = [_resolve_spectrum(s, d, cfg.ct, args.spectrum_dir, gens)
               for s, d in (("detunedMV", 9.0), ("80kV", 1.0))]
    arrays, meta = pack_dect(cfg.ct, cfg.phantom, *spectra, cfg.N_matrix,
                             cfg.FOV, cfg.ramp, device=dev, n_iters=50,
                             projector="fourier", recon="parallel")

    def step():
        return dect_step(arrays, meta)

    step()
    torch.cuda.synchronize()
    syncs = _syncs(step)
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    result = {"syncs_per_step": syncs, "mean_ms": statistics.fmean(walls),
              "median_ms": statistics.median(walls), "min_ms": min(walls),
              "max_ms": max(walls), "reps": args.reps}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
