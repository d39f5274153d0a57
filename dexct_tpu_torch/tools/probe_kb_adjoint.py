"""K21, the Fourier sampler's adjoint, on the card: its time at the three
plans the paths run it at, and the paths that launch it.

    python dexct_tpu_torch/tools/probe_kb_adjoint.py [--root DIR] [--reps 5]
                                                     [--paths]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` (and, with ``--paths``, ``chip_smoke.py``) is
measured (default: the one holding this file), so that one script measures
two commits on one card in one call.  The plans are ``chip_smoke.py``'s:
the reference protocol's phantom grid (G = 512, n_theta = 1024, one image,
as ``iterative_2d`` runs K21), the 512^2 reconstruction grid over the FOV
(G = 1024, n_theta = 1024, two images, as ``onestep`` does) and the same
grid at n_theta = 512 (one image, as ``motion``'s joint fit does); the
samples are drawn as phase 3 draws them (generator seed 7).

Prints the card's name and power limit, then one JSON line per plan
(``"probe": "k21"``): K21's call (CUDA events over ``--reps`` calls, after
a warm call, twice) and device time (20 calls in one CUDA graph), whether
two launches on the same input are bit-equal and whether the result is
bit-equal to the CPU's ``kb_sample_adjoint_plain`` (with the largest
difference of each); where the checkout builds K21's transposed table
(``fourier.kb_transpose``), the build's time (host clock, synchronised;
the least of three after a first), its bytes and long rows, K21's call
with a build per call, and the device time of the rows over 256 taps
alone.  With ``--paths`` it then runs ``chip_smoke.py``'s
``iterative_2d``, ``onestep`` and ``motion`` paths of that checkout (each
prints its runs' stage times and checks).

Card only.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parents[2]
_LONG = 256  # the rows timed alone


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(fn, reps):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, calls=20, reps=5):
    """chip_smoke's graph_ms: device time of one call, the host left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def _recon_grid(cfg):
    """chip_smoke's recon_grid: the N_matrix^2 grid over the FOV."""
    import numpy as np

    from dexct_tpu_torch.system.phantom import VoxelPhantom

    n, px = cfg.N_matrix, cfg.FOV / cfg.N_matrix
    return VoxelPhantom("recon_grid", np.zeros((1, n, n), np.uint8),
                        cfg.phantom.materials, px, px, px)


def long_rows(fourier, kb_t, n_cells):
    """The table cut to its rows of more than _LONG taps (the others
    empty; the dropped taps kept past the last row, where K21 reads
    none)."""
    import torch

    length = (kb_t.row_ptr[1:] - kb_t.row_ptr[:-1]).long()
    cells = torch.repeat_interleave(
        torch.arange(n_cells, device=length.device), length)
    keep = length[cells] > _LONG
    cut = fourier._pack_kb_transpose(cells[keep], kb_t.sample[keep],
                                     kb_t.weight[keep], n_cells)
    cut.entries = torch.cat([cut.entries, kb_t.entries[~keep]])
    return cut, int((length > _LONG).sum()), int(keep.sum())


def _probe_k21(fourier, label, plan, M, reps):
    import torch

    dev = torch.device("cuda")
    G = plan.grid
    tabs = (plan.slice_idx, plan.slice_w, plan.phase_cos, plan.phase_sin)
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.complex(*(torch.randn((M,) + tuple(plan.phase_cos.shape),
                                    generator=gen, device=dev)
                        for _ in range(2)))
    rec = {"probe": "k21", "plan": label, "grid": G,
           "n_theta": plan.n_theta, "images": M,
           "samples": plan.phase_cos.numel()}
    adjoint = fourier.kb_sample_adjoint
    if hasattr(fourier, "kb_transpose"):
        builds = []
        for _ in range(4):  # the first warms the allocator
            plan.kb_t = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kb_t = fourier.kb_transpose(plan)
            torch.cuda.synchronize()
            builds.append((time.perf_counter() - t0) * 1e3)
        rec.update(build_ms=min(builds[1:]), build_ms_all=builds,
                   table_bytes=sum(t.numel() * t.element_size()
                                   for t in (kb_t.row_ptr, kb_t.entries,
                                             kb_t.rows, kb_t.ell,
                                             kb_t.ell_offset)),
                   taps=kb_t.entries.shape[0], long_rows=kb_t.n_long)
        rec["call_with_build_ms"] = _time_ms(lambda: adjoint(g, *tabs, G),
                                             2)
        cut, n_rows, n_taps = long_rows(fourier, kb_t, G * G)
        rec.update(rows_over_256=n_rows, taps_over_256=n_taps,
                   rows_over_256_device_ms=_graph_ms(
                       lambda: adjoint(g, *tabs, G, kb_t=cut)))
        del cut

        def call():
            return adjoint(g, *tabs, G, kb_t=kb_t)
    else:
        def call():
            return adjoint(g, *tabs, G)

    rec["call_ms"] = [_time_ms(call, reps), _time_ms(call, reps)]
    rec["device_ms"] = _graph_ms(call)
    a, b = call(), call()
    torch.cuda.synchronize()
    rec["two_launches_equal"] = bool(torch.equal(a, b))
    rec["two_launches_max_diff"] = float((a - b).abs().max())
    cpu = fourier.kb_sample_adjoint_plain(g.cpu(), *(t.cpu() for t in tabs),
                                          G)
    rec["cpu_plain_equal"] = bool(torch.equal(a.cpu(), cpu))
    rec["cpu_plain_max_diff"] = float((a.cpu() - cpu).abs().max())
    rec["max_abs"] = float(cpu.abs().max())
    print(json.dumps(rec))
    del a, b, cpu
    torch.cuda.empty_cache()


def _paths(root, cfg, dev):
    """chip_smoke.py's iterative_2d, onestep and motion paths of the
    checkout at ``root``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)

    gens = default_generators()

    def spectra(ct):
        return (_resolve_spectrum("detunedMV", 9.0, ct, str(cs.SPECTRA),
                                  gens),
                _resolve_spectrum("80kV", 1.0, ct, str(cs.SPECTRA), gens))

    smi = _card_line()
    records = collections.defaultdict(lambda: {"launches": 0})
    cs.iterative_2d_path(cfg, records, smi, dev)
    cs.onestep_path(cfg, spectra, records, smi, dev)
    cs.motion_path(cfg, spectra, records, smi, dev)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=lambda p: Path(p).resolve(),
                        default=_HERE)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--paths", action="store_true")
    args = parser.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    sys.path.insert(0, str(args.root))
    os.chdir(args.root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("probe_kb_adjoint: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dexct_tpu_torch.ops import fourier
    from dexct_tpu_torch.system.config import read_parameter_file

    print(f"root {args.root}; {_card_line()}")
    dev = torch.device("cuda")
    cfg = read_parameter_file(args.root / "input" / "params.txt")[0]
    grid = _recon_grid(cfg)
    for label, make, M in (
            ("reference", lambda: fourier.plan_fourier_projector(
                cfg.phantom, cfg.ct, device=dev), 1),
            ("onestep", lambda: fourier.plan_fourier_projector(
                grid, cfg.ct, device=dev), 2),
            ("motion", lambda: fourier.plan_fourier_projector(
                grid, cfg.ct, n_theta=512, device=dev), 1)):
        _probe_k21(fourier, label, make(), M, args.reps)
    if args.paths:
        _paths(args.root, cfg, dev)


if __name__ == "__main__":
    main()
