"""K24's device time cut after each of its phases, on the card.

    python -m dexct_tpu_torch.tools.probe_dose3d [--every 30] [--reps 3]

Run from the repository root.  Builds three copies of
``dexct_tpu_torch/csrc/dose.cu`` with nvcc: as it is, cut after building
T (each chunk's column search and dose terms skipped), and cut after the
column search (the dose terms skipped; the queue is still filled), and
times each (CUDA events, after a warm-up call, ``--reps`` calls) on
``chip_smoke.py``'s phase-3 workload of K24: the repo's cone config (360
views x 16 rows x 256 channels, the 256^2 x 32 pelvis at 0.2 cm) and its
helical config (720 views over two turns, pitch 3 cm, the 256^2 x 48
pelvis, its z-slab window), 80 kV, every ``--every``-th view (30 and 60
by default).  The cuts differ from the whole kernel only where they stop,
so the differences of their times are the phases' shares.  Prints the
card's name and power limit, then one JSON line per config:
``{"config", "views", "full_ms", "cut_after_T_ms", "cut_after_search_ms"}``.
Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["main"]

# where the cuts go: before the chunk's column search, and at the top of
# the dose term of one queued voxel
_SEARCH = "    // 2. the voxel columns of the chunk's sector"
_TERM = "  auto serve_one = [&](int w, int nc, int q, int ra) {\n"
_CONFIGS = {
    "cone": (dict(scanner_geometry="cone_beam", N_projections=360), 32, 30),
    "helical": (dict(scanner_geometry="helical_cone_beam", N_projections=720,
                     rotation_angle_total=4.0 * 3.141592653589793,
                     pitch=3.0), 48, 60),
}


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _builds(out):
    """The whole source and its two cuts, each built into a library of
    ``out`` with the port's flags: {name: ctypes library}."""
    from ..utils import kernels

    src = (kernels.CSRC / "dose.cu").read_text()
    if src.count(_SEARCH) != 1 or src.count(_TERM) != 1:
        raise SystemExit("probe_dose3d: dose.cu no longer has its cut points")
    texts = {"full": src,
             "cut_after_T": src.replace(
                 _SEARCH, "    if (true) { __syncthreads(); continue; }\n"
                 + _SEARCH),
             "cut_after_search": src.replace(
                 _TERM, _TERM + "    if (ra >= 0) return;\n")}
    procs = {}
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")])
    libs = {}
    for name, proc in procs.items():
        if proc.wait():
            raise SystemExit(f"probe_dose3d: nvcc failed on the {name} copy")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.dexct_dose_3d.argtypes = kernels._SIGNATURES["dexct_dose_3d"]
        lib.dexct_dose_3d.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _workload(tmp, label, every, dev):
    """K24's arguments at chip_smoke.py's phase-3 shape of ``label``."""
    from ..ops import dose
    from ..pipeline.runner import _resolve_spectrum, default_generators
    from ..system.config import read_parameter_file
    from ..system.phantom import pelvis_phantom_3d

    spec, nz, _ = _CONFIGS[label]
    ph = pelvis_phantom_3d(N=256, nz=nz, dx=0.2, dz=0.2)
    ph.to_file(str(tmp / f"{label}.bin"), str(tmp / f"{label}.csv"))
    cfg = json.loads(Path("input/params.txt").read_text())
    cfg.update({"RUN_ID": label, "phantom_id": ph.name,
                "phantom_filename": str(tmp / f"{label}.bin"),
                "matcomp_filename": str(tmp / f"{label}.csv"),
                "Nx": 256, "Ny": 256, "Nz": nz, "dx": 0.2, "dy": 0.2,
                "dz": 0.2, "N_rows": 16, "detector_px_height": 0.25,
                "N_channels": 256, "SID": 60.0, "SDD": 100.0,
                "fan_angle_total": 0.8230337,
                "detector_filename": str(Path(cfg["detector_filename"])
                                         .resolve()),
                "N_recon_matrix": 256, "FOV_recon": 40.0, **spec})
    (tmp / f"{label}.txt").write_text(json.dumps(cfg))
    ccfg = read_parameter_file(str(tmp / f"{label}.txt"))[0]
    s80 = _resolve_spectrum("80kV", 1.0, ccfg.ct, "input/spectrum",
                            default_generators())
    args, _ = dose._dose_prep_3d(
        ccfg.phantom, ccfg.ct, s80, n_gamma=None, n_t=None, n_r=None,
        oversample=2, views=None, n_energy=None, view_weights=None,
        scoring="removed", z_window="auto", device=dev)
    args = list(args)
    for i in (4, 5, 6):  # betas, source z, view weights
        args[i] = args[i][::every].contiguous()
    return args


def _ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    from ..ops import dose
    from ..utils import kernels

    parser = argparse.ArgumentParser(
        description="K24's device time cut after each phase, on one CUDA "
                    "device.")
    parser.add_argument("--every", type=int, default=None,
                        help="every n-th view (default: chip_smoke.py's "
                             "30 on the cone, 60 on the helix)")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_dose3d: needs a CUDA device")
    dev = torch.device("cuda")
    print(_card_line())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        libs = _builds(tmp)
        library = kernels.library
        try:
            for label, (_, _, every) in _CONFIGS.items():
                work = _workload(tmp, label, args.every or every, dev)
                row = {"config": label, "views": int(work[4].shape[0])}
                for name, lib in libs.items():
                    kernels.library = lambda lib=lib: lib
                    row[f"{name}_ms"] = _ms(
                        lambda: dose._dose_accumulate_3d(*work), args.reps)
                print(json.dumps(row))
        finally:
            kernels.library = library


if __name__ == "__main__":
    main()
