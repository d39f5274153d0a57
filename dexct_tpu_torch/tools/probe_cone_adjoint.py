"""K18 and K19, the exact 3-D Siddon projector and its adjoint, on the
card: their times at ``chip_smoke.py``'s phase-3 shape and on their
``cone_pwls`` path.

    python dexct_tpu_torch/tools/probe_cone_adjoint.py [--root DIR] [--reps 5]
        [--sass]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one script measures two commits on one card in one call.
The workload is chip_smoke's: the repo's cone config (360 views x 16 rows x
256 channels through the 256^2 x 32 pelvis at 0.2 cm), a random sinogram
drawn as phase 3 draws it (generator seed 6), and the ``cone_pwls`` path
of phase 4 (60 keV Poisson scan at 1e5 counts per ray, FDK warm start,
``cone_pwls_recon`` 60 iterations, ``cone_cg_recon`` 30).

Prints the card's name and power limit, then JSON lines:

- ``"k18"``: K18's device time (20 calls in one CUDA graph) on
  ``mu[labels]`` at 60 keV over all views, over the views whose central
  ray runs mostly along x (|d_x| > |d_y|) and over the rest (each set a
  contiguous copy of its views' rays), its call (CUDA events), whether two
  launches are bit-equal, and, where the checkout's K18 swaps the volume's
  x and y for its x-dominant warps (``conebeam._swap_xy``), that copy's
  device time;
- ``"k18_sass"`` (with ``--sass``): K18's registers, instructions by
  opcode and loops (``sass_stats.py``);
- ``"k19"``: K19's call (CUDA events over ``--reps`` calls, after a warm
  call) and device time (20 calls in one CUDA graph), whether two launches on the same input are bit-equal and their largest
  difference; where the checkout builds K19's transposed table
  (``conebeam.cone_transpose``), the build's time (host clock,
  synchronised; the least of three), its bytes, entries and padding, and
  K19's call with a build per call;
- ``"cone_pwls"``: per run the wall time, the stages, the gather launches,
  the table builds and the peak device memory;
- ``"cone_pwls_profile"``: one more run under torch.profiler: its wall,
  its device time (the device's own events: kernels and copies), K19's
  (the gather or atomic kernel), the build's kernels' and K18's device
  time, and K19's share of the run.

Card only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parents[2]
_N0 = 1.0e5  # chip_smoke's PWLS_N0
_KEV = 60.0  # chip_smoke's MONO_KEV


def _card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# chip_smoke.py's CONE_CONFIGS entries of the repo's cone and helical
# configurations (tools/bench_r3c.py:60-69, tools/bench_helical.py:62-66)
CONE_CONFIGS = {
    "cone": dict(scanner_geometry="cone_beam", N_projections=360,
                 phantom_nz=32),
    "helical": dict(scanner_geometry="helical_cone_beam", N_projections=720,
                    rotation_angle_total=4.0 * 3.141592653589793, pitch=3.0,
                    phantom_nz=48),
}


def _cone_config(root, tmp, label="cone"):
    """chip_smoke's cone (or helical) config: its params file and pelvis,
    read back."""
    from dexct_tpu_torch.system.config import read_parameter_file
    from dexct_tpu_torch.system.phantom import pelvis_phantom_3d

    spec = dict(CONE_CONFIGS[label])
    nz = spec.pop("phantom_nz")
    ph = pelvis_phantom_3d(N=256, nz=nz, dx=0.2, dz=0.2)
    ph.to_file(str(tmp / f"{label}.bin"), str(tmp / f"{label}.csv"))
    cfg = json.loads((root / "input" / "params.txt").read_text())
    cfg.update({"RUN_ID": label, "phantom_id": ph.name,
                "phantom_filename": str(tmp / f"{label}.bin"),
                "matcomp_filename": str(tmp / f"{label}.csv"),
                "Nx": 256, "Ny": 256, "Nz": nz, "dx": 0.2, "dy": 0.2,
                "dz": 0.2, "N_rows": 16, "detector_px_height": 0.25,
                "N_channels": 256, "SID": 60.0, "SDD": 100.0,
                "fan_angle_total": 0.8230337,
                "detector_filename": str(root / cfg["detector_filename"]),
                "N_recon_matrix": 256, "FOV_recon": 40.0, **spec})
    path = tmp / f"{label}.txt"
    path.write_text(json.dumps(cfg))
    return read_parameter_file(path)[0]


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


def _k18_inputs(ccfg):
    """chip_smoke's phase-3 K18 inputs: the cone rays [V, R, C, 3] and
    ``mu[labels]`` at 60 keV on the card."""
    import numpy as np
    import torch

    ct, ph = ccfg.ct, ccfg.phantom
    dev = torch.device("cuda")
    src, dirs = (torch.as_tensor(x, dtype=torch.float32,
                                 device=dev).contiguous()
                 for x in ct.ray_geometry_3d())
    mu = torch.as_tensor(ph.materials.mu_table(np.array([_KEV]))[:, 0],
                         dtype=torch.float32, device=dev)
    labels = torch.as_tensor(np.asarray(ph.labels), device=dev).long()
    return src, dirs, mu[labels].contiguous(), (ph.dx, ph.dy, ph.dz)


def _probe_k18(conebeam, ccfg, reps):
    import torch

    src, dirs, vol, vox = _k18_inputs(ccfg)
    centre = dirs[:, dirs.shape[1] // 2, dirs.shape[2] // 2]
    along_x = centre[:, 0].abs() > centre[:, 1].abs()
    rec = {"probe": "k18", "rays": src.numel() // 3,
           "shape": list(vol.shape), "views": src.shape[0],
           "x_dominant_views": int(along_x.sum())}
    for name, keep in (("all", None), ("x_dominant", along_x),
                       ("y_dominant", ~along_x)):
        s, d = ((src, dirs) if keep is None else
                (src[keep].contiguous(), dirs[keep].contiguous()))

        def fwd(s=s, d=d):
            return conebeam.project_volume_3d(vol, s, d, *vox)

        rec[f"device_ms_{name}"] = _graph_ms(fwd)
    def fwd():
        return conebeam.project_volume_3d(vol, src, dirs, *vox)

    rec["call_ms"] = [_time_ms(fwd, reps), _time_ms(fwd, reps)]
    a, b = fwd(), fwd()
    rec["two_launches_equal"] = bool(torch.equal(a, b))
    swap = getattr(conebeam, "_swap_xy", None)
    if swap is not None:
        rec["swap_device_ms"] = _graph_ms(lambda: swap(vol))
    print(json.dumps(rec))
    del a, b
    torch.cuda.empty_cache()


def _probe_sass(kernels):
    """K18's registers and the loops of its walk in the built library
    (``sass_stats.py`` beside this file)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "sass_stats.py"
    spec = importlib.util.spec_from_file_location("_sass_stats", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.kernel_stats(kernels.build(),
                             ("project_3d_kernel", "swap_xy"))
    print(json.dumps({"probe": "k18_sass", "kernels": stats}))


def _probe_k19(conebeam, ccfg, reps):
    import torch

    dev = torch.device("cuda")
    src, dirs, vol, vox = _k18_inputs(ccfg)
    shape = tuple(vol.shape)
    gen = torch.Generator(device=dev).manual_seed(6)
    y = torch.randn(src.shape[:-1], generator=gen, device=dev)
    rec = {"probe": "k19", "rays": int(y.numel()), "shape": list(shape)}
    adjoint = conebeam.project_volume_3d_adjoint
    table = None
    if hasattr(conebeam, "cone_transpose"):
        builds = []
        for _ in range(4):  # the first warms the allocator
            table = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = conebeam.cone_transpose(src, dirs, shape, *vox)
            torch.cuda.synchronize()
            builds.append((time.perf_counter() - t0) * 1e3)
        rec.update(build_ms=min(builds[1:]), build_ms_all=builds,
                   table_bytes=table.nbytes, entries=table.nnz,
                   slots=table.slots, padding=table.slots / table.nnz - 1.0,
                   blocks=len(table.blocks))
        rec["call_with_build_ms"] = _time_ms(
            lambda: adjoint(y, src, dirs, shape, *vox), 2)

        def call():
            return adjoint(y, src, dirs, shape, *vox, table=table)
    else:
        def call():
            return adjoint(y, src, dirs, shape, *vox)

    rec["k19_call_ms"] = [_time_ms(call, reps), _time_ms(call, reps)]
    rec["k19_device_ms"] = _graph_ms(call)
    a, b = call(), call()
    rec["two_launches_equal"] = bool(torch.equal(a, b))
    rec["two_launches_max_diff"] = float((a - b).abs().max())
    rec["max_abs"] = float(a.abs().max())
    print(json.dumps(rec))
    del table, a, b
    torch.cuda.empty_cache()


def _probe_pwls(conebeam, ccfg):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dexct_tpu_torch.ops.siddon import mono_sinogram

    ct, ph = ccfg.ct, ccfg.phantom
    dev = torch.device("cuda")
    shape = tuple(ph.labels.shape)
    vox = (ph.dx, ph.dy, ph.dz)
    n, fov = shape[-1], shape[-1] * ph.dx
    mu = torch.as_tensor(ph.materials.mu_table(np.array([_KEV]))[:, 0],
                         dtype=torch.float32, device=dev)
    adjoint = conebeam.project_volume_3d_adjoint
    build = getattr(conebeam, "cone_transpose", None)

    def run():
        t = {}
        t0 = time.perf_counter()

        def mark(name):
            nonlocal t0
            torch.cuda.synchronize()
            t[name] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()

        sino = mono_sinogram(conebeam.cone_material_paths(ph, ct, device=dev),
                             mu)
        mark("cone_material_paths + mono_sinogram")
        gen = torch.Generator(device=dev).manual_seed(5)
        counts = torch.clamp_min(torch.poisson(_N0 * torch.exp(-sino),
                                               generator=gen), 1.0)
        y = -torch.log(counts / _N0)
        mark("Poisson counts")
        fdk = conebeam.fdk_reconstruct(y, ct, n, fov, ccfg.ramp,
                                       nz_out=shape[0], dz_out=ph.dz)
        mark("FDK warm start")
        conebeam.cone_pwls_recon(y, counts, ct, shape, vox, n_iters=60,
                                 beta=3e-2, x0=torch.clamp_min(fdk, 0.0))
        mark("cone_pwls_recon (60 iterations)")
        conebeam.cone_cg_recon(y, ct, shape, vox, n_iters=30)
        mark("cone_cg_recon (30 iterations)")
        return t

    for i in (1, 2):
        adjoint.launches = 0
        if build is not None:
            build.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = run()
        print(json.dumps({
            "probe": "cone_pwls", "run": i, "wall_s": sum(t.values()) / 1e3,
            "stages_ms": t, "k19_launches": adjoint.launches,
            "builds": None if build is None else build.launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
    per = {}
    for e in prof.key_averages():
        # the device's own events (kernels, copies): an operator on the host
        # also carries the device time of the kernels it launched
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        per[e.key] = float(us or 0.0) / 1e3
    k19 = sum(ms for k, ms in per.items() if "backproject_3d" in k)
    tbuild = sum(ms for k, ms in per.items() if "transpose" in k)
    k18 = sum(ms for k, ms in per.items()
              if "project_3d_kernel" in k or "swap_xy" in k)
    print(json.dumps({
        "probe": "cone_pwls_profile", "wall_ms": wall,
        "device_ms": sum(per.values()), "k19_device_ms": k19,
        "build_device_ms": tbuild, "k18_device_ms": k18,
        "k19_share": (k19 + tbuild) / wall,
        "kernels_ms": {k: ms for k, ms in sorted(per.items(),
                                                 key=lambda kv: -kv[1])[:8]}}))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--sass", action="store_true",
                        help="print K18's registers and loops from its SASS")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)  # the params file names its inputs from the root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_cone_adjoint: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.utils import kernels

    if Path(conebeam.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_cone_adjoint: imported {conebeam.__file__}, "
                         f"not the checkout {root}")
    print(f"{_card_line()} | torch {torch.__version__} | {root}")
    kernels.library()
    if args.sass:
        _probe_sass(kernels)
    with tempfile.TemporaryDirectory() as tmp:
        ccfg = _cone_config(root, Path(tmp))
        _probe_k18(conebeam, ccfg, args.reps)
        _probe_k19(conebeam, ccfg, args.reps)
        _probe_pwls(conebeam, ccfg)


if __name__ == "__main__":
    main()
