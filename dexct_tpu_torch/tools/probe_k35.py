"""K35, the general Newton decomposition, on the card: its time at the
shapes the paths launch it at, its bounds, its SASS, the sha1s of its
pinned cases, and the steps of its redesign.

    python dexct_tpu_torch/tools/probe_k35.py [--root DIR] [--reps 5]
        [--sass] [--sass-dump FILE] [--steps] [--variants 0,1,2] [--nvcc]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one script measures two commits on one card in one call.
The cases (:data:`PIN_CASES`, :func:`pin_case`): the K-edge pelvis's 8e5
pixels (M = 6 bins, K = 4 materials, 60 iterations) and the packed PCD
path's (M = 4, K = 2, 10 iterations), both made by the port's K1 and K34
as ``chip_smoke.py``'s phase 3 makes them (its ``spectral_path_inputs``
and ``k35_inputs``), the exact path's DE counts solved by K35 at (2, 2)
with K3's schedule (``de_2x2_inputs``), and :data:`K35_CASES`' ``6x4``
and ``8x4_newton`` drawn at 1, 127, 129 and 4097 pixels, ragged against
any block.

Prints the card's name and power limit, then JSON lines:

- ``"k35_sass"`` (with ``--sass``): K35's registers, instructions by
  opcode and loops in the built library's SASS (``sass_stats.py``);
  ``--sass-dump`` writes its SASS to a file;
- ``"k35_time"``: at each path shape, K35's device time (20 calls in one
  CUDA graph, twice) and call time (CUDA events over ``--reps`` calls,
  twice), its float32 bound (``chip_smoke.py``'s ``newton_work`` over 67
  TFLOP/s) and its float64 bound (the sums' DFMAs, 2 M (1 + K) (+ 2 M T
  with "newton") operations a pixel and table node, over 33.5 TFLOP/s);
- ``"k35_bits"``: for each case, the sha1 of K35's output, whether two
  launches are bit-equal, and whether it agrees with the plain version on
  the card (``tiny_cases.newton_agrees``);
- with ``--steps``: ``tools/k35_steps.cu`` (beside this file; it includes
  ``csrc/gauss_newton.cu``) built with nvcc for ``sm_90a`` and
  ``-Xptxas -v``: ``"k35_step_sass"`` (each variant's registers, spills
  and loops), then one ``"k35_step"`` line per variant of :data:`STEPS`:
  whether its output equals variant 0's (the parent) bit for bit in each
  case, and its device time at the path shapes and on ``8x4_newton`` (at
  the K-edge shape also its warm steps and its polish steps alone),
  measured in two passes over the variants, the second in reverse;
- with ``--nvcc``: ``"k35_nvcc"``, the seconds nvcc takes to compile the
  checkout's ``csrc/gauss_newton.cu`` alone with the library's flags, and
  the registers and spill bytes ptxas reports for each K35 kernel (the
  other probes are skipped).

Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

THR4 = [20.0, 34.0, 50.0, 70.0]
THR6 = [20.0, 34.0, 45.0, 52.0, 65.0, 85.0]
THR8 = [20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0, 90.0]
# name -> (thresholds, K, solver keywords): the card tests' K35 cases
K35_CASES = {
    "4x2": (THR4, 2, dict(n_iters=50)),
    "4x3": (THR4, 3, dict(n_iters=200, step_max=2.0)),
    "6x4": (THR6, 4, dict(n_iters=200, step_max=2.0)),
    "4x2_newton": (THR4, 2, dict(n_iters=30, method="newton")),
    "4x3_lm": (THR4, 3, dict(n_iters=60, lm_damping=0.1, step_max=2.0)),
    "4x2_mle_warm": (THR4, 2, dict(n_iters=40, warm="mle")),
    "2x2_lm": (THR4[:1] + [60.0], 2, dict(n_iters=40, lm_damping=0.05)),
    # M = 8 with the Hessian columns on the 140-bin grid: 278 KB of
    # float64 table, more than a block's shared memory
    "8x4_newton": (THR8, 4, dict(n_iters=40, method="newton",
                                 step_max=2.0)),
}
PATH_SHAPES = ("kedge", "packed", "de_2x2")
RAGGED = tuple(f"{case}_n{n}" for case in ("6x4", "8x4_newton")
               for n in (1, 127, 129, 4097))
PIN_CASES = PATH_SHAPES + RAGGED
PEAK_F64_S = 33.5e12

# variant of k35_steps.cu: name; variant 0 is the parent
STEPS = (
    "parent: float table, maximum M, a pixel a thread",
    "float64 table, maximum M, one lane a row",
    "float64 table, exact M, one lane a row (the library's)",
    "float64 table, exact M, 2 pixels a thread",
    "float64 table, exact M, one lane a row, 4 blocks an SM",
    "float64 table, exact M, one lane a row, 5 blocks an SM",
    "float64 table, exact M, 2 lanes sharing each row, 4 blocks an SM",
    "float64 table, exact M, 4 lanes sharing each row, 4 blocks an SM",
    "one lane a row, the weights read from the card's memory at every size",
)


def multibin_case(thresholds, n_mats, n_pix=2048, seed=43):
    """Noiseless photon-counting counts [M, P], i0 [M, E] and mus [K, E]
    (float32 CPU tensors) of random area densities of K of (tissue, bone,
    iodine, gadolinium) under a 140 kV spectrum, bins at ``thresholds``
    (the JAX tests' multi-bin scene)."""
    import torch

    from dexct_tpu_torch.ops.matdecomp import pcd_bin_fluences
    from dexct_tpu_torch.physics import kramers_spectrum, xcom
    from dexct_tpu_torch.physics.detector import photon_counting_response
    from dexct_tpu_torch.physics.materials import BONE, TISSUE, Material
    from dexct_tpu_torch.system import FanBeamGeometry

    basis = (TISSUE, BONE,
             Material("iodine solution", 1.1, "H(10.0)O(85.0)I(5.0)"),
             Material("gadolinium solution", 1.05,
                      "H(10.5)O(88.5)Gd(1.0)"))[:n_mats]
    ct = FanBeamGeometry(N_channels=64, N_proj=8, gamma_fan=0.8, SID=60.0,
                         SDD=100.0, eid=False,
                         detector=photon_counting_response())
    spec = kramers_spectrum(140.0)
    spec.rescale_counts(ct.A_iso * 20.0 / ct.N_proj)
    i0s = pcd_bin_fluences(ct, spec, thresholds)
    mus = np.stack([xcom.mixatten(m.matcomp, spec.E) for m in basis])
    rng = np.random.default_rng(seed)
    hi = (25.0, 5.0, 2.0, 2.0)
    a = np.stack([rng.uniform(0.0, hi[k], n_pix) for k in range(n_mats)],
                 -1)
    counts = (np.exp(-a @ mus) @ i0s.T).T
    return [torch.as_tensor(x, dtype=torch.float32)
            for x in (counts, i0s, mus)]


def _sibling(name):
    """The probe ``name`` beside this file, as a module."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    """``chip_smoke.py`` of the checkout holding this file, as a module
    (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", _HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_cases(dev, root=_HERE):
    """{name: (counts, i0, mus, keywords)} of the three path shapes on
    ``dev``, made as ``chip_smoke.py``'s phase 3 makes them."""
    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.pipeline.runner import default_generators
    from dexct_tpu_torch.system.config import read_parameter_file

    cs = _chip_smoke()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pcd = cs.pcd_setup(Path(tmp), dev, default_generators())
        for key, _, paths, mu, i0s, i0_T, basis, n_iters in \
                cs.spectral_path_inputs(pcd, dev):
            c = spectral.counts_from_paths(paths, mu, i0_T)
            out[key] = (*cs.k35_inputs(c, i0s, basis, pcd[1], dev),
                        dict(n_iters=n_iters))
    cfg = read_parameter_file(Path(root) / "input" / "params.txt")[0]
    spectra = _sibling("probe_gauss_newton")._spectra
    out["de_2x2"] = cs.de_2x2_inputs(cfg, lambda ct: spectra(ct, Path(root)),
                                     dev)
    return out


def pin_case(name, dev):
    """(counts, i0, mus, keywords) on ``dev`` of a ragged case of
    :data:`RAGGED`: ``"<K35_CASES name>_n<pixels>"``, drawn at that many
    pixels."""
    import torch

    case, n = name.rsplit("_n", 1)
    thr, n_mats, kw = K35_CASES[case]
    args = multibin_case(thr, n_mats, n_pix=int(n))
    return (*(x.to(dev) for x in args), dict(kw))


def solve(matdecomp, name, counts, i0, mus, kw):
    """K35's output on a case: ``_gauss_newton_general`` for "de_2x2"
    (the default call there takes K3), ``gauss_newton_solve`` else."""
    if name == "de_2x2":
        return matdecomp._gauss_newton_general(counts, i0, mus, **kw)
    return matdecomp.gauss_newton_solve(counts, i0, mus, **kw)


def schedule_nodes(e_full, n_iters, polish=4, warm_nodes=32,
                   compress=True):
    """(warm table nodes, table nodes a pixel visits) of the schedule
    (``matdecomp._tables``): the log warm phase on the moment-compressed
    table when the grid has more than twice ``warm_nodes`` bins, then the
    polish on the full one."""
    e_warm = e_full
    n_pol = min(polish, n_iters)
    if compress and e_full > 2 * warm_nodes and n_iters > n_pol:
        seg = -(-e_full // warm_nodes)
        e_warm = -(-e_full // seg)
    return e_warm, (n_iters - n_pol) * e_warm + n_pol * e_full


def bounds_ms(cs, counts, mus, kw):
    """(float32 bound ms and what bounds it, float64 bound ms of the
    sums' DFMAs, table nodes a pixel visits)."""
    M, P = counts.shape
    K, E = mus.shape
    newton = kw.get("method", "gn") == "newton"
    compress = kw.get("warm", "log") == "log" and not newton
    n_iters = kw["n_iters"]
    b32 = cs.bound(*cs.newton_work(P, M, K, n_iters, E, newton,
                                   compress=compress))
    nodes = schedule_nodes(E, n_iters, compress=compress)[1]
    sums = M * (1 + K) + (M * K * (K + 1) // 2 if newton else 0)
    return b32, P * nodes * 2 * sums / PEAK_F64_S * 1e3, nodes


def _probe_time(h, cs, matdecomp, cases, reps):
    for name in PATH_SHAPES:
        counts, i0, mus, kw = cases[name]

        def call(name=name, args=(counts, i0, mus, kw)):
            return solve(matdecomp, name, *args)

        (b32, by), b64, nodes = bounds_ms(cs, counts, mus, kw)
        print(json.dumps({
            "probe": "k35_time", "case": name, "pixels": counts.shape[1],
            "M": counts.shape[0], "K": mus.shape[0], "e_full": mus.shape[1],
            "nodes_per_pixel": nodes,
            "device_ms": [h._graph_ms(call), h._graph_ms(call)],
            "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)],
            "bound_ms": b32, "bound_by": by, "bound_f64_ms": b64}),
            flush=True)


def _probe_bits(matdecomp, cases):
    import torch

    from dexct_tpu_torch.tools.probe_gauss_newton import output_sha1
    from dexct_tpu_torch.utils import tiny_cases

    for name, (counts, i0, mus, kw) in cases.items():
        a = solve(matdecomp, name, counts, i0, mus, kw)
        b = solve(matdecomp, name, counts, i0, mus, kw)
        want = matdecomp.gauss_newton_solve_plain(counts, i0, mus, **kw)
        torch.cuda.synchronize()
        print(json.dumps({
            "probe": "k35_bits", "case": name, "pixels": counts.shape[1],
            "sha1": output_sha1(a),
            "two_launches_equal": bool(torch.equal(a, b)),
            "plain_agrees": bool(tiny_cases.newton_agrees(a, want)),
            "plain_agreement": list(tiny_cases.newton_agreement(a, want))}),
            flush=True)


def _ptxas_registers(stderr, names):
    """{kernel: {"registers", "spill_bytes"}} from ``-Xptxas -v`` output,
    for the kernels whose mangled names contain one of ``names``."""
    regs, cur = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            regs.setdefault(cur, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs.setdefault(cur, {})["registers"] = int(m.group(1))
    return regs


def _probe_nvcc(root):
    """nvcc's seconds for the checkout's csrc/gauss_newton.cu alone, with
    the library's flags, and K35's registers."""
    from dexct_tpu_torch.utils import kernels

    src = root / "dexct_tpu_torch" / "csrc" / "gauss_newton.cu"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", str(Path(tmp) / "gauss_newton.o"), str(src)],
            capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
    if res.returncode:
        raise SystemExit(f"probe_k35: nvcc failed:\n{res.stderr}")
    print(json.dumps({"probe": "k35_nvcc", "source": str(src),
                      "seconds": seconds,
                      "ptxas": _ptxas_registers(res.stderr,
                                                ("general_kernel",))}),
          flush=True)


def _build_steps(tmp):
    """``k35_steps.cu`` built and loaded, with each kernel's registers and
    spill bytes from ptxas."""
    from dexct_tpu_torch.utils import kernels

    so = Path(tmp) / "libk35_steps.so"
    cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", str(so),
           str(Path(__file__).resolve().parent / "k35_steps.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"probe_k35: nvcc failed:\n{res.stderr}")
    regs = _ptxas_registers(res.stderr, ("",))
    lib = ctypes.CDLL(str(so))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.k35_step.argtypes = ((I, P, P, P, P, P, L) + (I,) * 10 + (F,) * 6
                             + (P,))
    lib.k35_step.restype = I
    return lib, so, regs


def _probe_steps(h, matdecomp, cases, variants, dump):
    """Each variant of ``k35_steps.cu`` on every case through
    ``matdecomp.k35_arguments``: bits against variant 0, device times."""
    import torch

    from dexct_tpu_torch.tools.probe_gauss_newton import output_sha1

    args = {}
    for name, (counts, i0, mus, kw) in cases.items():
        kw = {k: v for k, v in kw.items() if k != "pixel_block"}
        args[name] = matdecomp.k35_arguments(counts, i0, mus, **kw)
        args[name] += (args[name][1].float(),)  # the parent's float rows
    timed = PATH_SHAPES + ("8x4_newton_n4097",)
    with tempfile.TemporaryDirectory() as tmp:
        lib, so, regs = _build_steps(tmp)
        loops = {name: st.get("loops") for name, st in
                 _sibling("sass_stats").kernel_stats(
                     so, ("gauss_newton_general_kernel", "parent_kernel",
                          "k35_blocks_kernel", "k35_pix_kernel",
                          "k35_lanes_kernel", "k35_global_kernel"),
                     dump).items()}
        print(json.dumps({"probe": "k35_step_sass", "ptxas": regs,
                          "loops": loops}), flush=True)

        def call(variant, name, phase=None):
            counts, tables, scale, P, M, K, *rest, tables32 = args[name]
            if phase == "warm":  # the warm steps alone
                rest[4] = 0
            elif phase == "polish":  # the polish steps alone
                rest[3] = 0
            out = torch.empty((P, K), dtype=torch.float32,
                              device=counts.device)
            rc = lib.k35_step(variant, counts.data_ptr(), tables.data_ptr(),
                              tables32.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), P, M, K, *rest,
                              torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"probe_k35: variant {variant} on {name}: "
                                 f"cudaError_t {rc}")
            return out

        recs = {v: {"probe": "k35_step", "variant": v, "name": STEPS[v],
                    "equal_to_parent": {}, "two_launches_equal": True,
                    "device_ms": {name: [] for name in timed},
                    "kedge_phase_ms": {"warm": [], "polish": []}}
                for v in variants}
        sha1 = {}
        for name in PIN_CASES:
            ref = call(0, name)
            sha1[name] = output_sha1(ref)
            for v in variants:
                a = call(v, name)
                recs[v]["equal_to_parent"][name] = bool(torch.equal(a, ref))
                recs[v]["two_launches_equal"] &= bool(
                    torch.equal(a, call(v, name)))
        print(json.dumps({"probe": "k35_step_parent_sha1", "sha1": sha1}),
              flush=True)
        for order in (list(variants), list(variants)[::-1]):
            for v in order:
                for name in timed:
                    recs[v]["device_ms"][name].append(
                        h._graph_ms(lambda v=v, name=name: call(v, name)))
                for phase in ("warm", "polish"):
                    recs[v]["kedge_phase_ms"][phase].append(h._graph_ms(
                        lambda v=v, phase=phase: call(v, "kedge", phase)))
        for v in variants:
            print(json.dumps(recs[v]), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--sass", action="store_true",
                        help="print K35's registers and loops")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass or --steps, write the SASS here")
    parser.add_argument("--steps", action="store_true",
                        help="build k35_steps.cu and measure its variants "
                             "(the time and bits probes are skipped)")
    parser.add_argument("--variants", default=None,
                        help="with --steps, comma-separated variant "
                             "numbers (default all)")
    parser.add_argument("--nvcc", action="store_true",
                        help="time nvcc on the checkout's gauss_newton.cu "
                             "alone (the other probes are skipped)")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    h = _sibling("probe_cone_adjoint")
    sys.path.insert(0, str(root))
    os.chdir(root)  # the params files name their inputs from the root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_k35: needs a CUDA device")
    from dexct_tpu_torch.ops import matdecomp
    from dexct_tpu_torch.utils import kernels

    if Path(matdecomp.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_k35: imported {matdecomp.__file__}, not "
                         f"the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}",
          flush=True)
    if args.nvcc:
        _probe_nvcc(root)
        return
    kernels.library()
    if args.sass:
        stats = _sibling("sass_stats").kernel_stats(
            kernels.build(), ("gauss_newton_general_kernel",), dump)
        print(json.dumps({"probe": "k35_sass", "kernels": stats}),
              flush=True)
    dev = torch.device("cuda")
    cases = path_cases(dev, root)
    cases.update({name: pin_case(name, dev) for name in RAGGED})
    if args.steps:
        variants = (range(len(STEPS)) if args.variants is None
                    else [int(v) for v in args.variants.split(",")])
        _probe_steps(h, matdecomp, cases, variants, dump)
        return
    _probe_time(h, _chip_smoke(), matdecomp, cases, args.reps)
    _probe_bits(matdecomp, cases)


if __name__ == "__main__":
    main()
