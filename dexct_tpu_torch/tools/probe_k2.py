"""K2, the spectral counts, on the card: its time at the shapes the paths
launch it at, its bound, the sha1s of its pinned cases, the code Triton
made of the first K2, and the steps of its redesign.

    python dexct_tpu_torch/tools/probe_k2.py [--root DIR] [--reps 5]
        [--sass] [--sass-dump FILE] [--dump DIR] [--steps]
        [--variants 0,1,2] [--nvcc]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one script measures two commits on one card in one call.
The cases (:data:`PIN_CASES`, :func:`pin_case`): the material paths of the
three path shapes, each traced by the port (K1 on the exact path's 1000 x
800 rays, 8e5; K10 on the cone config's 360 x 16 x 256, 1.47M, and the
helical config's 720 x 16 x 256, 2.95M) and counted under each spectrum of
the reference protocol (detunedMV at 9 mGy, E = 100; 80kV at 1 mGy, E =
140), with and without the second moment ``i2`` (:func:`path_cases`); and
seeded rays (:data:`SYNTH_CASES`) at 1, 127, 129 and 4097 rays, M in {1,
2, 6, 8, 12} materials and E in {1, 63, 64, 65, 100, 140, 200} energies,
so that every tail of the 64-energy chunks and of a block's rays is hit,
one of them with rays whose attenuation lies past both clamps (-700 and
+2) and whose exp falls into float32's subnormal range.

Prints the card's name and power limit, then JSON lines:

- ``"k2_sass"`` (with ``--sass``): K2's registers, instructions by opcode
  and loops in the built library's SASS (``sass_stats.py``);
- ``"k2_triton"`` (with ``--dump``, on a checkout whose K2 is the Triton
  kernel): for M = 6 with and without ``i2``, the blocked layouts of its
  TTGIR, the PTX instructions that fix its arithmetic (``fma``, ``mul``,
  ``add``, ``max``, ``min``, ``ex2``, ``shfl``, shared memory, barriers)
  by count, and the SASS's by opcode; the TTGIR, PTX and SASS are written
  to DIR;
- ``"k2_time"``: at each path shape, K2's device time for both spectra
  (20 pairs of calls in one CUDA graph, twice) and call time (CUDA events
  over ``--reps`` pairs, twice), without and with ``i2``, and the bound
  (``chip_smoke.py``'s: the bytes over 3.35 TB/s, ``2 M + 3`` operations
  a ray and energy over 67 TFLOP/s);
- ``"k2_bits"``: for each case, the sha1 of K2's output (the counts, then
  the second moment where there is one), whether two launches are
  bit-equal, and its largest difference from the plain version on the
  card relative to |plain|;
- with ``--steps``: ``tools/k2_steps.cu`` (beside this file) built with
  nvcc for ``sm_90a`` and ``-Xptxas -v``: ``"k2_step_sass"`` (each
  variant's registers and spills), then one ``"k2_step"`` line per
  variant of :data:`STEPS`: whether its output equals K2's of the checkout
  at ``--root`` bit for bit on every case, and its device time at the path
  shapes, in two passes over the variants, the second in reverse;
- with ``--nvcc``: ``"k2_nvcc"``, the seconds nvcc takes to compile each
  of the checkout's sources alone with the library's flags, all started
  together as the library's build starts them (the other probes are
  skipped).

Card only.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

PATH_SHAPES = ("exact", "cone", "helical")
PATH_CASES = tuple(f"{p}_s{s}{i2}" for p in PATH_SHAPES for s in (1, 2)
                   for i2 in ("", "_i2"))
# name -> (rays, materials, energies, with i2, clamped): seeded rays
SYNTH_CASES = {
    **{f"r4097_m6_e{e}_i2": (4097, 6, e, True, False)
       for e in (1, 63, 64, 65, 100, 140, 200)},
    **{f"r129_m{m}_e140": (129, m, 140, False, False) for m in (1, 2, 8)},
    "r129_m12_e100_i2": (129, 12, 100, True, False),
    **{f"r{n}_m2_e65{i2}": (n, 2, 65, bool(i2), False)
       for n in (1, 127, 129) for i2 in ("", "_i2")},
    "r4097_m8_e200": (4097, 8, 200, False, False),
    "clamp_r4097_m6_e140_i2": (4097, 6, 140, True, True),
}
PIN_CASES = PATH_CASES + tuple(SYNTH_CASES)

# variant of k2_steps.cu: name (the checkout's K2 is the reference)
STEPS = (
    "a ray a thread, 128 threads",
    "2 rays a thread, 128 threads",
    "4 rays a thread, 128 threads",
    "2 rays a thread, 256 threads",
    "4 rays a thread, 64 threads",
    "the parent's lanes over energies, shuffles",
    "2 rays a thread, 512 threads",
)


def synthetic_case(name):
    """(paths [R, M], mu [M, E], i0 [E], i2 [E] or None) float32 NumPy of
    the seeded case ``name`` of :data:`SYNTH_CASES`."""
    n, m, e, with_i2, clamped = SYNTH_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    mu = rng.uniform(0.01, 2.0, (m, e))
    i0 = rng.uniform(0.0, 1e6, e)
    i2 = i0 * rng.uniform(30.0, 90.0, e) if with_i2 else None
    paths = rng.uniform(0.0, 5.0, (n, m))
    if clamped:
        # attenuations from 1e-3 to ~1e3 (past -700), a twentieth of the
        # rays negative (past +2), a few rays of zero paths: the exps of
        # L in [87.3, 103.3] are float32 subnormals
        scale = 10.0 ** rng.uniform(-3.0, 2.6, n)
        scale[rng.random(n) < 0.05] *= -0.05
        scale[:8] = 0.0
        paths = rng.uniform(0.0, 1.0, (n, m)) * scale[:, None]
    f32 = [np.ascontiguousarray(x, np.float32) for x in (paths, mu, i0)]
    return (*f32, None if i2 is None else i2.astype(np.float32))


def _sibling(name):
    """The probe ``name`` beside this file (not the measured checkout's),
    as a module."""
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


def path_inputs(label, dev, root=_HERE):
    """(paths, [(mu, i0, i2) of each spectrum]) on ``dev`` of the path
    ``label`` ("exact", "cone" or "helical"): the pack's rays traced by the
    port (K1 or K10) as ``chip_smoke.py``'s phase 3 traces them, the pack's
    tables and the second moment of each spectrum."""
    import torch

    from dexct_tpu_torch.ops import conebeam, siddon, spectral
    from dexct_tpu_torch.system.config import read_parameter_file

    root = Path(root)
    spectra = _sibling("probe_gauss_newton")._spectra
    if label == "exact":
        from dexct_tpu_torch.pipeline.fused import pack_dect

        cfg = read_parameter_file(root / "input" / "params.txt")[0]
        specs = spectra(cfg.ct, root)
        a, meta = pack_dect(cfg.ct, cfg.phantom, *specs, cfg.N_matrix,
                            cfg.FOV, cfg.ramp, device=dev, n_iters=50,
                            projector="siddon", recon="fan")
        paths = siddon.trace_paths(a["labels"], a["src"], a["dirs"],
                                   meta.dx, meta.dy,
                                   n_materials=meta.n_materials)
    else:
        from dexct_tpu_torch.pipeline.cone import pack_cone_dect

        with tempfile.TemporaryDirectory() as tmp:
            cfg = _sibling("probe_cone_adjoint")._cone_config(
                root, Path(tmp), label)
        specs = spectra(cfg.ct, root)
        a, meta = pack_cone_dect(cfg.ct, cfg.phantom, *specs, cfg.N_matrix,
                                 cfg.FOV, cfg.ramp, device=dev, n_iters=50)
        paths = conebeam.trace_paths_3d(a["labels"], a["src"], a["dirs"],
                                        meta.dx, meta.dy, meta.dz,
                                        n_materials=meta.n_materials)
    tables = [(a["mu_t" + s], a["i0_" + s], torch.as_tensor(
        spectral.second_moment_fluence(spec, cfg.ct), dtype=torch.float32,
        device=dev)) for s, spec in zip(("1", "2"), specs)]
    return paths, tables


def cases_of(inputs):
    """{name: (paths, mu, i0, i2 or None)} of :data:`PATH_CASES` from
    {label: :func:`path_inputs`}."""
    out = {}
    for label, (paths, tables) in inputs.items():
        for s, (mu, i0, i2) in zip((1, 2), tables):
            out[f"{label}_s{s}"] = (paths, mu, i0, None)
            out[f"{label}_s{s}_i2"] = (paths, mu, i0, i2)
    return out


def path_cases(dev, root=_HERE):
    """{name: (paths, mu, i0, i2 or None)} of :data:`PATH_CASES` on
    ``dev``."""
    return cases_of({label: path_inputs(label, dev, root)
                     for label in PATH_SHAPES})


def pin_case(name, dev):
    """(paths, mu, i0, i2 or None) on ``dev`` of the seeded case ``name``
    of :data:`SYNTH_CASES`."""
    import torch

    return tuple(None if x is None else torch.as_tensor(x, device=dev)
                 for x in synthetic_case(name))


def output_sha1(out):
    """sha1 of K2's output on the host: the counts' bytes, then the second
    moment's where the call returns one (C order)."""
    h = hashlib.sha1()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def counts(spectral, paths, mu, i0, i2):
    """K2's output on a case: counts, or (counts, var) with ``i2``."""
    if i2 is None:
        return spectral.counts_from_paths(paths, mu, i0)
    return spectral.counts_from_paths(paths, mu, i0, i2)


def work(cs, paths, tables, with_i2):
    """(bytes, operations) of K2 over ``tables`` as ``chip_smoke.py``
    counts them: the paths, tables and outputs once; ``2 M + 3``
    operations a ray and energy (one more output and two more operations
    a ray and energy with ``i2``)."""
    m = paths.shape[-1]
    n_rays = paths.numel() // m
    n_bytes = n_ops = 0
    for mu, i0, i2 in tables:
        e = mu.shape[1]
        n_bytes += cs.nbytes(paths, mu, i0) + 4 * n_rays
        n_ops += n_rays * e * (2 * m + 3)
        if with_i2:
            n_bytes += cs.nbytes(i2) + 4 * n_rays
            n_ops += n_rays * e * 2
    return n_bytes, n_ops


def _probe_time(h, cs, spectral, inputs, reps):
    for label, (paths, tables) in inputs.items():
        rec = {"probe": "k2_time", "case": label,
               "rays": paths.numel() // paths.shape[-1],
               "M": paths.shape[-1], "E": [t[0].shape[1] for t in tables]}
        for with_i2 in (False, True):
            def call(with_i2=with_i2):
                for mu, i0, i2 in tables:
                    counts(spectral, paths, mu, i0, i2 if with_i2 else None)

            key = "_i2" if with_i2 else ""
            b, by = cs.bound(*work(cs, paths, tables, with_i2))
            rec["device_ms" + key] = [h._graph_ms(call), h._graph_ms(call)]
            rec["call_ms" + key] = [h._time_ms(call, reps),
                                    h._time_ms(call, reps)]
            rec["bound_ms" + key] = b
            rec["bound_by" + key] = by
        print(json.dumps(rec), flush=True)


def _probe_bits(spectral, cases):
    import torch

    for name, (paths, mu, i0, i2) in cases.items():
        a = counts(spectral, paths, mu, i0, i2)
        b = counts(spectral, paths, mu, i0, i2)
        pairs = list(zip(a, b)) if i2 is not None else [(a, b)]
        wants = [spectral.counts_from_paths_plain(paths, mu, t)
                 for t in ((i0, i2) if i2 is not None else (i0,))]
        rel = max(float(((x - w).abs() / w.abs().clamp_min(1e-30)).max())
                  for (x, _), w in zip(pairs, wants))
        torch.cuda.synchronize()
        print(json.dumps({
            "probe": "k2_bits", "case": name,
            "rays": paths.numel() // paths.shape[-1],
            "M": paths.shape[-1], "E": mu.shape[1], "i2": i2 is not None,
            "sha1": output_sha1(a),
            "two_launches_equal": all(bool(torch.equal(x, y))
                                      for x, y in pairs),
            "plain_max_rel": rel}), flush=True)


_PTX_WATCH = ("fma.rn.f32", "mul.f32", "mul.rn.f32", "add.f32",
              "add.rn.f32", "neg.f32", "max.f32", "min.f32", "ex2.approx",
              "shfl.sync.bfly", "st.shared", "ld.shared", "bar.sync",
              "ld.global")


def _probe_triton(spectral, dump):
    """The first K2's compiled code for M = 6, with and without i2."""
    import torch

    if not hasattr(spectral, "_counts_kernel"):
        print(json.dumps({"probe": "k2_triton",
                          "note": "this checkout's K2 is not Triton"}))
        return
    dump.mkdir(parents=True, exist_ok=True)
    paths, mu, i0, i2 = pin_case("r4097_m6_e140_i2", torch.device("cuda"))
    r, e = paths.shape[0], mu.shape[1]
    out = torch.empty(r, device=paths.device)
    var = torch.empty_like(out)
    for has_i2 in (False, True):
        k = spectral._counts_kernel()[(-(-r // spectral._BLOCK_R),)](
            paths, mu, i0, i2, out, var, r, e, M=6, HAS_I2=has_i2,
            BLOCK_R=spectral._BLOCK_R, BLOCK_E=spectral._BLOCK_E,
            num_warps=4)
        tag = f"k2_m6_{'i2' if has_i2 else 'no_i2'}"
        rec = {"probe": "k2_triton", "i2": has_i2,
               "layouts": re.findall(r"#\w+ = #\w+\.\w+<.*>",
                                     k.asm["ttgir"])}
        for ext in ("ttgir", "ptx"):
            (dump / f"{tag}.{ext}").write_text(k.asm[ext])
        ptx = k.asm["ptx"]
        rec["ptx"] = {w: len(re.findall(rf"\b{re.escape(w)}\b", ptx))
                      for w in _PTX_WATCH}
        cubin = dump / f"{tag}.cubin"
        cubin.write_bytes(k.asm["cubin"])
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              timeout=120).stdout
        (dump / f"{tag}.sass").write_text(sass)
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split()[0]
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", sass))
        rec["sass"] = dict(ops.most_common())
        rec["registers"] = getattr(k, "n_regs", None)
        rec["spills"] = getattr(k, "n_spills", None)
        print(json.dumps(rec), flush=True)


def _probe_first_call(spectral):
    """Seconds of the process's first K2 calls at M = 6 (without, then
    with i2): a Triton K2 compiles each there, a CUDA K2 is built."""
    import torch

    paths, mu, i0, i2 = pin_case("r4097_m6_e140_i2", torch.device("cuda"))
    rec = {"probe": "k2_first_call"}
    for key, second in (("no_i2_s", None), ("i2_s", i2)):
        t0 = time.perf_counter()
        counts(spectral, paths, mu, i0, second)
        torch.cuda.synchronize()
        rec[key] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)


def _ptxas_registers(stderr):
    """{kernel: {"registers", "spill_bytes"}} from ``-Xptxas -v``."""
    regs, cur = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            regs.setdefault(cur, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs.setdefault(cur, {})["registers"] = int(m.group(1))
    return regs


def _probe_nvcc(root):
    """Each source's nvcc seconds, all started together as the library's
    build starts them."""
    from dexct_tpu_torch.utils import kernels

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {src: subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o",
             str(Path(tmp) / (src[:-3] + ".o")),
             str(kernels.CSRC / src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for src in kernels.SOURCES}
        seconds = {}
        pending = dict(procs)
        while pending:
            for src, proc in list(pending.items()):
                if proc.poll() is not None:
                    seconds[src] = time.perf_counter() - t0
                    if proc.returncode:
                        raise SystemExit(f"probe_k2: nvcc failed on {src}:"
                                         f"\n{proc.stderr.read()}")
                    del pending[src]
            time.sleep(0.05)
    print(json.dumps({"probe": "k2_nvcc", "root": str(root),
                      "sources": len(kernels.SOURCES),
                      "wall_s": max(seconds.values()),
                      "seconds": seconds}), flush=True)


def _build_steps(tmp):
    """``k2_steps.cu`` built and loaded, with each kernel's registers."""
    from dexct_tpu_torch.utils import kernels

    so = Path(tmp) / "libk2_steps.so"
    cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", str(so),
           str(Path(__file__).resolve().parent / "k2_steps.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"probe_k2: nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k2_step.argtypes = (I, P, P, P, P, P, P, L, I, I, P)
    lib.k2_step.restype = I
    return lib, _ptxas_registers(res.stderr)


def _probe_steps(h, spectral, cases, variants):
    """Each variant of ``k2_steps.cu`` on every case: bits against the
    checkout's K2, device times at the path shapes."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        lib, regs = _build_steps(tmp)
        print(json.dumps({"probe": "k2_step_sass", "ptxas": regs}),
              flush=True)

        def call(variant, paths, mu, i0, i2):
            m = paths.shape[-1]
            r = paths.numel() // m
            out = torch.empty(r, device=paths.device)
            var = torch.empty(r, device=paths.device) if i2 is not None \
                else out
            rc = lib.k2_step(variant, paths.data_ptr(), mu.data_ptr(),
                             i0.data_ptr(),
                             0 if i2 is None else i2.data_ptr(),
                             out.data_ptr(), var.data_ptr(), r, m,
                             mu.shape[1],
                             torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"probe_k2: variant {variant}: "
                                 f"cudaError_t {rc}")
            shape = paths.shape[:-1]
            if i2 is None:
                return out.reshape(shape)
            return out.reshape(shape), var.reshape(shape)

        recs = {v: {"probe": "k2_step", "variant": v, "name": STEPS[v],
                    "equal_to_reference": {}, "device_ms": {}}
                for v in variants}
        for name, case in cases.items():
            ref = counts(spectral, *case)
            for v in variants:
                got = call(v, *case)
                recs[v]["equal_to_reference"][name] = all(
                    bool(torch.equal(x, y)) for x, y in
                    (zip(got, ref) if case[3] is not None else [(got, ref)]))
        timed = [n for n in PATH_CASES if n in cases]
        for order in (list(variants), list(variants)[::-1]):
            for v in order:
                for name in timed:
                    recs[v]["device_ms"].setdefault(name, []).append(
                        h._graph_ms(lambda v=v, c=cases[name]: call(v, *c)))
        for v in variants:
            recs[v]["all_equal"] = all(
                recs[v]["equal_to_reference"].values())
            print(json.dumps(recs[v]), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--sass", action="store_true",
                        help="print K2's registers and loops")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass, write K2's SASS here")
    parser.add_argument("--dump", type=Path, default=None,
                        help="write the Triton K2's TTGIR, PTX and SASS "
                             "here (a checkout whose K2 is Triton)")
    parser.add_argument("--steps", action="store_true",
                        help="build k2_steps.cu and measure its variants "
                             "(the time and bits probes are skipped)")
    parser.add_argument("--variants", default=None,
                        help="with --steps, comma-separated variant "
                             "numbers (default all)")
    parser.add_argument("--nvcc", action="store_true",
                        help="time nvcc on the checkout's sources (the "
                             "other probes are skipped)")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    tdump = None if args.dump is None else args.dump.resolve()
    h = _sibling("probe_cone_adjoint")
    sys.path.insert(0, str(root))
    os.chdir(root)  # the params files name their inputs from the root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_k2: needs a CUDA device")
    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.utils import kernels

    if Path(spectral.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_k2: imported {spectral.__file__}, not "
                         f"the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}",
          flush=True)
    if args.nvcc:
        _probe_nvcc(root)
        return
    kernels.library()
    _probe_first_call(spectral)
    if args.sass:
        stats = _sibling("sass_stats").kernel_stats(
            kernels.build(), ("spectral_counts",), dump)
        print(json.dumps({"probe": "k2_sass", "kernels": stats}),
              flush=True)
    if tdump is not None:
        _probe_triton(spectral, tdump)
    dev = torch.device("cuda")
    inputs = {label: path_inputs(label, dev, root) for label in PATH_SHAPES}
    cases = cases_of(inputs)
    cases.update({name: pin_case(name, dev) for name in SYNTH_CASES})
    if args.steps:
        variants = (range(len(STEPS)) if args.variants is None
                    else [int(v) for v in args.variants.split(",")])
        _probe_steps(h, spectral, cases, variants)
        return
    _probe_time(h, _chip_smoke(), spectral, inputs, args.reps)
    _probe_bits(spectral, cases)


if __name__ == "__main__":
    main()
