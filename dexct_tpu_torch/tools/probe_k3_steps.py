"""The steps of K3's redesign on the card: each variant of ``k3_steps.cu``
against K3 as it stood before it, in bits, in time and in SASS.

    python dexct_tpu_torch/tools/probe_k3_steps.py [--variants 0,3,4]
        [--sass-dump FILE]

Run it by path, from the repository root.  Builds ``k3_steps.cu`` (beside
this file; it includes ``csrc/gauss_newton.cu``) with nvcc for ``sm_90a``
into a temporary directory, with ``-Xptxas -v``, and loads it with
``ctypes``.  Variant 0 is the kernel before the redesign; variants 1-8 are
the library's kernel at (P pixels a thread, the node loop unrolled by U) =
:data:`STEPS`.  The inputs are ``probe_gauss_newton``'s pinned cases, each
through ``matdecomp.k3_arguments`` (the wrapper's tables and schedule).

Prints the card's name and power limit, then JSON lines: ``"k3_step_sass"``
(each variant's registers and spills from ptxas, and the loops of each
kernel's SASS from ``sass_stats.py``), then one ``"k3_step"`` line per
variant: whether its output equals variant 0's bit for bit in each case,
whether two launches are equal, and its device time (20 calls in one CUDA
graph) at the three path shapes, measured in two passes over the variants,
the second in reverse order.

Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent

# variant: (name, P, U); variant 0 is the parent (U 0: nvcc's unrolling)
STEPS = (
    ("parent: a pixel a thread, nvcc's contractions and unrolling", 1, 0),
    ("P 1, U 1 (K29's body)", 1, 1),
    ("P 1, U 2", 1, 2),
    ("P 2, U 1", 2, 1),
    ("P 2, U 2", 2, 2),
    ("P 2, U 4", 2, 4),
    ("P 4, U 1", 4, 1),
    ("P 4, U 2 (the library's K3)", 4, 2),
    ("P 4, U 4", 4, 4),
)


def _sibling(name):
    path = _HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(tmp):
    """``k3_steps.cu`` built and loaded, with each kernel's registers and
    spill bytes from ptxas."""
    from dexct_tpu_torch.utils import kernels

    so = Path(tmp) / "libk3_steps.so"
    cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", str(so),
           str(_HERE / "k3_steps.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"probe_k3_steps: nvcc failed:\n{res.stderr}")
    regs, cur = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            regs.setdefault(cur, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs.setdefault(cur, {})["registers"] = int(m.group(1))
    lib = ctypes.CDLL(str(so))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.k3_step.argtypes = (I, P, P, P, P, L) + (I,) * 5 + (F,) * 5 + (P,)
    lib.k3_step.restype = I
    regs = {k: v for k, v in regs.items()
            if "gauss_newton_kernel" in k or "parent_kernel" in k}
    return lib, so, regs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=None,
                        help="comma-separated variant numbers (default all)")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="write the variants' SASS here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(_HERE.parents[1]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_k3_steps: needs a CUDA device")
    from dexct_tpu_torch.ops import matdecomp

    pg = _sibling("probe_gauss_newton")
    h = _sibling("probe_cone_adjoint")
    variants = (range(len(STEPS)) if args.variants is None
                else [int(v) for v in args.variants.split(",")])
    print(h._card_line())
    dev = torch.device("cuda")
    cases = {}
    for name in pg.PIN_CASES:
        counts, i0, mus, kw = pg.pin_case(name, dev)
        cases[name] = matdecomp.k3_arguments(counts, i0, mus, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        lib, so, regs = _build(tmp)
        dump = None if args.sass_dump is None else str(args.sass_dump)
        loops = {name: st.get("loops") for name, st in
                 _sibling("sass_stats").kernel_stats(
                     so, ("gauss_newton_kernel", "parent_kernel"),
                     dump).items()}
        print(json.dumps({"probe": "k3_step_sass", "ptxas": regs,
                          "loops": loops}))

        def call(variant, name):
            counts, tables, scale, P, *rest = cases[name]
            out = torch.empty((P, 2), dtype=torch.float32, device=dev)
            rc = lib.k3_step(variant, counts.data_ptr(), tables.data_ptr(),
                             scale.data_ptr(), out.data_ptr(), P, *rest,
                             torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"probe_k3_steps: variant {variant} on "
                                 f"{name}: cudaError_t {rc}")
            return out

        recs = {v: {"probe": "k3_step", "variant": v, "name": STEPS[v][0],
                    "P": STEPS[v][1], "U": STEPS[v][2],
                    "equal_to_parent": {}, "two_launches_equal": True,
                    "device_ms": {name: [] for name in pg.PATH_SHAPES}}
                for v in variants}
        sha1 = {}
        for name in pg.PIN_CASES:
            ref = call(0, name)
            sha1[name] = pg.output_sha1(ref)
            for v in variants:
                a = call(v, name)
                recs[v]["equal_to_parent"][name] = bool(torch.equal(a, ref))
                recs[v]["two_launches_equal"] &= bool(
                    torch.equal(a, call(v, name)))
        print(json.dumps({"probe": "k3_step_parent_sha1", "sha1": sha1}))
        for order in (list(variants), list(variants)[::-1]):
            for v in order:
                for name in pg.PATH_SHAPES:
                    recs[v]["device_ms"][name].append(
                        h._graph_ms(lambda v=v, name=name: call(v, name)))
        for v in variants:
            print(json.dumps(recs[v]))


if __name__ == "__main__":
    main()
