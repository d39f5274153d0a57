"""The steps of K7's redesign on the card: each variant of
``k7_steps.cu`` against K7 as it stood before it, in bits and in time.

    python dexct_tpu_torch/tools/probe_k7_steps.py [--variants 0,4,6]

Run it by path, from the repository root.  Builds ``k7_steps.cu`` (beside
this file; it includes ``csrc/kb_sample.cu``) with nvcc for ``sm_90a`` into
a temporary directory, with ``-Xptxas -v``, and loads it with ``ctypes``.
Each variant of :data:`STEPS` (index = the variant's number) is one kernel
of ``k7_steps.cu`` at one tile and item size of the binning
(``fourier._kb_tiles_build`` with ``fourier.KB_TILE`` and
``fourier.KB_ITEM`` set to them for the build); variant 0 is the kernel
before the redesign.  The inputs are ``probe_kb_sample``'s pinned cases at the four
shapes the paths launch K7 at, and the z-stack batch.

Prints the card's name and power limit, then one JSON line per variant:
its name, the registers and spill bytes of its kernels (from ptxas),
whether its output equals variant 0's bit for bit in each case and whether
two launches are equal, and its device time (20 calls in one CUDA graph)
in each case, measured in two passes over the variants, the second in
reverse order.

Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

_HERE = Path(__file__).resolve().parent

# (name, kernel of k7_step, tile, item cap): the redesign's steps, each on
# the last, then the tile and the item size
STEPS = (
    ("parent: a thread per sample, scalar weights, gathers", 0, 16, 256),
    ("a: + weights as four float4", 1, 16, 256),
    ("b: + binned order (T 16, items of 256), gathers through L1", 2, 16,
     256),
    ("b, items of 128", 2, 16, 128),
    ("c: + the tile staged in shared memory (T 16, items of 256)", 3, 16,
     256),
    ("c, items of 128", 3, 16, 128),
    ("c, T 8, items of 256", 3, 8, 256),
    ("c, T 8, items of 128: the new K7", 3, 8, 128),
    ("c, T 8, items of 64", 3, 8, 64),
    ("c, T 8, items of 96", 3, 8, 96),
    ("c, T 8, items of 192", 3, 8, 192),
    ("c, T 16, items of 192", 3, 16, 192),
    ("c, T 8, items of 128, built for up to 256 threads", 4, 8, 128),
)
CASES = ("ref6", "ref1", "onestep2", "motion1", "zstack16")


def _build(tmp):
    """``k7_steps.cu`` built and loaded, with each kernel's registers and
    spill bytes from ptxas."""
    from dexct_tpu_torch.utils import kernels

    so = Path(tmp) / "libk7_steps.so"
    cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", str(so),
           str(_HERE / "k7_steps.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"probe_k7_steps: nvcc failed:\n{res.stderr}")
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
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k7_step.argtypes = (I,) + (P,) * 10 + (I,) * 6 + (P,)
    lib.k7_step.restype = I
    return lib, {k: v for k, v in regs.items()
                 if "kernel" in k and "adjoint" not in k
                 and "conj_phase" not in k}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=None,
                        help="comma-separated variant numbers (default all)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(_HERE.parents[1]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_k7_steps: needs a CUDA device")
    from dexct_tpu_torch.ops import fourier
    from dexct_tpu_torch.tools import probe_kb_sample as pk

    h = pk._helpers()
    variants = (range(len(STEPS)) if args.variants is None
                else [int(v) for v in args.variants.split(",")])
    print(h._card_line())
    cases = pk._cases(fourier, CASES)
    binned = {}

    def tables(name, tile, cap):
        F, idx, w, pc, ps = cases[name]
        key = (id(idx), tile, cap)
        if key not in binned:
            with mock.patch.object(fourier, "KB_TILE", tile), \
                    mock.patch.object(fourier, "KB_ITEM", cap):
                binned[key] = fourier._kb_tiles_build(idx, w, pc, ps,
                                                      F.shape[-1])
        return binned[key]

    with tempfile.TemporaryDirectory() as tmp:
        lib, regs = _build(tmp)

        def call(variant, name):
            _, kind, tile, cap = STEPS[variant]
            F, idx, w, pc, ps = cases[name]
            t = tables(name, tile, cap)
            M, G = F.shape[0], F.shape[-1]
            out = torch.empty((M,) + tuple(pc.shape), dtype=torch.complex64,
                              device=F.device)
            rc = lib.k7_step(kind, F.data_ptr(), idx.data_ptr(),
                             w.data_ptr(), pc.data_ptr(), ps.data_ptr(),
                             t.items.data_ptr(), t.origin.data_ptr(),
                             t.rec.data_ptr(), t.w.data_ptr(),
                             out.data_ptr(), pc.numel(), M, G, tile,
                             t.n_items, cap,
                             torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"probe_k7_steps: variant {variant} on "
                                 f"{name}: cudaError_t {rc}")
            return out

        recs = {v: {"probe": "k7_step", "variant": v, "name": STEPS[v][0],
                    "equal_to_parent": {}, "two_launches_equal": True,
                    "device_ms": {name: [] for name in CASES}}
                for v in variants}
        print(json.dumps({"probe": "k7_step_resources", "kernels": regs}))
        for name in CASES:
            ref = call(0, name)
            for v in variants:
                a = call(v, name)
                recs[v]["equal_to_parent"][name] = bool(torch.equal(a, ref))
                recs[v]["two_launches_equal"] &= bool(
                    torch.equal(a, call(v, name)))
        for order in (list(variants), list(variants)[::-1]):
            for v in order:
                for name in CASES:
                    recs[v]["device_ms"][name].append(
                        h._graph_ms(lambda v=v, name=name: call(v, name)))
        for v in variants:
            print(json.dumps(recs[v]))


if __name__ == "__main__":
    main()
