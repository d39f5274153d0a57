"""The steps of K4's redesign on the card: each variant of
``k4_steps.cu`` against K4 as it stood before it, in bits and in time.

    python dexct_tpu_torch/tools/probe_k4_steps.py [--variants 0,5,17]

Run it by path, from the repository root.  Builds ``k4_steps.cu`` (beside
this file) with nvcc for ``sm_90a`` into a temporary directory, with
``-Xptxas -v``, and loads it with ``ctypes``.  Each variant of
:data:`STEPS` (index = the variant's number in ``k4_steps.cu``) is one
setting of the redesign; variant 0 is the kernel before it.  The inputs
are ``probe_fan_backproject``'s pinned cases (:func:`pin_case`).

Prints the card's name and power limit, then one JSON line per variant:
its name, registers and spill bytes (from ptxas), whether its output
equals variant 0's bit for bit on each pinned case and whether two
launches are equal, and its device time (20 calls in one CUDA graph) at
the exact path's shape at K = 4 and K = 1, measured in two passes over the
variants, the second in reverse order.

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

_HERE = Path(__file__).resolve().parent

# the variants of k4_steps.cu, in its order: (name, kernel, its Cfg (TW,
# BH, VEC, OFF32, UNROLL, MINB, RCP, INNER, OUTER)).  The redesign's steps
# (a) 16-byte loads, (b) 32-bit offsets, (c) compact warp tiles, (d)
# explicit contraction, (e) loads issued ahead, (f) two pixels a thread,
# then the block size, the register cap, the reciprocal and the unrolling,
# and last the new K4 with one setting at a time put back
STEPS = (
    ("parent: 16x2 warps, scalar loads, 64-bit offsets", "parent", None),
    ("d: explicit fma as nvcc contracted, float2 cos/sin, 1-D blocks",
     "step", (16, 16, 0, 0, 1, 1, 0, 0, 0)),
    ("d, tap as fma(b, f, a g)", "step", (16, 16, 0, 0, 1, 1, 0, 1, 0)),
    ("d, tap without fma", "step", (16, 16, 0, 0, 1, 1, 0, 2, 0)),
    ("d, sum as acc + w tap rounded", "step", (16, 16, 0, 0, 1, 1, 0, 0, 1)),
    ("a: + 16-byte row loads", "step", (16, 16, 1, 0, 1, 1, 0, 0, 0)),
    ("b: + 32-bit row offsets", "step", (16, 16, 1, 1, 1, 1, 0, 0, 0)),
    ("c: + 8x4 warp tiles", "step", (8, 16, 1, 1, 1, 1, 0, 0, 0)),
    ("c: 4x8 warp tiles", "step", (4, 16, 1, 1, 1, 1, 0, 0, 0)),
    ("c, 16x8-pixel blocks", "step", (8, 8, 1, 1, 1, 1, 0, 0, 0)),
    ("c, 16x32-pixel blocks", "step", (8, 32, 1, 1, 1, 1, 0, 0, 0)),
    ("+ 32 registers, 16x16 blocks", "step", (8, 16, 1, 1, 1, 8, 0, 0, 0)),
    ("+ 32 registers, 16x32 blocks", "step", (8, 32, 1, 1, 1, 4, 0, 0, 0)),
    ("+ 1/l2 by __frcp_rn", "step", (8, 32, 1, 1, 1, 4, 1, 0, 0)),
    ("e: next view's loads before this view's sums", "step",
     (8, 32, 1, 1, 0, 1, 1, 0, 0)),
    ("view loop unrolled by 2", "step", (8, 32, 1, 1, 2, 4, 1, 0, 0)),
    ("view loop unrolled by 4", "step", (8, 32, 1, 1, 4, 4, 1, 0, 0)),
    ("view loop unrolled by 8: the new K4", "step",
     (8, 32, 1, 1, 8, 4, 1, 0, 0)),
    ("f: two pixels a thread, 64 registers", "two_px",
     (8, 32, 1, 1, 2, 4, 1, 0, 0)),
    ("f: two pixels a thread, 128 registers", "two_px",
     (8, 32, 1, 1, 2, 2, 1, 0, 0)),
    ("new K4 with scalar loads", "step", (8, 32, 0, 1, 8, 4, 1, 0, 0)),
    ("new K4 with 64-bit offsets", "step", (8, 32, 1, 0, 8, 4, 1, 0, 0)),
    ("new K4 with __fdiv_rn", "step", (8, 32, 1, 1, 8, 4, 0, 0, 0)),
    ("new K4 with 16x2 warps", "step", (16, 32, 1, 1, 8, 4, 1, 0, 0)),
    ("new K4 with 4x8 warps", "step", (4, 32, 1, 1, 8, 4, 1, 0, 0)),
)


def _instance(variant, K=4):
    """Substrings of the mangled name of ``variant``'s kernel at ``K``."""
    _, kernel, cfg = STEPS[variant]
    if cfg is None:
        return (f"parent_kernelILi{K}E",)
    args = "".join(f"L{kind}{int(v)}E" for kind, v in zip("iibbiibii", cfg))
    return (f"{kernel}_kernelILi{K}E", f"CfgI{args}E")


def _build(tmp):
    """``k4_steps.cu`` built and loaded, with each kernel instance's
    registers and spill bytes from ptxas."""
    from dexct_tpu_torch.utils import kernels

    so = Path(tmp) / "libk4_steps.so"
    cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", str(so),
           str(_HERE / "k4_steps.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise SystemExit(f"probe_k4_steps: nvcc failed:\n{res.stderr}")
    # registers and spills of each instance, by mangled name
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
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k4_step.argtypes = (I, I, P, P, P, P, I, I, I, F, F, F, F, F, P)
    lib.k4_step.restype = I
    return lib, regs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default=None,
                        help="comma-separated variant numbers (default all)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(_HERE.parents[1]))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_k4_steps: needs a CUDA device")
    from dexct_tpu_torch.ops.fbp_fast import pack_filtered
    from dexct_tpu_torch.tools import probe_fan_backproject as pf

    h = pf._helpers()
    variants = (range(len(STEPS)) if args.variants is None
                else [int(v) for v in args.variants.split(",")])
    print(h._card_line())
    dev = torch.device("cuda")
    cases = {}
    for name in pf.PIN_CASES:
        q, betas, geo = pf.pin_case(name)
        b = torch.as_tensor(betas, device=dev)
        cases[name] = (pack_filtered(torch.as_tensor(q, device=dev)),
                       torch.cos(b), torch.sin(b), q.shape[0], geo)

    with tempfile.TemporaryDirectory() as tmp:
        lib, regs = _build(tmp)

        def call(variant, name):
            packed, cb, sb, K, (sid, dgamma, C, N, fov, dbeta) = cases[name]
            out = torch.empty((K, N, N), device=dev)
            rc = lib.k4_step(variant, K, packed.data_ptr(), cb.data_ptr(),
                             sb.data_ptr(), out.data_ptr(), cb.shape[0], C,
                             N, fov / N, N / 2.0, sid, dgamma, dbeta,
                             torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"probe_k4_steps: variant {variant} on "
                                 f"{name}: cudaError_t {rc}")
            return out

        recs = {v: {"probe": "k4_step", "variant": v, "name": STEPS[v][0],
                    "k4_resources": [r for k, r in regs.items() if all(
                        part in k for part in _instance(v))],
                    "equal_to_parent": {}, "two_launches_equal": True,
                    "device_ms": {"k4": [], "k1": []}}
                for v in variants}
        for name in pf.PIN_CASES:
            ref = call(0, name)
            for v in variants:
                a = call(v, name)
                recs[v]["equal_to_parent"][name] = bool(torch.equal(a, ref))
                recs[v]["two_launches_equal"] &= bool(
                    torch.equal(a, call(v, name)))
        for order in (list(variants), list(variants)[::-1]):
            for v in order:
                for name in ("k4", "k1"):
                    recs[v]["device_ms"][name].append(
                        h._graph_ms(lambda v=v, name=name: call(v, name)))
        for v in variants:
            print(json.dumps(recs[v]))


if __name__ == "__main__":
    main()
