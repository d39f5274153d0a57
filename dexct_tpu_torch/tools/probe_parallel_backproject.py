"""K6, the parallel-beam backprojector, on the card: the sha1s of its
pinned cases, its device time at the paths' shapes, what nvcc made of it,
and the steps of its redesign.

    python dexct_tpu_torch/tools/probe_parallel_backproject.py [--root DIR]
        [--reps 20] [--bits] [--time] [--sass] [--sass-dump FILE]
        [--steps] [--parent DIR] [--variants 0,1,2]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one chip call can run a parent and its change in turns
(parent, change, change, parent), each in its own process; unpack the
parent with ``git archive`` into a directory that ``.gitignore`` lists.

The cases (:data:`PIN_CASES`, :func:`pin_case`): filtered sinograms drawn
standard normal with ``numpy.random.default_rng(seed)``, packed by
``pack_filtered``, on the paths' parallel grids (the reference protocol,
``input/params.txt``: SID 60 cm, fan 0.8230337 rad; 512^2 pixels over 50
cm):

- ``default``, ``default_k1``: the default path's grid, 512 views x 1024
  bins (``parallel_rebin_plan``'s t0 and dt), K = 4 as ``dect_step``
  launches it and K = 1;
- ``ffs``: the in-plane FFS grid, 500 x 1600 (``parallel_rebin_plan_ffs``),
  K = 1 as ``ffs_fbp_recon`` launches it;
- ``parallel``: the parallel-beam config's 1000 views x 800 channels (the
  geometry's ``betas``, ``s_positions[0]`` and ``ds``), K = 1;
- ``sweep``: the dose study's 512 x 1600 grid at K = 4;
- ``k2``, ``k3``: the default grid at K = 2 (the spectral paths' basis
  pair) and K = 3;
- ``n257``, ``n500``: images that no pixel tile divides (257^2 over 24 cm
  from 90 x 96 bins; 500^2 at the default grid, K = 2);
- ``nomask``: ``fov_mask=False`` on 257^2 over 50 cm (corners off the
  detector);
- ``views1100``: 1100 views x 300 bins onto 200^2 over 40 cm, past the
  1024 views K6 stages at a time.

Prints the card's name and power limit, then JSON lines:

- ``"k6_sass"`` (``--sass``): K6's instances' registers, instructions by
  opcode and loops (``sass_stats.py``); ``--sass-dump FILE`` also writes
  their SASS there;
- ``"k6_bits"`` (``--bits``): per case the sha1 of K6's output, whether
  two launches are bit-equal, and its largest difference from the plain
  twin relative to the plain twin's largest value;
- ``"k6_time"`` (``--time``): at :data:`TIME_CASES`, the device time (20
  calls in one CUDA graph) and the call (CUDA events over ``--reps``
  calls), twice each;
- ``"k6_step"`` (``--steps``): each variant of :data:`STEPS` in
  ``k6_steps.cu`` (beside this file; built with nvcc and ``-Xptxas -v``):
  its registers, whether its output equals the checkout's K6 bit for bit
  on every case (and, with ``--parent DIR``, the parent checkout's K6,
  built from its ``csrc/parallel_backproject.cu``), whether two launches
  are equal, and its device time at :data:`STEP_TIME_CASES` in two passes
  over the variants, the second in reverse; the checkout's and the
  parent's K6 are timed in the same passes.

Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

# the reference protocol (input/params.txt)
REF_SID = 60.0
REF_FAN = 0.8230337
REF_ROTATION = 6.283185

# name -> (K images, views, bins, n_matrix, FOV [cm], grid, seed,
# fov_mask); grid "fan" is the fan scan's parallel grid
# (parallel_rebin_plan, parallel_rebin_plan_ffs), "parallel" the
# parallel-beam geometry of the reference protocol
PIN_CASES = {
    "default": (4, 512, 1024, 512, 50.0, "fan", 251, True),
    "default_k1": (1, 512, 1024, 512, 50.0, "fan", 252, True),
    "ffs": (1, 500, 1600, 512, 50.0, "fan", 253, True),
    "parallel": (1, 1000, 800, 512, 50.0, "parallel", 254, True),
    "sweep": (4, 512, 1600, 512, 50.0, "fan", 255, True),
    "k2": (2, 512, 1024, 512, 50.0, "fan", 256, True),
    "k3": (3, 512, 1024, 512, 50.0, "fan", 257, True),
    "n257": (4, 90, 96, 257, 24.0, "fan", 258, True),
    "n500": (2, 512, 1024, 500, 50.0, "fan", 259, True),
    "nomask": (4, 512, 1024, 257, 50.0, "fan", 260, False),
    "views1100": (2, 1100, 300, 200, 40.0, "fan", 261, True),
}
TIME_CASES = ("default", "default_k1", "ffs", "parallel", "sweep")
STEP_TIME_CASES = ("default", "default_k1", "ffs", "parallel", "sweep",
                   "k2", "k3")

# the variants of k6_steps.cu, in its order: (name, its Cfg (TW, BW, BH,
# VEC, UNROLL, PIX, MINB, INNER, LAYOUT, TWO)).  TW x 32/TW pixels a warp
# (LAYOUT 1: an 8 x 4 warp whose groups of 8 lanes are 4 x 2 tiles), BW x
# BH pixels a block; VEC the row in 8- or 16-byte loads (else 2K scalar
# loads); UNROLL views a step of the loop, and with TWO all their rows
# loaded before their sums; PIX pixels a thread (PIX rows of the block
# apart by BH / PIX); MINB blocks an SM (the register cap); INNER the tap:
# 0 fma(a, 1 - f, b f), 1 fma(b, f, a (1 - f)), 2 unfused.  Variant 0 is
# the parent kernel itself, "staged" the shared-memory staging kernel.
STEPS = (
    ('parent: 16x2 warps, scalar loads, a branch per view', None),
    ('d: explicit fma(a, g, b f), 16x2 warps, scalar, branch-free',
     (16, 16, 16, 0, 1, 1, 1, 0, 0, 0)),
    ('d, tap as fma(b, f, a g)', (16, 16, 16, 0, 1, 1, 1, 1, 0, 0)),
    ('d, tap unfused', (16, 16, 16, 0, 1, 1, 1, 2, 0, 0)),
    ('a: + vector row loads', (16, 16, 16, 1, 1, 1, 1, 0, 0, 0)),
    ('c: + 8x4 warp tiles', (8, 16, 16, 1, 1, 1, 1, 0, 0, 0)),
    ('c: 4x8 warp tiles', (4, 16, 16, 1, 1, 1, 1, 0, 0, 0)),
    ('e: 8x4, views unrolled by 4', (8, 16, 16, 1, 4, 1, 1, 0, 0, 0)),
    ('e: 8x4, views unrolled by 8', (8, 16, 16, 1, 8, 1, 1, 0, 0, 0)),
    ('e: 8x4, unrolled by 8, 16x32 blocks', (8, 16, 32, 1, 8, 1, 1, 0, 0, 0)),
    ('e: 8x4, unrolled by 8, 32x8 blocks', (8, 32, 8, 1, 8, 1, 1, 0, 0, 0)),
    ('e: 8x4, unrolled by 8, at least 4 blocks of 256',
     (8, 16, 16, 1, 8, 1, 4, 0, 0, 0)),
    ('e: 8x4, unrolled by 4, at least 6 blocks of 256',
     (8, 16, 16, 1, 4, 1, 6, 0, 0, 0)),
    ('f: 8x4, two pixels a thread, unrolled by 4',
     (8, 16, 16, 1, 4, 2, 1, 0, 0, 0)),
    ('f: 8x4, two pixels a thread, unrolled by 8',
     (8, 16, 16, 1, 8, 2, 1, 0, 0, 0)),
    ('f: 8x4, two pixels a thread, 16x32 blocks, unrolled by 4',
     (8, 16, 32, 1, 4, 2, 1, 0, 0, 0)),
    ('8x4 unrolled by 8 with scalar loads', (8, 16, 16, 0, 8, 1, 1, 0, 0, 0)),
    ('16x2 warps unrolled by 8', (16, 16, 16, 1, 8, 1, 1, 0, 0, 0)),
    ('g: channel windows staged in shared memory (cp.async), 16 views a chunk',
     'staged'),
    ('c: 8x4 warps of 4x2 quarters', (8, 16, 16, 1, 1, 1, 1, 0, 1, 0)),
    ('c: 2x16 warp tiles', (2, 16, 16, 1, 1, 1, 1, 0, 0, 0)),
    ('4x8, unrolled by 4', (4, 16, 16, 1, 4, 1, 1, 0, 0, 0)),
    ('4x8, unrolled by 8', (4, 16, 16, 1, 8, 1, 1, 0, 0, 0)),
    ("e: 4x8, 4 views' rows loaded before their sums",
     (4, 16, 16, 1, 4, 1, 1, 0, 0, 1)),
    ("e: 4x8, 8 views' rows loaded first", (4, 16, 16, 1, 8, 1, 1, 0, 0, 1)),
    ("e: 4x8, 2 views' rows loaded first", (4, 16, 16, 1, 2, 1, 1, 0, 0, 1)),
    ('4x8, 4 views first, at least 4 blocks',
     (4, 16, 16, 1, 4, 1, 4, 0, 0, 1)),
    ('4x8, 4 views first, at least 3 blocks',
     (4, 16, 16, 1, 4, 1, 3, 0, 0, 1)),
    ('4x8, 4 views first, at least 2 blocks',
     (4, 16, 16, 1, 4, 1, 2, 0, 0, 1)),
    ('f: 4x8, two pixels a thread, unrolled by 4',
     (4, 16, 16, 1, 4, 2, 1, 0, 0, 0)),
    ('f: 4x8, two pixels, 2 views first', (4, 16, 16, 1, 2, 2, 1, 0, 0, 1)),
    ('f: 4x8, two pixels, 4 views first', (4, 16, 16, 1, 4, 2, 1, 0, 0, 1)),
    ('4x8, 16x32 blocks, 4 views first', (4, 16, 32, 1, 4, 1, 1, 0, 0, 1)),
    ('4x8, 32x8 blocks, 4 views first', (4, 32, 8, 1, 4, 1, 1, 0, 0, 1)),
    ('4x8 unrolled by 1, at least 4 blocks', (4, 16, 16, 1, 1, 1, 4, 0, 0, 0)),
    ('8x4 of 4x2 quarters, 4 views first', (8, 16, 16, 1, 4, 1, 1, 0, 1, 1)),
    ('4x8, 4 views first, scalar loads', (4, 16, 16, 0, 4, 1, 1, 0, 0, 1)),
    ('4x2 quarters, two pixels, 2 views first',
     (8, 16, 16, 1, 2, 2, 1, 0, 1, 1)),
    ('4x8, two pixels, 2 views first, 32x16 blocks',
     (4, 32, 16, 1, 2, 2, 1, 0, 0, 1)),
    ('4x8, two pixels, 3 views first', (4, 16, 16, 1, 3, 2, 1, 0, 0, 1)),
    ('4x8, two pixels, 2 views first, at least 8 blocks',
     (4, 16, 16, 1, 2, 2, 8, 0, 0, 1)),
    ('4x2 quarters, 3 views first', (8, 16, 16, 1, 3, 1, 1, 0, 1, 1)),
    ('4x2 quarters, 4 views first, 16x8 blocks',
     (8, 16, 8, 1, 4, 1, 1, 0, 1, 1)),
    ('4x2 quarters, 4 views first, 32x16 blocks',
     (8, 32, 16, 1, 4, 1, 1, 0, 1, 1)),
    ('4x8, two pixels, 2 views first, 16x32 blocks',
     (4, 16, 32, 1, 2, 2, 1, 0, 0, 1)),
    ('4x2 quarters, 4 views first, 8x8 blocks',
     (8, 8, 8, 1, 4, 1, 1, 0, 1, 1)),
    ('4x2 quarters, 4 views first, 8x16 blocks',
     (8, 8, 16, 1, 4, 1, 1, 0, 1, 1)),
    ('4x2 quarters, 2 views first, 16x8 blocks',
     (8, 16, 8, 1, 2, 1, 1, 0, 1, 1)),
    ('4x2 quarters, 3 views first, 16x8 blocks',
     (8, 16, 8, 1, 3, 1, 1, 0, 1, 1)),
    ('4x2 quarters, two pixels, 2 views first, 16x8 blocks',
     (8, 16, 8, 1, 2, 2, 1, 0, 1, 1)),
    ('4x2 quarters, two pixels, 2 views first, 8x16 blocks',
     (8, 8, 16, 1, 2, 2, 1, 0, 1, 1)),
    ('4x2 quarters, 4 views first, 16x8 blocks, at least 10 blocks',
     (8, 16, 8, 1, 4, 1, 10, 0, 1, 1)),
    ('4x2 quarters, two pixels, 2 views first, 8x8 blocks',
     (8, 8, 8, 1, 2, 2, 1, 0, 1, 1)),
)


def _fan_grid(nt):
    """(t0, dt) of the fan scan's parallel grid of ``nt`` bins, in the
    plans' operations (float64): t_max = SID sin(fan / 2)."""
    t_max = REF_SID * np.sin(REF_FAN / 2.0)
    dt = 2.0 * t_max / nt
    return float(-t_max + 0.5 * dt), float(dt)


def pin_case(name):
    """One case of :data:`PIN_CASES`: (q [K, V, nt] float32, thetas [V]
    float32, the arguments of ``parallel_backproject_multi`` after
    (packed, K, thetas): (t0, dt, nt, n_matrix, fov, dtheta), fov_mask)."""
    K, V, nt, N, fov, grid, seed, mask = PIN_CASES[name]
    q = np.random.default_rng(seed).normal(size=(K, V, nt)).astype(
        np.float32)
    if grid == "parallel":
        from dexct_tpu_torch.system import ParallelBeamGeometry

        ct = ParallelBeamGeometry(N_channels=nt, N_proj=V,
                                  rotation_total=REF_ROTATION)
        thetas = ct.betas.astype(np.float32)
        t0, dt = float(ct.s_positions[0]), float(ct.ds)
        dtheta = ct.rotation_total / ct.N_proj * (np.pi / ct.rotation_total)
    else:
        thetas = (np.arange(V) * (np.pi / V)).astype(np.float32)
        t0, dt = _fan_grid(nt)
        dtheta = np.pi / V
    return q, thetas, (t0, dt, nt, N, fov, float(dtheta)), mask


def output_sha1(img):
    """sha1 of a float32 image stack's bytes (on the host, C order)."""
    return hashlib.sha1(
        np.ascontiguousarray(img.detach().cpu().numpy()).tobytes()).hexdigest()


def _sibling(name):
    """The module ``name`` beside this file (not the measured
    checkout's)."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def case_tensors(fbp_fast, name, dev):
    """(packed, K, thetas, args, fov_mask) of case ``name`` on ``dev``."""
    import torch

    q, thetas, args, mask = pin_case(name)
    packed = fbp_fast.pack_filtered(torch.as_tensor(q, device=dev))
    return packed, q.shape[0], torch.as_tensor(thetas, device=dev), args, mask


def k6_call(fbp_fast, name, dev, plain=False):
    """K6's call on case ``name`` through the checkout's wrapper (with
    ``plain``, its plain twin's)."""
    packed, K, th, args, mask = case_tensors(fbp_fast, name, dev)
    fn = (fbp_fast.parallel_backproject_multi_plain if plain
          else fbp_fast.parallel_backproject_multi)
    return lambda: fn(packed, K, th, *args, fov_mask=mask)


def _probe_bits(fbp_fast):
    import torch

    dev = torch.device("cuda")
    for name in PIN_CASES:
        call = k6_call(fbp_fast, name, dev)
        a, b = call(), call()
        want = k6_call(fbp_fast, name, dev, plain=True)()
        print(json.dumps({
            "probe": "k6_bits", "case": name, "sha1": output_sha1(a),
            "two_launches_equal": bool(torch.equal(a, b)),
            "plain_max_rel": float((a - want).abs().max()
                                   / want.abs().max())}), flush=True)
        del call, a, b, want
        torch.cuda.empty_cache()


def _probe_time(h, fbp_fast, reps):
    import torch

    dev = torch.device("cuda")
    for name in TIME_CASES:
        call = k6_call(fbp_fast, name, dev)
        print(json.dumps({
            "probe": "k6_time", "case": name,
            "device_ms": [h._graph_ms(call), h._graph_ms(call)],
            "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)]}),
            flush=True)
        del call
        torch.cuda.empty_cache()


def _nvcc(src, so, verbose=False):
    """nvcc ``src`` into the shared library ``so`` with the package's
    flags, started (a ``Popen``; with ``verbose`` ptxas reports on
    stderr)."""
    from dexct_tpu_torch.utils import kernels

    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(src)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _registers(ptxas):
    """{mangled kernel name: {"registers": n, "spill_bytes": m}} from
    ptxas's ``-v`` report."""
    regs, cur = {}, None
    for line in ptxas.splitlines():
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


def _instance(variant, K):
    """Substrings of the mangled name of ``variant``'s kernel at ``K``."""
    cfg = STEPS[variant][1]
    if cfg is None:
        return (f"parent_kernelILi{K}E",)
    if cfg == "staged":
        return (f"staged_kernelILi{K}E",)
    args = "".join(f"L{kind}{int(v)}E"
                   for kind, v in zip("iiibiiiiib", cfg))
    return (f"step_kernelILi{K}E", f"CfgI{args}E")


def _build_steps(tmp, parent):
    """``k6_steps.cu`` and, with ``parent``, the parent checkout's K6
    source, built at once: (steps library, its registers, parent library
    or None)."""
    from dexct_tpu_torch.utils import kernels

    procs = [(_nvcc(Path(__file__).resolve().parent / "k6_steps.cu",
                    Path(tmp) / "libk6_steps.so", verbose=True),
              Path(tmp) / "libk6_steps.so")]
    if parent is not None:
        src = parent / "dexct_tpu_torch" / "csrc" / "parallel_backproject.cu"
        procs.append((_nvcc(src, Path(tmp) / "libk6_parent.so"),
                      Path(tmp) / "libk6_parent.so"))
    libs = []
    for proc, so in procs:
        out, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise SystemExit(f"probe_parallel_backproject: nvcc failed on "
                             f"{so.name}:\n{err}")
        libs.append((ctypes.CDLL(str(so)), err))
    steps, ptxas = libs[0]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    steps.k6_step.argtypes = (I, P, P, P, P, P, I, I, I, I, F, F, F, F, F,
                              P)
    steps.k6_step.restype = I
    par = None
    if len(libs) > 1:
        par = libs[1][0]
        par.dexct_parallel_backproject.argtypes = kernels._SIGNATURES[
            "dexct_parallel_backproject"]
        par.dexct_parallel_backproject.restype = I
    return steps, _registers(ptxas), par


def _probe_steps(h, fbp_fast, parent, variants, dump=None):
    """Each variant on every case against the checkout's K6 (and the
    parent's): bits and device times; with ``dump``, the variants' SASS
    written there."""
    import torch

    from dexct_tpu_torch.utils import kernels

    dev = torch.device("cuda")
    cases = {}
    for name in PIN_CASES:
        packed, K, th, (t0, dt, nt, N, fov, dth), mask = case_tensors(
            fbp_fast, name, dev)
        m = fbp_fast._fov_disc_mask_on(N, fov, dev) if mask else None
        cases[name] = (packed, torch.cos(th), torch.sin(th), m, K,
                       th.shape[0], nt, N, fov / N, N / 2.0, t0, dt, dth)

    with tempfile.TemporaryDirectory() as tmp:
        lib, regs, par = _build_steps(tmp, parent)
        if dump is not None:
            names = sorted({_instance(v, K)[-1] for v in variants
                            for K in (1, 4)})
            _sibling("sass_stats").kernel_stats(
                Path(tmp) / "libk6_steps.so", names, dump)

        def run(fn, name, *head):
            (packed, ct, st, m, K, V, nt, N, px, half, t0, dt,
             dth) = cases[name]
            out = torch.empty((K, N, N), device=dev)
            rc = fn(*head, packed.data_ptr(), ct.data_ptr(), st.data_ptr(),
                    None if m is None else m.data_ptr(), out.data_ptr(), K,
                    V, nt, N, px, half, t0, dt, dth,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"probe_parallel_backproject: {head} on "
                                 f"{name}: cudaError_t {rc}")
            return out

        # the checkout's and the parent's C entries, called as the variants
        # are (the wrapper's Python left out of all of them)
        entries = {"checkout": kernels.library().dexct_parallel_backproject}
        if par is not None:
            entries["parent"] = par.dexct_parallel_backproject

        def call(v, name):
            if v in entries:
                return run(entries[v], name)
            return run(lib.k6_step, name, v)

        names = list(variants) + ["checkout"] + (
            ["parent"] if par is not None else [])
        recs = {v: {"probe": "k6_step", "variant": v,
                    "name": v if isinstance(v, str) else STEPS[v][0],
                    "equal_to_checkout": {}, "equal_to_parent": {},
                    "two_launches_equal": True,
                    "device_ms": {c: [] for c in STEP_TIME_CASES}}
                for v in names}
        for v in variants:
            recs[v]["resources"] = {
                K: [r for k, r in regs.items()
                    if all(p in k for p in _instance(v, K))]
                for K in (1, 4)}
        for name in PIN_CASES:
            ref = call("checkout", name)
            pref = call("parent", name) if par is not None else None
            for v in names:
                a = call(v, name)
                recs[v]["equal_to_checkout"][name] = bool(torch.equal(a, ref))
                if pref is not None:
                    recs[v]["equal_to_parent"][name] = bool(
                        torch.equal(a, pref))
                recs[v]["two_launches_equal"] &= bool(
                    torch.equal(a, call(v, name)))
        for order in (names, names[::-1]):
            for v in order:
                for name in STEP_TIME_CASES:
                    recs[v]["device_ms"][name].append(
                        h._graph_ms(lambda v=v, name=name: call(v, name)))
    for v in names:
        rec = recs[v]
        rec["all_equal_to_checkout"] = all(rec["equal_to_checkout"].values())
        if par is not None:
            rec["all_equal_to_parent"] = all(rec["equal_to_parent"].values())
        print(json.dumps(rec), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--bits", action="store_true",
                        help="the pinned cases' sha1s")
    parser.add_argument("--time", action="store_true",
                        help="device and call times at the paths' shapes")
    parser.add_argument("--sass", action="store_true",
                        help="K6's registers, instructions and loops")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass, write K6's SASS here (with "
                             "--steps also the variants' SASS, to the same "
                             "name with the suffix .steps)")
    parser.add_argument("--steps", action="store_true",
                        help="build and measure the variants of STEPS")
    parser.add_argument("--parent", type=Path, default=None,
                        help="with --steps, a parent checkout whose K6 to "
                             "hold the variants to and time beside them")
    parser.add_argument("--variants", default=None,
                        help="with --steps, comma-separated variant numbers "
                             "(default all)")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    parent = None if args.parent is None else args.parent.resolve()
    h = _sibling("probe_cone_adjoint")
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_parallel_backproject: needs a CUDA device")
    from dexct_tpu_torch.ops import fbp_fast
    from dexct_tpu_torch.utils import kernels

    if Path(fbp_fast.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_parallel_backproject: imported "
                         f"{fbp_fast.__file__}, not the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}",
          flush=True)
    kernels.library()
    if args.sass:
        stats = _sibling("sass_stats").kernel_stats(
            kernels.build(), ("parallel_backproject_kernel",), dump)
        print(json.dumps({"probe": "k6_sass", "kernels": stats}), flush=True)
    if args.bits:
        _probe_bits(fbp_fast)
    if args.time:
        _probe_time(h, fbp_fast, args.reps)
    if args.steps:
        variants = (range(len(STEPS)) if args.variants is None
                    else [int(v) for v in args.variants.split(",")])
        _probe_steps(h, fbp_fast, parent, list(variants),
                     None if dump is None else dump.with_suffix(".steps"))


if __name__ == "__main__":
    main()
