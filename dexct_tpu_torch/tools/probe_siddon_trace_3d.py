"""K10, the exact 3-D Siddon trace, on the card: the sha1s of its pinned
cases, its device time at the paths' shapes, what nvcc made of it, and the
steps of its redesign.

    python dexct_tpu_torch/tools/probe_siddon_trace_3d.py [--root DIR]
        [--reps 10] [--bits] [--time] [--sass] [--sass-dump FILE]
        [--steps] [--parent DIR] [--variants 0,1,2]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one chip call can run a parent and its change in turns
(parent, change, change, parent), each in its own process; unpack the
parent with ``git archive`` into a directory that ``.gitignore`` lists.

The cases (:data:`PIN_CASES`, :func:`pin_case`), each the arguments of one
``trace_paths_3d`` call:

- the paths' rays (:data:`PATH_CASES`), through ``chip_smoke.py``'s
  pelvis (``pelvis_phantom_3d``, 256^2 at 0.2 cm, seven materials): ``cone``
  (360 views x 16 rows x 256 channels, 32 slices), ``helical`` (720 views
  over two turns at pitch 3 cm, 48 slices), ``flat`` (a flat panel),
  ``tilted`` (0.2618 rad), ``zffs`` (a z flying focal spot), ``motion_3d``
  (the cone rays in the object frame of a 0.5 cm breathing drift, as
  ``cone_material_paths_motion`` traces them) and ``kedge`` (the cone rays
  through the pelvis with the K-edge scene's two rods as labels 7 and 8,
  nine materials);
- ragged cases, seeded: ``tiny`` (the card test's 12 x 40 x 40 grid and
  48 x 24 x 8 cone scan), ``axis_x``, ``axis_y``, ``axis_z`` (rays along
  each axis, on and between the cell planes, from outside and inside the
  grid), ``miss`` (rays that miss or graze the grid), ``r1``, ``r33``,
  ``r1001`` (ray counts that are no multiple of 32), ``labels_past``
  (labels up to 255 against six materials) and ``m1``, ``m8``, ``m9``,
  ``m32`` (material counts, labels one past them).

Prints the card's name and power limit, then JSON lines:

- ``"k10_sass"`` (``--sass``): K10's registers, instructions by opcode and
  loops (``sass_stats.py``); ``--sass-dump FILE`` also writes its SASS;
- ``"k10_bits"`` (``--bits``): per case the sha1 of K10's output, whether
  two launches are bit-equal, and its largest difference from the plain
  version on the card;
- ``"k10_time"`` (``--time``): at the cone and helical rays, the device
  time (20 calls in one CUDA graph) and the call (CUDA events over
  ``--reps`` calls), twice each, the walk's steps and the bound
  (``chip_smoke.py``'s: the bytes over 3.35 TB/s, 7 operations a step and
  60 a ray over 67 TFLOP/s);
- ``"k10_step"`` (``--steps``): each variant of :data:`STEPS` in
  ``k10_steps.cu`` (beside this file; built with nvcc and ``-Xptxas
  -v``): its registers, whether its output equals the checkout's K10 bit
  for bit on every case (and, with ``--parent DIR``, the parent
  checkout's K10, built from its ``csrc/siddon_trace_3d.cu``), whether two
  launches are equal, its device time at the cone and helical rays in two
  passes over the variants, the second in reverse, and its loops; the
  checkout's and the parent's K10 are timed in the same passes.

Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

# chip_smoke.py's cone configurations (tools/bench_r3c.py:60-69,
# tools/bench_helical.py:62-66, and the cone one as a flat panel, tilted
# and with a z flying focal spot) as params-file entries
CONE_CONFIGS = {
    "cone": dict(scanner_geometry="cone_beam", N_projections=360,
                 phantom_nz=32),
    "helical": dict(scanner_geometry="helical_cone_beam", N_projections=720,
                    rotation_angle_total=4.0 * np.pi, pitch=3.0,
                    phantom_nz=48),
    "flat": dict(scanner_geometry="flat_panel_cone_beam", N_projections=360,
                 phantom_nz=32),
    "tilted": dict(scanner_geometry="tilted_cone_beam",
                   gantry_tilt_rad=0.2618, N_projections=360, phantom_nz=32),
    "zffs": dict(scanner_geometry="cone_beam", flying_focal_spot="z",
                 N_projections=360, phantom_nz=32),
}
# chip_smoke.py's CONE_DZ_CM and the pelvis K-edge rods (KEDGE_SCENES):
# centres (x, y) [cm] and radius
MOTION_DZ_CM = 0.5
KEDGE_RODS = (((-6.7, -5.1), (6.9, -5.1)), 1.0)

PATH_CASES = ("cone", "helical", "flat", "tilted", "zffs", "motion_3d",
              "kedge")
# name -> (grid [nz, ny, nx], voxel (dx, dy, dz) [cm], rays, materials,
# highest label): seeded cases (rays made by _ragged_rays)
RAGGED_CASES = {
    "tiny": ((12, 40, 40), (0.5, 0.5, 0.5), "tiny_cone", 6, 5),
    "axis_x": ((12, 40, 40), (0.5, 0.5, 0.5), "axis0", 6, 6),
    "axis_y": ((12, 40, 40), (0.5, 0.5, 0.5), "axis1", 6, 6),
    "axis_z": ((12, 40, 40), (0.5, 0.5, 0.5), "axis2", 6, 6),
    "miss": ((12, 40, 40), (0.5, 0.5, 0.5), "miss", 6, 5),
    "r1": ((20, 48, 56), (0.5, 0.45, 0.6), 1, 6, 5),
    "r33": ((20, 48, 56), (0.5, 0.45, 0.6), 33, 6, 5),
    "r1001": ((20, 48, 56), (0.5, 0.45, 0.6), 1001, 6, 5),
    "labels_past": ((20, 48, 56), (0.5, 0.45, 0.6), 4097, 6, 255),
    "m1": ((24, 40, 48), (0.4, 0.5, 0.45), 4097, 1, 2),
    "m8": ((24, 40, 48), (0.4, 0.5, 0.45), 4097, 8, 9),
    "m9": ((24, 40, 48), (0.4, 0.5, 0.45), 4097, 9, 10),
    "m32": ((24, 40, 48), (0.4, 0.5, 0.45), 4097, 32, 33),
}
PIN_CASES = PATH_CASES + tuple(RAGGED_CASES)
TIME_CASES = ("cone", "helical")

# the variants of k10_steps.cu, in its order (the C table's names); each
# adds one step of the redesign to the one before it, variant 0 is the
# parent kernel itself
STEPS = (
    "parent: the 64-bit walk, a register per material, 256 threads",
    "1: the 32-bit walk (predicated axis, max only while a crossing lies "
    "behind t), register selects, the exit tested every step",
    "2: + the exit tested every 16 steps",
    "3: + the sums in shared memory, a row per material and a dump row",
    "4: + the warp's vote between the labels and their x/y-swapped copy "
    "(the kept design)",
    "5: + the block's [threads x M] tile written coalesced (256 threads)",
    "6: as 5 at 128 threads a block",
    "7: as 5 at 512 threads a block",
    "8: as 4 with the exit tested every step",
    "9: as 4 with the exit tested every 8 steps",
    "10: as 4 at 512 threads a block",
)


@functools.lru_cache(maxsize=None)
def _cone_scan(label, root=_HERE):
    """(ct, phantom) of the cone configuration ``label``: its params file
    and pelvis written and read back as ``chip_smoke.py`` does."""
    from dexct_tpu_torch.system.config import read_parameter_file
    from dexct_tpu_torch.system.phantom import pelvis_phantom_3d

    spec = dict(CONE_CONFIGS[label])
    nz = spec.pop("phantom_nz")
    ph = pelvis_phantom_3d(N=256, nz=nz, dx=0.2, dz=0.2)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ph.to_file(str(tmp / f"{label}.bin"), str(tmp / f"{label}.csv"))
        cfg = json.loads((Path(root) / "input" / "params.txt").read_text())
        cfg.update({"RUN_ID": label, "phantom_id": ph.name,
                    "phantom_filename": str(tmp / f"{label}.bin"),
                    "matcomp_filename": str(tmp / f"{label}.csv"),
                    "Nx": 256, "Ny": 256, "Nz": nz, "dx": 0.2, "dy": 0.2,
                    "dz": 0.2, "N_rows": 16, "detector_px_height": 0.25,
                    "N_channels": 256, "SID": 60.0, "SDD": 100.0,
                    "fan_angle_total": 0.8230337,
                    "detector_filename": str(Path(root)
                                             / cfg["detector_filename"]),
                    "N_recon_matrix": 256, "FOV_recon": 40.0, **spec})
        (tmp / f"{label}.txt").write_text(json.dumps(cfg))
        cfg = read_parameter_file(tmp / f"{label}.txt")[0]
    return cfg.ct, cfg.phantom


def _kedge_labels(labels, dx, dy):
    """The pelvis labels [nz, ny, nx] with the K-edge rods as labels n and
    n + 1 (n the count of the pelvis's materials)."""
    centres, radius = KEDGE_RODS
    ny, nx = labels.shape[-2:]
    y = (np.arange(ny) + 0.5 - ny / 2.0) * dy
    x = (np.arange(nx) + 0.5 - nx / 2.0) * dx
    out = np.array(labels, copy=True)
    first = int(out.max()) + 1
    for i, (cx, cy) in enumerate(centres):
        out[..., np.hypot(x[None, :] - cx, y[:, None] - cy) <= radius] = \
            first + i
    return out


def _path_case(name, root):
    """(labels [nz, ny, nx] uint8, src, dirs [V, R, C, 3] float64, voxel,
    materials) of the path case ``name``, on the host."""
    from dexct_tpu_torch.ops.motion import (MotionProfile3D,
                                            rays_in_object_frame)

    scan = {"motion_3d": "cone", "kedge": "cone"}.get(name, name)
    ct, ph = _cone_scan(scan, str(root))
    labels = np.asarray(ph.labels)
    m = int(ph.n_materials)
    src, dirs = ct.ray_geometry_3d()
    if name == "motion_3d":
        track = MotionProfile3D.breathing_z(ct.N_proj,
                                            amplitude_cm=MOTION_DZ_CM)
        src, dirs = rays_in_object_frame(src, dirs, track.phi, track.disp)
    if name == "kedge":
        labels = _kedge_labels(labels, ph.dx, ph.dy)
        m += 2
    return (labels.astype(np.uint8), src, dirs,
            (float(ph.dx), float(ph.dy), float(ph.dz)), m)


def _ragged_rays(kind, shape, vox, rng):
    """(src, dirs) [R, 3] float64 of a ragged case: ``kind`` a ray count
    (random lines, a fifth of them starting inside the grid), "tiny_cone"
    (the card test's cone scan), "axis<i>" (lines along axis i) or
    "miss"."""
    half = 0.5 * np.array(shape[::-1]) * np.array(vox)  # (x, y, z)
    if kind == "tiny_cone":
        from dexct_tpu_torch.system import ConeBeamGeometry

        ct = ConeBeamGeometry(N_channels=48, N_proj=24, N_rows=8, SID=40.0,
                              SDD=70.0, h_iso=0.5)
        return ct.ray_geometry_3d()
    if isinstance(kind, str) and kind.startswith("axis"):
        a = int(kind[-1])
        b, c = [i for i in range(3) if i != a]
        # on the cell planes, between them, and outside the grid
        ub = np.concatenate([np.arange(-half[b], half[b] + 1e-9, vox[b]),
                             rng.uniform(-1.1 * half[b], 1.1 * half[b], 40)])
        uc = np.concatenate([np.arange(-half[c], half[c] + 1e-9, vox[c]),
                             rng.uniform(-1.1 * half[c], 1.1 * half[c], 40)])
        gb, gc = (g.reshape(-1) for g in np.meshgrid(ub, uc))
        n = gb.size
        src = np.zeros((4 * n, 3))
        dirs = np.zeros((4 * n, 3))
        for k, (start, sign) in enumerate(((-2.0, 1.0), (2.0, -1.0),
                                           (0.3, 1.0), (-0.4, -1.0))):
            sl = slice(k * n, (k + 1) * n)
            src[sl, a] = start * half[a]
            src[sl, b], src[sl, c] = gb, gc
            dirs[sl, a] = sign
        return src, dirs
    if kind == "miss":
        n = 2048
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        # lines whose closest point to the centre lies just outside the
        # grid's bounding sphere, or on a face plane, or pointing away
        perp = rng.standard_normal((n, 3))
        perp -= (perp * d).sum(-1, keepdims=True) * d
        perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
        r = np.linalg.norm(half) * rng.uniform(1.0001, 1.5, n)
        src = perp * r[:, None] - 30.0 * d
        away = slice(0, n // 4)  # outside, pointing away from the grid
        src[away] = 2.5 * half * np.sign(rng.standard_normal((n // 4, 3)))
        d[away] = np.sign(src[away]) * np.abs(d[away])
        graze = slice(n // 4, n // 2)  # in a face plane, along it
        src[graze, 0] = half[0]
        d[graze, 0] = 0.0
        d[graze] /= np.linalg.norm(d[graze], axis=-1, keepdims=True)
        src[graze, 1:] -= 30.0 * d[graze, 1:]
        return src, d
    n = int(kind)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aim = rng.uniform(-0.9, 0.9, (n, 3)) * half
    src = aim - 40.0 * d
    inside = rng.random(n) < 0.2
    src[inside] = aim[inside]
    return src, d


def _ragged_case(name):
    shape, vox, kind, m, top = RAGGED_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    labels = rng.integers(0, top + 1, shape).astype(np.uint8)
    if name == "tiny":  # the card test's volume
        labels = np.random.default_rng(3).integers(0, 6, shape).astype(
            np.uint8)
    src, dirs = _ragged_rays(kind, shape, vox, rng)
    return labels, src, dirs, vox, m


def pin_case(name, dev, root=_HERE):
    """One case of :data:`PIN_CASES` on ``dev``: (labels [nz, ny, nx]
    uint8, src, dirs [..., 3] float32 (rounded from the host's float64),
    (dx, dy, dz), n_materials)."""
    import torch

    labels, src, dirs, vox, m = (_path_case(name, root)
                                 if name in PATH_CASES
                                 else _ragged_case(name))
    lab, s, d = (torch.as_tensor(np.ascontiguousarray(x), device=dev)
                 for x in (labels, np.asarray(src, np.float32),
                           np.asarray(dirs, np.float32)))
    return lab, s, d, vox, m


def output_sha1(paths):
    """sha1 of K10's output on the host (float32, C order)."""
    return hashlib.sha1(np.ascontiguousarray(
        paths.detach().cpu().numpy()).tobytes()).hexdigest()


def k10_call(conebeam, case, plain=False):
    """K10's call on ``case`` (:func:`pin_case`'s tuple) through the
    checkout's wrapper (with ``plain``, its plain version)."""
    lab, src, dirs, vox, m = case
    fn = conebeam.trace_paths_3d_plain if plain else conebeam.trace_paths_3d
    return lambda: fn(lab, src, dirs, *vox, n_materials=m)


def _sibling(name):
    """The module ``name`` beside this file (not the measured
    checkout's)."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    """``chip_smoke.py`` beside this checkout, as a module (its ``main``
    does not run)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", _HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work(cs, case, paths):
    """(bytes, operations, steps) of K10 on ``case`` as ``chip_smoke.py``
    counts them: the labels, rays and paths once; 7 operations a step
    and 60 a ray."""
    lab, src, dirs, vox, _ = case
    steps = cs.walk_steps(paths, dirs, vox)
    rays = src.numel() // 3
    return cs.nbytes(lab, src, dirs, paths), 7 * steps + 60 * rays, steps


def _probe_bits(conebeam, root, names):
    import torch

    dev = torch.device("cuda")
    for name in names:
        case = pin_case(name, dev, root)
        call = k10_call(conebeam, case)
        a, b = call(), call()
        want = k10_call(conebeam, case, plain=True)()
        print(json.dumps({
            "probe": "k10_bits", "case": name,
            "rays": case[1].numel() // 3, "M": case[4],
            "sha1": output_sha1(a),
            "two_launches_equal": bool(torch.equal(a, b)),
            "plain_max_abs": float((a - want).abs().max())}), flush=True)
        del case, call, a, b, want
        torch.cuda.empty_cache()


def _probe_time(h, cs, conebeam, root, reps):
    import torch

    dev = torch.device("cuda")
    for name in TIME_CASES:
        case = pin_case(name, dev, root)
        call = k10_call(conebeam, case)
        n_bytes, n_ops, steps = work(cs, case, call())
        b, by = cs.bound(n_bytes, n_ops)
        print(json.dumps({
            "probe": "k10_time", "case": name, "rays": case[1].numel() // 3,
            "M": case[4], "steps": steps,
            "device_ms": [h._graph_ms(call), h._graph_ms(call)],
            "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)],
            "bound_ms": b, "bound_by": by}), flush=True)
        del case, call
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


def _build_steps(tmp, parent):
    """``k10_steps.cu`` and, with ``parent``, the parent checkout's K10
    source, built at once: (steps library, its ptxas report, parent
    library or None)."""
    from dexct_tpu_torch.utils import kernels

    here = Path(__file__).resolve().parent
    procs = [(_nvcc(here / "k10_steps.cu", Path(tmp) / "libk10_steps.so",
                    verbose=True), Path(tmp) / "libk10_steps.so")]
    if parent is not None:
        src = parent / "dexct_tpu_torch" / "csrc" / "siddon_trace_3d.cu"
        procs.append((_nvcc(src, Path(tmp) / "libk10_parent.so"),
                      Path(tmp) / "libk10_parent.so"))
    libs = []
    for proc, so in procs:
        _, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise SystemExit(f"probe_siddon_trace_3d: nvcc failed on "
                             f"{so.name}:\n{err}")
        libs.append((ctypes.CDLL(str(so)), err))
    steps, ptxas = libs[0]
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    # variant, labels, labels_yx, src, dirs, out, then the checkout's
    # dexct_siddon_trace_3d arguments from n_rays on
    steps.k10_step.argtypes = (I, P, P, P, P, P, L) + (I,) * 4 + (F,) * 10 \
        + (I, P)
    steps.k10_step.restype = I
    par = None
    if len(libs) > 1:
        par = libs[1][0]
        par.dexct_siddon_trace_3d.argtypes = (P, P, P, P, L) + (I,) * 4 \
            + (F,) * 10 + (I, P)
        par.dexct_siddon_trace_3d.restype = I
    return steps, ptxas, par


def _probe_steps(h, conebeam, root, parent, variants, dump=None):
    """Each variant on every case against the checkout's K10 (and the
    parent's): bits, device times at :data:`TIME_CASES`, registers and
    loops; with ``dump``, the variants' SASS written there."""
    import torch

    dev = torch.device("cuda")
    cases = {name: pin_case(name, dev, root) for name in PIN_CASES}
    with tempfile.TemporaryDirectory() as tmp:
        lib, ptxas, par = _build_steps(tmp, parent)
        regs = _registers(ptxas)
        sass = _sibling("sass_stats").kernel_stats(
            Path(tmp) / "libk10_steps.so", ("k10v_kernel", "parent_kernel"),
            dump)

        def c_args(name):
            lab, src, dirs, vox, m = cases[name]
            nz, ny, nx = lab.shape
            g0, g1, eps = conebeam._grid_3d((nz, ny, nx), *vox)
            rays = src.numel() // 3
            return (rays, nx, ny, nz, m, *g0, *g1, *vox, eps,
                    conebeam._max_steps((nz, ny, nx)),
                    torch.cuda.current_stream().cuda_stream)

        scratch = {name: torch.empty(
            (c[0].shape[0], c[0].shape[2], c[0].shape[1]), dtype=torch.uint8,
            device=dev) for name, c in cases.items()}

        def call(v, name):
            lab, src, dirs, _, m = cases[name]
            if v == "checkout":
                return k10_call(conebeam, cases[name])().reshape(-1, m)
            out = torch.empty((src.numel() // 3, m), device=dev)
            args = c_args(name)
            if v == "parent":
                rc = par.dexct_siddon_trace_3d(
                    lab.data_ptr(), src.data_ptr(), dirs.data_ptr(),
                    out.data_ptr(), *args)
            else:
                rc = lib.k10_step(v, lab.data_ptr(),
                                  scratch[name].data_ptr(), src.data_ptr(),
                                  dirs.data_ptr(), out.data_ptr(), *args)
            if rc:
                raise SystemExit(f"probe_siddon_trace_3d: {v} on {name}: "
                                 f"cudaError_t {rc}")
            return out

        names = list(variants) + ["checkout"] + (
            ["parent"] if par is not None else [])
        recs = {v: {"probe": "k10_step", "variant": v,
                    "name": v if isinstance(v, str) else STEPS[v],
                    "equal_to_checkout": {}, "equal_to_parent": {},
                    "two_launches_equal": True,
                    "device_ms": {c: [] for c in TIME_CASES}}
                for v in names}
        for v in variants:
            tag = "parent_kernel" if v == 0 else f"k10v_kernelILi{v}E"
            recs[v]["resources"] = {k: r for k, r in regs.items() if tag in k}
            recs[v]["loops"] = {k: s.get("loops") for k, s in sass.items()
                                if tag in k}
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
                for name in TIME_CASES:
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
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--bits", action="store_true",
                        help="the pinned cases' sha1s")
    parser.add_argument("--cases", default=None,
                        help="with --bits, comma-separated case names "
                             "(default all)")
    parser.add_argument("--time", action="store_true",
                        help="device and call times at the paths' shapes")
    parser.add_argument("--sass", action="store_true",
                        help="K10's registers, instructions and loops")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass, write K10's SASS here (with "
                             "--steps also the variants' SASS, to the same "
                             "name with the suffix .steps)")
    parser.add_argument("--steps", action="store_true",
                        help="build and measure the variants of STEPS")
    parser.add_argument("--parent", type=Path, default=None,
                        help="with --steps, a parent checkout whose K10 to "
                             "hold the variants to and time beside them")
    parser.add_argument("--variants", default=None,
                        help="with --steps, comma-separated variant numbers "
                             "(default all)")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    parent = None if args.parent is None else args.parent.resolve()
    h = _sibling("probe_cone_adjoint")
    cs = _chip_smoke()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_siddon_trace_3d: needs a CUDA device")
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.utils import kernels

    if Path(conebeam.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_siddon_trace_3d: imported "
                         f"{conebeam.__file__}, not the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}",
          flush=True)
    kernels.library()
    if args.sass:
        stats = _sibling("sass_stats").kernel_stats(
            kernels.build(), ("siddon_trace_3d_kernel", "swap_xy_kernelIhE"),
            dump)
        print(json.dumps({"probe": "k10_sass", "kernels": stats}), flush=True)
    if args.bits:
        names = (PIN_CASES if args.cases is None
                 else args.cases.split(","))
        _probe_bits(conebeam, root, names)
    if args.time:
        _probe_time(h, cs, conebeam, root, args.reps)
    if args.steps:
        variants = (range(len(STEPS)) if args.variants is None
                    else [int(v) for v in args.variants.split(",")])
        _probe_steps(h, conebeam, root, parent, list(variants),
                     None if dump is None else dump.with_suffix(".steps"))


if __name__ == "__main__":
    main()
