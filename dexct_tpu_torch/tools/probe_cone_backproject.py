"""K12, the helical gFDK backprojector, and K11, the circular FDK
backprojector, on the card: the sha1s of their pinned cases, their device
times at the paths' shapes, what nvcc made of them, and the steps of their
redesigns; and the sha1s of K32's and K33's pinned cases.

    python dexct_tpu_torch/tools/probe_cone_backproject.py [--root DIR]
        [--kernel k12|k11|motion] [--reps 10] [--bits] [--time] [--sass]
        [--sass-dump FILE] [--steps] [--parent DIR] [--variants 0,1,2]

``--kernel`` picks the kernel (default ``k12``); ``motion`` has ``--bits``
only.  K11's cases, lines and steps are described after K12's below.

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one chip call can run a parent and its change in turns
(parent, change, change, parent), each in its own process; unpack the
parent with ``git archive`` into a directory that ``.gitignore`` lists.

The cases (:data:`PIN_CASES`, :func:`pin_case`), each the arguments of one
``_helical_backproject`` call on seeded filtered stacks (standard normal
float32 from the case's name):

- ``helical_<weighting>``: the helical configuration of ``chip_smoke.py``
  (720 views over two turns at pitch 3 cm, 16 rows x 256 channels, 19
  slices over the central 80 % of the travel, 256^2 over 40 cm, K = 4) in
  each of the six view weightings;
- ``zffs``: the circular z flying focal spot's call (the cone config, 360
  views, pitch 0, 16 slices, the window centred on the orbit, nonzero
  per-view row offsets), K = 4;
- ``k1``, ``k2``, ``k3``: the helical configuration in ``full`` at K = 1,
  2, 3;
- ``ragged_<weighting>``: a 50-view helix over 1.2 pi (pitch 1.5 cm, 6
  rows x 40 channels), a 37^2 grid (1085 disc pixels, no multiple of 32),
  one slice whose window runs off the first and the last view, K = 2;
- ``ragged_nz7``: the same detector over two turns (120 views), 7 slices,
  random row offsets, K = 3.

Prints the card's name and power limit, then JSON lines:

- ``"k12_sass"`` (``--sass``): K12's registers, instructions by opcode and
  loops (``sass_stats.py``) at K = 4; ``--sass-dump FILE`` writes its SASS;
- ``"k12_bits"`` (``--bits``): per case the sha1 of K12's output, whether
  two launches are bit-equal, and its largest difference from the plain
  version on the card;
- ``"k12_time"`` (``--time``): at the helical configuration in each
  weighting and at the z-FFS case, the device time (20 calls in one CUDA
  graph) and the call (CUDA events over ``--reps`` calls), twice each,
  with the terms and the bound (``chip_smoke.py``'s);
- ``"k12_step"`` (``--steps``): each variant of :data:`STEPS` in
  ``k12_steps.cu`` (beside this file; built with nvcc and ``-Xptxas
  -v``): its registers, whether its output equals the checkout's K12 bit
  for bit on every case (and, with ``--parent DIR``, the parent
  checkout's K12, built from its ``csrc/cone_backproject.cu``), whether two
  launches are equal, its device time at the helical ``full`` case in two
  passes over the variants, the second in reverse, and its loops; the
  checkout's and the parent's K12 are timed in the same passes.

K11's cases (:data:`K11_PIN_CASES`, :func:`k11_case`), each the arguments
of one ``_fdk_backproject_multi`` call on seeded filtered stacks:

- ``cone``: the cone configuration of ``chip_smoke.py`` (360 views x 16
  rows x 256 channels, 256^2 x 16 slices of ``h_iso`` over 40 cm), K = 4;
  ``k1``, ``k2``, ``k3``: the same at K = 1, 2, 3;
- ``tilted``: the tilted configuration's gantry grid (``_tilted_grid``:
  258^2 x 60 slices), K = 4;
- ``warm``: ``cone_pwls``'s FDK warm start (the cone scan onto the
  phantom's 256^2 x 32 voxel grid at 0.2 cm), K = 1;
- ``ragged``: a 600-view orbit of a 6-row x 40-channel detector onto a
  37^2 grid (1085 disc pixels) of 5 slices centred at z = 0.3 cm (no
  slice mirrors another), K = 2; ``ragged_odd``: the same with 7 slices
  centred at 0 (the middle slice its own mirror), K = 3.

Its lines: ``"k11_sass"``, ``"k11_bits"``, ``"k11_time"`` (at
:data:`K11_TIME_CASES`) and ``"k11_step"`` as K12's, the variants those of
:data:`K11_STEPS` in ``k11_steps.cu``, each packed variant timed with its
pack (as the wrapper packs), the parent through its C entry.

K32's and K33's cases (:data:`MOTION_PIN_CASES`, :func:`motion_case`),
seeded stacks under seeded rigid poses: ``k32_cone`` (the cone
configuration, K = 4), ``k33_helical`` (the helical configuration's 19
slices, K = 4) and ``k33_ragged`` (a 120-view helix over two turns of the
ragged detector, 37^2 x 7 slices, K = 3); ``"motion_bits"`` as
``"k12_bits"``.

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
import types
import zlib
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parents[2]

WEIGHTINGS = ("full", "feather", "td", "cosz", "short", "pair")
# chip_smoke.py's reconstruction grid of the cone configurations
N_MATRIX, FOV = 256, 40.0
# the ragged detector: (views, turns in pi, pitch [cm]) per case
RAGGED_DETECTOR = dict(N_channels=40, N_rows=6, SID=40.0, SDD=70.0,
                       h_iso=0.5, gamma_fan=0.7)
RAGGED_GRID = (37, 18.0)  # 1085 disc pixels

PATH_CASES = tuple(f"helical_{w}" for w in WEIGHTINGS) + ("zffs", "k1",
                                                           "k2", "k3")
RAGGED_CASES = tuple(f"ragged_{w}" for w in WEIGHTINGS) + ("ragged_nz7",)
PIN_CASES = PATH_CASES + RAGGED_CASES
TIME_CASES = tuple(f"helical_{w}" for w in WEIGHTINGS) + ("zffs",)


def _sibling(name):
    """The module ``name`` beside this file (not the measured
    checkout's)."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _scan(label, root):
    """The geometry of ``chip_smoke.py``'s cone configuration ``label``
    (``probe_siddon_trace_3d``'s params file, read back)."""
    return _sibling("probe_siddon_trace_3d")._cone_scan(label, root)[0]


def _helical_args(ct, n_matrix, fov, nz_out=None, row_off=None):
    """``_helical_backproject``'s geometry arguments after q on the helix
    ``ct`` as ``pack_cone_dect`` forms them (host float64 arrays), and its
    ``dbeta``."""
    pitch = float(ct.pitch)
    if nz_out is None:
        half = 0.4 * pitch * ct.rotation_total / (2.0 * np.pi)
        nz_out = max(int(2.0 * half / ct.h_iso), 1)
        dz_out = 2.0 * half / nz_out
    else:
        dz_out = float(ct.h_iso)
    z0 = (0.5 - nz_out / 2.0) * dz_out
    zv = z0 + dz_out * np.arange(nz_out)
    V = ct.N_proj
    row_off = np.zeros(V) if row_off is None else row_off
    beta_c = 0.5 * ct.rotation_total + 2.0 * np.pi * zv / pitch
    return ((ct.betas, ct.source_z, row_off, beta_c, float(ct.SID),
             float(ct.dgamma), float(ct.h_iso), int(ct.N_rows), pitch,
             int(n_matrix), int(nz_out), float(fov), float(dz_out),
             float(z0)), float(ct.rotation_total / V))


def _zffs_args(ct, n_matrix, fov):
    """The z flying focal spot's K12 call as ``fdk_reconstruct`` makes it
    (``chip_smoke.py``'s z-FFS phase)."""
    R = ct.N_rows
    off = np.asarray(ct.ffs_view_offsets, np.float64)
    row_off = off * ct.SID / (ct.SDD * ct.h_iso)
    z0 = (0.5 - R / 2.0) * ct.h_iso
    return ((ct.betas, off, row_off, np.full(R, 0.5 * ct.rotation_total),
             float(ct.SID), float(ct.dgamma), float(ct.h_iso), int(R), 0.0,
             int(n_matrix), int(R), float(fov), float(ct.h_iso), float(z0)),
            float(ct.rotation_total / ct.N_proj))


def _ragged_geometry(views, turns_pi, pitch):
    from dexct_tpu_torch.system.geometry import HelicalConeBeamGeometry

    return HelicalConeBeamGeometry(N_proj=views, pitch=pitch,
                                   rotation_total=turns_pi * np.pi,
                                   **RAGGED_DETECTOR)


def case_spec(name, root=_HERE):
    """(K, weighting, host geometry arguments, dbeta) of the case
    ``name``."""
    root = str(root)
    if name.startswith("helical_"):
        args, dbeta = _helical_args(_scan("helical", root), N_MATRIX, FOV)
        return 4, name[len("helical_"):], args, dbeta
    if name == "zffs":
        args, dbeta = _zffs_args(_scan("zffs", root), N_MATRIX, FOV)
        return 4, "full", args, dbeta
    if name in ("k1", "k2", "k3"):
        args, dbeta = _helical_args(_scan("helical", root), N_MATRIX, FOV)
        return int(name[1]), "full", args, dbeta
    if name == "ragged_nz7":
        ct = _ragged_geometry(120, 4.0, 1.5)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        args, dbeta = _helical_args(ct, *RAGGED_GRID, nz_out=7,
                                    row_off=rng.uniform(-0.4, 0.4, 120))
        return 3, "full", args, dbeta
    w = name[len("ragged_"):]
    if w not in WEIGHTINGS:
        raise KeyError(name)
    ct = _ragged_geometry(50, 1.2, 1.5)
    args, dbeta = _helical_args(ct, *RAGGED_GRID, nz_out=1)
    return 2, w, args, dbeta


def pin_case(name, dev, root=_HERE):
    """One case of :data:`PIN_CASES` on ``dev``: (q [K, V, R, C] float32,
    the geometry arguments of ``_helical_backproject`` with its arrays as
    float32 tensors, the keywords ``dbeta`` and ``weighting``)."""
    import torch

    K, w, args, dbeta = case_spec(name, root)
    arrays = tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                   for a in args[:4])
    V, R = len(args[0]), args[7]
    C = RAGGED_DETECTOR["N_channels"] if name.startswith("ragged") else 256
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = torch.as_tensor(rng.standard_normal((K, V, R, C), np.float32),
                        device=dev)
    return q, arrays + args[4:], dict(dbeta=dbeta, weighting=w)


def k12_call(conebeam, case, plain=False):
    """K12's call on ``case`` (:func:`pin_case`'s tuple) through the
    checkout's wrapper (with ``plain``, its plain version)."""
    q, args, kw = case
    if plain:
        return lambda: conebeam._helical_backproject_plain(
            q, *args, weighting=kw["weighting"])
    return lambda: conebeam._helical_backproject(q, *args, **kw)


def output_sha1(vol):
    """sha1 of K12's output on the host (float32, C order)."""
    return hashlib.sha1(np.ascontiguousarray(
        vol.detach().cpu().numpy()).tobytes()).hexdigest()


def _chip_smoke():
    """``chip_smoke.py`` beside this checkout, as a module (its ``main``
    does not run)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", _HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work(cs, conebeam, case, vol):
    """(bytes, operations, terms on the detector, terms with taps) of K12
    on ``case`` as ``chip_smoke.py`` counts them."""
    q, args, kw = case
    K, V, R, C = q.shape
    meta = types.SimpleNamespace(
        vrc=(V, R, C), sid=args[4], dgamma=args[5], row_h=args[6],
        pitch=args[8], n_matrix=args[9], nz_out=args[10], fov=args[11],
        dz_out=args[12], z0=args[13])
    a = dict(zip(("betas", "src_z", "row_off", "beta_c"), args[:4]))
    X, Y, _ = conebeam._disc(meta.n_matrix, meta.fov, q.device)
    P = X.shape[0]
    on, taps = cs.helical_terms(a, meta, kw["weighting"], X, Y)
    return (cs.nbytes(q, vol) + 8 * P + 16 * V,
            cs.PLANE_OPS * P * V
            + (cs.MOTION_ROW_OPS + cs.WEIGHT_OPS[kw["weighting"]]) * on
            + (cs.MOTION_TAP_OPS + 7 * K) * taps, on, taps)


def _probe_bits(conebeam, root, names):
    import torch

    dev = torch.device("cuda")
    for name in names:
        case = pin_case(name, dev, root)
        call = k12_call(conebeam, case)
        a, b = call(), call()
        want = k12_call(conebeam, case, plain=True)()
        print(json.dumps({
            "probe": "k12_bits", "case": name, "shape": list(a.shape),
            "weighting": case[2]["weighting"], "sha1": output_sha1(a),
            "two_launches_equal": bool(torch.equal(a, b)),
            "plain_max_abs": float((a - want).abs().max()),
            "plain_max": float(want.abs().max())}), flush=True)
        del case, call, a, b, want
        torch.cuda.empty_cache()


def _probe_time(h, cs, conebeam, root, reps):
    import torch

    dev = torch.device("cuda")
    for name in TIME_CASES:
        case = pin_case(name, dev, root)
        call = k12_call(conebeam, case)
        n_bytes, n_ops, on, taps = work(cs, conebeam, case, call())
        b, by = cs.bound(n_bytes, n_ops)
        print(json.dumps({
            "probe": "k12_time", "case": name,
            "weighting": case[2]["weighting"], "terms_on_detector": on,
            "terms_with_taps": taps,
            "device_ms": [h._graph_ms(call), h._graph_ms(call)],
            "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)],
            "bound_ms": b, "bound_by": by}), flush=True)
        del case, call
        torch.cuda.empty_cache()


# the variants of k12_steps.cu, in its order; each adds one step of the
# redesign, variant 0 is the parent kernel itself
STEPS = (
    "parent: a thread per (pixel, slice), the in-plane geometry per term, "
    "16 scalar taps at K = 4, 128 threads",
    "1: a thread per (pixel, 4 slices), the in-plane geometry once per "
    "view, scalar taps",
    "2: as 1 with 8 slices a thread",
    "3: as 1 with all 19 slices a thread",
    "4: as 2 with (z - src_z) sid and beta - beta_c from a shared table",
    "5: as 2 with the packed taps",
    "6: as 5 at 256 threads a block",
    "7: as 5 with 4 slices a thread",
    "8: as 5 with all 19 slices a thread",
    "9: as 5 with 4's shared table",
    "10: a block of 32 pixels x up to 8 slices, a (pixel, slice) a thread, "
    "each 32 views' in-plane geometry staged in shared memory, packed taps",
    "11: as 10 with up to 16 slices a block",
    "12: as 5 with the slices' constants in shared memory",
    "13: as 12 bounded to 6 blocks an SM",
    "14: as 7 with the slices' constants in shared memory, bounded to 8 "
    "blocks an SM (the kept design, less full's product by 1)",
    "15: as 12 with 10 slices a thread, bounded to 5 blocks an SM",
    "16: as 14 with 5 slices a thread",
    "17: as 14 in 64-thread blocks bounded to 16 blocks an SM",
)


def _nvcc(src, so, defines=(), verbose=False):
    """nvcc ``src`` into the shared library ``so`` with the package's
    flags, started (a ``Popen``; with ``verbose`` ptxas reports on
    stderr)."""
    from dexct_tpu_torch.utils import kernels

    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-shared", "-o",
           str(so), str(src)]
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


def _build_steps(tmp, variants, parent, kernel="k12"):
    """Each variant of ``<kernel>_steps.cu`` and, with ``parent``, the
    parent checkout's ``csrc/cone_backproject.cu``, built at once, one nvcc
    each: ({variant: (library, ptxas report, path)}, parent library or
    None)."""
    here = Path(__file__).resolve().parent
    define = kernel.upper() + "_VARIANT"
    jobs = {v: (Path(tmp) / f"lib{kernel}_step{v}.so", _nvcc(
        here / f"{kernel}_steps.cu", Path(tmp) / f"lib{kernel}_step{v}.so",
        (f"-D{define}={v}",), verbose=True)) for v in variants}
    if parent is not None:
        so = Path(tmp) / f"lib{kernel}_parent.so"
        jobs["parent"] = (so, _nvcc(
            parent / "dexct_tpu_torch" / "csrc" / "cone_backproject.cu", so))
    libs = {}
    for v, (so, proc) in jobs.items():
        _, err = proc.communicate(timeout=1500)
        if proc.returncode:
            raise SystemExit(f"probe_cone_backproject: nvcc failed on "
                             f"{so.name}:\n{err}")
        libs[v] = (ctypes.CDLL(str(so)), err, so)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    if kernel == "k11":  # dexct_fdk_backproject's arguments
        args = (P,) * 8 + (I,) * 6 + (L,) + (F,) * 4 + (P,)
        entry = "dexct_fdk_backproject"
    else:
        # the parent's dexct_helical_backproject: the checkout's arguments
        # with beta0 before dbeta
        args = (P,) * 12 + (I,) * 7 + (L,) + (F,) * 16 + (P,)
        entry = "dexct_helical_backproject"
    for v, (lib, _, _) in libs.items():
        fn = getattr(lib, entry if v == "parent" else f"{kernel}_step")
        fn.argtypes, fn.restype = args, I
    par = libs.pop("parent", (None,))[0]
    return libs, par


def _c_args(conebeam, case):
    """The C arguments of a K12 launch on ``case`` after the stacks and
    before the stream, with beta0 (host) before dbeta, and the arrays they
    point to (kept alive by the caller)."""
    import torch

    q, args, kw = case
    K, V, R, C = q.shape
    (betas, src_z, row_off, beta_c, sid, dgamma, row_h, _, pitch, n_matrix,
     nz, fov, dz_out, z0) = args
    X, Y, sel = conebeam._disc(n_matrix, fov, q.device)
    zc = conebeam._helical_z(nz, dz_out, z0, q.device)
    cos_b, sin_b = torch.cos(betas), torch.sin(betas)
    out = torch.zeros((K, nz, n_matrix, n_matrix), device=q.device)
    k = conebeam._window_constants(kw["weighting"], C, dgamma, pitch, row_h,
                                   R, sid)
    keep = (cos_b, sin_b, betas, src_z, row_off, beta_c, X, Y, sel, zc)
    c_args = ([t.data_ptr() for t in keep] + [out.data_ptr(), K,
              WEIGHTINGS.index(kw["weighting"]), V, R, C, X.shape[0], nz,
              n_matrix * n_matrix, sid, dgamma, row_h,
              float(betas[0].cpu()), kw["dbeta"]]
              + [k[name] for name in conebeam._WINDOW_ARGS])
    return c_args, out, keep


def _probe_steps(h, conebeam, root, parent, variants):
    """Each variant on every case against the checkout's K12 (and the
    parent's): bits, registers, loops and device times at the helical
    ``full`` case; the checkout and the parent timed in the same passes
    at every case of :data:`TIME_CASES`."""
    import torch

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs, par = _build_steps(tmp, variants, parent)
        cache = {}

        def setup(name):
            if name not in cache:
                case = pin_case(name, dev, root)
                c_args, out, keep = _c_args(conebeam, case)
                cache[name] = (case, c_args, out, keep,
                               conebeam._pack_images(case[0]))
            return cache[name]

        def call(v, name):
            case, c_args, out, _, packed = setup(name)
            # the current stream: a CUDA graph captures on its own
            stream = torch.cuda.current_stream().cuda_stream
            if v == "checkout":
                return k12_call(conebeam, case)()
            if v == "parent":
                rc = par.dexct_helical_backproject(case[0].data_ptr(),
                                                   *c_args, stream)
            else:
                lib = libs[v][0]
                q = packed if lib.k12_step_packed() else case[0]
                rc = lib.k12_step(q.data_ptr(), *c_args, stream)
            if rc:
                raise SystemExit(f"probe_cone_backproject: {v} on {name}: "
                                 f"cudaError_t {rc}")
            return out

        # timed parent, checkout, variants, then in reverse
        names = (["parent"] if par is not None else []) + ["checkout"] + \
            list(variants)
        recs = {v: {"probe": "k12_step", "variant": v,
                    "name": v if isinstance(v, str) else STEPS[v],
                    "equal_to_checkout": {}, "equal_to_parent": {},
                    "two_launches_equal": True,
                    "device_ms": {c: [] for c in TIME_CASES}}
                for v in names}
        sass = _sibling("sass_stats")
        for v in variants:
            recs[v]["resources"] = _registers(libs[v][1])
            tag = {0: "parent_kernel", 10: "tile_kernel",
                   11: "tile_kernel"}.get(v, "k12v_kernel")
            st = sass.kernel_stats(libs[v][2], (tag + "ILi4ELi0E",))
            recs[v]["sass"] = {k: {"resources": s.get("resources"),
                                   "instructions": s.get("instructions"),
                                   "loops": s.get("loops")}
                               for k, s in st.items()}
        for name in PIN_CASES:
            ref = call("checkout", name).clone()
            pref = (call("parent", name).clone() if par is not None
                    else None)
            for v in names:
                a = call(v, name).clone()
                recs[v]["equal_to_checkout"][name] = bool(torch.equal(a, ref))
                if pref is not None:
                    recs[v]["equal_to_parent"][name] = bool(
                        torch.equal(a, pref))
                recs[v]["two_launches_equal"] &= bool(
                    torch.equal(a, call(v, name)))
            if name not in TIME_CASES:
                del cache[name]
            torch.cuda.empty_cache()
        for order in (names, names[::-1]):
            for v in order:
                for name in TIME_CASES:
                    if isinstance(v, int) and name != "helical_full":
                        continue
                    recs[v]["device_ms"][name].append(
                        h._graph_ms(lambda v=v, name=name: call(v, name)))
    for v in names:
        rec = recs[v]
        rec["device_ms"] = {c: t for c, t in rec["device_ms"].items() if t}
        rec["all_equal_to_checkout"] = all(rec["equal_to_checkout"].values())
        if par is not None:
            rec["all_equal_to_parent"] = all(rec["equal_to_parent"].values())
        print(json.dumps(rec), flush=True)



# ---------------------------------------------------------------------------
# K11, the circular FDK backprojector
# ---------------------------------------------------------------------------

K11_PATH_CASES = ("cone", "k1", "k2", "k3", "tilted", "warm")
K11_RAGGED_CASES = ("ragged", "ragged_odd")
K11_PIN_CASES = K11_PATH_CASES + K11_RAGGED_CASES
K11_TIME_CASES = ("cone", "tilted", "warm")


def _ragged_orbit(views):
    from dexct_tpu_torch.system.geometry import ConeBeamGeometry

    return ConeBeamGeometry(N_proj=views, **RAGGED_DETECTOR)


def k11_spec(name, root=_HERE):
    """(K, the scan, (n_matrix, nz_out, fov, dz_out, z_center)) of the K11
    case ``name``."""
    root = str(root)
    if name in ("cone", "k1", "k2", "k3"):
        ct = _scan("cone", root)
        K = 4 if name == "cone" else int(name[1])
        return K, ct, (N_MATRIX, int(ct.N_rows), FOV, float(ct.h_iso), 0.0)
    if name == "warm":  # chip_smoke's cone_pwls: the pelvis's voxel grid
        return 1, _scan("cone", root), (256, 32, 256 * 0.2, 0.2, 0.0)
    if name == "tilted":
        from dexct_tpu_torch.ops.conebeam import _tilted_grid

        ct = _scan("tilted", root)
        n_g, fov_g, nz_g = _tilted_grid(ct.tilt, N_MATRIX, FOV, ct.N_rows,
                                        ct.h_iso)
        return 4, ct.untilted(), (n_g, nz_g, fov_g, float(ct.h_iso), 0.0)
    n, fov = RAGGED_GRID
    if name == "ragged":
        return 2, _ragged_orbit(600), (n, 5, fov, 0.5, 0.3)
    if name == "ragged_odd":
        return 3, _ragged_orbit(600), (n, 7, fov, 0.5, 0.0)
    raise KeyError(name)


def k11_case(name, dev, root=_HERE):
    """One case of :data:`K11_PIN_CASES` on ``dev``: (q [K, V, R, C]
    float32, the arguments of ``_fdk_backproject_multi`` after q, the
    betas a float32 tensor)."""
    import torch

    K, ct, (n, nz, fov, dz, zc) = k11_spec(name, root)
    V, R, C = int(ct.N_proj), int(ct.N_rows), int(ct.N_channels)
    rng = np.random.default_rng(zlib.crc32(f"k11_{name}".encode()))
    q = torch.as_tensor(rng.standard_normal((K, V, R, C), np.float32),
                        device=dev)
    betas = torch.as_tensor(np.asarray(ct.betas, np.float32), device=dev)
    return q, (betas, float(ct.SID), float(ct.dgamma), float(ct.h_iso), R,
               int(n), int(nz), float(fov), float(dz),
               float(ct.rotation_total / V), float(zc))


def k11_call(conebeam, case, plain=False):
    """K11's call on ``case`` (:func:`k11_case`'s tuple) through the
    checkout's wrapper (with ``plain``, its plain version)."""
    q, args = case
    fn = (conebeam._fdk_backproject_multi_plain if plain
          else conebeam._fdk_backproject_multi)
    return lambda: fn(q, *args)


def k11_work(cs, conebeam, case, vol):
    """(bytes, operations, terms with taps) of K11 on ``case`` as
    ``chip_smoke.py`` counts them."""
    q, args = case
    K, V, R, C = q.shape
    betas, sid, dgamma, row_h, _, n, nz, fov, dz, _, zc0 = args
    X, Y, _ = conebeam._disc(n, fov, q.device)
    P = X.shape[0]
    zc = conebeam._fdk_z(nz, dz, zc0, q.device)
    taps = cs.rows_on_detector(
        betas, lambda beta: conebeam._inplane(X, Y, beta, sid, dgamma,
                                              C)[2:4],
        lambda inv_h: (zc[None, :, None] * sid) * inv_h[:, None, :] / row_h
        - 0.5 + R / 2.0, R)
    return (cs.nbytes(q, vol) + 8 * P + 8 * V,
            cs.PLANE_OPS * P * V + cs.MOTION_ROW_OPS * P * nz * V
            + (cs.MOTION_TAP_OPS + 7 * K) * taps, taps)


def _probe_k11_bits(conebeam, root, names):
    import torch

    dev = torch.device("cuda")
    for name in names:
        case = k11_case(name, dev, root)
        call = k11_call(conebeam, case)
        a, b = call(), call()
        want = k11_call(conebeam, case, plain=True)()
        print(json.dumps({
            "probe": "k11_bits", "case": name, "shape": list(a.shape),
            "sha1": output_sha1(a),
            "two_launches_equal": bool(torch.equal(a, b)),
            "plain_max_abs": float((a - want).abs().max()),
            "plain_max": float(want.abs().max())}), flush=True)
        del case, call, a, b, want
        torch.cuda.empty_cache()


def _probe_k11_time(h, cs, conebeam, root, reps):
    import torch

    dev = torch.device("cuda")
    for name in K11_TIME_CASES:
        case = k11_case(name, dev, root)
        call = k11_call(conebeam, case)
        n_bytes, n_ops, taps = k11_work(cs, conebeam, case, call())
        b, by = cs.bound(n_bytes, n_ops)
        print(json.dumps({
            "probe": "k11_time", "case": name, "shape": list(
                call().shape), "terms_with_taps": taps,
            "device_ms": [h._graph_ms(call), h._graph_ms(call)],
            "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)],
            "bound_ms": b, "bound_by": by}), flush=True)
        del case, call
        torch.cuda.empty_cache()


# the variants of k11_steps.cu, in its order; variant 0 is the parent kernel
K11_STEPS = (
    "parent: a thread per (pixel, slice), the in-plane geometry per term, "
    "scalar taps at 64-bit offsets, 128 threads",
    "1: a thread per (pixel, 4 slices), the in-plane geometry once per "
    "view, scalar taps, 128 threads bounded to 8 blocks an SM",
    "2: as 1 with the packed taps",
    "3: as 2 with 2 slices a thread",
    "4: as 2 in 64-thread blocks bounded to 16",
    "5: as 3 in 64-thread blocks bounded to 16",
    "6: as 2 with mirror slices paired, one division for both",
    "7: as 3 with mirror slices paired",
    "8: as 2 with 8 slices a thread",
    "9: as 3 bounded to 12 blocks an SM",
    "10: as 8 with mirror slices paired",
    "11: as 8 in 64-thread blocks bounded to 16",
    "12: as 8 bounded to 6 blocks an SM",
    "13: as 8 with each slice's quotient formed where it is used",
)


def _k11_c_args(conebeam, case):
    """The C arguments of a K11 launch on ``case`` after the stacks and
    before the stream, the output, and the arrays they point to (kept
    alive by the caller)."""
    import torch

    q, args = case
    K, V, R, C = q.shape
    betas, sid, dgamma, row_h, _, n, nz, fov, dz, dbeta, zc0 = args
    X, Y, sel = conebeam._disc(n, fov, q.device)
    zc = conebeam._fdk_z(nz, dz, zc0, q.device)
    cos_b, sin_b = torch.cos(betas), torch.sin(betas)
    out = torch.zeros((K, nz, n, n), device=q.device)
    keep = (cos_b, sin_b, X, Y, sel, zc)
    return ([t.data_ptr() for t in keep]
            + [out.data_ptr(), K, V, R, C, X.shape[0], nz, n * n, sid,
               dgamma, row_h, dbeta]), out, keep


def _probe_k11_steps(h, conebeam, root, parent, variants):
    """Each variant on every K11 case against the checkout's K11 (and the
    parent's): bits, registers, SASS and device times at every case of
    :data:`K11_TIME_CASES`, the checkout and the parent timed in the same
    passes."""
    import torch

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs, par = _build_steps(tmp, variants, parent, "k11")
        cache = {}

        def setup(name):
            if name not in cache:
                case = k11_case(name, dev, root)
                cache[name] = (case, *_k11_c_args(conebeam, case))
            return cache[name]

        def call(v, name):
            case, c_args, out, _ = setup(name)
            stream = torch.cuda.current_stream().cuda_stream
            if v == "checkout":
                return k11_call(conebeam, case)()
            if v == "parent":
                rc = par.dexct_fdk_backproject(case[0].data_ptr(), *c_args,
                                               stream)
            else:
                lib = libs[v][0]
                # a packed variant packs on every call, as the wrapper does
                q = (conebeam._pack_images(case[0]) if lib.k11_step_packed()
                     else case[0])
                rc = lib.k11_step(q.data_ptr(), *c_args, stream)
            if rc:
                raise SystemExit(f"probe_cone_backproject: {v} on {name}: "
                                 f"cudaError_t {rc}")
            return out

        # timed parent, checkout, variants, then in reverse
        names = (["parent"] if par is not None else []) + ["checkout"] + \
            list(variants)
        recs = {v: {"probe": "k11_step", "variant": v,
                    "name": v if isinstance(v, str) else K11_STEPS[v],
                    "equal_to_checkout": {}, "equal_to_parent": {},
                    "two_launches_equal": True,
                    "device_ms": {c: [] for c in K11_TIME_CASES}}
                for v in names}
        sass = _sibling("sass_stats")
        for v in variants:
            recs[v]["resources"] = _registers(libs[v][1])
            tag = "parent_kernel" if v == 0 else "k11v_kernel"
            st = sass.kernel_stats(libs[v][2], (tag + "ILi4E",))
            recs[v]["sass"] = {k: {"resources": s.get("resources"),
                                   "instructions": s.get("instructions"),
                                   "ops": s.get("ops"),
                                   "loops": s.get("loops")}
                               for k, s in st.items()}
        for name in K11_PIN_CASES:
            ref = call("checkout", name).clone()
            pref = (call("parent", name).clone() if par is not None
                    else None)
            for v in names:
                a = call(v, name).clone()
                recs[v]["equal_to_checkout"][name] = bool(torch.equal(a, ref))
                if pref is not None:
                    recs[v]["equal_to_parent"][name] = bool(
                        torch.equal(a, pref))
                recs[v]["two_launches_equal"] &= bool(
                    torch.equal(a, call(v, name)))
            if name not in K11_TIME_CASES:
                del cache[name]
            torch.cuda.empty_cache()
        for order in (names, names[::-1]):
            for v in order:
                for name in K11_TIME_CASES:
                    recs[v]["device_ms"][name].append(
                        h._graph_ms(lambda v=v, name=name: call(v, name)))
    for v in names:
        rec = recs[v]
        rec["all_equal_to_checkout"] = all(rec["equal_to_checkout"].values())
        if par is not None:
            rec["all_equal_to_parent"] = all(rec["equal_to_parent"].values())
        print(json.dumps(rec), flush=True)


# ---------------------------------------------------------------------------
# K32 and K33, the motion-compensated cone backprojectors
# ---------------------------------------------------------------------------

MOTION_PIN_CASES = ("k32_cone", "k33_helical", "k33_ragged")


def motion_case(name, dev, root=_HERE):
    """One case of :data:`MOTION_PIN_CASES` on ``dev``: (the wrapper's
    name in ``ops/motion.py``, its positional arguments: the seeded stacks
    and betas as float32 tensors on ``dev``, the rest as the library's
    callers pass them)."""
    import torch

    from dexct_tpu_torch.ops.conebeam import helical_slices

    rng = np.random.default_rng(zlib.crc32(f"motion_{name}".encode()))
    if name == "k32_cone":
        ct, K = _scan("cone", str(root)), 4
    elif name == "k33_helical":
        ct, K = _scan("helical", str(root)), 4
    elif name == "k33_ragged":
        ct, K = _ragged_geometry(120, 4.0, 1.5), 3
    else:
        raise KeyError(name)
    n, fov = RAGGED_GRID if name == "k33_ragged" else (N_MATRIX, FOV)
    V, R, C = int(ct.N_proj), int(ct.N_rows), int(ct.N_channels)
    q = torch.as_tensor(rng.standard_normal((K, V, R, C), np.float32),
                        device=dev)
    betas = torch.as_tensor(np.asarray(ct.betas, np.float32), device=dev)
    phi = rng.uniform(-0.03, 0.03, V)
    disp = rng.uniform(-0.4, 0.4, (V, 3))
    geo = (float(ct.SID), float(ct.dgamma), float(ct.h_iso))
    if name == "k32_cone":
        return "_fdk_backproject_motion", (
            q, betas, phi, disp, *geo, R, n, R, fov, float(ct.h_iso),
            (0.5 - R / 2.0) * float(ct.h_iso))
    z_out, dz = helical_slices(ct, None if name == "k33_helical"
                               else 0.6 * np.arange(7) - 1.8)
    return "_helical_backproject_motion", (
        q, betas, np.asarray(ct.source_z, np.float64),
        float(0.5 * ct.rotation_total), phi, disp, *geo, R, float(ct.pitch),
        n, len(z_out), fov, dz, float(z_out[0]))


def motion_call(motion, case):
    """K32's or K33's call on ``case`` (:func:`motion_case`'s tuple)."""
    fn, args = case
    return lambda: getattr(motion, fn)(*args)


def _probe_motion_bits(motion, root):
    import torch

    dev = torch.device("cuda")
    for name in MOTION_PIN_CASES:
        case = motion_case(name, dev, root)
        call = motion_call(motion, case)
        a, b = call(), call()
        print(json.dumps({
            "probe": "motion_bits", "case": name, "kernel": case[0],
            "shape": list(a.shape), "sha1": output_sha1(a),
            "two_launches_equal": bool(torch.equal(a, b))}), flush=True)
        del case, call, a, b
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--kernel", choices=("k12", "k11", "motion"),
                        default="k12", help="the kernel to probe")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--bits", action="store_true",
                        help="the pinned cases' sha1s")
    parser.add_argument("--cases", default=None,
                        help="with --bits, comma-separated case names "
                             "(default all)")
    parser.add_argument("--time", action="store_true",
                        help="device and call times at the paths' shapes")
    parser.add_argument("--sass", action="store_true",
                        help="K12's registers, instructions and loops")
    parser.add_argument("--sass-dump", type=Path, default=None,
                        help="with --sass, write K12's SASS here")
    parser.add_argument("--steps", action="store_true",
                        help="build and measure the variants of STEPS")
    parser.add_argument("--parent", type=Path, default=None,
                        help="with --steps, a parent checkout whose K12 to "
                             "hold the variants to and time beside them")
    parser.add_argument("--variants", default=None,
                        help="with --steps, comma-separated variant numbers "
                             "(default all)")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.sass_dump is None else args.sass_dump.resolve()
    h = _sibling("probe_cone_adjoint")
    cs = _chip_smoke()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_cone_backproject: needs a CUDA device")
    from dexct_tpu_torch.ops import conebeam
    from dexct_tpu_torch.utils import kernels

    if Path(conebeam.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_cone_backproject: imported "
                         f"{conebeam.__file__}, not the checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}",
          flush=True)
    kernels.library()
    parent = None if args.parent is None else args.parent.resolve()
    if args.kernel == "motion":
        if args.bits:
            from dexct_tpu_torch.ops import motion

            _probe_motion_bits(motion, root)
        return
    k11 = args.kernel == "k11"
    if args.sass:
        name = ("fdk_backproject_kernelILi4E" if k11
                else "helical_backproject_kernelILi4E")
        stats = _sibling("sass_stats").kernel_stats(kernels.build(), (name,),
                                                    dump)
        print(json.dumps({"probe": f"{args.kernel}_sass", "kernels": stats}),
              flush=True)
    if args.bits:
        names = ((K11_PIN_CASES if k11 else PIN_CASES)
                 if args.cases is None else args.cases.split(","))
        (_probe_k11_bits if k11 else _probe_bits)(conebeam, root, names)
    if args.time:
        (_probe_k11_time if k11 else _probe_time)(h, cs, conebeam, root,
                                                  args.reps)
    if args.steps:
        n_steps = len(K11_STEPS if k11 else STEPS)
        variants = (range(n_steps) if args.variants is None
                    else [int(v) for v in args.variants.split(",")])
        (_probe_k11_steps if k11 else _probe_steps)(h, conebeam, root, parent,
                                                    list(variants))


if __name__ == "__main__":
    main()
