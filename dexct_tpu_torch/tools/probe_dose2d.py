"""K23, the 2-D dose accumulation, on the card: the sha1s of its pinned
cases, its device time split by kernel at the paths' shapes, and the steps
of its redesign.

    python dexct_tpu_torch/tools/probe_dose2d.py [--root DIR] [--reps 3]
        [--sass] [--bits] [--time] [--k24] [--steps] [--variants 0,1,2]

Run it by path, from the repository root.  ``--root`` names the checkout
whose ``dexct_tpu_torch`` is measured (default: the one holding this
file), so that one chip call can run a parent and its change in turns
(parent, change, change, parent), each in its own process.  On a checkout
whose K23 predates ``dose._dose_2d_launch`` the probe calls that K23's C
entry as its wrapper did, to read its float64 slots.

The cases (:data:`PIN_CASES`, :func:`pin_case`), each the arguments of
``dose._dose_accumulate`` as ``dose._dose_prep`` makes them:

- ``ref_mv``, ``ref_80``: ``chip_smoke.py`` phase 3's calls, the reference
  protocol (``input/params.txt``: the 256^2 pelvis, a 512 x 512 polar
  grid, K = 6) at every 10th of its 1000 views, detunedMV (100 live
  energies) and 80 kV (74);
- ``full_mv``, ``full_80``: the whole 1000-view maps of phase 4;
- ``tcm_80``: 80 kV at every 10th view with a tube-current profile
  ``0.6 + 0.8 |sin beta|``;
- ``ne16_80``: 80 kV at every 10th view, the spectrum compressed to 16
  energy groups (``n_energy``);
- ``k12``: 12 materials of random labels on a 64^2 fan case (the kernel's
  MAXK = 16 instance);
- ``ragged``: a 45 x 37 phantom (1665 voxels, not a multiple of 256) on a
  100 x 77 polar grid;
- ``tiny_fan``: ``utils/tiny_cases.py``'s fan dose case.

Prints the card's name and power limit, then JSON lines:

- ``"k23_sass"`` (``--sass``): the polar, term and view-sum kernels'
  registers, instructions by opcode and loops in the built library's SASS
  (``sass_stats.py``);
- ``"k23_bits"`` (``--bits``): per case the sha1 of the dose and of the
  float64 slots, the deposited keV (their sum), the C calls and, on the
  100-view and smaller cases, the largest difference from the plain twin
  relative to its maximum;
- ``"k23_time"`` (``--time``): at the 100-view calls, a 170-view call (a
  C call of the parent's phase-4 maps) and the 1000-view maps, the device
  time by kernel over one call (``torch.profiler``), the call time (CUDA
  events over ``--reps`` calls, twice) and ``chip_smoke.py``'s bound;
- ``"k24_time"`` (``--k24``): K24 at phase 3's cone and helical calls
  (``probe_dose3d.py``'s workloads of 12 views), its device time by
  kernel over one call and its call time, to hold K24 beside a parent;
- ``"k23_step"`` (``--steps``): each variant of :data:`STEPS` (copies of
  the checkout's ``csrc/dose.cu`` with constants replaced, built with nvcc
  three at a time): whether its dose and its slots equal the checkout's
  on every case, and its call
  time at the 100-view calls and the 1000-view 80 kV map, in two passes
  over the variants, the second in reverse.

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

PIN_CASES = ("ref_mv", "ref_80", "full_mv", "full_80", "tcm_80", "ne16_80",
             "k12", "ragged", "tiny_fan")
# the cases timed, and the plain twin's (the 1000-view maps too slow)
TIME_CASES = ("ref_mv", "ref_80", "v170_mv", "v170_80", "full_mv",
              "full_80")
PLAIN_CASES = ("ref_mv", "ref_80", "tcm_80", "ne16_80", "k12", "ragged",
               "tiny_fan")
# nvcc processes at once for the variants (each compiles all of dose.cu)
_BUILDS_AT_ONCE = 3
# variant: (name, {constant: value} replaced in dose.cu)
STEPS = (
    ("as built", {}),
    ("1 view a term thread", {"kViews": 1}),
    ("2 views a term thread", {"kViews": 2}),
    ("8 views a term thread", {"kViews": 8}),
    ("polar tiles of 8 lines x 64 samples",
     {"kPolarLines": 8, "kPolarChunk": 64}),
    ("polar tiles of 32 lines x 16 samples",
     {"kPolarLines": 32, "kPolarChunk": 16}),
    ("polar tiles of 4 lines x 128 samples",
     {"kPolarLines": 4, "kPolarChunk": 128}),
    ("energies not unrolled", {"kEnergyUnroll": 1}),
    ("term blocks of 128 threads", {"kTermThreads": 128}),
    ("term blocks of 128 threads, at least 8 an SM",
     {"kTermThreads": 128, "kTermBlocks": 8}),
    ("no least count of term blocks an SM", {"kTermBlocks": 1}),
    ("K at run time in the term pass", {"kConstK": "false"}),
)


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


def _reference(root):
    """The reference protocol's config and its (detunedMV, 80 kV)
    spectra."""
    from dexct_tpu_torch.system.config import read_parameter_file

    root = Path(root)
    cfg = read_parameter_file(str(root / "input" / "params.txt"))[0]
    return cfg, _sibling("probe_gauss_newton")._spectra(cfg.ct, root)


def _small_fan(labels, n_mats, dx):
    """A fan of 64 channels and 48 views over ``labels`` [1, ny, nx] of the
    first ``n_mats`` of twelve materials at ``dx`` cm, 120 kV at 10x the
    isocentre fluence (the tiny dose case's scan)."""
    from dexct_tpu_torch.physics import kramers_spectrum
    from dexct_tpu_torch.physics import materials as m
    from dexct_tpu_torch.system import FanBeamGeometry, VoxelPhantom

    mats = [m.AIR, m.WATER, m.BONE, m.TISSUE, m.MARROW, m.ADIPOSE,
            m.MUSCLE, m.BRAIN, m.CSF, m.LUNG, m.BLOOD, m.TITANIUM]
    ct = FanBeamGeometry(N_channels=64, N_proj=48, h_iso=0.1)
    ph = VoxelPhantom("k23", labels.astype(np.uint8),
                      m.MaterialTable(mats[:n_mats]), dx, dx, dx)
    spec = kramers_spectrum(120.0)
    spec.rescale_counts(ct.A_iso * 10.0 / ct.N_proj)
    return ph, ct, spec


def pin_case(name, dev, root=_HERE):
    """The arguments of ``dose._dose_accumulate`` of the case ``name`` (of
    :data:`PIN_CASES` or :data:`TIME_CASES`) on ``dev``."""
    from dexct_tpu_torch.ops import dose
    from dexct_tpu_torch.utils import tiny_cases

    kw = dict(n_gamma=None, n_r=None, oversample=2, views=None,
              z_index=None, n_energy=None, view_weights=None,
              scoring="removed", device=dev)
    if name == "tiny_fan":
        ph, ct, spec = tiny_cases.dose_inputs("fan")
    elif name == "k12":
        lab = np.random.default_rng(23).integers(0, 12, (1, 64, 64))
        ph, ct, spec = _small_fan(lab, 12, 0.5)
    elif name == "ragged":
        y = (np.arange(37) + 0.5 - 18.5) * 0.5
        x = (np.arange(45) + 0.5 - 22.5) * 0.5
        lab = (np.hypot(x[None, :], y[:, None]) <= 8.0).astype(np.int64)
        lab[np.hypot(x[None, :] - 3.0, y[:, None] + 1.0) <= 2.0] = 2
        ph, ct, spec = _small_fan(lab[None], 3, 0.5)
        kw.update(n_gamma=100, n_r=77)
    else:
        cfg, specs = _reference(root)
        ph, ct = cfg.phantom, cfg.ct
        spec = specs[0] if name.endswith("_mv") else specs[1]
        if name.startswith("full_"):
            pass
        elif name.startswith("v170_"):
            kw["views"] = ct.betas[:170]
        else:
            kw["views"] = ct.betas[::10]
        if name == "tcm_80":
            kw["view_weights"] = 0.6 + 0.8 * np.abs(np.sin(kw["views"]))
        elif name == "ne16_80":
            kw["n_energy"] = 16
    args, _ = dose._dose_prep(ph, ct, spec, **kw)
    return args


def output_sha1(t):
    """sha1 of a tensor's bytes on the host (C order)."""
    return hashlib.sha1(np.ascontiguousarray(
        t.detach().cpu().numpy()).tobytes()).hexdigest()


def _launch_first_k23(dose, args):
    """The first K23's wrapper (its checkout has no ``_dose_2d_launch``)
    without its final sum: its C calls, one per block of T views."""
    import torch

    from dexct_tpu_torch.utils import kernels

    (labels, mu, mu_dep, i0w, betas, view_w, gammas, rs, vox_xy, rho_vox,
     lab_vox, scalars) = args
    dev = labels.device
    ny, nx = labels.shape
    K, E = mu.shape
    V, n_g, n_r = betas.shape[0], gammas.shape[0], rs.shape[0]
    n_vox = vox_xy.shape[0]
    sid, dx, dy, geom, g_half, h_over_sid, dxdy = (float(v) for v in scalars)
    src, ca, sa = dose._view_trig(
        betas, gammas, torch.full((), sid, dtype=torch.float32, device=dev))
    muT = mu.T.contiguous()
    out = torch.zeros(n_vox, dtype=torch.float32, device=dev)
    edep = torch.zeros((n_vox + 255) // 256, dtype=torch.float64, device=dev)
    vb = dose._view_block(V, n_r * n_g * K * 4)
    T = torch.empty((vb, n_r, n_g, K), dtype=torch.float32, device=dev)
    lib, stream = kernels.library(), kernels.stream_ptr(dev)
    grid = dose._grid_scalars(gammas, rs)
    for v0 in range(0, V, vb):
        nv = min(vb, V - v0)
        rc = lib.dexct_dose_2d(
            labels.data_ptr(), src[v0:].data_ptr(), ca[v0:].data_ptr(),
            sa[v0:].data_ptr(), view_w[v0:].data_ptr(), rs.data_ptr(),
            vox_xy.data_ptr(), rho_vox.data_ptr(), lab_vox.data_ptr(),
            muT.data_ptr(), mu_dep.data_ptr(), i0w.data_ptr(), T.data_ptr(),
            out.data_ptr(), edep.data_ptr(), dose._max_k(K), nv, n_g, n_r,
            K, E, nx, ny, n_vox, sid, dx, dy, float(np.float32(nx / 2 - 0.5)),
            float(np.float32(ny / 2 - 0.5)), *grid, geom, g_half,
            h_over_sid, dxdy, stream)
        kernels.check(rc, "dose_map")
        dose._dose_accumulate.launches += 1
    return out, edep


def launch(dose, args):
    """(dose, float64 slots) of K23 on ``args`` without a final sum."""
    fn = getattr(dose, "_dose_2d_launch", None)
    if fn is None:
        return _launch_first_k23(dose, args)
    return fn(*args)


def _probe_bits(dose, root):
    import torch

    for name in PIN_CASES:
        args = pin_case(name, torch.device("cuda"), root)
        before = dose._dose_accumulate.launches
        d, slots = launch(dose, args)
        calls = dose._dose_accumulate.launches - before
        rec = {"probe": "k23_bits", "case": name,
               "views": int(args[4].shape[0]), "K": int(args[1].shape[0]),
               "E": int(args[1].shape[1]), "n_vox": int(args[8].shape[0]),
               "calls": calls, "dose_sha1": output_sha1(d),
               "slots_sha1": output_sha1(slots),
               "deposited_keV": repr(float(slots.sum()))}
        d2, s2 = launch(dose, args)
        rec["two_launches_equal"] = bool(torch.equal(d, d2)
                                         and torch.equal(slots, s2))
        if name in PLAIN_CASES:
            want, ew = dose._dose_accumulate_plain(*args)
            rec["plain_max_rel"] = float((d - want).abs().max()
                                         / want.abs().max())
            rec["plain_bitwise"] = bool(torch.equal(d, want))
            rec["plain_deposited_rel"] = abs(float(slots.sum()) - ew) / ew
        print(json.dumps(rec), flush=True)


def device_split(fn):
    """Device ms by kernel name over one call of ``fn`` (torch.profiler):
    {name: [count, ms]}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us:
            per[e.key[:60]] = [e.count, float(us) / 1e3]
    return per


def _probe_time(h, cs, dose, root, reps):
    import torch

    for name in TIME_CASES:
        args = pin_case(name, torch.device("cuda"), root)

        def call(args=args):
            launch(dose, args)

        call()
        per = device_split(call)
        b, by = cs.bound(*cs.dose_work(args, False))
        print(json.dumps({
            "probe": "k23_time", "case": name,
            "views": int(args[4].shape[0]), "E": int(args[1].shape[1]),
            "device_ms": sum(ms for _, ms in per.values()), "split": per,
            "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)],
            "bound_ms": b, "bound_by": by}), flush=True)


def _probe_k24(h, dose, reps):
    """K24 at ``chip_smoke.py`` phase 3's two shapes (``probe_dose3d``'s
    workloads): device ms by kernel over one call and call ms."""
    import torch

    from dexct_tpu_torch.tools import probe_dose3d

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        for label, (_, _, every) in probe_dose3d._CONFIGS.items():
            args = probe_dose3d._workload(Path(tmp), label, every, dev)

            def call(args=args):
                dose._dose_accumulate_3d(*args)

            call()
            per = device_split(call)
            print(json.dumps({
                "probe": "k24_time", "case": label,
                "views": int(args[4].shape[0]),
                "device_ms": sum(ms for _, ms in per.values()), "split": per,
                "call_ms": [h._time_ms(call, reps), h._time_ms(call, reps)]}),
                flush=True)


def _build_steps(tmp, variants):
    """Each variant's copy of the checkout's dose.cu built with nvcc (all
    at once): {source text: ctypes library}; the unchanged source maps to
    None (the checkout's own build)."""
    from dexct_tpu_torch.utils import kernels

    src = (kernels.CSRC / "dose.cu").read_text()
    texts = {}
    for v in variants:
        text = src
        for const, value in STEPS[v][1].items():
            old = next((line for line in src.splitlines()
                        if re.match(rf"constexpr \w+ {const} = ", line)),
                       None)
            if old is None:
                raise SystemExit(f"probe_dose2d: dose.cu has no {const}")
            text = text.replace(old, re.sub(r"= [^;]*;", f"= {value};",
                                            old, count=1))
        texts.setdefault(text, []).append(v)
    libs, builds = {src: None}, []
    for i, text in enumerate(t for t in texts if t != src):
        cu, so = Path(tmp) / f"v{i}.cu", Path(tmp) / f"v{i}.so"
        cu.write_text(text)
        builds.append((text, so, [kernels._nvcc(), *kernels.NVCC_FLAGS,
                                  "-shared", "-o", str(so), str(cu)]))
    procs = {}
    for i in range(0, len(builds), _BUILDS_AT_ONCE):
        batch = [(text, so, subprocess.Popen(cmd))
                 for text, so, cmd in builds[i:i + _BUILDS_AT_ONCE]]
        for text, so, proc in batch:
            if proc.wait():
                raise SystemExit("probe_dose2d: nvcc failed on a variant")
            procs[text] = so
    for text, so in procs.items():
        lib = ctypes.CDLL(str(so))
        lib.dexct_dose_2d.argtypes = kernels._SIGNATURES["dexct_dose_2d"]
        lib.dexct_dose_2d.restype = ctypes.c_int
        libs[text] = lib
    return {v: libs[text] for text, vs in texts.items() for v in vs}


def _probe_steps(h, dose, root, variants, reps):
    """Each variant on every case: dose and slots against the checkout's
    as built; call times at the 100-view calls and the 80 kV map."""
    import torch

    from dexct_tpu_torch.utils import kernels

    dev = torch.device("cuda")
    library = kernels.library
    cases = {name: pin_case(name, dev, root) for name in PIN_CASES}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_steps(tmp, variants)

        def use(v):
            lib = libs[v]
            kernels.library = library if lib is None else (lambda: lib)

        recs = {v: {"probe": "k23_step", "variant": v, "name": STEPS[v][0],
                    "equal_to_checkout": {}, "call_ms": {}}
                for v in variants}
        try:
            for name, args in cases.items():
                kernels.library = library
                ref = dose._dose_2d_launch(*args)
                for v in variants:
                    use(v)
                    got = dose._dose_2d_launch(*args)
                    recs[v]["equal_to_checkout"][name] = [
                        bool(torch.equal(x, y)) for x, y in zip(got, ref)]
            for order in (list(variants), list(variants)[::-1]):
                for v in order:
                    use(v)
                    for name in ("ref_mv", "ref_80", "full_80"):
                        recs[v]["call_ms"].setdefault(name, []).append(
                            h._time_ms(lambda a=cases[name]:
                                       dose._dose_2d_launch(*a), reps))
        finally:
            kernels.library = library
    for v in variants:
        recs[v]["all_doses_equal"] = all(
            d for d, _ in recs[v]["equal_to_checkout"].values())
        print(json.dumps(recs[v]), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose dexct_tpu_torch to measure")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--bits", action="store_true",
                        help="the pinned cases' sha1s")
    parser.add_argument("--time", action="store_true",
                        help="the device time split by kernel")
    parser.add_argument("--sass", action="store_true",
                        help="print K23's kernels' registers and loops")
    parser.add_argument("--k24", action="store_true",
                        help="K24's device time at phase 3's shapes")
    parser.add_argument("--steps", action="store_true",
                        help="build and measure the variants of STEPS")
    parser.add_argument("--variants", default=None,
                        help="with --steps, comma-separated variant "
                             "numbers (default all)")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    h = _sibling("probe_cone_adjoint")
    sys.path.insert(0, str(root))
    os.chdir(root)  # the params files name their inputs from the root
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_dose2d: needs a CUDA device")
    from dexct_tpu_torch.ops import dose
    from dexct_tpu_torch.utils import kernels

    if Path(dose.__file__).resolve().parents[2] != root:
        raise SystemExit(f"probe_dose2d: imported {dose.__file__}, not the "
                         f"checkout {root}")
    print(f"{h._card_line()} | torch {torch.__version__} | {root}",
          flush=True)
    kernels.library()
    if args.sass:
        stats = _sibling("sass_stats").kernel_stats(
            kernels.build(), ("polar_2d", "term_2d", "view_sum_kernel"))
        print(json.dumps({"probe": "k23_sass", "kernels": stats}),
              flush=True)
    if args.bits:
        _probe_bits(dose, root)
    if args.time:
        _probe_time(h, _chip_smoke(), dose, root, args.reps)
    if args.k24:
        _probe_k24(h, dose, args.reps)
    if args.steps:
        variants = (range(len(STEPS)) if args.variants is None
                    else [int(v) for v in args.variants.split(",")])
        _probe_steps(h, dose, root, list(variants), args.reps)


if __name__ == "__main__":
    main()
