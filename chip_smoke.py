#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``dexct_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and Triton; imports nothing
of JAX.  Phases, each of which raises on failure:

1. Device: the card's name and power limit (nvidia-smi).
2. Build: nvcc builds kernels K1 and K3-K8 from ``dexct_tpu_torch/csrc``
   (one nvcc per source, all at once); Triton compiles K2.
3. Each kernel against its plain PyTorch version on the card, on the
   inputs its path gives it at the reference protocol
   (``input/params.txt``: 256^2 pelvis, 1000 views x 800 channels, 50 GN
   iterations, four 512^2 images), with the error and both times: K1-K4
   on the exact path (``--projector siddon --recon fan``), K5-K8 on the
   default path (``--projector fourier --recon parallel``: Fourier plan
   n_theta 1024, parallel grid 512 x 1024), where K2 and K3 are held
   against their plain versions again on the Fourier paths.
4. Both paths through ``dexct_tpu_torch.run.main`` on
   ``input/params.txt``: the default path (no projector or recon flags)
   twice, then the exact path twice (each second call is steady state).
   Every launch counter is set to 0 just before a path and read just after
   it: each kernel of the path must have launched, and no kernel of the
   other path.  Each path's §2.6 files are checked (exact byte sizes,
   finite values, air ~ -1000 HU).
5. A 64^2 config through the port on ``--device cpu`` and ``--device
   cuda`` under both flag sets; every output file agrees to the pipeline
   tolerances.

The last two lines of standard output are the kernels' JSON record and the
device JSON line.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PARAMS = ROOT / "input" / "params.txt"
SPECTRA = ROOT / "input" / "spectrum"

# name -> (route, source, TPU program replaced, tolerance statement)
KERNELS = {
    "siddon_trace": ("cuda", "dexct_tpu_torch/csrc/siddon_trace.cu",
                     "dexct_tpu/ops/siddon.py:98", "max abs <= 1e-4 cm"),
    "spectral_counts": ("triton", "dexct_tpu_torch/ops/spectral.py",
                        "dexct_tpu/ops/spectral.py:67", "max rel <= 1e-5"),
    "gauss_newton": ("cuda", "dexct_tpu_torch/csrc/gauss_newton.cu",
                     "dexct_tpu/ops/matdecomp.py:333",
                     "max |d| / max(|a|, 1) <= 1e-4"),
    "fan_backproject": ("cuda", "dexct_tpu_torch/csrc/fan_backproject.cu",
                        "dexct_tpu/ops/fbp_fast.py:53",
                        "max abs <= 1e-4 cm^-1"),
    "rebin_to_parallel": ("cuda", "dexct_tpu_torch/csrc/gather_taps.cu",
                          "dexct_tpu/ops/fbp_fast.py:184",
                          "max abs <= 1e-5 x max |plain|"),
    "parallel_backproject": ("cuda",
                             "dexct_tpu_torch/csrc/parallel_backproject.cu",
                             "dexct_tpu/ops/fbp_fast.py:277",
                             "max abs <= 1e-4 cm^-1"),
    "kb_sample": ("cuda", "dexct_tpu_torch/csrc/kb_sample.cu",
                  "dexct_tpu/ops/fourier.py:258",
                  "max abs <= 1e-5 x max |plain|"),
    "resample_to_fan": ("cuda", "dexct_tpu_torch/csrc/gather_taps.cu",
                        "dexct_tpu/ops/fourier.py:397",
                        "max abs <= 1e-5 x max |plain|"),
}
# the CLI flags of each path and the kernels it launches
PATHS = {
    "default": ([], ("kb_sample", "resample_to_fan", "spectral_counts",
                     "gauss_newton", "rebin_to_parallel",
                     "parallel_backproject")),
    "exact": (["--projector", "siddon", "--recon", "fan"],
              ("siddon_trace", "spectral_counts", "gauss_newton",
               "fan_backproject")),
}


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events,
    after one warm-up call)."""
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


def compare(kernel_fn, plain_fn, reps):
    """Kernel and plain outputs and their times, measured in turns (plain,
    kernel, kernel, plain) within this call."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    tp = [time_ms(plain_fn, reps)]
    tk = [time_ms(kernel_fn, reps), time_ms(kernel_fn, reps)]
    tp.append(time_ms(plain_fn, reps))
    return got, want, sum(tk) / 2, sum(tp) / 2


def report(records, name, err, ms, plain_ms, ok, extra=""):
    print(f"  {name:20s} max_abs_err={err:.6g}{extra}  kernel={ms:.4f} ms"
          f"  plain={plain_ms:.4f} ms  [{KERNELS[name][3]}]")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    route, src, replaces, _ = KERNELS[name]
    records[name] = {"name": name, "route": route, "source": src,
                     "replaces": replaces, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms}


def max_err(got, want):
    """Max abs difference and max |want|."""
    return float((got - want).abs().max()), float(want.abs().max())


def kernel_phase(arrays, meta, records):
    """Phase 3, exact path: K1-K4 against their plain versions at the
    reference protocol's shapes."""
    import torch

    from dexct_tpu_torch.ops import fbp_fast, matdecomp, siddon, spectral
    from dexct_tpu_torch.ops.fbp import filter_views

    a = arrays

    # K1: 8e5 exact rays through the 256^2 pelvis
    args = (a["labels"], a["src"], a["dirs"], meta.dx, meta.dy)
    kw = dict(n_materials=meta.n_materials)
    paths, want, ms, pms = compare(
        lambda: siddon.trace_paths(*args, **kw),
        lambda: siddon.trace_paths_plain(*args, **kw), reps=3)
    err = float((paths - want).abs().max())
    report(records, "siddon_trace", err, ms, pms, err <= 1e-4)

    # K2: both spectra, counts as the main path asks for them; the
    # optional second-moment table is checked too (not timed)
    counts, errs, rels, ms_sum, pms_sum = [], [], [], 0.0, 0.0
    for s in ("1", "2"):
        mu, i0, i2 = a["mu_t" + s], a["i0_" + s], a["i2_" + s]
        c, wc, ms, pms = compare(
            lambda: spectral.counts_from_paths(paths, mu, i0),
            lambda: spectral.counts_from_paths_plain(paths, mu, i0), reps=5)
        _, v = spectral.counts_from_paths(paths, mu, i0, i2)
        wv = spectral.counts_from_paths_plain(paths, mu, i2)
        for x, y in ((c, wc), (v, wv)):
            errs.append(float((x - y).abs().max()))
            rel = (x - y).abs() / y.abs().clamp_min(1e-30)
            rels.append(float(rel.max()))
        ms_sum += ms
        pms_sum += pms
        counts.append(c)
    report(records, "spectral_counts", max(errs), ms_sum, pms_sum,
           max(rels) <= 1e-5, f" (max rel {max(rels):.3g})")

    # K3: all 8e5 pixels, 50 iterations
    flat = torch.stack([counts[0].reshape(-1), counts[1].reshape(-1)])
    gkw = dict(n_iters=meta.n_iters, pixel_block=meta.pixel_block,
               warm_nodes=meta.gn_warm_nodes)
    ab, want, ms, pms = compare(
        lambda: matdecomp.gauss_newton_solve(flat, a["dec_i0"], a["dec_mus"],
                                             **gkw),
        lambda: matdecomp.gauss_newton_solve_plain(flat, a["dec_i0"],
                                                   a["dec_mus"], **gkw),
        reps=2)
    err = float((ab - want).abs().max())
    rel = float(((ab - want).abs() / want.abs().clamp_min(1.0)).max())
    report(records, "gauss_newton", err, ms, pms, rel <= 1e-4,
           f" (rel {rel:.3g})")

    # K4: 4 x 512^2 from the filtered 4 x 1000 x 800 sinogram stack
    log = [spectral.log_sinogram(c, air) for c, air in
           zip(counts, (meta.air1, meta.air2))]
    sinos = torch.stack([log[0], log[1], ab[:, 0].reshape(log[0].shape),
                         ab[:, 1].reshape(log[0].shape)])
    packed = fbp_fast.pack_filtered(filter_views(
        sinos, a["cos_w"], a["filt_H"], meta.fft_len, meta.dgamma))
    bargs = (packed, 4, a["betas"], meta.sid, meta.dgamma, sinos.shape[-1],
             meta.n_matrix, meta.fov, meta.dbeta)
    img, want, ms, pms = compare(
        lambda: fbp_fast.fan_backproject_multi(*bargs),
        lambda: fbp_fast.fan_backproject_multi_plain(*bargs), reps=3)
    err = float((img - want).abs().max())
    report(records, "fan_backproject", err, ms, pms, err <= 1e-4)


def default_kernel_phase(arrays, meta, records):
    """Phase 3, default path: K7, K8, K5 and K6 against their plain
    versions at the reference protocol's shapes, and K2 and K3 again on
    the Fourier paths (which ring slightly negative at edges)."""
    import numpy as np
    import torch

    from dexct_tpu_torch.ops import fbp_fast, fourier, matdecomp, spectral
    from dexct_tpu_torch.ops.fbp import filter_views
    from dexct_tpu_torch.pipeline.fused import dect_step

    a = arrays
    n_mat, n_theta, nt, grid, n_img, scale = meta.fp_meta

    # K7: the 6 material spectra (G = 512) along 1024 x 257 radial samples
    F = fourier._spectrum(fourier._onehot_images(a["labels"], n_mat),
                          a["fp_deapod"], grid, n_img)
    sargs = (F, a["fp_slice_idx"], a["fp_slice_w"], a["fp_phase_cos"],
             a["fp_phase_sin"])
    spec, want, ms, pms = compare(lambda: fourier.kb_sample(*sargs),
                                  lambda: fourier.kb_sample_plain(*sargs),
                                  reps=5)
    err, big = max_err(spec, want)
    report(records, "kb_sample", err, ms, pms, err <= 1e-5 * big,
           f" (max |plain| {big:.6g})")

    # K8: 8e5 fan rays from the 6 x 1024 x 1024 Radon transforms
    radon = torch.fft.irfft(spec, n=nt, dim=-1) * scale
    V, C4 = a["fp_fan_idx"].shape
    rargs = (radon, a["fp_fan_idx"], a["fp_fan_w"], (V, C4 // 4, n_mat))
    paths, want, ms, pms = compare(
        lambda: fourier.resample_to_fan(*rargs),
        lambda: fourier.resample_to_fan_plain(*rargs), reps=5)
    err, big = max_err(paths, want)
    report(records, "resample_to_fan", err, ms, pms, err <= 1e-5 * big,
           f" (max |plain| {big:.6g} cm)")
    print(f"  Fourier paths: min {float(paths.min()):.6g} cm, "
          f"{int((paths < 0).sum())} of {paths.numel()} negative")

    # K2 and K3 on the Fourier paths
    counts = []
    for s in ("1", "2"):
        c = spectral.counts_from_paths(paths, a["mu_t" + s], a["i0_" + s])
        wc = spectral.counts_from_paths_plain(paths, a["mu_t" + s],
                                              a["i0_" + s])
        rel = float(((c - wc).abs() / wc.abs().clamp_min(1e-30)).max())
        print(f"  spectral_counts on Fourier paths {s}: max rel {rel:.3g} "
              f"[max rel <= 1e-5]")
        if rel > 1e-5:
            fail("spectral_counts disagrees with its plain version on the "
                 "Fourier paths")
        counts.append(c)
    flat = torch.stack([counts[0].reshape(-1), counts[1].reshape(-1)])
    gkw = dict(n_iters=meta.n_iters, pixel_block=meta.pixel_block,
               warm_nodes=meta.gn_warm_nodes)
    ab = matdecomp.gauss_newton_solve(flat, a["dec_i0"], a["dec_mus"], **gkw)
    want = matdecomp.gauss_newton_solve_plain(flat, a["dec_i0"],
                                              a["dec_mus"], **gkw)
    rel = float(((ab - want).abs() / want.abs().clamp_min(1.0)).max())
    print(f"  gauss_newton on Fourier counts: rel {rel:.3g} "
          f"[max |d| / max(|a|, 1) <= 1e-4]")
    if not (rel <= 1e-4 and bool(torch.isfinite(ab).all())):
        fail("gauss_newton disagrees with its plain version on the "
             "Fourier counts")

    # K5 and K6 on the default path's 4 x 1000 x 800 sinogram stack
    out = dect_step(a, meta)
    sinos = torch.stack([out["sino_log"][0], out["sino_log"][1],
                         out["mat_sinos"][0], out["mat_sinos"][1]])
    n_th, pnt, t0, dt, par_m = meta.par_meta
    rargs = (sinos, a["rb_idx"], a["rb_w"], pnt)
    par, want, ms, pms = compare(
        lambda: fbp_fast.rebin_to_parallel(*rargs),
        lambda: fbp_fast.rebin_to_parallel_plain(*rargs), reps=5)
    err, big = max_err(par, want)
    report(records, "rebin_to_parallel", err, ms, pms, err <= 1e-5 * big,
           f" (max |plain| {big:.6g})")
    packed = fbp_fast.pack_filtered(filter_views(par, 1.0, a["par_H"],
                                                 par_m, dt))
    bargs = (packed, 4, a["par_thetas"], t0, dt, pnt, meta.n_matrix,
             meta.fov, np.pi / n_th)
    img, want, ms, pms = compare(
        lambda: fbp_fast.parallel_backproject_multi(*bargs),
        lambda: fbp_fast.parallel_backproject_multi_plain(*bargs), reps=3)
    err, big = max_err(img, want)
    report(records, "parallel_backproject", err, ms, pms, err <= 1e-4,
           f" (max |plain| {big:.6g})")


def counters():
    from dexct_tpu_torch.ops import (fbp_fast, fourier, matdecomp, siddon,
                                     spectral)

    return {"siddon_trace": siddon.trace_paths,
            "spectral_counts": spectral.counts_from_paths,
            "gauss_newton": matdecomp.gauss_newton_solve,
            "fan_backproject": fbp_fast.fan_backproject_multi,
            "rebin_to_parallel": fbp_fast.rebin_to_parallel,
            "parallel_backproject": fbp_fast.parallel_backproject_multi,
            "kb_sample": fourier.kb_sample,
            "resample_to_fan": fourier.resample_to_fan}


def check_outputs(out_dir, run_id, n_views, n_ch, n_img):
    """Phase 4 checks on the §2.6 files of the reference protocol."""
    import numpy as np

    acq = [out_dir / run_id / "detunedMV_9000uGy",
           out_dir / run_id / "80kV_1000uGy"]
    md = out_dir / run_id / "matdecomp_detunedMV_80kV_9000uGy_1000uGy"
    want = {}
    for d in acq:
        for f in ("sino_raw", "sino_log"):
            want[d / f"{f}_float32.bin"] = n_views * n_ch * 4
        for f in ("recon_raw", "recon_HU"):
            want[d / f"{f}_float32.bin"] = n_img * n_img * 4
    for i in (1, 2):
        want[md / f"mat{i}_sino_float32.bin"] = n_views * n_ch * 4
        want[md / f"mat{i}_recon_float32.bin"] = n_img * n_img * 4
    for path, size in want.items():
        if not path.exists():
            fail(f"missing output {path}")
        if path.stat().st_size != size:
            fail(f"{path} has {path.stat().st_size} bytes, want {size}")
        if not np.all(np.isfinite(np.fromfile(path, np.float32))):
            fail(f"{path} holds non-finite values")
    # air ROI inside the FOV: 1 cm x 1 cm at (x, y) = (0, -20) cm, 5 cm
    # below the pelvis body (which spans |y| <= 14.7 cm)
    px = 50.0 / n_img
    iy = int(round(-20.0 / px + n_img / 2 - 0.5))
    ix = n_img // 2
    h = int(round(0.5 / px))
    hus = []
    for d in acq:
        hu = np.fromfile(d / "recon_HU_float32.bin", np.float32).reshape(
            n_img, n_img)
        hus.append(float(hu[iy - h:iy + h, ix - h:ix + h].mean()))
    print(f"  air ROI HU: detunedMV {hus[0]:.2f}, 80kV {hus[1]:.2f}")
    if any(abs(h_ + 1000.0) > 50.0 for h_ in hus):
        fail(f"air ROI is not ~-1000 HU: {hus}")
    return len(want)


def both_devices_phase(tmp, label, flags):
    """Phase 5: a 64^2 water-cylinder config through the port's CLI on the
    CPU and on the card, under one path's flags; every output file must
    agree."""
    import numpy as np

    from dexct_tpu_torch.run import main as run_main
    from dexct_tpu_torch.system.phantom import water_cylinder_phantom

    ph = water_cylinder_phantom(N=64, dx=0.4)
    ph.to_file(str(tmp / "ph.bin"), str(tmp / "ph.csv"))
    cfg = json.loads(PARAMS.read_text())
    cfg.update({"RUN_ID": "tiny", "phantom_id": "water_cyl",
                "phantom_filename": str(tmp / "ph.bin"),
                "matcomp_filename": str(tmp / "ph.csv"),
                "Nx": 64, "Ny": 64, "dx": 0.4, "dy": 0.4, "dz": 0.4,
                "N_channels": 64, "N_projections": 64,
                "detector_filename": str(ROOT / cfg["detector_filename"]),
                "N_recon_matrix": 64, "FOV_recon": 26.0})
    (tmp / "tiny.txt").write_text(json.dumps(cfg))
    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = tmp / f"tiny_{label}_{dev}"
        run_main(["--params", str(tmp / "tiny.txt"), "--output",
                  str(outs[dev]), "--spectrum-dir", str(SPECTRA),
                  "--iters", "8", "--device", dev] + flags)
    tol = {"sino_raw": dict(rtol=1e-4, atol=0.0),
           "sino_log": dict(rtol=0.0, atol=1e-4),
           "recon_raw": dict(rtol=0.0, atol=1e-4),
           "recon_HU": dict(rtol=0.0, atol=1.0),
           "mat1_sino": dict(rtol=0.0, atol=1e-3),
           "mat2_sino": dict(rtol=0.0, atol=1e-3),
           "mat1_recon": dict(rtol=0.0, atol=1e-3),
           "mat2_recon": dict(rtol=0.0, atol=1e-3)}
    files = sorted(p.relative_to(outs["cpu"])
                   for p in outs["cpu"].rglob("*.bin"))
    if files != sorted(p.relative_to(outs["cuda"])
                       for p in outs["cuda"].rglob("*.bin")):
        fail("cpu and cuda runs wrote different file sets")
    if len(files) != 12:
        fail(f"expected 12 output files, got {len(files)}")
    for rel in files:
        x = np.fromfile(outs["cpu"] / rel, np.float32)
        y = np.fromfile(outs["cuda"] / rel, np.float32)
        kind = rel.name[:-len("_float32.bin")]
        np.testing.assert_allclose(y, x, err_msg=str(rel), **tol[kind])
    print(f"  {label} path: {len(files)} files agree between --device cpu "
          "and --device cuda")


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "dexct_tpu_torch").is_dir() or not PARAMS.exists():
        fail(f"run from a checkout of the repository ({ROOT} lacks "
             "dexct_tpu_torch/ or input/params.txt)")
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)  # params.txt names its inputs relative to the repo root
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    # 2. build
    from dexct_tpu_torch.ops import spectral
    from dexct_tpu_torch.utils import kernels

    t0 = time.time()
    kernels.build()
    kernels.library()
    t1 = time.time()
    dev = torch.device("cuda")
    spectral.counts_from_paths(torch.zeros((1, 1), device=dev),
                               torch.zeros((1, 1), device=dev),
                               torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    t2 = time.time()
    print(f"build: nvcc K1, K3-K8 {t1 - t0:.1f} s, triton K2 "
          f"{t2 - t1:.1f} s")

    # 3. kernels against their plain versions at the slice's shapes
    from dexct_tpu_torch.pipeline.fused import pack_dect
    from dexct_tpu_torch.pipeline.runner import (_resolve_spectrum,
                                                 default_generators)
    from dexct_tpu_torch.system.config import read_parameter_file

    cfg = read_parameter_file(PARAMS)[0]
    gens = default_generators()
    s1 = _resolve_spectrum("detunedMV", 9.0, cfg.ct, str(SPECTRA), gens)
    s2 = _resolve_spectrum("80kV", 1.0, cfg.ct, str(SPECTRA), gens)
    pack = (cfg.ct, cfg.phantom, s1, s2, cfg.N_matrix, cfg.FOV, cfg.ramp)
    print(f"kernels vs plain at the reference protocol ({smi}):")
    records = {}
    arrays, meta = pack_dect(*pack, device=dev, n_iters=50,
                             projector="siddon", recon="fan")
    kernel_phase(arrays, meta, records)
    arrays, meta = pack_dect(*pack, device=dev, n_iters=50,
                             projector="fourier", recon="parallel")
    default_kernel_phase(arrays, meta, records)
    del arrays
    torch.cuda.empty_cache()

    # 4. both paths, through the CLI
    from dexct_tpu_torch.run import main as run_main

    tmp = Path(tempfile.mkdtemp(prefix="dexct_chip_smoke_"))
    try:
        fns = counters()
        for name in KERNELS:
            records[name]["launches"] = 0
        for label, (flags, path_kernels) in PATHS.items():
            for fn in fns.values():
                fn.launches = 0
            walls = []
            for i in (1, 2):
                res = run_main(["--params", str(PARAMS), "--output",
                                str(tmp / f"{label}{i}"), "--spectrum-dir",
                                str(SPECTRA)] + flags)
                torch.cuda.synchronize()
                walls.append(res[0].wall_s)
            launches = {name: fn.launches for name, fn in fns.items()}
            print(f"{label} path {flags}: wall per DE pair {walls[0]:.3f} s "
                  f"(first), {walls[1]:.3f} s (steady) on {smi}")
            print(f"  launches: {launches}")
            for name, n in launches.items():
                if name in path_kernels and n <= 0:
                    fail(f"kernel {name} was not launched on the {label} "
                         "path")
                if name not in path_kernels and n != 0:
                    fail(f"kernel {name} was launched on the {label} path")
                records[name]["launches"] += n
            n_files = check_outputs(tmp / f"{label}2", cfg.run_id,
                                    cfg.ct.N_proj, cfg.ct.N_channels,
                                    cfg.N_matrix)
            print(f"  {n_files} output files: exact sizes, finite")

        # 5. both paths on both devices
        for label, (flags, _) in PATHS.items():
            both_devices_phase(tmp, label, flags)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: records[n][k] for k in order}
                                  for n in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
