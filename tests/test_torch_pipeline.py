"""The port's main paths as a whole against the JAX package's, on the CPU:
the fused step on identical packed inputs under every projector and
reconstruction pairing, the composed engine, both CLIs writing the §2.6
files (default and exact flags), and the runner's downgrades.  Tolerances
as in tests/test_pipeline.py: sino_raw rtol 1e-4, mat_sinos atol 1e-3,
recon_raw atol 1e-4, mat_recons atol 1e-3 (and recon_HU atol 1 HU,
sino_log atol 1e-4).

The fused step is held as a whole, and each stage after the trace also
on the JAX step's own inputs (the decomposition fed its counts, the
reconstruction its sinograms), so that a fault is placed in its stage.
The decomposition amplifies count differences: here a random 3.9e-6
relative perturbation of the counts moves mat_sinos by 2.3e-4, so the
port's plain counts and Gauss-Newton solve round as their expressions say
and not as the host's BLAS or vector-math kernels do (tests/
test_torch_matdecomp.py::test_plain_rounding_does_not_follow_the_host)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dexct_tpu.physics import kramers_spectrum, linac_spectrum
from dexct_tpu.pipeline import simulate_dect as j_simulate
from dexct_tpu.pipeline.fused import make_jitted_step
from dexct_tpu.pipeline.fused import pack_dect as j_pack
from dexct_tpu.system import FanBeamGeometry, water_cylinder_phantom
from dexct_tpu_torch.pipeline import fused as t_fused
from dexct_tpu_torch.pipeline.api import simulate_dect as t_simulate

TOL = {"sino_raw": dict(rtol=1e-4, atol=0.0),
       "sino_log": dict(rtol=0.0, atol=1e-4),
       "mat_sinos": dict(rtol=0.0, atol=1e-3),
       "recon_raw": dict(rtol=0.0, atol=1e-4),
       "recon_HU": dict(rtol=0.0, atol=1.0),
       "mat_recons": dict(rtol=0.0, atol=1e-3)}
FILE_TOL = {"sino_raw": TOL["sino_raw"], "sino_log": TOL["sino_log"],
            "recon_raw": TOL["recon_raw"], "recon_HU": TOL["recon_HU"],
            "mat1_sino": TOL["mat_sinos"], "mat2_sino": TOL["mat_sinos"],
            "mat1_recon": TOL["mat_recons"], "mat2_recon": TOL["mat_recons"]}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_de():
    """The setup of tests/test_pipeline.py (JAX host objects; the port's
    host layer is identical, tests/test_torch_host.py)."""
    ct = FanBeamGeometry(N_channels=128, N_proj=96, gamma_fan=0.8230337,
                         SID=60.0, SDD=100.0, eid=True)
    ph = water_cylinder_phantom(N=96, dx=0.25)  # radius 9.6 cm
    s1 = linac_spectrum()
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2 = kramers_spectrum(80.0)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return ct, ph, s1, s2


def _assert_outputs_close(got, want, keys=TOL):
    for key in keys:
        for i in range(2):
            np.testing.assert_allclose(
                np.asarray(got[key][i]), np.asarray(want[key][i]),
                err_msg=f"{key}[{i}]", **TOL[key])


# small Fourier and parallel grids for the 96^2 phantom and 96 x 128 scan
PLAN_KW = dict(n_theta=128, recon_n_theta=64, recon_nt=256)
CHOICES = [("siddon", "fan"), ("fourier", "parallel"), ("fourier", "fan"),
           ("siddon", "parallel")]


@pytest.mark.parametrize("projector,recon", CHOICES)
def test_dect_step_matches_jax(small_de, projector, recon):
    from dexct_tpu_torch.ops.fbp import hu_image

    arrays, meta = j_pack(*small_de, 64, 24.0, 0.8, n_iters=20,
                          projector=projector, recon=recon, **PLAN_KW)
    want = make_jitted_step(meta)(arrays)
    a = t_fused.arrays_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, "cpu")
    m = t_fused.DectMeta(**{f: getattr(meta, f) for f in
                            t_fused.DectMeta._fields if hasattr(meta, f)})
    got = t_fused.dect_step(a, m)
    _assert_outputs_close({k: tuple(x.numpy() for x in v)
                           for k, v in got.items()}, want)
    # every later stage on the JAX step's own inputs
    counts = [torch.as_tensor(np.array(x)) for x in want["sino_raw"]]
    mats = t_fused.decompose_counts(*counts, a, m, m.pixel_block)
    stack = torch.stack([torch.as_tensor(np.array(x)) for x in
                         (*want["sino_log"], *want["mat_sinos"])])
    imgs = t_fused.reconstruct_stack(stack, a, m)
    staged = {"mat_sinos": mats, "recon_raw": (imgs[0], imgs[1]),
              "recon_HU": (hu_image(imgs[0], m.mu_w1),
                           hu_image(imgs[1], m.mu_w2)),
              "mat_recons": (imgs[2], imgs[3])}
    _assert_outputs_close({k: tuple(x.numpy() for x in v)
                           for k, v in staged.items()}, want,
                          keys=tuple(staged))


@pytest.mark.parametrize("projector,recon",
                         CHOICES + [("siddon_dominant", "fan")])
def test_port_pack_matches_jax_pack(small_de, projector, recon):
    """The port's own pack_dect gives the arrays and meta that
    arrays_from_numpy makes of the JAX pack."""
    arrays, meta = j_pack(*small_de, 64, 24.0, 0.8, n_iters=20,
                          projector=projector, recon=recon, **PLAN_KW)
    a, m = t_fused.pack_dect(*small_de, 64, 24.0, 0.8, n_iters=20,
                             device="cpu", projector=projector, recon=recon,
                             **PLAN_KW)
    ref = t_fused.arrays_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, "cpu")
    assert set(a) == set(ref)
    for k in a:
        assert a[k].dtype == ref[k].dtype, k
        torch.testing.assert_close(a[k], ref[k], rtol=0, atol=0)
    for f in t_fused.DectMeta._fields:
        # siddon_dominant's JAX fp_meta describes its TPU ray plan, which
        # the port's one per-ray kernel has no use for
        if hasattr(meta, f) and not (f == "fp_meta"
                                     and projector == "siddon_dominant"):
            assert getattr(m, f) == getattr(meta, f), f


def test_composed_engine_matches_jax(small_de):
    want = j_simulate(*small_de, 64, 24.0, 0.8, n_iters=20)
    got = t_simulate(*small_de, 64, 24.0, 0.8, n_iters=20, device="cpu")
    to_np = {k: tuple(None if x is None else x.numpy()
                      for x in getattr(got, k)) for k in TOL}
    _assert_outputs_close(to_np, {k: getattr(want, k) for k in TOL})


def test_noise_is_seeded_and_compound(small_de):
    a, m = t_fused.pack_dect(*small_de, 32, 24.0, 0.8, n_iters=4,
                             device="cpu", noise="compound", seed=5)
    o1, o2 = t_fused.dect_step(a, m), t_fused.dect_step(a, m)
    o3 = t_fused.dect_step(a, m._replace(seed=6))
    torch.testing.assert_close(o1["sino_raw"][1], o2["sino_raw"][1])
    assert bool((o1["sino_raw"][1] != o3["sino_raw"][1]).any())
    clean = t_fused.dect_step(a, m._replace(noise="none"))
    rel = (o1["sino_raw"][1] / clean["sino_raw"][1] - 1.0).abs()
    assert 1e-6 < float(rel.mean()) < 0.05  # noisy, not wild


def _tiny_params(tmp_path):
    """The verify recipe's config: 64^2 water cylinder, 64 x 64 sinogram."""
    ph = water_cylinder_phantom(N=64, dx=0.4)
    ph.to_file(str(tmp_path / "ph.bin"), str(tmp_path / "ph.csv"))
    with open(os.path.join(REPO, "input", "params.txt")) as f:
        cfg = json.load(f)
    cfg.update({"RUN_ID": "tiny", "phantom_id": "water_cyl",
                "phantom_filename": str(tmp_path / "ph.bin"),
                "matcomp_filename": str(tmp_path / "ph.csv"),
                "Nx": 64, "Ny": 64, "dx": 0.4, "dy": 0.4, "dz": 0.4,
                "N_channels": 64, "N_projections": 64,
                "detector_filename": os.path.join(REPO,
                                                  cfg["detector_filename"]),
                "N_recon_matrix": 64, "FOV_recon": 26.0})
    path = tmp_path / "params.txt"
    path.write_text(json.dumps(cfg))
    return path


def _file_tol(name):
    """The bar of one output file: the §2.6 files' FILE_TOL; the denoised
    and BHC images (recon_{denoised,waterBHC,boneBHC}_{raw,HU}) those of
    recon_raw and recon_HU."""
    if name in FILE_TOL:
        return FILE_TOL[name]
    return FILE_TOL["recon_HU" if name.endswith("_HU") else "recon_raw"]


def _both_clis(tmp_path, params, flags, n_files, iters="8"):
    """Run ``params`` through the JAX CLI and the port's (on the CPU) with
    ``flags``; both must write the same ``n_files`` files, each within its
    bar.  Returns the port's output directory."""
    from dexct_tpu.run import main as j_main
    from dexct_tpu_torch.run import main as t_main

    common = ["--params", str(params), "--iters", iters, "--spectrum-dir",
              os.path.join(REPO, "input", "spectrum")] + flags
    j_main(common + ["--output", str(tmp_path / "jax")])
    t_main(common + ["--output", str(tmp_path / "torch"), "--device", "cpu"])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.bin"))
    assert len(files) == n_files
    assert files == sorted(p.relative_to(tmp_path / "torch")
                           for p in (tmp_path / "torch").rglob("*.bin"))
    for rel in files:
        want = np.fromfile(tmp_path / "jax" / rel, np.float32)
        got = np.fromfile(tmp_path / "torch" / rel, np.float32)
        assert got.size == want.size
        np.testing.assert_allclose(
            got, want, err_msg=str(rel),
            **_file_tol(rel.name[:-len("_float32.bin")]))
    return tmp_path / "torch"


@pytest.mark.parametrize("flags", [[], ["--projector", "siddon", "--recon",
                                        "fan"]], ids=["defaults", "exact"])
def test_both_clis_write_the_same_files(tmp_path, flags):
    """With no flags both CLIs run the Fourier projector and the rebinned
    parallel recon; with the exact flags, the Siddon trace and fan FBP."""
    out = _both_clis(tmp_path, _tiny_params(tmp_path), flags, 12)
    assert (out / "tiny" / "params.txt").exists()


def test_resume_and_composed_cli(tmp_path, capsys):
    from dexct_tpu_torch.run import main as t_main

    params = _tiny_params(tmp_path)
    argv = ["--params", str(params), "--iters", "4", "--device", "cpu",
            "--engine", "composed", "--output", str(tmp_path / "o")]
    assert len(t_main(argv)) == 1
    assert t_main(argv + ["--resume"]) == []
    assert "skipping completed" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--projector", "fourier", "--recon", "fan"],
    ["--projector", "siddon", "--recon", "parallel"], ["--bhc"],
    ["--denoise"]])
def test_unported_choices_raise(tmp_path, flags):
    """Every choice that once raised now runs (here each beside the other
    path's choice): the Fourier projector and the parallel recon write the
    12 files; --bhc adds the water and bone BHC images of both spectra, and
    --denoise the denoised ones, all finite (tests/test_torch_bhc.py and
    tests/test_torch_learn.py hold them to the JAX CLI's)."""
    from dexct_tpu_torch.run import main as t_main

    params = _tiny_params(tmp_path)
    argv = ["--params", str(params), "--device", "cpu", "--iters", "4",
            "--output", str(tmp_path / "o")] + flags
    (res,) = t_main(argv)
    assert bool(torch.isfinite(res.dect.recon_raw[0]).all())
    files = list((tmp_path / "o").rglob("*.bin"))
    extra = [p for p in files if "BHC" in p.name or "denoised" in p.name]
    assert len(files) == 12 + len(extra)
    assert len(extra) == {"--bhc": 8, "--denoise": 4}.get(flags[0], 0)
    for p in extra:
        img = np.fromfile(p, np.float32)
        assert img.size == 64 * 64 and np.isfinite(img).all(), p


def test_analytic_projector_raises(small_de):
    """The analytic projector is a choice now (tests/test_torch_analytic.py
    runs it); what still raises is a voxel phantom under it."""
    t_fused.check_choices("analytic", "parallel")
    with pytest.raises(ValueError, match="AnalyticPhantom"):
        t_fused.pack_dect(*small_de, 32, 24.0, 0.8, device="cpu",
                          projector="analytic")


def _runner_cfg(kind):
    from dexct_tpu_torch.system import FanBeamGeometry as TFan
    from dexct_tpu_torch.system.config import RunConfig
    from dexct_tpu_torch.system.phantom import water_cylinder_phantom as tw

    ph = tw(N=32, dx=0.6)
    ct = TFan(N_channels=48, N_proj=40, gamma_fan=0.8230337, SID=60.0,
              SDD=100.0, eid=True)
    if kind == "non_square":
        ph.labels = np.ascontiguousarray(ph.labels[:, :, 2:-2])
    else:
        ct = TFan(N_channels=48, N_proj=40, gamma_fan=0.8230337, SID=60.0,
                  SDD=100.0, eid=True, rotation_total=np.pi + 1.0)
    return RunConfig(kind, True, True, ct, ph, None, 32, 20.0, 0.8)


@pytest.mark.parametrize("kind,want", [
    ("non_square", ("siddon", "parallel")),
    ("partial_rotation", ("fourier", "fan"))])
def test_runner_downgrades_like_jax(tmp_path, kind, want):
    """The JAX runner's rules: fourier needs a square phantom grid and
    parallel a full rotation; otherwise the default runs siddon / fan, and
    the run equals one with those choices given."""
    from dexct_tpu_torch.pipeline.runner import fused_choices, run_config

    cfg = _runner_cfg(kind)
    assert fused_choices(cfg, "fourier", "parallel") == want
    assert fused_choices(cfg, "siddon", "fan") == ("siddon", "fan")
    with pytest.raises(ValueError):  # what the downgrade avoids
        t_fused.pack_dect(cfg.ct, cfg.phantom, *_spectra(cfg.ct), 32, 20.0,
                          0.8, device="cpu", projector="fourier",
                          recon="parallel")
    kw = dict(device="cpu", n_iters=4, verbose=False,
              spectrum_dir=os.path.join(REPO, "input", "spectrum"))
    (got,) = run_config(cfg, out_dir=str(tmp_path / "a"), **kw)
    (ref,) = run_config(cfg, out_dir=str(tmp_path / "b"), projector=want[0],
                        recon=want[1], **kw)
    for key in ("sino_raw", "mat_sinos", "recon_raw"):
        for i in range(2):
            torch.testing.assert_close(getattr(got.dect, key)[i],
                                       getattr(ref.dect, key)[i], rtol=0,
                                       atol=0)


def _spectra(ct):
    from dexct_tpu_torch.physics import kramers_spectrum, linac_spectrum

    s1, s2 = linac_spectrum(), kramers_spectrum(80.0)
    s1.rescale_counts(ct.A_iso * 9.0 / ct.N_proj)
    s2.rescale_counts(ct.A_iso * 1.0 / ct.N_proj)
    return s1, s2


@pytest.mark.parametrize("what", ["flat_panel", "katsevich"])
def test_cone_config_raises(tmp_path, what):
    """Flat-panel configs and the Katsevich reconstructor run
    (tests/test_torch_cone.py) and keep the JAX package's refusals: a
    helical reconstructor on a circular flat-panel orbit, and a
    Tam-Danielsson window taller than the detector (pitch 6 cm over four
    0.5 cm rows)."""
    import dataclasses

    from dexct_tpu_torch.pipeline.runner import run_config
    from dexct_tpu_torch.system import (FlatPanelConeBeamGeometry,
                                        HelicalConeBeamGeometry)
    from dexct_tpu_torch.system.config import RunConfig
    from dexct_tpu_torch.system.phantom import water_cylinder_phantom as tw

    kw = dict(N_channels=16, N_rows=4, h_iso=0.5)
    if what == "flat_panel":
        ct, recon3d, msg = (FlatPanelConeBeamGeometry(N_proj=16, **kw),
                            "helical", "requires a helical config")
    else:
        ct, recon3d, msg = (
            HelicalConeBeamGeometry(N_proj=32, rotation_total=4 * np.pi,
                                    pitch=6.0, **kw),
            "katsevich", "TD window .* exceeds the detector half-height")
    ph = tw(N=16, dx=1.0)
    ph = dataclasses.replace(
        ph, labels=np.broadcast_to(ph.labels[0], (4, 16, 16)).copy(), dz=0.5)
    cfg = RunConfig("c", True, True, ct, ph, None, 16, 16.0, 0.8)
    with pytest.raises(ValueError, match=msg):
        run_config(cfg, out_dir=tmp_path, device="cpu", n_iters=2,
                   recon3d=recon3d)


def _tiny_cone_params(tmp_path):
    """The tiny config as a 2-row cone scan of its one-slice phantom."""
    path = _tiny_params(tmp_path)
    cfg = json.loads(path.read_text())
    cfg.update({"RUN_ID": "tiny_cone", "scanner_geometry": "cone_beam",
                "N_rows": 2, "detector_px_height": 0.4, "N_channels": 32,
                "N_projections": 16, "N_recon_matrix": 32})
    cone = tmp_path / "cone.txt"
    cone.write_text(json.dumps(cfg))
    return cone


def _tiny_3d_variant(tmp_path, name, **changes):
    """The tiny cone config with ``changes`` applied, as its own file."""
    cfg = json.loads(_tiny_cone_params(tmp_path).read_text())
    cfg.update(RUN_ID=f"tiny_{name}", **changes)
    path = tmp_path / f"{name}.txt"
    path.write_text(json.dumps(cfg))
    return path


def test_port_never_imports_jax(tmp_path):
    """Importing the port and running its CLI's default path (Fourier
    projector, parallel recon) with --bhc and --denoise, an in-plane
    flying-focal-spot config, a cone config, a flat-panel config and a
    helical config under ``--recon3d katsevich``, and a z-stack through the
    library, on the CPU, leaves JAX and the JAX package unimported."""
    params = _tiny_params(tmp_path)
    ffs = tmp_path / "ffs.txt"
    ffs.write_text(json.dumps(dict(json.loads(params.read_text()),
                                   RUN_ID="tiny_ffs",
                                   flying_focal_spot="inplane")))
    cone = _tiny_cone_params(tmp_path)
    flat = _tiny_3d_variant(tmp_path, "flat",
                            scanner_geometry="flat_panel_cone_beam")
    helix = _tiny_3d_variant(tmp_path, "helix",
                             scanner_geometry="helical_cone_beam",
                             N_projections=32, pitch=1.0,
                             rotation_angle_total=4 * np.pi)
    runs = [[str(params), "--bhc", "--denoise"], [str(ffs)], [str(cone)],
            [str(flat)], [str(helix), "--recon3d", "katsevich"]]
    code = (
        "import sys\n"
        "import dexct_tpu_torch\n"
        "from dexct_tpu_torch.run import main\n"
        f"for args in {runs!r}:\n"
        "    main(['--params', *args, '--iters', '2', '--device', 'cpu',"
        f" '--output', {str(tmp_path / 'o')!r}])\n"
        "from dexct_tpu_torch.pipeline import pack_zstack, stack_phantom,"
        " zstack_step\n"
        "from dexct_tpu_torch.pipeline.runner import _resolve_spectrum,"
        " default_generators\n"
        "from dexct_tpu_torch.system import FanBeamGeometry,"
        " contrast_rods_phantom\n"
        "ct = FanBeamGeometry(N_channels=32, N_proj=24)\n"
        "s = [_resolve_spectrum(n, d, ct, 'input/spectrum',"
        " default_generators()) for n, d in (('detunedMV', 9.0),"
        " ('80kV', 1.0))]\n"
        "ph = stack_phantom(contrast_rods_phantom, 3, N=32, dx=0.6)\n"
        "a, m, ax = pack_zstack(ct, ph, *s, 32, 20.0, 0.8, device='cpu',"
        " n_iters=2)\n"
        "assert zstack_step(a, m, ax)['recon_HU'][0].shape == (3, 32, 32)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dexct_tpu' or m.startswith('dexct_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
