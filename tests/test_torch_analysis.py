"""The port's ``analysis`` package (host NumPy) against the JAX package's,
function by function: every public function of ``analysis`` and of its
modules (metrics, loaders, nps, products, qa, register, figures) gets
identical inputs in both packages (the materials, phantoms and QA
specification each from its own package) and must agree to rtol 1e-12;
the figures by the data they draw.  The loaders read a tiny run of the
port's CLI (64^2 water cylinder, 64 x 64 rays, ``--bhc``, on the CPU)."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest

import dexct_tpu.analysis as j_an
import dexct_tpu_torch.analysis as t_an
from dexct_tpu.analysis import products as j_products
from dexct_tpu.physics import materials as j_mat
from dexct_tpu.system import phantom as j_ph
from dexct_tpu_torch.analysis import products as t_products
from dexct_tpu_torch.physics import materials as t_mat
from dexct_tpu_torch.system import phantom as t_ph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": types.SimpleNamespace(an=j_an, products=j_products,
                                     mat=j_mat, ph=j_ph,
                                     figures="dexct_tpu.analysis.figures"),
        "port": types.SimpleNamespace(an=t_an, products=t_products,
                                      mat=t_mat, ph=t_ph,
                                      figures="dexct_tpu_torch.analysis"
                                              ".figures")}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A tiny run of the port's CLI with --bhc: (output dir, run id,
    phantom id, matrix)."""
    from dexct_tpu_torch.run import main as t_main
    from dexct_tpu_torch.system import water_cylinder_phantom

    tmp = tmp_path_factory.mktemp("cli")
    ph = water_cylinder_phantom(N=64, dx=0.4)
    ph.to_file(str(tmp / "ph.bin"), str(tmp / "ph.csv"))
    with open(os.path.join(REPO, "input", "params.txt")) as f:
        cfg = json.load(f)
    cfg.update({"RUN_ID": "tiny", "phantom_id": "water_cyl",
                "phantom_filename": str(tmp / "ph.bin"),
                "matcomp_filename": str(tmp / "ph.csv"),
                "Nx": 64, "Ny": 64, "dx": 0.4, "dy": 0.4, "dz": 0.4,
                "N_channels": 64, "N_projections": 64,
                "detector_filename": os.path.join(REPO,
                                                  cfg["detector_filename"]),
                "N_recon_matrix": 64, "FOV_recon": 26.0})
    (tmp / "params.txt").write_text(json.dumps(cfg))
    t_main(["--params", str(tmp / "params.txt"), "--output",
            str(tmp / "out"), "--device", "cpu", "--iters", "4",
            "--projector", "siddon", "--recon", "fan", "--bhc",
            "--spectrum-dir", os.path.join(REPO, "input", "spectrum")])
    return str(tmp / "out"), "tiny", "water_cyl", 64


def _data():
    """Inputs shared by both packages, from one seed."""
    rng = np.random.default_rng(0)
    img = rng.normal(100.0, 5.0, (64, 64))
    img[20:30, 20:30] += 50.0
    m1 = np.clip(rng.normal(1.0, 0.1, (64, 64)), 0, None)
    m2 = np.clip(rng.normal(0.3, 0.1, (64, 64)), 0, None)
    yy, xx = np.mgrid[:64, :64]
    disk = np.where(np.hypot(yy - 31.5, xx - 31.5) < 12.0, 200.0, 0.0)
    blurred = disk + rng.normal(0.0, 1.0, disk.shape)
    noise = rng.normal(0.0, 10.0, (6, 32, 32))
    a_basis = [np.array([[1.0, 1.0], [1.06, 0.0]]),
               np.array([[0.0, 0.005], [0.0, 0.0]])]
    return types.SimpleNamespace(img=img, m1=m1, m2=m2, disk=blurred,
                                 noise=noise, a_basis=a_basis, rng=rng)


def _iodine(p):
    return [p.mat.WATER, p.mat.Material("iodine", 4.93, "I(100.0)")]


def _sig_bg(p):
    return p.an.Roi(20, 20, 10, 10), p.an.Roi(45, 45, 10, 10)


def _nps(p, d):
    return p.an.noise_power_spectrum(d.noise, 0.1)


def _qa(p, d):
    ph, spec = p.ph.qa_phantom(N=96, dx=0.3)
    hu = ph.M_mono(70.0)
    rng = np.random.default_rng(4)
    ens = hu[None] + rng.normal(0.0, 5.0, (4,) + hu.shape)
    return p.an.qa_report(hu + rng.normal(0.0, 2.0, hu.shape), spec,
                          noisy_recons=ens)


def _figure_data(fig):
    """What a figure draws: each axes' lines, images, collections and
    texts, as arrays and strings."""
    out = []
    for ax in fig.axes:
        out.append([line.get_xydata() for line in ax.get_lines()])
        out.append([np.asarray(im.get_array()) for im in ax.get_images()])
        out.append([np.asarray(c.get_offsets()) for c in ax.collections])
        out.append([t.get_text() for t in ax.texts])
        out.append([ax.get_title(), ax.get_xlabel(), ax.get_ylabel()])
    import matplotlib.pyplot as plt

    plt.close(fig)
    return out


def _figures(p, d):
    import importlib

    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    fg = importlib.import_module(p.figures)
    sig, bg = _sig_bg(p)
    panels = {"pelvis": {"MV-80kV": (d.m1, d.m2, np.arange(40, 140, 20))}}
    import matplotlib.pyplot as plt

    _, axes = plt.subplots(1, 3)
    fg.label_panels(axes, label_type="number", loc="inside",
                    label_format="{}.")
    return [_figure_data(f) for f in (
        fg.phantom_roi_figure([d.img], [sig], ["test"]),
        fg.vmi_metric_figure({"case": (d.m1, d.m2)}, [60.0, 80.0],
                             metric="cnr", roi_signal=sig,
                             roi_background=bg),
        fg.dect_gallery_figure(d.img, d.img, d.m1, d.m2),
        fg.contrast_noise_panels(panels, sig, bg, metric="contrast",
                                 baselines={"pelvis": {"80kV": d.img}}),
        fg.metal_lac_figure(), axes[0].figure)]


CASES = {
    "make_vmi": lambda p, d, r: (p.an.make_vmi(70.0, d.m1, d.m2),
                                 p.an.make_vmi(50.0, d.m1, d.m2, HU=False)),
    "Roi": lambda p, d, r: dataclasses.astuple(p.an.Roi(3, 5, 8, 6))
    + (p.an.Roi(3, 5, 8, 6).extract(d.img),),
    "measure_roi": lambda p, d, r: p.an.measure_roi(d.img, _sig_bg(p)[0]),
    "crop_img": lambda p, d, r: p.an.crop_img(d.img, 20),
    "nonair_mask": lambda p, d, r: p.an.nonair_mask(d.img - 1050.0
                                                    * (d.m1 < 0.9)),
    "rmse": lambda p, d, r: (p.an.rmse(d.img, d.img * 1.01),
                             p.an.rmse(d.img, d.img * 1.01,
                                       mask=d.m1 > 1.0)),
    "cnr": lambda p, d, r: p.an.cnr(d.img, *_sig_bg(p)),
    "contrast": lambda p, d, r: p.an.contrast(d.img, *_sig_bg(p)),
    "noise": lambda p, d, r: p.an.noise(d.img, *_sig_bg(p)),
    "vmi_metric_curve": lambda p, d, r: p.an.vmi_metric_curve(
        d.m1, d.m2, [40.0, 80.0, 120.0], lambda v: float(v.mean())),
    "noise_power_spectrum": lambda p, d, r: _nps(p, d),
    "radial_average": lambda p, d, r: p.an.radial_average(_nps(p, d)[0],
                                                          0.1),
    "mtf_from_disk_edge": lambda p, d, r: p.an.mtf_from_disk_edge(
        d.disk, 0.1, (0.0, 0.0), 1.2, band_cm=0.5),
    "neq": lambda p, d, r: p.an.neq(np.linspace(0.0, 5.0, 11),
                                    np.linspace(1.0, 0.2, 11),
                                    np.linspace(2.0, 1.0, 11), 40.0),
    "disk_task": lambda p, d, r: p.an.disk_task(32, 0.1, 10.0, 0.5),
    "detectability_index": lambda p, d, r: [
        p.an.detectability_index(_nps(p, d)[0], 0.1,
                                 p.an.disk_task(32, 0.1, 10.0, 0.5),
                                 observer=o,
                                 mtf=(np.linspace(0, 5, 8),
                                      np.linspace(1, 0.3, 8)))
        for o in ("npw", "pw")],
    "vnc_image": lambda p, d, r: p.an.vnc_image(d.a_basis, _iodine(p),
                                                70.0),
    "iodine_map": lambda p, d, r: p.an.iodine_map(d.a_basis, _iodine(p)),
    "electron_density_map": lambda p, d, r: p.an.electron_density_map(
        d.a_basis, _iodine(p)),
    "zeff_image": lambda p, d, r: p.an.zeff_image(d.a_basis, _iodine(p)),
    "mean_excitation_energy": lambda p, d, r: [
        p.products.mean_excitation_energy(m.matcomp)
        for m in (p.mat.WATER, p.mat.BONE, p.mat.TISSUE)],
    "proton_spr": lambda p, d, r: [p.products.proton_spr(m)
                                   for m in (p.mat.BONE, p.mat.TISSUE)],
    "spr_image": lambda p, d, r: p.products.spr_image(d.a_basis,
                                                      _iodine(p)),
    "qa_report": lambda p, d, r: _qa(p, d),
    "format_qa_report": lambda p, d, r: p.an.format_qa_report(_qa(p, d)),
    "rescale_shift": lambda p, d, r: p.an.rescale_shift(d.img, 96, 2, -3),
    "register_phantom_to_recon": lambda p, d, r: (
        p.an.register_phantom_to_recon(
            p.ph.water_cylinder_phantom(N=48, dx=0.5), 64, 20.0,
            energy_keV=70.0),
        p.an.register_phantom_to_recon(
            p.ph.water_cylinder_phantom(N=48, dx=0.5), 32, 30.0,
            image=d.img[:48, :48])),
    "load_ct_image": lambda p, d, r: [
        p.an.load_ct_image(r[0], r[1], "80kV", 1.0, r[3], units=u,
                           crop=c) for u in ("HU", "raw") for c in (None, 32)],
    "load_sinogram": lambda p, d, r: [
        p.an.load_sinogram(r[0], r[1], "detunedMV", 9.0, (64, 64), kind=k)
        for k in ("raw", "log")],
    "load_basis_images": lambda p, d, r: p.an.load_basis_images(
        r[0], r[1], "detunedMV", "80kV", 9.0, 1.0, r[3], crop=32),
    "load_bhc_image": lambda p, d, r: [
        p.an.load_bhc_image(r[0], r[1], r[2], "80kV", kind=k, units=u,
                            n_matrix=r[3])
        for k in ("bone", "water") for u in ("HU", "raw")],
    "figures": lambda p, d, r: _figures(p, d),
}


def _assert_same(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    elif dataclasses.is_dataclass(want):
        _assert_same(dataclasses.astuple(got), dataclasses.astuple(want),
                     path)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=path)


def test_every_public_name_is_covered():
    names = set(j_an.__all__) | {"load_ct_image", "load_sinogram",
                                 "load_basis_images", "load_bhc_image",
                                 "qa_report", "format_qa_report"}
    assert set(t_an.__all__) == set(j_an.__all__)
    assert names <= set(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_analysis_matches_jax(name, cli_run):
    want = CASES[name](PKGS["jax"], _data(), cli_run)
    got = CASES[name](PKGS["port"], _data(), cli_run)
    _assert_same(got, want)
