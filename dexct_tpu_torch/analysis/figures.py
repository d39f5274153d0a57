"""Publication-figure generation — the reference ``plots.py`` gallery.

Functional equivalents of the reference analysis script's figures
(``plots.py``): phantom/ROI overview (plots.py:245-271), VMI
RMSE curves (plots.py:278-328), CNR/SNR curves (plots.py:334-418), the
SE/BMI/VMI image gallery (plots.py:422-481), metal LAC curves
(plots.py:485-534), and contrast/noise sweeps (plots.py:541-717).

matplotlib is imported lazily so headless pipelines never pay for it.
Each function takes arrays (not file paths) and returns the Figure; the
file-contract loaders live in :mod:`dexct_tpu_torch.analysis.loaders`.
"""

from __future__ import annotations

import numpy as np

from ..physics import xcom
from .metrics import Roi, cnr, contrast, make_vmi, noise, rmse

__all__ = [
    "phantom_roi_figure",
    "vmi_metric_figure",
    "dect_gallery_figure",
    "metal_lac_figure",
    "label_panels",
    "contrast_noise_panels",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def phantom_roi_figure(images, rois, titles=None, window=(100, 500)):
    """HU images with ROI overlays (plots.py:245-271 analog).

    images: list of [N, N] HU arrays; rois: list of Roi drawn on each.
    window: (level, width).
    """
    plt = _plt()
    wl, ww = window
    n = len(images)
    fig, ax = plt.subplots(1, n, figsize=[3.2 * n, 3])
    ax = np.atleast_1d(ax)
    for i, img in enumerate(images):
        ax[i].imshow(img, cmap="gray", vmin=wl - ww / 2, vmax=wl + ww / 2)
        ax[i].axis("off")
        if titles:
            ax[i].set_title(titles[i])
        for roi in rois:
            r = roi if isinstance(roi, Roi) else Roi(*roi)
            xs = [r.x0 + r.dx, r.x0, r.x0, r.x0 + r.dx, r.x0 + r.dx]
            ys = [r.y0, r.y0, r.y0 + r.dy, r.y0 + r.dy, r.y0]
            ax[i].plot(xs, ys, "r-", lw=0.6)
    fig.tight_layout()
    return fig


def vmi_metric_figure(cases, energies, metric="rmse", **metric_kw):
    """Metric-vs-VMI-energy curves for several DE cases
    (the plots.py:278-328 / 381-397 pattern).

    cases: dict label -> (M1, M2[, ground_truth_fn]) basis images;
    metric: 'rmse' (needs gt fn: E0 -> HU image), 'cnr', 'contrast' or
    'noise' (need roi_signal/roi_background in metric_kw).
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=[4.2, 3])
    for label, case in cases.items():
        m1, m2 = case[0], case[1]
        vals = []
        for e0 in energies:
            vmi = make_vmi(float(e0), m1, m2)
            if metric == "rmse":
                gt = case[2](float(e0))
                vals.append(rmse(vmi, gt, metric_kw.get("mask")))
            elif metric == "cnr":
                vals.append(cnr(vmi, metric_kw["roi_signal"],
                                metric_kw["roi_background"]))
            elif metric == "contrast":
                vals.append(contrast(vmi, metric_kw["roi_signal"],
                                     metric_kw["roi_background"]))
            elif metric == "noise":
                vals.append(noise(vmi, metric_kw["roi_signal"],
                                  metric_kw["roi_background"]))
            else:
                raise ValueError(f"unknown metric {metric!r}")
        ax.plot(energies, vals, marker="o", markersize=3, label=label)
    ax.set_xlabel("VMI energy [keV]")
    ax.set_ylabel({"rmse": "RMSE [HU]", "cnr": "CNR",
                   "contrast": "contrast [HU]",
                   "noise": "noise [HU]"}[metric])
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def dect_gallery_figure(hu1, hu2, mat1, mat2, vmi_energies=(80.0, 300.0),
                        window=(50, 500), titles=("spec 1", "spec 2")):
    """The 3x2 SE-CT / BMI / VMI gallery (plots.py:422-481)."""
    plt = _plt()
    wl, ww = window
    hu_kw = dict(cmap="gray", vmin=wl - ww / 2, vmax=wl + ww / 2)
    fig, ax = plt.subplots(3, 2, figsize=[6.4, 8.4])
    panels = [
        (hu1, titles[0], hu_kw, "HU"),
        (hu2, titles[1], hu_kw, "HU"),
        (mat1, "BMI - ICRU tissue", dict(cmap="gray", vmin=0, vmax=1.2),
         r"$\rho$ [g/cm$^3$]"),
        (mat2, "BMI - ICRU bone", dict(cmap="gray", vmin=0, vmax=2.2),
         r"$\rho$ [g/cm$^3$]"),
        (make_vmi(vmi_energies[0], mat1, mat2),
         f"VMI - {vmi_energies[0]:.0f} keV", hu_kw, "HU"),
        (make_vmi(vmi_energies[1], mat1, mat2),
         f"VMI - {vmi_energies[1]:.0f} keV", hu_kw, "HU"),
    ]
    for axi, (img, title, kw, cbar_label) in zip(ax.ravel(), panels):
        m = axi.imshow(np.asarray(img), **kw)
        axi.set_title(title, fontsize=9)
        axi.axis("off")
        fig.colorbar(m, ax=axi, pad=0.02).set_label(cbar_label)
    fig.tight_layout(pad=0.3)
    return fig


def label_panels(ax, color="k", loc="outside", dx=-0.06, dy=0.09,
                 fontsize=None, label_type="lowercase",
                 label_format="({})"):
    """Letter/number labels on every panel of a subplot grid — the
    reference's figure-annotation helper (plots.py:62-102 analog).

    loc='outside' places the label above the axes corner, 'inside' just
    within it; label_type selects 'lowercase'/'uppercase' letters or
    numbers.
    """
    if "upper" in label_type:
        tags = [chr(c) for c in range(65, 91)]
    elif "lower" in label_type:
        tags = [chr(c) for c in range(97, 123)]
    else:
        tags = [str(i) for i in range(1, 27)]
    if loc == "outside":
        xf, yf = -dx, 1.0 + dy
    else:
        xf, yf = dx, 1.0 - dy
    for i, axi in enumerate(np.ravel(ax)):
        x0, x1 = axi.get_xlim()
        y0, y1 = axi.get_ylim()
        axi.text(x0 + (x1 - x0) * xf, y0 + (y1 - y0) * yf,
                 label_format.format(tags[i]), color=color,
                 fontsize=fontsize, fontweight="bold",
                 va="center", ha="center")


def contrast_noise_panels(panels, roi_signal, roi_background,
                          metric="contrast", baselines=None,
                          marker_step=10):
    """Per-phantom panels of contrast or noise vs VMI energy — the
    reference's revision-study figure families (contrast plots.py:541-603,
    noise plots.py:631-717).

    panels: dict panel_title -> dict of DE cases
        {case_label: (M1, M2, energies)} — basis-material images plus the
        VMI energy grid to sweep (the reference uses wider grids for the
        metal phantoms).
    baselines: optional dict panel_title -> {label: HU image} drawn as
        horizontal single-energy-scan reference lines (the reference's
        BHC-corrected kV scans).
    metric: 'contrast' (|u1-u2|) or 'noise' (sqrt(v1+v2)).
    """
    plt = _plt()
    fn = {"contrast": contrast, "noise": noise}[metric]
    n = len(panels)
    fig, ax = plt.subplots(1, n, figsize=[2.9 * n, 2.8])
    ax = np.atleast_1d(ax)
    ax[0].set_ylabel(metric + (" [HU]" if metric == "contrast" else " [HU]"))
    for i, (title, cases) in enumerate(panels.items()):
        ax[i].set_title(title.replace("_", " with "), fontsize=9)
        if baselines and title in baselines:
            for ls, (lab, img) in zip(("--", ":", "-", "-."),
                                      baselines[title].items()):
                ax[i].axhline(fn(img, roi_signal, roi_background),
                              lw=1.2, color="k", ls=ls,
                              label=lab if i == 0 else None)
        for fmt, (lab, case) in zip(("bs", "ro", "g^", "mv"),
                                    cases.items()):
            m1, m2, energies = case
            es = np.arange(float(energies[0]), float(energies[-1]) + 1.0)
            vals = [fn(make_vmi(float(e), m1, m2), roi_signal,
                       roi_background) for e in es]
            ax[i].plot(es, vals, fmt[0] + "-", lw=1.0,
                       label=lab if i == 0 else None)
            ax[i].plot(es[::marker_step], vals[::marker_step], fmt,
                       markerfacecolor="None", markersize=4)
        ax[i].set_xlabel("VMI energy [keV]")
    fig.legend(loc="center right", fontsize=7)
    fig.tight_layout(pad=1.1, rect=(0, 0, 0.86, 1))
    label_panels(ax, dy=0.06)
    return fig


# implant alloys of the reference metal-LAC study (plots.py:487-498)
IMPLANT_ALLOYS = [
    ("Steel 316L", 8.0,
     "C(0.5)N(0.1)P(0.0025)S(0.01)Fe(64.335)Cr(17.0)Ni(13.0)Mo(2.25)"
     "Mn(2.0)Si(0.75)Cu(0.5)"),
    ("Pure Ti", 4.5, "Ti(100.0)"),
    ("Ti-6Al-4V", 4.43, "Al(6)Ti(90)V(4)"),
    ("Co-28Cr-6Mo", 8.5, "Co(66)Cr(28)Mo(6)"),
]


def metal_lac_figure(alloys=None):
    """Linear attenuation of implant alloys, keV + MeV panels
    (plots.py:485-534)."""
    plt = _plt()
    alloys = alloys or IMPLANT_ALLOYS
    fig, ax = plt.subplots(1, 2, figsize=[6.4, 3])
    for axi, (e_lo, e_hi, unit) in zip(
            ax, [(1.0, 140.0, "keV"), (150.0, 6500.0, "MeV")]):
        e = np.linspace(e_lo, e_hi, 500)
        for name, density, matcomp in alloys:
            mu = xcom.mixatten(matcomp, e) * density
            x = e if unit == "keV" else e * 1e-3
            axi.plot(x, mu, lw=1.0, label=name)
        axi.set_yscale("log")
        axi.set_xlabel(f"energy [{unit}]")
        axi.set_title(f"{unit}-scale")
    ax[0].set_ylabel("linear attenuation [cm$^{-1}$]")
    ax[0].legend(fontsize=7)
    fig.tight_layout()
    return fig
