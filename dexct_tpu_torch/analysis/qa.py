"""Automated image-quality (QA) report on the QA phantom.

`system.phantom.qa_phantom` builds the Catphan-style object; this
module measures a reconstruction of it and emits the acceptance-test
numbers a physicist reads off a scanner QA scan:

- CT-number linearity (per-insert ROI mean/std),
- uniformity (center vs periphery of the water background),
- noise (HU std in the uniform center),
- in-plane MTF50/MTF10 from the bone insert's circular edge,
- low-contrast insert contrast + CNR,
- with a noisy ensemble: the measured NPS and task-based detectability
  d' (PW and NPW observers) for a 3 mm, +10 HU disk task.

The quantities are the same ones the reference's contrast/noise
figures compute ad hoc (plots.py:334-418, 541-717) — here packaged as
one call against a known phantom, the way scanner QA actually runs.
All measurement code is host-side NumPy on reconstructions already
fetched from device (analysis-layer convention).
"""

from __future__ import annotations

import numpy as np

from .nps import (
    detectability_index,
    disk_task,
    mtf_from_disk_edge,
    noise_power_spectrum,
)

__all__ = ["qa_report", "format_qa_report"]


def _roi_mask(n, dx, cy, cx, r):
    y = (np.arange(n) + 0.5 - n / 2.0) * dx
    return np.hypot(y[None, :] - cx, y[:, None] - cy) <= r


def _mtf_crossing(f, mtf, level):
    """First frequency where the MTF falls below ``level`` [1/cm]."""
    below = np.nonzero(mtf < level)[0]
    if len(below) == 0 or below[0] == 0:
        return float("nan")
    i = below[0]
    f0, f1 = f[i - 1], f[i]
    m0, m1 = mtf[i - 1], mtf[i]
    return float(f0 + (m0 - level) * (f1 - f0) / max(m0 - m1, 1e-12))


def qa_report(recon_HU, spec, *, noisy_recons=None,
              task_contrast_HU=10.0, task_radius_cm=0.3):
    """Measure a QA-phantom reconstruction.

    recon_HU: [N, N] HU image of `qa_phantom` (noiseless or a single
        scan).  spec: the dict returned by `qa_phantom`.
    noisy_recons: optional [R, N, N] ensemble of independently noisy
        reconstructions of the same scan — enables the NPS + d' block.

    Returns a plain dict (JSON-serializable apart from nothing —
    floats only) — see `format_qa_report` for pretty-printing.
    """
    img = np.asarray(recon_HU, np.float64)
    n = img.shape[-1]
    dx = spec["dx"]
    body_r = spec["body_radius"]

    report = {"inserts": {}}
    for name, ins in spec["inserts"].items():
        cy, cx = ins["center"]
        m = _roi_mask(n, dx, cy, cx, 0.6 * ins["radius"])
        report["inserts"][name] = {
            "mean_HU": float(img[m].mean()),
            "std_HU": float(img[m].std()),
        }

    # uniformity: center vs 4 peripheral ROIs BETWEEN the inserts
    # (6 inserts at 60 deg spacing -> offset by 30 deg)
    c_mask = _roi_mask(n, dx, 0.0, 0.0, 0.12 * body_r)
    center = float(img[c_mask].mean())
    periph = []
    for k in range(4):
        ang = np.pi / 6.0 + k * np.pi / 2.0
        r = 0.78 * body_r
        m = _roi_mask(n, dx, r * np.sin(ang), r * np.cos(ang),
                      0.08 * body_r)
        periph.append(float(img[m].mean()))
    report["uniformity"] = {
        "center_HU": center,
        "periphery_HU": periph,
        "max_deviation_HU": float(max(abs(p - center) for p in periph)),
    }
    report["noise_HU"] = float(img[c_mask].std())

    bone = spec["inserts"]["bone"]
    f, mtf = mtf_from_disk_edge(img, dx, bone["center"], bone["radius"],
                                window_cm=4.0 * dx)
    report["mtf"] = {
        "f50_per_cm": _mtf_crossing(f, mtf, 0.5),
        "f10_per_cm": _mtf_crossing(f, mtf, 0.1),
    }

    lc = spec["inserts"]["low_contrast"]
    m_in = _roi_mask(n, dx, *lc["center"], 0.6 * lc["radius"])
    ring = (_roi_mask(n, dx, *lc["center"], 2.2 * lc["radius"])
            & ~_roi_mask(n, dx, *lc["center"], 1.4 * lc["radius"]))
    contrast = float(img[m_in].mean() - img[ring].mean())
    noise = max(report["noise_HU"], 1e-12)
    report["low_contrast"] = {
        "contrast_HU": contrast,
        "cnr": contrast / noise,
    }

    if noisy_recons is not None:
        reals = np.asarray(noisy_recons, np.float64)
        # central uniform patch (clear of every insert ring)
        half = int(0.14 * body_r / dx)
        sl = slice(n // 2 - half, n // 2 + half)
        nps2d, _ = noise_power_spectrum(reals[:, sl, sl], dx)
        task = disk_task(nps2d.shape[-1], dx, task_contrast_HU,
                         task_radius_cm)
        report["ensemble"] = {
            "n_realizations": int(reals.shape[0]),
            "noise_HU": float(reals[:, sl, sl].std(0).mean()),
            "dprime_pw": detectability_index(nps2d, dx, task,
                                             observer="pw"),
            "dprime_npw": detectability_index(nps2d, dx, task,
                                              observer="npw"),
        }
    return report


def format_qa_report(report):
    """Render the report dict as the acceptance-test text table."""
    lines = ["QA report", "=" * 44, "CT-number linearity:"]
    for name, r in report["inserts"].items():
        lines.append(f"  {name:<13s} {r['mean_HU']:9.1f} HU  "
                     f"(std {r['std_HU']:.1f})")
    u = report["uniformity"]
    lines.append(f"uniformity: center {u['center_HU']:.1f} HU, max "
                 f"periphery deviation {u['max_deviation_HU']:.1f} HU")
    lines.append(f"noise (center ROI): {report['noise_HU']:.2f} HU")
    m = report["mtf"]
    lines.append(f"MTF50 {m['f50_per_cm']:.2f} /cm, "
                 f"MTF10 {m['f10_per_cm']:.2f} /cm")
    lc = report["low_contrast"]
    lines.append(f"low contrast: {lc['contrast_HU']:+.1f} HU, "
                 f"CNR {lc['cnr']:.2f}")
    if "ensemble" in report:
        e = report["ensemble"]
        lines.append(f"ensemble ({e['n_realizations']}): noise "
                     f"{e['noise_HU']:.2f} HU, d' PW {e['dprime_pw']:.2f}"
                     f" / NPW {e['dprime_npw']:.2f}")
    return "\n".join(lines)
