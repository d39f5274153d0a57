"""Noise power spectrum, MTF measurement, NEQ, and model-observer
detectability for reconstructed CT images.

The reference's image-quality analysis is first/second-moment ROI
statistics — noise, contrast, CNR (``plots.py``:146-158,
581-693).  Those collapse the noise *texture*: FBP noise is strongly
correlated (the ramp filter shapes the spectrum), so two recons with
equal ROI variance can differ hugely in low-contrast detectability.
This module adds the standard frequency-domain metrology (ICRU 87 /
IEC 62220 style):

* ``noise_power_spectrum`` — ensemble 2-D NPS from noise realizations,
  with the Parseval normalization ``sum(NPS) * df^2 == pixel variance``;
* ``radial_average`` — 1-D radial rebin of any 2-D spectrum;
* ``mtf_from_disk_edge`` — circular-edge MTF: oversampled radial ESF
  around a disk insert -> LSF -> normalized |FT| (the standard
  bead/edge method, robust to the recon grid);
* ``neq`` — noise-equivalent quanta ``mean^2 MTF^2 / NPS``;
* ``detectability_index`` — task-based d' for the prewhitening (PW,
  ideal linear) and non-prewhitening (NPW) observers on the discrete
  frequency grid.

Discrete conventions (pinned by the tests): for an N x N image with
pixel size ``dx`` [cm], frequency bin ``df = 1/(N dx)`` [1/cm],

    NPS(k)  = dx^2 / N^2 * E|DFT(noise)|^2        [HU^2 cm^2]
    S(k)    = dx^2 * DFT(task signal)             [HU cm^2]
    d'_PW^2  = sum_k |S MTF|^2 / NPS * df^2
    d'_NPW^2 = (sum_k |S MTF|^2 df^2)^2 / sum_k |S MTF|^2 NPS df^2

In white noise (flat NPS, MTF == 1) both reduce to the matched-filter
SNR ``sqrt(sum_x s(x)^2) / sigma`` — the unit test's analytic anchor.
All functions are host-side NumPy (analysis runs on fetched images).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "noise_power_spectrum",
    "radial_average",
    "radial_frequencies",
    "mtf_from_disk_edge",
    "neq",
    "detectability_index",
    "disk_task",
]


def noise_power_spectrum(realizations, dx, detrend="ensemble"):
    """Ensemble 2-D NPS [HU^2 cm^2] from noise realizations.

    realizations: [R, N, N] reconstructed images of a *statistically
        identical* object (R >= 2).  detrend="ensemble" subtracts the
        ensemble mean image (removes the deterministic structure
        exactly as R -> inf); "pairs" differences consecutive
        realizations (exact structure removal at any R, costs a factor
        2 in dose efficiency; variance is compensated).
    Returns (nps2d [N, N], df): the fftshifted spectrum and the
        frequency bin [1/cm].
    """
    x = np.asarray(realizations, np.float64)
    if x.ndim != 3 or x.shape[0] < 2:
        raise ValueError("need [R>=2, N, N] noise realizations")
    if detrend == "ensemble":
        d = x - x.mean(0, keepdims=True)
        # unbiased: the residuals carry (R-1)/R of the noise power
        norm = x.shape[0] - 1.0
    elif detrend == "pairs":
        d = (x[1::2] - x[:-1:2][: len(x[1::2])]) / np.sqrt(2.0)
        norm = float(d.shape[0])
    else:
        raise ValueError(f"unknown detrend {detrend!r}")
    n = x.shape[-1]
    spec = np.abs(np.fft.fft2(d, axes=(-2, -1))) ** 2
    nps = spec.sum(0) / norm * (dx * dx / (n * n))
    return np.fft.fftshift(nps), 1.0 / (n * dx)


def radial_frequencies(n, dx):
    """fftshifted radial frequency magnitude grid [1/cm] for an n x n
    image."""
    f = np.fft.fftshift(np.fft.fftfreq(n, d=dx))
    return np.hypot(f[None, :], f[:, None])


def radial_average(spec2d, dx, n_bins=None, f_max=None):
    """Radially average an fftshifted 2-D spectrum.

    Returns (f_centers [B], curve [B]).  Bins are uniform in |f| up to
    ``f_max`` (default: the axis Nyquist 1/(2 dx), excluding the corner
    region where angular coverage is partial).
    """
    s = np.asarray(spec2d, np.float64)
    n = s.shape[-1]
    fr = radial_frequencies(n, dx)
    if f_max is None:
        f_max = 1.0 / (2.0 * dx)
    if n_bins is None:
        n_bins = n // 2
    edges = np.linspace(0.0, f_max, n_bins + 1)
    idx = np.digitize(fr.ravel(), edges) - 1
    ok = (idx >= 0) & (idx < n_bins)
    sums = np.bincount(idx[ok], weights=s.ravel()[ok], minlength=n_bins)
    cnts = np.bincount(idx[ok], minlength=n_bins).astype(np.float64)
    # drop bins no grid frequency falls into (n_bins finer than the
    # frequency grid) instead of reporting spurious zeros
    filled = cnts > 0
    curve = sums[filled] / cnts[filled]
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers[filled], curve


def mtf_from_disk_edge(img, dx, center, radius_cm, *, band_cm=None,
                       oversample=8, window_cm=None):
    """In-plane MTF from the edge of a high-contrast disk insert.

    img: [N, N] reconstruction containing a disk of known ``center``
        (cy, cx) [cm, world coords] and ``radius_cm``; the circular edge
        samples every in-plane direction, and binning pixels by their
        exact radial distance oversamples the ESF far beyond the pixel
        pitch (the classic slanted/circular-edge trick).
    Returns (f [1/cm], mtf [.]): |FT(LSF)| normalized to 1 at f=0, up to
        the oversampled Nyquist.

    band_cm: half-width of the radial band around the edge (default
        6 pixels).  window_cm: optional Hann half-width applied to the
        LSF to suppress far-tail noise.
    """
    a = np.asarray(img, np.float64)
    n = a.shape[-1]
    y = (np.arange(n) + 0.5 - n / 2.0) * dx
    rr = np.hypot(y[None, :] - center[1], y[:, None] - center[0])
    band = band_cm if band_cm is not None else 6.0 * dx
    sel = np.abs(rr - radius_cm) <= band
    r = rr[sel] - radius_cm
    v = a[sel]
    # oversampled ESF: bin radial offsets at dx/oversample pitch
    pitch = dx / oversample
    bins = np.round(r / pitch).astype(int)
    lo = bins.min()
    cnt = np.bincount(bins - lo).astype(np.float64)
    esf = np.bincount(bins - lo, weights=v)
    ok = cnt > 0
    # fill empty oversample bins by interpolation
    pos = np.arange(len(cnt))
    esf = np.interp(pos, pos[ok], esf[ok] / cnt[ok])
    lsf = np.gradient(esf, pitch)
    x = (pos + lo) * pitch
    if window_cm is not None:
        w = np.cos(np.clip(x / window_cm, -1.0, 1.0) * np.pi / 2.0) ** 2
        lsf = lsf * w
    # the disk is brighter inside: LSF sign is negative going outward;
    # MTF is |FT| so sign cancels, but de-mean to kill any ramp leakage
    spec = np.abs(np.fft.rfft(lsf))
    f = np.fft.rfftfreq(len(lsf), d=pitch)
    if spec[0] <= 0:
        raise ValueError("degenerate edge: zero DC response")
    return f, spec / spec[0]


def neq(f, mtf, nps_1d, mean_signal):
    """Noise-equivalent quanta NEQ(f) = mean^2 MTF^2(f) / NPS(f).

    ``mtf`` and ``nps_1d`` must be sampled on the same frequency grid
    ``f`` (interpolate with np.interp beforehand); ``mean_signal`` is
    the large-area signal level whose transfer the MTF describes (e.g.
    the water-insert mean in HU, or mu in 1/cm — NEQ units follow).
    """
    nps = np.asarray(nps_1d, np.float64)
    return (float(mean_signal) ** 2) * np.asarray(mtf) ** 2 \
        / np.maximum(nps, 1e-300)


def disk_task(n, dx, contrast, radius_cm, supersample=4):
    """Task signal image: a ``contrast``-amplitude disk at the image
    center, area-antialiased by ``supersample``x."""
    m = n * supersample
    y = (np.arange(m) + 0.5 - m / 2.0) * (dx / supersample)
    inside = (y[None, :] ** 2 + y[:, None] ** 2) <= radius_cm ** 2
    img = inside.reshape(n, supersample, n, supersample).mean((1, 3))
    return float(contrast) * img


def detectability_index(nps2d, dx, task, *, mtf=None, observer="npw"):
    """Task-based detectability d' on the discrete frequency grid.

    nps2d: [N, N] fftshifted NPS from :func:`noise_power_spectrum`.
    task:  [N, N] task signal image (e.g. :func:`disk_task`) — the
        difference image 'signal present minus absent' BEFORE system
        blur.
    mtf:   optional (f [1/cm], mtf) curve applied radially (None = the
        task is already expressed post-blur).
    observer: "pw" (prewhitening ideal) or "npw" (non-prewhitening).

    See the module docstring for the exact discrete formulas; in white
    noise with mtf=None both observers give the matched-filter SNR.
    """
    nps = np.asarray(nps2d, np.float64)
    n = nps.shape[-1]
    s = np.fft.fftshift(np.abs(np.fft.fft2(np.asarray(task, np.float64))))
    s = s * dx * dx  # [HU cm^2]
    if mtf is not None:
        fgrid = radial_frequencies(n, dx)
        mt = np.interp(fgrid, np.asarray(mtf[0]), np.asarray(mtf[1]),
                       right=float(np.asarray(mtf[1])[-1]))
        s = s * mt
    df2 = (1.0 / (n * dx)) ** 2
    s2 = s * s
    nps_f = np.maximum(nps, 1e-300)
    if observer == "pw":
        return float(np.sqrt(np.sum(s2 / nps_f) * df2))
    if observer == "npw":
        num = np.sum(s2) * df2
        den = np.sum(s2 * nps) * df2
        if den <= 0:
            raise ValueError("zero noise power under the task band")
        return float(num / np.sqrt(den))
    raise ValueError(f"unknown observer {observer!r}")
