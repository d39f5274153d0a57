"""Batched parameter sweeps: dose, ramp-filter and slice grids on one device.

Port of :mod:`dexct_tpu.pipeline.sweep` (BASELINE.json config 5).  The
trace is dose-independent, so one projection and its four base counts (the
mean counts of both spectra, and their second moments for compound noise)
feed every point of a dose grid; each point then scales them, draws its
noise, decomposes (K3) and reconstructs its four images through the fused
step's :func:`~.fused.decompose_counts` and :func:`~.fused.reconstruct_stack`.
A Python loop over the grid stands in for the JAX package's ``lax.map``,
and the results are stacked on a leading grid axis.  The ramp sweep shares
one acquisition across its filters; the slice sweep runs
:func:`~.fused.dect_step` once per slice.  No new kernel: K1-K8 run under
the loop, on the device of the packed arrays.

Noise: the key is an int seed or a ``torch.Generator`` (one int is drawn
from it per call).  Grid point ``i`` draws from its own generator, seeded
from that seed and ``i`` (:func:`_point_generator`), so its draw does not
depend on the length of the grid.  The draws differ from the JAX
package's (a JAX PRNG key split per point): compare statistics.

``sweep_mesh`` and ``sharded_dose_sweep`` belong to the multi-device layer
(ROADMAP queue 1, item 15) and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import spectral as sp_ops
from ..ops.fbp import hu_image
from ..ops.siddon import labels_stack_tensor
from ..utils.devices import upload
from .fused import (DectMeta, _project_paths, decompose_counts, dect_step,
                    reconstruct_stack)

__all__ = ["dose_sweep", "ramp_sweep", "slice_sweep", "sweep_mesh",
           "sharded_dose_sweep"]


def _base_counts(arrays, meta, second_moments):
    """One projection -> the mean counts of both spectra, and their second
    moments (``None`` unless ``second_moments``)."""
    a = arrays
    paths = _project_paths(a, meta)
    if not second_moments:
        return (sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_1"]),
                sp_ops.counts_from_paths(paths, a["mu_t2"], a["i0_2"]),
                None, None)
    c1, v1 = sp_ops.counts_from_paths(paths, a["mu_t1"], a["i0_1"],
                                      a["i2_1"])
    c2, v2 = sp_ops.counts_from_paths(paths, a["mu_t2"], a["i0_2"],
                                      a["i2_2"])
    return c1, c2, v1, v2


def _base_seed(key):
    """The sweep's seed: ``key`` itself, or one int drawn from a
    ``torch.Generator``."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=key,
                                 device=key.device).item())
    return int(key)


def _point_generator(seed, index, device):
    """The noise generator of grid point ``index`` of a sweep seeded with
    ``seed``, on ``device``: seeded from (seed, index) alone, so a point's
    draw does not depend on the grid around it."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, int(index)])
    point_seed = int(state.generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(point_seed)


def _hu_pair(imgs, meta):
    return torch.stack([hu_image(imgs[0], meta.mu_w1),
                        hu_image(imgs[1], meta.mu_w2)])


def dose_sweep(arrays, meta: DectMeta, dose_scales, key=0, *,
               noise="poisson"):
    """Full DE pipeline over a dose grid.

    dose_scales: [K] multipliers applied to BOTH spectra's fluence
    (relative to the doses baked into the packed arrays).  ``key``: an int
    seed or a ``torch.Generator`` (see the module docstring).  Returns a
    dict of per-dose stacks: recon_HU [K, 2, N, N], mat_recons
    [K, 2, N, N], mat_sinos [K, 2, V, C]."""
    dev = arrays["mu_t1"].device
    # float32 scales, as the JAX program sees them
    scales = torch.as_tensor(dose_scales, dtype=torch.float32).reshape(-1)
    c1_base, c2_base, v1_base, v2_base = _base_counts(
        arrays, meta, noise == "compound")
    seed = _base_seed(key) if noise != "none" else 0
    air = np.float32([meta.air1, meta.air2])
    out = {"recon_HU": [], "mat_recons": [], "mat_sinos": []}
    for i, s in enumerate(scales.tolist()):
        gen = _point_generator(seed, i, dev) if noise != "none" else None
        c1 = sp_ops.sample_noise(gen, c1_base * s, noise,
                                 var=None if v1_base is None else v1_base * s)
        c2 = sp_ops.sample_noise(gen, c2_base * s, noise,
                                 var=None if v2_base is None else v2_base * s)
        log1 = sp_ops.log_sinogram(c1, air[0] * np.float32(s))
        log2 = sp_ops.log_sinogram(c2, air[1] * np.float32(s))
        mat1, mat2 = decompose_counts(
            c1, c2, dict(arrays, dec_i0=arrays["dec_i0"] * s), meta,
            meta.pixel_block)
        imgs = reconstruct_stack(torch.stack([log1, log2, mat1, mat2]),
                                 arrays, meta)
        out["recon_HU"].append(_hu_pair(imgs, meta))
        out["mat_recons"].append(imgs[2:4])
        out["mat_sinos"].append(torch.stack([mat1, mat2]))
    return {k: torch.stack(v) for k, v in out.items()}


def ramp_sweep(arrays, meta: DectMeta, ramps_H, *, window="sinc"):
    """Reconstruction-filter sweep sharing one acquisition.

    ramps_H: [K, H] stack of precomputed fan filter responses (the pack's
    fft grid).  As in the JAX package, every point is a fan-beam FBP
    (``filter_views`` + K4) of the two noiseless log sinograms, whatever
    the pack's ``recon``; ``window`` is accepted and unused, as there.
    Returns recon_HU [K, 2, N, N]."""
    del window
    c1, c2, _, _ = _base_counts(arrays, meta, False)
    sinos = torch.stack([sp_ops.log_sinogram(c1, np.float32(meta.air1)),
                         sp_ops.log_sinogram(c2, np.float32(meta.air2))])
    H = upload(ramps_H, sinos)
    fan = meta._replace(recon="fan")
    return torch.stack([
        _hu_pair(reconstruct_stack(sinos, dict(arrays, filt_H=h), fan), meta)
        for h in H])


def slice_sweep(arrays, meta: DectMeta, labels_zyx):
    """Full DE pipeline over the slices of a multi-slice phantom.

    labels_zyx: [Z, N, N] label volume (NumPy or a tensor; labels 0..255).
    Every slice shares the geometry and spectra tables; returns the
    :func:`~.fused.dect_step` output dict with a leading Z axis on each
    tensor of each pair."""
    dev = arrays["labels"].device
    if torch.is_tensor(labels_zyx):
        labels_zyx = labels_zyx.cpu().numpy()
    vol = labels_stack_tensor(np.asarray(labels_zyx), dev)
    steps = [dect_step(dict(arrays, labels=lab), meta) for lab in vol]
    return {k: tuple(torch.stack([s[k][i] for s in steps]) for i in range(2))
            for k in steps[0]}


def sweep_mesh(n=None):
    """The JAX package's 1-D ``sweep`` device mesh: multi-device work is not
    ported yet (ROADMAP queue 1, item 15)."""
    raise NotImplementedError(
        "sweep_mesh needs the multi-device layer, which is not ported yet "
        "(ROADMAP queue 1, item 15); dose_sweep runs the grid on one card")


def sharded_dose_sweep(mesh, arrays, meta: DectMeta, dose_scales, key, *,
                       noise="poisson"):
    """The JAX package's dose sweep sharded over a ``sweep`` mesh axis:
    multi-device work is not ported yet (ROADMAP queue 1, item 15)."""
    raise NotImplementedError(
        "sharded_dose_sweep needs the multi-device layer, which is not "
        "ported yet (ROADMAP queue 1, item 15); dose_sweep computes the same "
        "grid on one card")
