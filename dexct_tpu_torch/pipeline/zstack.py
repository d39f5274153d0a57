"""Multi-slice (z-stack) batching of the fused DE pipeline.

Port of :mod:`dexct_tpu.pipeline.zstack`.  :func:`pack_zstack` packs every
requested slice of a voxel phantom: the arrays that are the same for every
slice (geometry, spectra, the Fourier plan, the rebin tables) are packed
once and shared, the labels (and, with noise, one seed per slice) are
stacked on a leading slice axis.  :func:`zstack_step` traces a chunk of
slices at once, then runs :func:`~dexct_tpu_torch.pipeline.fused.dect_step`
on each slice with its precomputed paths, so every stage after the trace is
the single-slice step's, the air mask against each slice's own maximum
included.

The trace of a chunk is one launch of kernel K17
(:func:`~dexct_tpu_torch.ops.siddon.trace_paths_stack`: one walk per ray
for all its slices) for ``projector='siddon'`` and ``'siddon_dominant'``,
and for ``'fourier'`` one pass of the Fourier projector over the one-hot
images of all its slices (K7 and K8 take the slices as a batch).  The JAX
package's ``trace_pairs`` and ``trace_bundle`` options choose TPU layouts
of the slice-paired trace; they are accepted and ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.fourier import fourier_paths_stack_from_arrays
from ..ops.siddon import labels_stack_tensor, trace_paths_stack
from .fused import dect_step, pack_dect

__all__ = ["pack_zstack", "zstack_step", "make_jitted_zstack_step",
           "stack_phantom", "slice_seed"]

# the JAX z-stack's options that choose TPU layouts of its paired trace
_TPU_LAYOUT_OPTIONS = ("trace_pairs", "trace_bundle")


def slice_seed(seed, z):
    """The noise seed of slice ``z`` of a stack scanned with ``seed``: a
    deterministic function of both, as the JAX package folds ``z`` into
    its key.  The draws differ from the JAX package's (another
    generator); their statistics agree."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(z)])
    return int(state.generate_state(1)[0])


def pack_zstack(ct, phantom, spec1, spec2, n_matrix, fov, ramp, *, device,
                z_indices=None, **pack_kw):
    """Lower an Nz-slice scan to ``(arrays, meta, in_axes)``.

    ``z_indices`` defaults to every slice of the phantom.  The arrays are
    :func:`~dexct_tpu_torch.pipeline.fused.pack_dect`'s, packed once, with
    ``labels`` [Nz, Ny, Nx] and, when ``noise`` is set, ``noise_seed``
    [Nz] (:func:`slice_seed`; one slice keeps ``seed``; a host tensor,
    since the seeds are read on the host) stacked;
    ``in_axes`` maps each key to 0 (stacked) or None (shared), the JAX
    package's split.
    """
    zs = (list(range(phantom.Nz)) if z_indices is None
          else [int(z) for z in z_indices])
    if not zs:
        raise ValueError("empty z_indices")
    for k in _TPU_LAYOUT_OPTIONS:
        pack_kw.pop(k, None)
    if pack_kw.get("projector") == "analytic":
        raise ValueError("the z-stack scans a voxel phantom's label slices; "
                         "projector='analytic' has none")
    arrays, meta = pack_dect(ct, dataclasses.replace(phantom, z_index=zs[0]),
                             spec1, spec2, n_matrix, fov, ramp,
                             device=device, **pack_kw)
    arrays["labels"] = labels_stack_tensor(
        np.stack([phantom.slice_labels(z) for z in zs]), device)
    in_axes = {k: None for k in arrays}
    in_axes["labels"] = 0
    if meta.noise != "none":
        seeds = ([slice_seed(meta.seed, z) for z in zs] if len(zs) > 1
                 else [meta.seed])
        arrays["noise_seed"] = torch.as_tensor(seeds, dtype=torch.int64)
        in_axes["noise_seed"] = 0
    return arrays, meta, in_axes


def stack_paths(arrays, labels, meta):
    """Material paths [Z, V, C, M] of a chunk of label slices [Z, Ny, Nx]
    through the meta's projector, all slices at once."""
    if meta.projector == "fourier":
        return fourier_paths_stack_from_arrays(arrays, labels, meta.fp_meta)
    if meta.projector not in ("siddon", "siddon_dominant"):
        raise ValueError(f"the z-stack does not run projector "
                         f"{meta.projector!r}")
    return trace_paths_stack(labels, arrays["src"], arrays["dirs"], meta.dx,
                             meta.dy, n_materials=meta.n_materials)


def zstack_step(arrays, meta, in_axes, z_chunk=None):
    """The fused DE step over the slice axis: a dict of the single-slice
    step's keys, each a pair of tensors with a leading Nz axis.

    ``z_chunk`` bounds the slices in flight: each chunk is traced at once
    and its slices then run one by one; it must divide Nz (``ValueError``
    otherwise).  None runs the whole stack as one chunk.
    """
    stacked = [k for k, ax in in_axes.items() if ax == 0]
    nz = int(arrays["labels"].shape[0])
    z_chunk = nz if z_chunk is None else int(z_chunk)
    if z_chunk < 1 or nz % z_chunk:
        raise ValueError(f"Nz={nz} not divisible by z_chunk={z_chunk}")
    shared = {k: v for k, v in arrays.items() if in_axes.get(k) is None}
    outs = []
    for c0 in range(0, nz, z_chunk):
        paths = stack_paths(shared, arrays["labels"][c0:c0 + z_chunk], meta)
        for j in range(z_chunk):
            a = dict(shared, **{k: arrays[k][c0 + j] for k in stacked})
            a["paths"] = paths[j]
            m = meta
            if "noise_seed" in a:
                m = meta._replace(seed=int(a.pop("noise_seed")))
            outs.append(dect_step(a, m))
        del paths
    return {k: tuple(torch.stack([o[k][i] for o in outs]) for i in range(2))
            for k in outs[0]}


def make_jitted_zstack_step(meta, in_axes, z_chunk=None):
    """:func:`zstack_step` closed over the meta, the axes and ``z_chunk``
    (the JAX package's name; PyTorch runs eagerly, so this is a plain
    callable of the arrays)."""
    axes = dict(in_axes)

    def step(arrays):
        return zstack_step(arrays, meta, axes, z_chunk)

    return step


def stack_phantom(phantom_2d_fn, Nz, *args, scales=None, name=None, **kw):
    """Build an Nz-deep voxel phantom from a 2-D generator by varying an
    anatomical scale per slice (host NumPy, as in the JAX package).

    phantom_2d_fn(*args, **kw) must return a single-slice VoxelPhantom;
    each slice is the base anatomy zoomed by ``scales[z]`` (default: a
    smooth 0.8..1.0 body profile) on the fixed voxel grid, zoomed-out
    regions filling with label 0 (air).
    """
    from ..system.phantom import VoxelPhantom

    if scales is None:
        scales = 0.8 + 0.2 * np.cos(
            np.linspace(-0.6 * np.pi, 0.6 * np.pi, Nz))
    base = phantom_2d_fn(*args, **kw)
    lab0 = np.asarray(base.slice_labels())
    ny, nx = lab0.shape
    slices = []
    for s in np.asarray(scales, np.float64):
        # nearest-neighbor zoom about the grid center; out of range -> air
        iy = np.rint((np.arange(ny) - (ny - 1) / 2.0) / s
                     + (ny - 1) / 2.0).astype(np.int64)
        ix = np.rint((np.arange(nx) - (nx - 1) / 2.0) / s
                     + (nx - 1) / 2.0).astype(np.int64)
        oky = (iy >= 0) & (iy < ny)
        okx = (ix >= 0) & (ix < nx)
        sl = np.zeros_like(lab0)
        sub = lab0[np.clip(iy, 0, ny - 1)[:, None],
                   np.clip(ix, 0, nx - 1)[None, :]]
        sl[np.ix_(oky, okx)] = sub[np.ix_(oky, okx)]
        slices.append(sl)
    labels = np.stack(slices)
    return VoxelPhantom(name or base.name + f"_z{Nz}", labels,
                        base.materials, base.dx, base.dy, base.dz)
