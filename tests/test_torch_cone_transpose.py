"""K19's table, the exact 3-D walk transposed, built by the plain builder
on the CPU (``cone_transpose`` on CPU tensors; the card's kernels are held
to it field for field in tests/test_torch_cuda.py).

Checks, on the iterative tests' cone geometry (48 x 4 x 32 rays through 4
x 24 x 24 cells of 1 cm, at both walk lengths of
test_torch_iterative.py's test_adjoint_matches_jax_linear_transpose) and
on rays that cross cell corners and run along grid lines (whose ties give
zero-length segments):

- each cell's run lies in (step, ray) order, the order in which the plain
  adjoint's ``index_add_`` adds it;
- the runs and their entries equal a NumPy count of the walk's nonzero
  segments, and the padding slots hold zeros;
- the gather in table order equals ``project_volume_3d_adjoint_plain`` bit
  for bit;
- split into blocks of views under a small table budget, the blocks cover
  the views in order and the gather stays within 1e-5 of the largest value
  of the plain adjoint (the blocks' sums are added in view order, not step
  by step);
- a view whose walk alone does not fit the budget is refused.
"""

import numpy as np
import pytest
import torch

from dexct_tpu_torch.ops import conebeam as cb
from dexct_tpu_torch.system import ConeBeamGeometry

# the plain gather over a split table against the plain adjoint: each
# block's sums are taken apart, then added in view order
SPLIT_TOL = 1e-5


def _case(name):
    """Rays [..., 3] (float32), the grid and its cells."""
    if name == "cone":
        ct = ConeBeamGeometry(N_channels=32, N_proj=48, N_rows=4,
                              gamma_fan=0.8230337, SID=60.0, SDD=100.0,
                              h_iso=0.5)
        src, dirs = (torch.as_tensor(x, dtype=torch.float32)
                     for x in ct.ray_geometry_3d())
        return src, dirs, (4, 24, 24), (1.0, 1.0, 1.0)
    # rays through cell corners (ties of two or three crossings) and along
    # grid lines, and random ones, through a 5 x 8 x 6 grid of 0.5 cm
    rng = np.random.default_rng(41)
    src = rng.uniform(-6.0, 6.0, (60, 3))
    src[:, 0] = -6.0
    dirs = rng.normal(size=(60, 3))
    dirs[:, 0] = np.abs(dirs[:, 0]) + 0.5
    src[:6] = [[-6.0, -6.0, 0.0], [-6.0, -6.0, -6.0], [-6.0, 0.5, 0.25],
               [-6.0, 0.0, 0.0], [-6.0, 1.0, -6.0], [-6.0, -5.0, 0.5]]
    dirs[:6] = [[1.0, 1.0, 0.0], [1.0, 1.0, 1.0], [1.0, 0.0, 0.0],
                [1.0, 0.0, 0.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (torch.as_tensor(src, dtype=torch.float32),
            torch.as_tensor(dirs, dtype=torch.float32), (5, 8, 6),
            (0.5, 0.5, 0.5))


def _walk(src, dirs, shape, vox, n_steps):
    """The walk's nonzero entries as NumPy (cell, step, ray, seg)."""
    p, d = src.reshape(-1, 3), dirs.reshape(-1, 3)
    k = cb._max_steps(shape) if n_steps is None else n_steps
    out = []
    for step, (lin, seg) in enumerate(cb._walk_3d(shape, p, d, *vox, k)):
        ray = np.nonzero(seg.numpy() != 0)[0]
        out.append((lin.numpy()[ray], np.full(ray.size, step), ray,
                    seg.numpy()[ray]))
    return tuple(np.concatenate(a) for a in zip(*out))


def _runs(table):
    """Per cell of the one-block table: its rays and segments in slot
    order."""
    (b,) = table.blocks
    length, offset = b.length.numpy(), b.offset.numpy()
    ray = b.entries[:, 0].numpy()
    seg = b.entries[:, 1].view(torch.float32).numpy()
    for c in range(int(np.prod(table.vol_shape))):
        at = offset[c // 32] + c % 32 + 32 * np.arange(length[c])
        yield c, ray[at], seg[at]


CASES = [("cone", None), ("cone", 20), ("corners", None), ("corners", 7)]


@pytest.mark.parametrize("name,n_steps", CASES)
def test_runs_are_in_step_then_ray_order(name, n_steps):
    src, dirs, shape, vox = _case(name)
    table = cb.cone_transpose(src, dirs, shape, *vox, n_steps=n_steps)
    cell, step, ray, seg = _walk(src, dirs, shape, vox, n_steps)
    # (a ray can cross a cell twice, where the walk's last steps round)
    order = np.lexsort((ray, step, cell))
    runs = list(_runs(table))
    np.testing.assert_array_equal(np.concatenate([r for _, r, _ in runs]),
                                  ray[order])
    np.testing.assert_array_equal(np.concatenate([s for _, _, s in runs]),
                                  seg[order])
    assert table.nnz == cell.size > 0


@pytest.mark.parametrize("name,n_steps", CASES)
def test_entries_are_a_numpy_count_of_the_walk(name, n_steps):
    src, dirs, shape, vox = _case(name)
    table = cb.cone_transpose(src, dirs, shape, *vox, n_steps=n_steps)
    cell, _, ray, seg = _walk(src, dirs, shape, vox, n_steps)
    n_cells = int(np.prod(shape))
    (b,) = table.blocks
    count = np.bincount(cell, minlength=n_cells)
    np.testing.assert_array_equal(b.length.numpy()[:n_cells], count)
    assert not b.length.numpy()[n_cells:].any()
    longest = np.pad(b.length.numpy(), (0, -b.length.numel() % 32))
    longest = longest.reshape(-1, 32).max(1)
    np.testing.assert_array_equal(np.diff(b.offset.numpy()), 32 * longest)
    got = sorted((c, int(r), float(s)) for c, rays, segs in _runs(table)
                 for r, s in zip(rays, segs))
    want = sorted(zip(cell.tolist(), ray.tolist(), seg.tolist()))
    assert got == want
    used = np.zeros(table.slots, bool)
    for c, _, _ in _runs(table):
        used[int(b.offset[c // 32]) + c % 32 + 32 * np.arange(count[c])] = True
    assert not b.entries.numpy()[~used].any()
    if name == "corners":
        # the ties give zero-length segments between a ray's nonzero ones,
        # which the table leaves out
        k = cb._max_steps(shape) if n_steps is None else n_steps
        segs = np.stack([s.numpy() for _, s in cb._walk_3d(
            shape, src.reshape(-1, 3), dirs.reshape(-1, 3), *vox, k)])
        inside = [np.nonzero(segs[:, r])[0] for r in range(segs.shape[1])]
        assert any(nz.size and nz[-1] - nz[0] + 1 > nz.size
                   for nz in inside)


@pytest.mark.parametrize("name,n_steps", CASES)
def test_gather_in_table_order_is_the_plain_adjoint(name, n_steps):
    src, dirs, shape, vox = _case(name)
    rng = np.random.default_rng(42)
    y = torch.as_tensor(rng.normal(size=src.shape[:-1]), dtype=torch.float32)
    table = cb.cone_transpose(src, dirs, shape, *vox, n_steps=n_steps)
    got = cb._adjoint_gather_plain(y, table)
    want = cb.project_volume_3d_adjoint_plain(y, src, dirs, shape, *vox,
                                              n_steps=n_steps)
    assert got.shape == want.shape == shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("budget", [120_000, 40_000])
def test_view_blocks_stay_within_tolerance(monkeypatch, budget):
    src, dirs, shape, vox = _case("cone")
    whole = cb.cone_transpose(src, dirs, shape, *vox)
    monkeypatch.setattr(cb, "_TABLE_BYTES", budget)
    table = cb.cone_transpose(src, dirs, shape, *vox)
    assert len(table.blocks) > 1
    assert all(b.entries.numel() * 4 <= budget for b in table.blocks)
    assert table.nnz == whole.nnz
    # the blocks cover the views in order
    per = src[0].numel() // 3
    rays = [b.entries[b.entries[:, 1] != 0, 0] for b in table.blocks]
    first = [int(r.min()) // per for r in rays]
    last = [int(r.max()) // per for r in rays]
    assert first[0] == 0 and last[-1] == src.shape[0] - 1
    assert all(a < b for a, b in zip(last, first[1:]))
    rng = np.random.default_rng(43)
    y = torch.as_tensor(rng.normal(size=src.shape[:-1]), dtype=torch.float32)
    got = cb._adjoint_gather_plain(y, table)
    want = cb.project_volume_3d_adjoint_plain(y, src, dirs, shape, *vox)
    assert float((got - want).abs().max()) <= SPLIT_TOL * float(
        want.abs().max())


def test_a_view_that_cannot_fit_is_refused(monkeypatch):
    src, dirs, shape, vox = _case("cone")
    monkeypatch.setattr(cb, "_TABLE_BYTES", 1_000)
    with pytest.raises(ValueError, match="one view"):
        cb.cone_transpose(src, dirs, shape, *vox)
