"""The gather-rate probe's kernels K38 and K39 (their plain twin on the
CPU) against what the JAX tool's two Pallas bodies compute,
``tab_ref[idx_ref[:]]`` and ``jnp.take(tab_ref[:], idx_ref[:])``
(tools/bench_gather.py:98-99, :113-114; the Pallas functions are local to
its ``main()``), bit for bit: on the tool's 800-entry float32 table, the
512^2 int32 label table and a table at K38's shared-memory limit.  Both
wrappers refuse other table types, non-int32 indices, and K38 a table
above ``MAX_VMEM_WORDS``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dexct_tpu_torch.tools import bench_gather as bg

CASES = {"tab800_f32": (800, np.float32), "labels512sq_i32": (512 * 512,
                                                              np.int32),
         "smem_limit_f32": (bg.MAX_VMEM_WORDS, np.float32)}


def _case(name, n=1 << 14, seed=0):
    n_tab, dtype = CASES[name]
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        tab = rng.integers(0, 6, n_tab).astype(np.int32)
    else:
        tab = rng.standard_normal(n_tab).astype(np.float32)
    idx = rng.integers(0, n_tab, n).astype(np.int32)
    idx[:2] = [0, n_tab - 1]  # both ends of the table
    return tab, idx


# K38 takes the tables within its shared-memory limit (the label table's
# refusal is test_vmem_table_limit)
PAIRS = [(name, fn) for name in CASES
         for fn in ("gather_plain", "gather_vmem", "gather_take")
         if not (fn == "gather_vmem" and CASES[name][0] > bg.MAX_VMEM_WORDS)]


@pytest.mark.parametrize("name,fn", PAIRS)
def test_gather_matches_jax_bit_for_bit(name, fn):
    tab, idx = _case(name)
    got = getattr(bg, fn)(torch.as_tensor(tab), torch.as_tensor(idx))
    assert got.dtype == torch.as_tensor(tab).dtype
    want_index = np.asarray(jnp.asarray(tab)[jnp.asarray(idx)])
    want_take = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want_index.view(np.uint32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want_take.view(np.uint32))


def test_vmem_table_limit():
    tab = torch.zeros(bg.MAX_VMEM_WORDS + 1)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="MAX_VMEM_WORDS"):
        bg.gather_vmem(tab, idx)
    assert bg.gather_take(tab, idx).shape == (4,)


@pytest.mark.parametrize("tab,idx", [
    (torch.zeros(8, dtype=torch.float64), torch.zeros(2, dtype=torch.int32)),
    (torch.zeros((2, 4)), torch.zeros(2, dtype=torch.int32)),
    (torch.zeros(8), torch.zeros(2, dtype=torch.int64))])
def test_gather_refuses_other_types(tab, idx):
    for fn in (bg.gather_vmem, bg.gather_take):
        with pytest.raises(ValueError):
            fn(tab, idx)
