"""The gather-rate probe on the card: port of the JAX package's
``tools/bench_gather.py``.

    python -m dexct_tpu_torch.tools.bench_gather [--n-log2 24] [--reps 20]

Times the gather and interpolation patterns of the projector and
backprojector inner loops on one CUDA device and prints, after the card's
name and power limit, one line per probe with its time (ms, CUDA events,
the mean of ``--reps`` calls after a warm-up) and its rate (GB/s: each
input read once and the output written once, over the time).  The two
probes that the JAX tool wrote in Pallas are kernels here:

- :func:`gather_vmem` (K38, ``csrc/gather_probe.cu``): each block stages
  the table in shared memory, the analogue of the Pallas probe's VMEM
  table (``pallas_gather``); tables of at most :data:`MAX_VMEM_WORDS`
  words (48 KB);
- :func:`gather_take` (K39): a direct read-only gather from device memory,
  the analogue of ``pallas_take``'s ``jnp.take``; any table size.

Both compute ``out[i] = tab[idx[i]]`` on a float32 or int32 table with
int32 indices, which must lie in ``[0, len(tab))`` (the probe draws them
so; the kernels do not check).  On CPU tensors both run their plain twin
:func:`gather_plain` (``tab[idx]``).  The other probes are plain PyTorch:
flat indexing, ``torch.gather`` over a [64, 800] table, two-tap linear
interpolation, the 512^2 label gather, the bf16 one-hot product and the
dense window (T-matrix) matvecs.  :func:`main` runs on the card only.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..utils import kernels

__all__ = ["gather_vmem", "gather_take", "gather_plain", "MAX_VMEM_WORDS",
           "main"]

# K38's table limit: 48 KB of shared memory in 32-bit words
MAX_VMEM_WORDS = 48 * 1024 // 4
_TABLE_DTYPES = (torch.float32, torch.int32)


def gather_plain(tab, idx):
    """``tab[idx]``: the plain twin of K38 and K39, on any device."""
    return tab[idx]


def _check(tab, idx, vmem):
    if tab.dim() != 1 or tab.dtype not in _TABLE_DTYPES:
        raise ValueError("the gather probe takes a 1-D float32 or int32 "
                         f"table, got {tab.dtype} {tuple(tab.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"the indices must be int32, got {idx.dtype}")
    if vmem and tab.numel() > MAX_VMEM_WORDS:
        raise ValueError(f"gather_vmem stages at most MAX_VMEM_WORDS = "
                         f"{MAX_VMEM_WORDS} table words (48 KB of shared "
                         f"memory), got {tab.numel()}")


def _gather_cuda(tab, idx, vmem):
    dev = tab.device
    kernels.require(tab, "tab", dev, tab.dtype)
    idx = kernels.require(idx.contiguous(), "idx", dev, torch.int32)
    out = torch.empty(idx.shape, dtype=tab.dtype, device=dev)
    lib = kernels.library()
    if vmem:
        rc = lib.dexct_gather_vmem(tab.data_ptr(), tab.numel(),
                                   idx.data_ptr(), out.data_ptr(),
                                   idx.numel(), kernels.stream_ptr(dev))
    else:
        rc = lib.dexct_gather_take(tab.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), idx.numel(),
                                   kernels.stream_ptr(dev))
    kernels.check(rc, "gather_vmem" if vmem else "gather_take")
    return out


def gather_vmem(tab, idx):
    """``out[i] = tab[idx[i]]`` through a table staged in shared memory.

    CUDA tensors run kernel K38 (counted in ``gather_vmem.launches``); CPU
    tensors run :func:`gather_plain`.  Tables above :data:`MAX_VMEM_WORDS`
    raise ``ValueError`` on both devices."""
    _check(tab, idx, True)
    if tab.is_cuda:
        out = _gather_cuda(tab, idx, True)
        gather_vmem.launches += 1
        return out
    if tab.device.type != "cpu":
        raise ValueError(f"unsupported device {tab.device}")
    return gather_plain(tab, idx)


gather_vmem.launches = 0


def gather_take(tab, idx):
    """``out[i] = tab[idx[i]]`` read straight from device memory.

    CUDA tensors run kernel K39 (counted in ``gather_take.launches``); CPU
    tensors run :func:`gather_plain`."""
    _check(tab, idx, False)
    if tab.is_cuda:
        out = _gather_cuda(tab, idx, False)
        gather_take.launches += 1
        return out
    if tab.device.type != "cpu":
        raise ValueError(f"unsupported device {tab.device}")
    return gather_plain(tab, idx)


gather_take.launches = 0


def _time_ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _probes(n, dev, gen):
    """(name, function, bytes moved) of every probe on ``n`` lookups."""

    def randint(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    table = torch.randn(800, generator=gen, device=dev)
    table2d = torch.randn((64, 800), generator=gen, device=dev)
    idx = randint(800, (n,))
    idx_1m = randint(800, (1 << 20,))
    idx2d = randint(800, (64, n // 64), torch.int64)
    fidx = torch.rand(n, generator=gen, device=dev) * 799.0
    labels = randint(6, (512 * 512,))
    bigidx = randint(512 * 512, (n,))
    onehot_idx = randint(800, (1 << 14, 64), torch.int64)
    q = torch.randn(320, generator=gen, device=dev)
    q64 = torch.randn((64, 320), generator=gen, device=dev)
    out_n = 4 * n  # a float32 or int32 output of n elements

    def lin_interp():
        c = torch.floor(fidx)
        i0 = torch.clamp(c, 0, 798).to(torch.int32)
        f = fidx - c
        return table[i0] * (1 - f) + table[i0 + 1] * f

    def onehot_mm():
        oh = torch.nn.functional.one_hot(onehot_idx, 800).to(torch.bfloat16)
        return torch.einsum("pbc,bc->pb", oh, table2d.to(torch.bfloat16))

    def t_matvec():
        xs = torch.arange(4096, device=dev, dtype=torch.float32)[:, None]
        ks = torch.arange(320, device=dev, dtype=torch.float32)[None, :]
        w = torch.clamp_min(1.0 - (xs * 0.07 - ks).abs(), 0.0)
        return w @ q

    def t_matvec_batch():
        xs = torch.arange(4096, device=dev, dtype=torch.float32)[None, :,
                                                                 None]
        ks = torch.arange(320, device=dev, dtype=torch.float32)[None, None]
        vv = torch.arange(64, device=dev, dtype=torch.float32)[:, None, None]
        w = torch.clamp_min(1.0 - (xs * 0.07 + vv * 0.01 - ks).abs(), 0.0)
        return torch.einsum("vpk,vk->vp", w, q64)

    return [
        ("flat_take (tab[idx])", lambda: gather_plain(table, idx),
         _nbytes(table, idx) + out_n),
        ("gather_vmem K38 (2^20)", lambda: gather_vmem(table, idx_1m),
         _nbytes(table, idx_1m) + 4 * idx_1m.numel()),
        ("gather_take K39 (2^20)", lambda: gather_take(table, idx_1m),
         _nbytes(table, idx_1m) + 4 * idx_1m.numel()),
        ("gather_vmem K38", lambda: gather_vmem(table, idx),
         _nbytes(table, idx) + out_n),
        ("gather_take K39", lambda: gather_take(table, idx),
         _nbytes(table, idx) + out_n),
        ("index_select", lambda: torch.index_select(table, 0, idx),
         _nbytes(table, idx) + out_n),
        ("torch.gather [64, 800]", lambda: torch.gather(table2d, 1, idx2d),
         _nbytes(table2d, idx2d) + out_n),
        ("lin_interp_2tap", lin_interp, _nbytes(table, fidx) + out_n),
        ("label_gather_512sq K39", lambda: gather_take(labels, bigidx),
         _nbytes(labels, bigidx) + out_n),
        ("label_gather_512sq tab[idx]",
         lambda: gather_plain(labels, bigidx),
         _nbytes(labels, bigidx) + out_n),
        ("onehot_matmul_bf16 [16k, 64, 800]", onehot_mm,
         _nbytes(onehot_idx) + 2 * table2d.numel() + 4 * (1 << 20)),
        ("Tmatvec_4096x320", t_matvec, _nbytes(q) + 4 * 4096),
        ("Tmatvec_batch64_4096x320", t_matvec_batch,
         _nbytes(q64) + 4 * 64 * 4096),
    ]


def _card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    """Run every probe on the card; print and return ``[{"probe", "ms",
    "gb_s"}, ...]``."""
    parser = argparse.ArgumentParser(
        description="Gather-rate probes on one CUDA device.")
    parser.add_argument("--n-log2", type=int, default=24,
                        help="log2 of the number of lookups (default 24)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather: needs a CUDA device")
    dev = torch.device("cuda")
    print(_card_line())
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    records = []
    for name, fn, n_bytes in _probes(1 << args.n_log2, dev, gen):
        ms = _time_ms(fn, args.reps)
        gb_s = n_bytes / (ms * 1e-3) / 1e9
        print(f"{name:36s} {ms:9.4f} ms {gb_s:9.1f} GB/s")
        records.append({"probe": name, "ms": ms, "gb_s": gb_s})
    return records


if __name__ == "__main__":
    main()
