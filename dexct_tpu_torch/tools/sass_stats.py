"""Registers, instruction counts and loops of the port's kernels, read from
the SASS of the built kernel library.

    python dexct_tpu_torch/tools/sass_stats.py [--root DIR] [--dump FILE]
        NAME [NAME ...]

Run it by path, from the repository root.  Builds the kernel library of
the checkout at ``--root`` (default: the one holding this file) if it is
not built, and prints one JSON line per kernel whose mangled name contains
one of the NAMEs: its registers and memory from ``cuobjdump -res-usage``,
its instructions by opcode, and each of its loops (a branch back to an
earlier address) with the instructions it spans, its loads and its float
and integer multiply operations by opcode.  ``--dump`` writes those
kernels' SASS to FILE.  Needs the CUDA toolkit (``cuobjdump``), not a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parents[2]
_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_WATCH = ("FFMA", "FMUL", "FADD", "MUFU", "F2I", "I2F", "IMAD", "F2F",
          "DFMA", "DMUL", "DADD", "HFMA2")


def _opcode(ins):
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def loops(lines):
    """The loops of one function's SASS listing: for each branch back to
    an earlier address, its span, its loads and watched operations by
    opcode."""
    code = []
    for line in lines:
        m = _ADDR.search(line)
        if m:
            code.append((int(m.group(1), 16), m.group(2)))
    out = []
    for at, ins in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not (m and int(m.group(1), 16) < at):
            continue
        lo = int(m.group(1), 16)
        ops = collections.Counter(_opcode(i) for a, i in code if lo <= a <= at)
        out.append({
            "from": hex(lo), "to": hex(at), "instructions": sum(ops.values()),
            "loads": {op: n for op, n in ops.items() if op.startswith("LD")},
            "ops": {op: n for op, n in ops.items()
                    if op.split(".")[0] in _WATCH}})
    return out


def kernel_stats(lib, names, dump=None):
    """{mangled name: stats} of the kernels in the shared library ``lib``
    whose names contain one of ``names``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout.splitlines()
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout.splitlines()

    def wanted(name):
        return any(n in name for n in names)

    stats = collections.defaultdict(dict)
    for i, line in enumerate(res):
        if "Function" in line and wanted(line) and i + 1 < len(res):
            name = line.split("Function")[1].strip(" :")
            stats[name]["resources"] = res[i + 1].strip()
    funcs, cur = {}, None
    for line in sass:
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    fh = open(dump, "w") if dump else None
    try:
        for name, body in funcs.items():
            if not wanted(name):
                continue
            ops = collections.Counter(
                _opcode(m.group(2)) for m in map(_ADDR.search, body) if m)
            stats[name].update(instructions=sum(ops.values()),
                               ops=dict(ops.most_common()),
                               loops=loops(body))
            if fh:
                fh.write(f"# {name}\n" + "\n".join(body) + "\n\n")
    finally:
        if fh:
            fh.close()
    return dict(stats)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("names", nargs="+",
                        help="substrings of the kernels' mangled names")
    parser.add_argument("--root", type=Path, default=_HERE,
                        help="the checkout whose kernel library to read")
    parser.add_argument("--dump", type=Path, default=None,
                        help="write the kernels' SASS here")
    args = parser.parse_args(argv)
    root = args.root.resolve()
    dump = None if args.dump is None else args.dump.resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    from dexct_tpu_torch.utils import kernels

    for name, st in kernel_stats(kernels.build(), args.names, dump).items():
        print(json.dumps({"probe": "sass", "kernel": name, **st}))


if __name__ == "__main__":
    main()
