"""Instructions of the tensor-copy route's row reductions in K1's SASS.

Builds ``csrc/risi18_level.cu`` (K1) of a checkout with
``-DRISI18_SASS_MARK`` into a cubin under that checkout's
``build/sass_mark/``, lists it with ``cuobjdump -sass`` and, in K1's cluster
kernel on the tensor-copy route (``risi18_level_cluster_kernel<E, true,
true>``: the products on the tensor cores), counts the instructions between
each pair of marks that ``SASS_MARK()`` leaves there (a ``NANOSLEEP``
where a consumer's row reduction starts and one where its sum over the
lanes, ``reduce_over_columns``, starts): the instructions of a row's cells,
as laid out, every branch counted once, with the opcodes that make them
up.  A checkout whose sources have no ``SASS_MARK`` (one from before the
producer route) gets the same two marks in a copy of its
``risi18_level_common.cuh``, around the cells of ``tile_reductions``'
``reduce_row``, the one reduction its tensor-copy stream calls.  The marks
are ``asm volatile`` with a memory clobber, so the compiler keeps the
shared-memory accesses on their side; the counts are a layout's, not an
execution's.

Usage: python -m graphflow_tpu_torch.tools.sass_count [--root DIR]
[--dtype float32|bfloat16].  Needs nvcc and cuobjdump, not a card.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
from pathlib import Path

from graphflow_tpu_torch.runtime import cuda_build

MARK = 'asm volatile("nanosleep.u32 0;\\n" ::: "memory");'
# Where a checkout without SASS_MARK gets its marks: the first line of
# tile_reductions' reduce_row after its head, and its sum over the lanes.
OLD_ROW_START = ("    const bool row = b0 == x0, "
                 "whole = a >= x0 && a < x0 + nx;\n")
OLD_ROW_SUMS = "    const float z = reduce_over_columns(ts, ws, h, quads);\n"
# An instruction of cuobjdump's listing, its predicate dropped: the opcode.
INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def marked_sources(root: Path) -> Path:
    """A copy of ``root``'s kernel sources with the marks in place."""
    src = root / "graphflow_tpu_torch" / "ops" / "csrc"
    dst = root / "build" / "sass_mark" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    common = dst / "risi18_level_common.cuh"
    text = common.read_text()
    if "SASS_MARK" not in text:
        start = text.index("  auto reduce_row = [&]")
        head = text.index(OLD_ROW_START, start)
        sums = text.index(OLD_ROW_SUMS, head)
        text = (text[:sums] + "    " + MARK + "\n" + text[sums:])
        text = (text[:head + len(OLD_ROW_START)] + "    " + MARK + "\n"
                + text[head + len(OLD_ROW_START):])
        common.write_text(text)
    return dst


def sass(root: Path) -> str:
    csrc = marked_sources(root)
    cubin = csrc.parent / "risi18_level.cubin"
    subprocess.run([cuda_build.find_nvcc(), "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-DRISI18_SASS_MARK", "-o", str(cubin),
                    str(csrc / "risi18_level.cu")], check=True)
    cuobjdump = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout


def kernel_listing(listing: str, dtype: str) -> tuple:
    """(name, opcodes in layout order) of K1's cluster kernel on the
    tensor-copy route with the products on the tensor cores."""
    elem = "f" if dtype == "float32" else "13__nv_bfloat16"
    want = f"risi18_level_cluster_kernelI{elem}Lb1ELb1E"
    name, ops = None, []
    for line in listing.splitlines():
        if "Function :" in line:
            if name is not None:
                break
            if want in line:
                name = line.split("Function :")[1].strip()
            continue
        if name is not None:
            m = INSTRUCTION.search(line)
            if m:
                ops.append(m.group(1))
    if name is None:
        raise RuntimeError(f"no kernel {want} in the listing")
    return name, ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    name, ops = kernel_listing(sass(Path(args.root).resolve()), args.dtype)
    marks = [i for i, op in enumerate(ops) if op.startswith("NANOSLEEP")]
    print(f"{args.root} {args.dtype}: {name[:60]}...: {len(ops)} "
          f"instructions, {len(marks)} marks")
    for k in range(0, len(marks) - 1, 2):
        region = ops[marks[k] + 1:marks[k + 1]]
        kinds = collections.Counter(op.split(".")[0] for op in region)
        print(f"  cells of row reduction {k // 2}: {len(region)} "
              f"instructions: " + ", ".join(
                  f"{op} {n}" for op, n in kinds.most_common(12)))


if __name__ == "__main__":
    main()
