"""Where one block of the level and bank kernels spends its cycles.

Builds ``csrc/risi18_level.cu`` (K1), ``csrc/risi18_level_bwd.cu`` (K2
kernel 1), ``csrc/risi18_bank.cu`` (K4) and ``csrc/risi18_bank_bwd.cu`` (K5
kernel 1) with ``-DRISI18_STAGE_CLOCK`` into ``build/kernels/*_clock.so``,
launches each on seeded inputs at one level shape (the bank on the
take-gather's T of the same level), and prints the cycles that block
(0, 0, 0) spent between the kernels' ``STAGE`` marks (its first thread
reads ``clock64()`` behind a barrier at each mark), per dtype, with each
stage's share.  The marks add a barrier each, so the sums run a few per
cent above an unmarked launch; the shares are what the tool is for.  A
forward block (K1, K4) is one vertex; a backward block (K2, K5) is the
vertices of one vertex group for one channel chunk (two at N=256).  K4 and
K5 run K1's and K2's blocks on slots streamed from T, so their stages are
K1's and K2's, named for what the bank does there.  On a row-tiled plan
(a field one block does not hold, e.g. P = 64) it prints the stages of the
block's stream (a ring buffer's pieces of a few rows) and thread 0's
cycles a stage: waiting for the copies and the block, issuing the next
copies, reducing the stage.  K1 and K2 run such a field on cluster plans
(a vertex's row tiles over a cluster of blocks), whose marks it prints as
well: block (0, 0, 0) is rank 0 of the first cluster, and its marks split
its own tiles into the stream, the products and the rest, and name the
cycles it waits at the cluster's meetings.  K4 and K5 keep one block a
vertex on such a field and have no marks there.

Usage: python -m graphflow_tpu_torch.tools.stage_clock [N] [P] [C] [Cout]
(defaults 256 16 32 32).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from graphflow_tpu_torch.runtime import cuda_build
from graphflow_tpu_torch.utils.datasets import random_level_case

FORWARD_STAGES = ("set-up", "first copies", "K staging", "stream",
                  "U and s", "products", "epilogue")
BACKWARD_STAGES = ("set-up, K staging", "geff", "structure",
                   "first copies, GAp, GR", "stream", "dK", "cotangents",
                   "scatter", "partial row")
BANK_STAGES = ("set-up (adjacency)", "first copies", "K staging",
               "stream from T", "U and s", "products", "epilogue")
BANK_BACKWARD_STAGES = ("set-up, K staging", "G = g", "adjacency",
                        "first copies, GAp, GR", "stream from T", "dK",
                        "cotangents", "dT written", "partial row")
# The cluster plans' marks (csrc/risi18_forward_block.cuh:
# forward_block_cluster, csrc/risi18_backward_block.cuh:
# backward_block_cluster).
CLUSTER_STAGES = ("set-up", "K staging and the tiles' stream",
                  "U, the part of s and the products", "pre-activations",
                  "the cluster's exchange of s (meetings)", "epilogue")
CLUSTER_BACKWARD_STAGES = (
    "set-up, K staging", "structure, geff's sums, GA's exchange (meetings)",
    "the tiles' stream and G", "dK of the tiles",
    "the scalars' cotangents, G and B maps of rows b",
    "the partial row's exchange (meetings)", "G of rows a",
    "GAp and GR of rows a", "A maps", "scatter")
ROUNDS = 3


def build(name: str) -> ctypes.CDLL:
    """``lib<name>_clock.so``: the kernel with its stage clock compiled in."""
    return ctypes.CDLL(str(cuda_build.build_library(
        name, flags=("-DRISI18_STAGE_CLOCK",), suffix="_clock").path))


# stage_cycles[10..13] of a row-tiled block (csrc/risi18_level_common.cuh:
# stream_pieces): thread 0's cycles per stage (a ring buffer's pieces)
# waiting for its copies and the block, issuing the next stage's copies,
# reducing the stage; the stages.
PIECE_STAGES = ("wait and barrier", "issuing copies", "reducing")
PIECE_SLOT = 10


def report(what, stages, read_cycles, cluster_stages=None):
    cycles = (ctypes.c_longlong * 16)()
    err = read_cycles(cycles)
    if err != 0:
        raise RuntimeError(f"{what}: reading the stage clock failed ({err})")
    pieces = cycles[PIECE_SLOT + len(PIECE_STAGES)]
    if pieces:
        print(f"{what}: row tiles, {pieces} stages in block (0, 0, 0), "
              f"cycles a stage of its thread 0: " + ", ".join(
                  f"{name} {cycles[PIECE_SLOT + i] / pieces:.0f}"
                  for i, name in enumerate(PIECE_STAGES)))
        if cluster_stages is None or not any(cycles[:len(cluster_stages)]):
            return      # one block a vertex (K4, K5): no marks there
        stages = cluster_stages
    total = sum(cycles[:len(stages)])
    print(f"{what}: {total} cycles in block (0, 0, 0): " + ", ".join(
        f"{name} {cycles[i]} ({100 * cycles[i] / max(total, 1):.0f} %)"
        for i, name in enumerate(stages)))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    N, P, C, Cout = [int(a) for a in argv] + [256, 16, 32, 32][len(argv):]
    if not torch.cuda.is_available():
        raise RuntimeError("stage_clock runs CUDA kernels: no CUDA device "
                           "is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2_reference)

    fwd, bwd = build("risi18_level"), build("risi18_level_bwd")
    bank, bank_bwd = build("risi18_bank"), build("risi18_bank_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    d = random_level_case(N, P, C, Cout, seed=0)
    f32 = {k: torch.as_tensor(d[k], dtype=torch.float32, device="cuda")
           for k in ("state", "radj", "K", "b")}
    nbr, pos = (torch.as_tensor(d[k], dtype=torch.int32, device="cuda")
                for k in ("nbr", "pos"))
    g32 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(N, P * P, Cout)), dtype=torch.float32, device="cuda")
    groups = bwd.risi18_level_backward_blocks(N)
    stream = torch.cuda.current_stream().cuda_stream
    for suffix, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        state, K, b, g = (t.to(dtype) for t in (f32["state"], f32["K"],
                                                f32["b"], g32))
        out = torch.empty((N, P * P, Cout), dtype=dtype, device="cuda")
        dstate = torch.zeros(state.shape, dtype=torch.float32, device="cuda")
        partial = torch.empty((groups, 18 * C * Cout + Cout),
                              dtype=torch.float32, device="cuda")
        forward = getattr(fwd, f"risi18_level_forward_{suffix}")
        forward.argtypes = [ptr] * 8 + [i32] * 4 + [ctypes.c_float, ptr]
        # A cluster plan's float32 pre-activations: out itself in float32.
        pre = (out if dtype == torch.float32 else
               torch.empty(out.shape, dtype=torch.float32, device="cuda"))
        backward = getattr(bwd, f"risi18_level_backward_{suffix}")
        backward.argtypes = [ptr] * 9 + [i32] * 4 + [ctypes.c_float, i32, ptr]
        shape = f"(N,P,C,Cout)=({N},{P},{C},{Cout}) {suffix}"
        for _ in range(ROUNDS):
            err = forward(state.data_ptr(), nbr.data_ptr(), pos.data_ptr(),
                          f32["radj"].data_ptr(), K.data_ptr(), b.data_ptr(),
                          out.data_ptr(), pre.data_ptr(), N, P, C, Cout,
                          0.01, stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_level launch failed ({err})")
            report(f"K1 {shape}", FORWARD_STAGES,
                   fwd.risi18_level_stage_cycles, CLUSTER_STAGES)
        for _ in range(ROUNDS):
            err = backward(state.data_ptr(), nbr.data_ptr(), pos.data_ptr(),
                           f32["radj"].data_ptr(), K.data_ptr(), g.data_ptr(),
                           out.data_ptr(), dstate.data_ptr(),
                           partial.data_ptr(), N, P, C, Cout, 0.01, groups,
                           stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_level_backward launch failed "
                                   f"({err})")
            report(f"K2 kernel 1 {shape}", BACKWARD_STAGES,
                   bwd.risi18_level_backward_stage_cycles,
                   CLUSTER_BACKWARD_STAGES)
        T = risi18_aligned_t2_reference(state, nbr, pos).contiguous()
        Z = torch.empty((N, P, P, Cout), dtype=dtype, device="cuda")
        dT = torch.empty_like(T)
        bank_partial = torch.empty((groups, 18 * C * Cout),
                                   dtype=torch.float32, device="cuda")
        bank_forward = getattr(bank, f"risi18_bank_forward_{suffix}")
        bank_forward.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        bank_backward = getattr(bank_bwd, f"risi18_bank_backward_{suffix}")
        bank_backward.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        for _ in range(ROUNDS):
            err = bank_forward(T.data_ptr(), f32["radj"].data_ptr(),
                               K.data_ptr(), Z.data_ptr(), N, P, C, Cout,
                               stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_bank launch failed ({err})")
            report(f"K4 {shape}", BANK_STAGES,
                   bank.risi18_bank_stage_cycles)
        for _ in range(ROUNDS):
            err = bank_backward(T.data_ptr(), f32["radj"].data_ptr(),
                                K.data_ptr(), g.data_ptr(), dT.data_ptr(),
                                bank_partial.data_ptr(), N, P, C, Cout,
                                groups, stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_bank_backward launch failed "
                                   f"({err})")
            report(f"K5 kernel 1 {shape}", BANK_BACKWARD_STAGES,
                   bank_bwd.risi18_bank_backward_stage_cycles)


if __name__ == "__main__":
    main()
