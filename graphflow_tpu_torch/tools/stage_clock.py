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
cycles a stage: waiting for the copies (and, one block a vertex, the
block), issuing the next copies, reducing the stage.  K1's and K2's lines
name the stream's route from their plans: ``tma_producer`` or ``cp_async``
(every lane issues its cells' copies).  On ``tma_producer`` thread 0 is a
consumer, which issues no copy: its line gives its cycles a stage waiting
on the ring buffer's full mbarrier, issuing (none), reducing and arriving
on the empty mbarrier; a line of its own gives the producer's (lane 0 of
the last warp, which issues every row's tensor copy) cycles a stage
waiting on the empty mbarrier and issuing the stage's copies.  K1 and K2
run such a field on cluster plans
(a vertex's row tiles over a cluster of blocks), whose marks it prints as
well: block (0, 0, 0) is rank 0 of the first cluster, and its marks split
its own tiles into the stream, the products and the rest, and name the
cycles it waits at the cluster's meetings.  K4 and K5 kernel 1 run the
same cluster blocks on T there, with the same marks (K2's names: for K5
the structure is the adjacency, geff is g itself and the scatter writes
dT).  On a cluster plan kernel 0 (GAp and the row sums of G once a
vertex) runs before kernel 1, unclocked; the cluster plans' dT phase is
one pass a row tile, the next tile's maps formed on the tensor cores while
this tile's dT is scattered (K5: written), one mark for the whole phase.

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
    "set-up, K staging", "structure, GA and db's sums",
    "the tiles' stream and G", "dK of the tiles", "the scalars' cotangents",
    "the partial row's exchange (meetings)",
    "dT: the tiles' maps (tensor cores) and scatter")
ROUNDS = 3


def build(name: str) -> ctypes.CDLL:
    """``lib<name>_clock.so``: the kernel with its stage clock compiled in."""
    return ctypes.CDLL(str(cuda_build.build_library(
        name, flags=("-DRISI18_STAGE_CLOCK",), suffix="_clock").path))


# stage_cycles[10..13] of a row-tiled block (csrc/risi18_level_common.cuh:
# stream_pieces, stream_rows, stream_rows_producer): thread 0's cycles per
# stage (a ring buffer's pieces) waiting for its copies (stream_pieces: and
# the block; stream_rows_producer: on the full mbarrier), issuing the next
# stage's copies, reducing the stage; the stages.  [14]: on the tensor-copy
# route, thread 0's cycles arriving on the empty mbarrier; [15..17] the
# producer's cycles waiting on the empty mbarrier and issuing the copies,
# and its stages.
PIECE_STAGES = ("wait", "issuing copies", "reducing")
PIECE_SLOT = 10
RELEASE_SLOT = 14
PRODUCER_STAGES = ("waiting on empty", "issuing copies")
PRODUCER_SLOT = 15
SLOTS = 24     # csrc/risi18_level_common.cuh: stage_cycles


def report(what, stages, read_cycles, cluster_stages=None):
    cycles = (ctypes.c_longlong * SLOTS)()
    err = read_cycles(cycles)
    if err != 0:
        raise RuntimeError(f"{what}: reading the stage clock failed ({err})")
    pieces = cycles[PIECE_SLOT + len(PIECE_STAGES)]
    produced = cycles[PRODUCER_SLOT + len(PRODUCER_STAGES)]
    if pieces:
        names = PIECE_STAGES + (("arriving on empty",) if produced else ())
        slots = [PIECE_SLOT + i for i in range(len(PIECE_STAGES))]
        print(f"{what}: row tiles, {pieces} stages in block (0, 0, 0), "
              f"cycles a stage of its thread 0"
              + (" (a consumer)" if produced else "") + ": " + ", ".join(
                  f"{name} {cycles[i] / pieces:.0f}" for name, i in
                  zip(names, slots + [RELEASE_SLOT])))
    if produced:
        print(f"{what}: the producer warp, {produced} stages in block "
              f"(0, 0, 0), cycles a stage of its lane 0: " + ", ".join(
                  f"{name} {cycles[PRODUCER_SLOT + i] / produced:.0f}"
                  for i, name in enumerate(PRODUCER_STAGES)))
    if pieces:
        if cluster_stages is None or not any(cycles[:len(cluster_stages)]):
            return      # one block a vertex: no marks there
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
    from graphflow_tpu_torch.ops.risi_level import _bind_plan, query_plan

    _bind_plan(fwd.risi18_level_plan)
    _bind_plan(bwd.risi18_level_backward_plan)
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
        backward.argtypes = [ptr] * 11 + [i32] * 4 + [ctypes.c_float, i32,
                                                      ptr]
        # Kernel 0's scratch, filled before kernel 1 on a cluster plan.
        gap = torch.empty((N, P, P, Cout), dtype=torch.float32,
                          device="cuda")
        sums = torch.empty((N, 3, P, Cout), dtype=torch.float32,
                           device="cuda")
        level_sums = getattr(bwd, f"risi18_level_backward_sums_{suffix}")
        level_sums.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_float, ptr]
        bank_sums = getattr(bank_bwd, f"risi18_bank_backward_sums_{suffix}")
        bank_sums.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        shape = f"(N,P,C,Cout)=({N},{P},{C},{Cout}) {suffix}"
        routes = [query_plan(fn, N, P, C, Cout, dtype, backward=b)["stream"]
                  for fn, b in ((fwd.risi18_level_plan, False),
                                (bwd.risi18_level_backward_plan, True))]
        for _ in range(ROUNDS):
            err = forward(state.data_ptr(), nbr.data_ptr(), pos.data_ptr(),
                          f32["radj"].data_ptr(), K.data_ptr(), b.data_ptr(),
                          out.data_ptr(), pre.data_ptr(), N, P, C, Cout,
                          0.01, stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_level launch failed ({err})")
            report(f"K1 {shape} stream {routes[0]}", FORWARD_STAGES,
                   fwd.risi18_level_stage_cycles, CLUSTER_STAGES)
        for _ in range(ROUNDS):
            err = level_sums(f32["radj"].data_ptr(), g.data_ptr(),
                             out.data_ptr(), gap.data_ptr(), sums.data_ptr(),
                             N, P, Cout, 0.01, stream)
            err = err or backward(
                state.data_ptr(), nbr.data_ptr(), pos.data_ptr(),
                f32["radj"].data_ptr(), K.data_ptr(), g.data_ptr(),
                out.data_ptr(), gap.data_ptr(), sums.data_ptr(),
                dstate.data_ptr(), partial.data_ptr(), N, P, C, Cout, 0.01,
                groups, stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_level_backward launch failed "
                                   f"({err})")
            report(f"K2 kernel 1 {shape} stream {routes[1]}",
                   BACKWARD_STAGES,
                   bwd.risi18_level_backward_stage_cycles,
                   CLUSTER_BACKWARD_STAGES)
        T = risi18_aligned_t2_reference(state, nbr, pos).contiguous()
        Z = torch.empty((N, P, P, Cout), dtype=dtype, device="cuda")
        dT = torch.empty_like(T)
        bank_partial = torch.empty((groups, 18 * C * Cout),
                                   dtype=torch.float32, device="cuda")
        bank_forward = getattr(bank, f"risi18_bank_forward_{suffix}")
        bank_forward.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        bank_pre = Z if dtype == torch.float32 else pre
        bank_backward = getattr(bank_bwd, f"risi18_bank_backward_{suffix}")
        bank_backward.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        for _ in range(ROUNDS):
            err = bank_forward(T.data_ptr(), f32["radj"].data_ptr(),
                               K.data_ptr(), Z.data_ptr(),
                               bank_pre.data_ptr(), N, P, C, Cout, stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_bank launch failed ({err})")
            report(f"K4 {shape}", BANK_STAGES,
                   bank.risi18_bank_stage_cycles, CLUSTER_STAGES)
        for _ in range(ROUNDS):
            err = bank_sums(f32["radj"].data_ptr(), g.data_ptr(),
                            gap.data_ptr(), sums.data_ptr(), N, P, Cout,
                            stream)
            err = err or bank_backward(
                T.data_ptr(), f32["radj"].data_ptr(), K.data_ptr(),
                g.data_ptr(), gap.data_ptr(), sums.data_ptr(), dT.data_ptr(),
                bank_partial.data_ptr(), N, P, C, Cout, groups, stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_bank_backward launch failed "
                                   f"({err})")
            report(f"K5 kernel 1 {shape}", BANK_BACKWARD_STAGES,
                   bank_bwd.risi18_bank_backward_stage_cycles,
                   CLUSTER_BACKWARD_STAGES)


if __name__ == "__main__":
    main()
