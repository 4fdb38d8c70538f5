"""Where one block of the two level kernels spends its cycles.

Builds ``csrc/risi18_level.cu`` (K1) and ``csrc/risi18_level_bwd.cu`` (K2
kernel 1) with ``-DRISI18_STAGE_CLOCK`` into ``build/kernels/*_clock.so``,
launches each on seeded inputs at one level shape, and prints the cycles
that block (0, 0, 0) spent between the kernels' ``STAGE`` marks (its first
thread reads ``clock64()`` behind a barrier at each mark), per dtype, with
each stage's share.  The marks add a barrier each, so the sums run a few
per cent above an unmarked launch; the shares are what the tool is for.
K1's block is one vertex; K2's is the vertices of one vertex group for one
channel chunk (two at N=256).

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
ROUNDS = 3


def build(name: str) -> ctypes.CDLL:
    """``lib<name>_clock.so``: the kernel with its stage clock compiled in."""
    return ctypes.CDLL(str(cuda_build.build_library(
        name, flags=("-DRISI18_STAGE_CLOCK",), suffix="_clock").path))


def report(what, stages, read_cycles):
    cycles = (ctypes.c_longlong * 16)()
    err = read_cycles(cycles)
    if err != 0:
        raise RuntimeError(f"{what}: reading the stage clock failed ({err})")
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
    fwd, bwd = build("risi18_level"), build("risi18_level_bwd")
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
        forward.argtypes = [ptr] * 7 + [i32] * 4 + [ctypes.c_float, ptr]
        backward = getattr(bwd, f"risi18_level_backward_{suffix}")
        backward.argtypes = [ptr] * 9 + [i32] * 4 + [ctypes.c_float, i32, ptr]
        shape = f"(N,P,C,Cout)=({N},{P},{C},{Cout}) {suffix}"
        for _ in range(ROUNDS):
            err = forward(state.data_ptr(), nbr.data_ptr(), pos.data_ptr(),
                          f32["radj"].data_ptr(), K.data_ptr(), b.data_ptr(),
                          out.data_ptr(), N, P, C, Cout, 0.01, stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"risi18_level launch failed ({err})")
            report(f"K1 {shape}", FORWARD_STAGES,
                   fwd.risi18_level_stage_cycles)
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
                   bwd.risi18_level_backward_stage_cycles)


if __name__ == "__main__":
    main()
