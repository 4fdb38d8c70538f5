"""Outputs of the gather-fused kernels on seeded inputs, to hold one
checkout's kernels against another's on the same card.

For each dtype and level shape it runs the fused level forward
(``risi18_level``, K1), its backward (``risi18_level_backward``, K2: dstate,
dK, db) and the aligned neighbour tensor (``risi18_aligned_t2``, K7) on
inputs drawn from a NumPy seed and prints a SHA-256 of every output's
bytes.  With ``--save FILE`` the outputs are kept; with ``--against FILE``
each output is compared with the kept one: ``equal`` bit for bit, or the
largest absolute difference (K2's dstate is summed by float32 atomics in an
order that changes from run to run, so it agrees to rounding only).

Usage:
    python graphflow_tpu_torch/tools/kernel_digest.py [--root DIR]
        [--dtypes float32,bfloat16] [--save FILE] [--against FILE]

``--root`` names the checkout whose ``graphflow_tpu_torch`` is imported
(default: the one this file lies in), so one copy of this tool can drive an
older checkout, with ``--dtypes float32`` where that one has no bfloat16
mode; for that it imports nothing of the package but the three wrappers and
the seeded inputs.  Each checkout's ``chip_smoke.py`` gives its kernels'
times.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8),
          (256, 16, 32, 16), (64, 10, 2, 1)]


def digest(t: torch.Tensor) -> str:
    raw = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--save")
    ap.add_argument("--against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_digest runs CUDA kernels: no CUDA device "
                           "is available")
    sys.path.insert(0, args.root)
    from graphflow_tpu_torch.ops.risi_aligned import risi18_aligned_t2
    from graphflow_tpu_torch.ops.risi_level import (risi18_level,
                                                    risi18_level_backward)
    from graphflow_tpu_torch.utils.datasets import random_level_case
    import graphflow_tpu_torch

    print(f"package {Path(graphflow_tpu_torch.__file__).resolve().parent}; "
          f"{torch.cuda.get_device_name(0)}")
    kept = torch.load(args.against) if args.against else None
    outputs = {}
    for name in args.dtypes.split(","):
        dtype = getattr(torch, name)
        for i, (N, P, C, Cout) in enumerate(SHAPES):
            d = random_level_case(N, P, C, Cout, seed=i, empty_vertex=N // 2)
            f = {k: torch.as_tensor(d[k], dtype=torch.float32, device="cuda")
                 for k in ("state", "radj", "K", "b")}
            nbr, pos = (torch.as_tensor(d[k], dtype=torch.int32,
                                        device="cuda") for k in ("nbr", "pos"))
            g = torch.as_tensor(
                np.random.default_rng(i).normal(size=(N, P * P, Cout)),
                dtype=torch.float32, device="cuda").to(dtype)
            level = (f["state"].to(dtype), nbr, pos, f["radj"],
                     f["K"].to(dtype), f["b"].to(dtype))
            out = risi18_level(*level)
            dstate, dK, db = risi18_level_backward(*level, out, g)
            T = risi18_aligned_t2(level[0], nbr, pos)
            torch.cuda.synchronize()
            for key, t in (("K1 out", out), ("K2 dstate", dstate),
                           ("K2 dK", dK), ("K2 db", db), ("K7 T", T)):
                tag = f"{name} {(N, P, C, Cout)} {key}"
                line = f"{tag}: sha256 {digest(t)}"
                if kept is not None:
                    old = kept[tag].to(t.device)
                    if torch.equal(old, t):
                        line += " equal"
                    else:
                        diff = (old.double() - t.double()).abs().max()
                        line += (f" max abs diff {float(diff):.3e} (max|kept|"
                                 f" {float(old.double().abs().max()):.3e})")
                print(line)
                if args.save:
                    outputs[tag] = t.cpu()
    if args.save:
        torch.save(outputs, args.save)


if __name__ == "__main__":
    main()
