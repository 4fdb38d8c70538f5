"""Outputs of the level, bank and gather kernels on seeded inputs, to hold
one checkout's kernels against another's on the same card.

For each dtype and level shape it runs the fused level forward
(``risi18_level``, K1), its backward (``risi18_level_backward``, K2: dstate,
dK, db), the aligned neighbour tensor (``risi18_aligned_t2``, K7) and, over
that T, the bank (``risi18_bank``, K4), its backward
(``risi18_bank_backward``, K5: dT, dK) and the bank's five ablation
variants (``risi18_bank_variant``, K6) on inputs drawn from a NumPy seed
and prints a SHA-256 of every output's bytes.  With ``--save FILE`` the
outputs are kept; with ``--against FILE`` each output is compared with the
kept one: ``equal`` bit for bit, or the largest absolute difference with
the kernels' gate beside it, 1e-4 (float32) or 1e-2 (bfloat16) times
max(1, max|kept|), and ``within gate`` or ``BEYOND gate`` (K2's dstate is
summed by float32 atomics in an order that changes from run to run, so it
agrees to rounding only; a redesigned kernel sums in another order).
With ``--times`` it prints instead the spin-timed median ms of K1, of K2
kernel 1, of K4 and of K5 kernel 1 (on the take-gather's T of the same
level; each backward's kernel 1 with the kernel 0 that a cluster plan
launches before it), of K7, and of both kernels 2 (K2's in float32) beside
``partial.sum(0)``, with K4's and K5 kernel 1's bounds,
at every level shape that ``chip_smoke.py`` checks, so that two
checkouts' kernels can be timed in one call at the shapes (and, for the
bank, in the dtypes) the smoke does not time.  ``--shapes`` names other
level shapes (``N,P,C,Cout`` each), and ``--level-only`` times K1 and K2
kernel 1 alone there (with its kernel 0, and kernel 0 alone, on a cluster
plan), with the plan each checkout's launchers take (since the
tensor-copy route, its ``stream``) and each kernel's bound by
``chip_smoke.py``'s count (``level_ops``, ``level_backward_ops`` and the
bytes of its inputs and outputs).  Two checkouts timed in one call: run
the tool with ``--root`` on the older one and without it, in turns.

Usage:
    python graphflow_tpu_torch/tools/kernel_digest.py [--root DIR]
        [--dtypes float32,bfloat16] [--save FILE] [--against FILE]
        [--times [--shapes N,P,C,Cout ...] [--level-only]]

``--root`` names the checkout whose ``graphflow_tpu_torch`` is imported
(default: the one this file lies in), so one copy of this tool can drive an
older checkout, with ``--dtypes float32`` where that one has no bfloat16
mode; for that it imports nothing of the package but the kernels' wrappers
and the seeded inputs (and, for ``--times``, the timer of
``tools/measure.py``, the take-gather and K2's and K5's kernel-1
wrappers).  Needs a CUDA device.
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
# chip_smoke.py's LEVEL_SHAPES and SCHEDULE_SHAPES.
TIME_SHAPES = SHAPES + [(256, 16, 16, 8), (32, 4, 1, 1)]


def digest(t: torch.Tensor) -> str:
    raw = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--save")
    ap.add_argument("--against")
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--shapes", nargs="+", default=None)
    ap.add_argument("--level-only", action="store_true")
    args = ap.parse_args(argv)
    shapes = ([tuple(int(x) for x in a.split(",")) for a in args.shapes]
              if args.shapes else (TIME_SHAPES if args.times else SHAPES))
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_digest runs CUDA kernels: no CUDA device "
                           "is available")
    sys.path.insert(0, args.root)
    from graphflow_tpu_torch.ops.risi_aligned import risi18_aligned_t2
    from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                                   risi18_bank_backward)
    from graphflow_tpu_torch.ops.risi_bank_ablate import (
        MODES, risi18_bank_variant)
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
        for i, (N, P, C, Cout) in enumerate(shapes):
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
            if args.times:
                from graphflow_tpu_torch.ops import risi_bank
                from graphflow_tpu_torch.ops.risi_aligned import (
                    risi18_aligned_t2_reference)
                from graphflow_tpu_torch.ops.risi_level import (
                    _backward_main_kernel, _backward_reduce_kernel)
                from graphflow_tpu_torch.tools.measure import time_ms

                k1 = time_ms(lambda: risi18_level(*level))
                k2 = time_ms(lambda: _backward_main_kernel(
                    *level[:5], g, out, 0.01))
                if args.level_only:
                    from chip_smoke import (bound_ms, level_backward_ops,
                                            level_ops, nbytes,
                                            present_elements)
                    from graphflow_tpu_torch.ops.risi_level import (
                        _backward_sums_kernel, level_backward_plan,
                        level_plan)
                    bplan = level_backward_plan(N, P, C, Cout, dtype)
                    k0 = ""
                    if bplan["cluster"]:
                        ms0 = time_ms(lambda: _backward_sums_kernel(
                            level[3], g, out, 0.01))
                        k0 = f" (kernel 0 alone {ms0:.4f} ms)"
                    present = present_elements(nbr, pos)
                    grads = risi18_level_backward(*level, out, g)
                    b1 = bound_ms(nbytes(*level, out),
                                  level_ops(N, P, C, Cout, present), name)
                    b2 = bound_ms(nbytes(*level[:5], g, out, *grads),
                                  level_backward_ops(N, P, C, Cout, present),
                                  name)
                    print(f"{name} {(N, P, C, Cout)}: K1 {k1:.4f} ms (bound "
                          f"{b1[0]:.4f} by {b1[1]}), K2 kernel 1 {k2:.4f} ms "
                          f"(bound {b2[0]:.4f} by {b2[1]}){k0}; plans "
                          f"{level_plan(N, P, C, Cout, dtype)}, {bplan}",
                          flush=True)
                    continue
                _, partial = _backward_main_kernel(*level[:5], g, out, 0.01)
                T = risi18_aligned_t2_reference(level[0], nbr,
                                                pos).contiguous()
                gb = g.view(N, P, P, Cout)
                k4 = time_ms(lambda: risi18_bank(T, level[3], level[4]))
                k7 = time_ms(lambda: risi18_aligned_t2(level[0], nbr, pos))
                k5 = time_ms(lambda: risi_bank._backward_main_kernel(
                    T, level[3], level[4], gb))
                _, bpartial = risi_bank._backward_main_kernel(
                    T, level[3], level[4], gb)
                # Kernel 2 of K2 (float32 only: bfloat16 takes
                # finish_bf16_kernel) and of K5, beside partial.sum(0).
                red = ""
                if dtype == torch.float32:
                    r2 = time_ms(lambda: _backward_reduce_kernel(
                        partial, C, Cout))
                    red = f"K2 kernel 2 {r2:.4f} ms, "
                r5 = time_ms(lambda: risi_bank._backward_reduce_kernel(
                    bpartial, C, Cout))
                red += (f"K5 kernel 2 {r5:.4f} ms, partial.sum(0) "
                        f"{time_ms(lambda: bpartial.sum(0)):.4f} ms")
                # K4's and K5 kernel 1's bounds, by chip_smoke.py's count
                # (bank_factored_ops, bank_backward_factored_ops).
                from chip_smoke import (bank_backward_factored_ops,
                                        bank_factored_ops, bound_ms, nbytes)
                Z = risi18_bank(T, level[3], level[4])
                dT, dK = risi18_bank_backward(T, level[3], level[4], gb)
                b4 = bound_ms(nbytes(T, level[3], level[4], Z),
                              bank_factored_ops(N, P, C, Cout), name)
                b5 = bound_ms(nbytes(T, level[3], level[4], gb, dT, dK),
                              bank_backward_factored_ops(N, P, C, Cout), name)
                del Z, dT, dK
                print(f"{name} {(N, P, C, Cout)}: K1 {k1:.4f} ms, K2 kernel "
                      f"1 {k2:.4f} ms, K4 {k4:.4f} ms (bound {b4[0]:.4f} by "
                      f"{b4[1]}), K5 kernel 1 {k5:.4f} ms (bound "
                      f"{b5[0]:.4f} by {b5[1]}), K7 {k7:.4f} ms; {red}")
                continue
            dstate, dK, db = risi18_level_backward(*level, out, g)
            T = risi18_aligned_t2(level[0], nbr, pos)
            Z = risi18_bank(T, level[3], level[4])
            dT, dK_bank = risi18_bank_backward(T, level[3], level[4],
                                               g.view(N, P, P, Cout))
            variants = [(f"K6 {mode}", risi18_bank_variant(
                T, level[3], level[4], mode)) for mode in MODES
                if mode != "dma" or Cout <= P * C]
            torch.cuda.synchronize()
            for key, t in (("K1 out", out), ("K2 dstate", dstate),
                           ("K2 dK", dK), ("K2 db", db), ("K7 T", T),
                           ("K4 Z", Z), ("K5 dT", dT), ("K5 dK", dK_bank),
                           *variants):
                tag = f"{name} {(N, P, C, Cout)} {key}"
                line = f"{tag}: sha256 {digest(t)}"
                if kept is not None and tag not in kept:
                    line += " (not kept)"
                elif kept is not None:
                    old = kept[tag].to(t.device)
                    if torch.equal(old, t):
                        line += " equal"
                    else:
                        diff = float((old.double() - t.double()).abs().max())
                        scale = float(old.double().abs().max())
                        gate = (1e-4 if name == "float32" else 1e-2) * max(
                            1.0, scale)
                        line += (f" max abs diff {diff:.3e} (max|kept| "
                                 f"{scale:.3e}, gate {gate:.3e}: "
                                 f"{'within' if diff <= gate else 'BEYOND'}"
                                 f" gate)")
                print(line)
                if args.save:
                    outputs[tag] = t.cpu()
    if args.save:
        torch.save(outputs, args.save)


if __name__ == "__main__":
    main()
