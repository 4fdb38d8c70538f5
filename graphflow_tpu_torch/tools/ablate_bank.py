"""On-card ablation of the bank kernel (counterpart of
``tools/ablate_bank.py``).

Times the stripped-down variants of ``ops/risi_bank_ablate.py`` to
attribute the cost of one call of the bank kernel (``ops/risi_bank.py``,
K4: the cp.async ring over T, the stream's reductions, nine map slabs on
the tensor cores, the adjacency applied once) to its stages:

  full      the bank kernel's own block (the reference point)
  dma       every element of T through K4's ring and loaded once, and the
            output written, with no arithmetic: the floor of the stream
  reduce    the stream and its reductions without M6 and M10, two products
            with K, no vector or scalar cases
  nogroupd  everything except the adjacency-weighted cases: no M6 and M10,
            no W, two map slabs
  novpu     full with every pick of a diagonal replaced by the full sum
            (wrong results; prices the selection)

and from them: stream = dma (copies and loads); reductions = reduce - dma
(T_ab and T_bc with their shuffles, the picks, the row sums, two
products); products = nogroupd - reduce (the vector and scalar cases U and
s, the products' difference); group D = full - nogroupd (M6 and M10 in the
stream, their two slabs, W's five slabs and the adjacency in the
epilogue); selection = full - novpu (the picks, less the pass that writes
the full sums in their place).
Each time is the median of 50 CUDA-event timings of single launches (each
queued behind a spin kernel, so that no host time falls between the events),
the variants taken in turns, printed with its quartiles; a last line, ``bank``,
times the bank kernel itself in the same turns (``full`` is the same code,
so the gap between the two shows what a difference of two variants can
resolve).  Each difference is also taken within every round, and printed
with the quartiles of those paired differences: a stage whose quartiles
straddle zero is not resolved by the run.

Usage: python -m graphflow_tpu_torch.tools.ablate_bank [B] [P] [C]
(defaults 256 16 32; float32 then bfloat16).  Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from graphflow_tpu_torch.ops.risi_bank import risi18_bank
from graphflow_tpu_torch.ops.risi_bank_ablate import risi18_bank_variant
from graphflow_tpu_torch.tools.measure import time_in_turns

MODE_ORDER = ("dma", "reduce", "nogroupd", "novpu", "full")
DTYPES = (torch.float32, torch.bfloat16)


def parse_args(argv):
    """[B] [P] [C] -> (B, P, C), defaults 256 16 32."""
    given = [int(x) for x in argv[:3]]
    return tuple(given + [256, 16, 32][len(given):])


def make_inputs(B, P, C, dtype, device="cuda"):
    """T [B,P,P,P,C], A [B,P,P] >= 0 and K [18C, C], drawn from
    ``np.random.RandomState(0)`` in float32 as the JAX tool draws them; T
    and K then cast to ``dtype``."""
    rng = np.random.RandomState(0)
    T = torch.from_numpy(rng.randn(B, P, P, P, C).astype(np.float32))
    A = torch.from_numpy(np.abs(rng.randn(B, P, P).astype(np.float32)))
    K = torch.from_numpy((rng.randn(18 * C, C) * 0.1).astype(np.float32))
    return (T.to(device).to(dtype), A.to(device), K.to(device).to(dtype))


REPS, WARMUP = 50, 3


def time_variants(T, A, K, reps=REPS):
    """{mode: [ms of one launch, one per round]}, and under "bank" the bank
    kernel itself, which ``full`` repeats."""
    fns = {mode: (lambda m=mode: risi18_bank_variant(T, A, K, m))
           for mode in MODE_ORDER}
    fns["bank"] = lambda: risi18_bank(T, A, K)
    return time_in_turns(fns, reps, WARMUP)


def attribution(ms):
    """The stages' shares of one call, from the variants' times."""
    return {"stream": ms["dma"],
            "reductions": ms["reduce"] - ms["dma"],
            "products": ms["nogroupd"] - ms["reduce"],
            "group_d": ms["full"] - ms["nogroupd"],
            "selection": ms["full"] - ms["novpu"]}


def quartiles(xs):
    """(first, third) quartile of xs."""
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def report(B, P, C, dtype, out=print):
    """Times the five variants at (B, P, C, Cout=C) in ``dtype`` and prints
    them with the attribution; returns (ms, attribution, spread): the
    medians, their differences, and {variant or stage: (first, third)
    quartile}, a stage's from its differences within each round, and under
    "full-bank" those of the two timings of the same code."""
    T, A, K = make_inputs(B, P, C, dtype)
    name = str(dtype)[6:]
    out(f"B={B} P={P} C={C} Cout={C} {name}: T "
        f"{T.numel() * T.element_size() / 1e6:.1f} MB")
    times = time_variants(T, A, K)
    ms = {mode: statistics.median(ts) for mode, ts in times.items()}
    spread = {mode: quartiles(ts) for mode, ts in times.items()}
    for mode in MODE_ORDER + ("bank",):
        out(f"{mode:10s}: {ms[mode]:8.4f} ms  [{spread[mode][0]:.4f}, "
            f"{spread[mode][1]:.4f}]")
    parts = attribution(ms)
    rounds = [attribution(dict(zip(times, ts))) for ts in zip(*times.values())]
    spread.update({k: quartiles([r[k] for r in rounds]) for k in parts})
    out("attribution of full: "
        + ", ".join(f"{k} {v:.4f} ms ({100 * v / ms['full']:.0f} %) "
                    f"[{spread[k][0]:.4f}, {spread[k][1]:.4f}]"
                    for k, v in parts.items()))
    same = [f - b for f, b in zip(times["full"], times["bank"])]
    spread["full-bank"] = quartiles(same)
    out(f"full - bank, the same code: {statistics.median(same):.4f} ms "
        f"[{spread['full-bank'][0]:.4f}, {spread['full-bank'][1]:.4f}]")
    return ms, parts, spread


def main(argv=None):
    B, P, C = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_bank times CUDA kernels: no CUDA device "
                           "is available")
    for dtype in DTYPES:
        report(B, P, C, dtype)


if __name__ == "__main__":
    main()
