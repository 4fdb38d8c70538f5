"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress and, as its last lines, each number that decided
``correct`` beside its limit on standard error, and one JSON object as the
last line of standard output.  It needs the cards the cell asks for and the
program (``graphflow_tpu_torch``) in the checkout beside ``perfbench/``;
without either it exits with another code than 0 and prints no result, as
it does if any JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

# Caches of the program and of libraries it may load, inside the checkout
# at fixed paths; transformers, should anything load it, without flax.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" /
                                                  "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    spec = harness.load_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < spec.chips:
        harness.log(f"{spec.cell} needs {spec.chips} cards, this machine "
                    f"has {torch.cuda.device_count()}")
        return 2
    import graphflow_tpu_torch

    where = Path(graphflow_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        harness.log(f"the program was found at {where}, outside the "
                    f"checkout {ROOT}")
        return 2
    card = harness.card_line()
    harness.log(f"{spec.cell} seed {args.seed}: {card}")
    record = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), t0=T0)
    record["card"] = card
    out = harness.result(spec, record, bool(args.trace))
    banned = harness.banned_modules()
    if banned:
        harness.log(f"modules that no run may load were loaded: {banned}")
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["check"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    harness.log(f"correct: {out['correct']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
