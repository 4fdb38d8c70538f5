"""The readings that a cell's limits are set from: the numbers the check
compares, for the program on many seeds, for the control, and for the
planted faults, each at the cell's own sizes.  Not part of a run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --mode program[,control]|control|<fault> [--out FILE]

``program``: the program's followed steps (training) or checked requests
(prediction) against the reference, as a run compares them, with no
window.  ``control``: the reference itself in TF32 (operands of every
product rounded to 10 mantissa bits, summed in float32) in the program's
place.  A fault name from ``faults.py`` plants that fault in the program.
One JSON line a seed is printed and, with ``--out``, appended to FILE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from perfbench import compare, graphs, harness  # noqa: E402
from perfbench.drivers import common  # noqa: E402


def _subset(seed, traffic, batches):
    """The pool's graphs of ``batches`` alone, the batches renumbered."""
    idx = sorted({int(i) for b in batches for i in b})
    pool, targets = graphs.make_pool(seed, traffic, idx)
    where = {g: k for k, g in enumerate(idx)}
    return pool, targets, [[where[int(i)] for i in b] for b in batches]


def train_readings(spec, driver, seed, dev, mode):
    cfg, tr = spec.config, spec.traffic
    it = common.batches_of(seed, tr)
    batches = [next(it) for _ in range(spec.check["steps_followed"])]
    pool, targets, steps = _subset(seed, tr, batches)
    fam = harness.family(spec)
    weights = fam.make_weights(cfg, seed, dev)
    ref = driver.follow(spec, pool, targets, steps, weights, dev)
    if mode == "control":
        ctl = driver.follow(spec, pool, targets, steps, weights, dev,
                            precision="tf32")
        prog = (steps,) + tuple(ctl)
    else:
        model, weights, dense, _ = common.model_and_pool(fam, cfg, seed, dev,
                                                         pool)
        prog = driver.first_steps(spec, model, dense, targets, iter(steps))
        del model, dense
        common.free(dev)
    check, _, logged = driver.judge_steps(spec, prog, ref, weights)
    return dict({k: v["value"] for k, v in check.items()}, **logged)


def predict_readings(spec, driver, seed, dev, mode):
    cfg, tr, chk = spec.config, spec.traffic, spec.check
    it = common.batches_of(seed, tr)
    requests = [next(it) for _ in range(chk["requests_checked"])]
    pool, _, reqs = _subset(seed, tr, requests)
    fam = harness.family(spec)
    flat = [i for r in reqs for i in r]
    if mode == "control":
        weights = fam.make_weights(cfg, seed, dev)
        prog = driver.reference_predictions(spec, pool, flat, weights, dev,
                                            precision="tf32")
    else:
        model, weights, dense, _ = common.model_and_pool(fam, cfg, seed, dev,
                                                         pool)
        prog = [x for r in reqs for x in model.Threaded_Predict(
            [dense[i] for i in r])]
        del model, dense
        common.free(dev)
    ref = driver.reference_predictions(spec, pool, flat, weights, dev)
    return compare.prediction_numbers(prog, ref)


READINGS = {"train": train_readings, "predict": predict_readings}


def readings(spec, seed, mode, device=None):
    """{number: reading} of one seed, by the kind of the cell's driver; a
    fault is planted by the caller."""
    dev = common.device_of(device)
    driver = harness.driver(spec)
    common.build_kernels(harness.family(spec), driver.KIND, dev)
    return READINGS[driver.KIND](spec, driver, seed, dev, mode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = harness.load_spec(args.workload)
    harness.log(f"{spec.cell} {args.mode}: {harness.card_line()}")
    modes = args.mode.split(",")
    faults = [m for m in modes if m not in ("program", "control")]
    if faults:                                      # once: a fault stacks
        if len(modes) > 1:
            raise SystemExit("a fault runs in a process of its own")
        harness.call_hooks((f"perfbench.faults:{faults[0]}",))
    for mode in modes:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            line = {"cell": spec.cell, "mode": mode, "seed": seed,
                    "readings": readings(spec, seed, mode),
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
