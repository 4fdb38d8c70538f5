"""Cells of ``BENCHMARK.json`` cut to a size that a CPU test can run: the
same files and code, with few and small graphs, few channels and a short
window."""

from __future__ import annotations

import dataclasses
import json

from perfbench import harness

# The cells on one card: the CPU tests run each of them.
ONE_CHIP = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]
    if w["chips"] == 1]
# Molecules that fit every family's tiny configuration (10 vertices).
TRAFFIC = {"atoms": [7, 10]}


def spec(cell: str, pool: int = 8, batch: int = 4) -> harness.Spec:
    s = harness.load_spec(cell)
    cfg = harness.family(s).tiny_config(s.config)
    traffic = dict(s.traffic, **TRAFFIC, pool=pool, batch=batch)
    check = dict(s.check, block_elements=1 << 16)
    if "requests_checked" in check:
        check["reference_graphs_per_call"] = 3
    return dataclasses.replace(s, config=cfg, traffic=traffic, check=check)


def run(cell: str, seed: int = 123456789012, seconds: float = 0.2,
        trace: bool = False, hooks=(), **kw) -> dict:
    """A tiny run of ``cell`` on the CPU -> (record, result line)."""
    s = spec(cell, **kw)
    record = harness.run_cell(s, seed, seconds, trace, device="cpu",
                              hooks=hooks)
    return record, harness.result(s, record, trace)


def main(argv):
    """``python -m perfbench.tests.tiny <cell> [hook ...]``: a tiny run in a
    process of its own, printing its result line and the modules that no
    run may load."""
    import json
    import sys

    record, out = run(argv[0], hooks=argv[1:])
    print(json.dumps({"result": out, "banned": harness.banned_modules()}))
    sys.stdout.flush()


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
