"""What every run shares: finding a cell's files by name, the result line,
the readers of the metrics, and the check that no JAX module was loaded.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``driver`` names the
module of ``drivers/`` that runs it); ``workloads/<cell>.json`` holds the
limits of the cell's check.  Each metric is read by ``metrics/<name>.py``.

A driver module declares its ``KIND`` (``"train"`` or ``"predict"``) and
has ``run(spec, seed, seconds, trace, device, t0, hooks)``.  The
configuration's ``family`` names ``family_<family>.py``, which gives the
drivers, the calibration and the tests everything of one model family:

- ``make_weights(cfg, seed, device)``: the weights of the seed, {path:
  tensor};
- ``build_model(cfg, weights, device)``: the program's model holding them,
  with a fresh optimizer state;
- ``program_graph(adj, feature)``: the program's graph of one molecule;
- ``graph_elements(cfg, adj)`` and ``batch_work(cfg, B, elements)``: the
  work of a batch for the rooflines and MFU;
- ``KERNELS``: {role: the profiler's kernel names}; ``LIBRARIES``: {kind:
  the kernel libraries that a driver of that kind loads};
- ``REFERENCE``: the plain reference module, with ``prepare(adj, feature,
  cfg)``, ``predict(preps, params, cfg, precision, block_elements,
  device)`` -> float64 NumPy, and ``train(steps, params, cfg, lr,
  precision, block_elements, device)`` -> (losses before each step, the
  first step's gradient, the parameters after the last); it takes the
  settings of its optimizer from ``cfg``;
- ``first_gradient(model, cfg)``: the first step's gradient as the
  program's optimizer took it, read from its state after that step;
- ``tiny_config(cfg)``: the configuration cut to a size that CPU tests run,
  on molecules of 7-10 atoms.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may load (the JAX package's name is
# compared whole: the port's name begins with it).
BANNED_MODULES = ("jax", "jaxlib", "flax", "graphflow_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Spec:
    root: Path
    cell: str
    config: dict
    traffic: dict
    check: dict
    chips: int
    end_to_end: list
    per_layer: list


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(cell: str, root: Path = ROOT) -> Spec:
    """The cell ``cell`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json; it has "
                         f"{sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(root / "perfbench" / "traffic"
                         / f"{w['traffic']}.json")
    check = _read_json(root / "perfbench" / "workloads" / f"{cell}.json")
    e2e = [m for m in bench["end_to_end"] if cell in m.get(
        "workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    return Spec(root, cell, config, traffic, check, int(w["chips"]), e2e,
                per_layer)


def family(spec: Spec):
    return importlib.import_module(f"perfbench.family_{spec.config['family']}")


def driver(spec: Spec):
    return importlib.import_module(
        f"perfbench.drivers.{spec.traffic['driver']}")


def reader(name: str, root: Path = ROOT):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def busiest_idle(record: dict) -> dict:
    """The rank whose device was idle longest in the traced window (the
    only rank on one chip)."""
    ranks = [r for r in record["ranks"] if r.get("trace")]
    return max(ranks, key=lambda r: r["trace"]["window_s"]
               - r["trace"]["busy_s"]) if ranks else record["ranks"][0]


def banned_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in BANNED_MODULES)


def judge(numbers: dict, limits: dict) -> tuple:
    """({name: {"value", "limit"}}, correct): every number finite and at
    most its limit."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return out, ok


def result(spec: Spec, record: dict, trace: bool) -> dict:
    """The result line of a run."""
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = reader(m["name"], spec.root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": record["platform"], "kind": record["kind_name"],
              "count": record["count"],
              "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": record["correct"], "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": device}
    if trace:
        traces = [r["trace"] for r in record["ranks"] if r.get("trace")]
        if traces:
            device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
            device["window_s"] = sum(t["window_s"] for t in traces) / len(
                traces)
            t = busiest_idle(record)["trace"]
            out["breakdown"] = {"device_ops": t["device_ops"],
                                "idle_gaps": t["idle_gaps"]}
    out["check"] = record["check"]
    return out


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, t0: Optional[float] = None,
             hooks=()) -> dict:
    """Run the cell once through its traffic's driver -> the record the
    metrics read.  ``device`` None is the card; a test passes "cpu".
    ``hooks`` ("module:function" names) run before set-up in every
    process of the run: a test plants a fault with them."""
    return driver(spec).run(spec, seed, seconds, trace, device, t0,
                            tuple(hooks))


def call_hooks(hooks) -> None:
    for h in hooks:
        mod, fn = h.split(":")
        getattr(importlib.import_module(mod), fn)()


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
