"""Where a cached training step and a cached request spend their time on
the card, for one model configuration after another.

For each named configuration, at the width ``chip_smoke.py`` drives (V=64,
P=16, C=32, two levels, 4 Erdos-Renyi graphs a batch, seeded weights), it
warms the model up (so that host preparation is cached and the kernels are
built), then prints
- the median wall milliseconds of 5 ``BatchLearn`` steps and of 5
  ``Threaded_Predict`` requests (host clock, each ended by a synchronise),
- from one ``torch.profiler`` run over 5 more of each: the device-busy
  milliseconds per step and per request (the sum of every device kernel's
  and copy's time) and the kernels that take most of it, with their
  launches per step or request,
- the peak device memory of one step above what the model holds.

Usage: python -m graphflow_tpu_torch.tools.profile_step [NAME ...]
Names: omega_f32, omega_bf16, omega_bf16_bank (the bank route over a
materialised T, ``level_fn=risi18_bank_level``: K4 serving, K4 and K5
training; ``tools/measure.py:bank_route_model``), ver6_f32, ver6_bf16,
ver7_f32, ver7_bf16 (default: all).  Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from graphflow_tpu_torch.tools.measure import (ADAM_LR, ER_P,
                                               FULL_WIDTH as MODEL, GRAPHS,
                                               MOMENTUM_LR, bank_route_model)

ROUNDS, TOP = 5, 8
# (contraction, dtype, optimizer, learning rate, through the bank route).
CONFIGS = {
    "omega_f32": (18, "float32", "adam", ADAM_LR, False),
    "omega_bf16": (18, "bfloat16", "adam", ADAM_LR, False),
    "omega_bf16_bank": (18, "bfloat16", "adam", ADAM_LR, True),
    "ver6_f32": (10, "float32", "momentum", MOMENTUM_LR, False),
    "ver6_bf16": (10, "bfloat16", "momentum", MOMENTUM_LR, False),
    "ver7_f32": (50, "float32", "momentum", MOMENTUM_LR, False),
    "ver7_bf16": (50, "bfloat16", "momentum", MOMENTUM_LR, False),
}


def device_time_us(event) -> float:
    """An averaged profiler event's own device time in microseconds (the
    attribute's name changed between torch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def wall_ms(fn, rounds=ROUNDS):
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(fn, rounds=ROUNDS):
    """(device-busy ms per call, [(kernel name, ms per call, launches per
    call)] by time) over ``rounds`` calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
    # Device events only: a host operator's entry repeats the time of the
    # kernels it launched.
    rows = [(e.key, device_time_us(e) / 1e3 / rounds, e.count / rounds)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_time_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def report(name, out=print):
    from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
    from graphflow_tpu_torch.utils.datasets import random_graph

    contraction, dtype, optimizer, lr, bank_route = CONFIGS[name]
    config = dict(MODEL, contraction=contraction, dtype=dtype,
                  optimizer=optimizer)
    model = (bank_route_model(seed=0, device="cuda", **config) if bank_route
             else SMP2D(SMP2DConfig(**config), seed=0, device="cuda"))
    graphs = [random_graph(MODEL["max_nVertices"], ER_P, seed=100 + i)
              for i in range(GRAPHS)]
    targets = np.random.default_rng(0).normal(size=GRAPHS).tolist()

    def request():
        return model.Threaded_Predict(graphs)

    def step():
        return model.BatchLearn(graphs, targets, lr)

    for what, call in (("step", step), ("request", request)):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        wall = wall_ms(call)
        busy, rows = profile(call)
        out(f"{name} cached {what}: wall {wall:.3f} ms (median of {ROUNDS}, "
            f"host clock, synced); device busy {busy:.4f} ms per {what} "
            f"({100 * busy / wall:.0f} % of the wall)")
        for key, ms, count in rows[:TOP]:
            out(f"{name} {what}:   {ms:8.4f} ms  {count:5.1f} launches  "
                f"{key[:90]}")
        if what == "step":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e6
            out(f"{name} cached step: peak device memory {peak:.1f} MB above "
                f"the {base / 1e6:.1f} MB held")


def main(argv=None):
    names = list(sys.argv[1:] if argv is None else argv) or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        raise SystemExit(f"unknown configuration {unknown}; known: "
                         f"{list(CONFIGS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step profiles CUDA work: no CUDA device "
                           "is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in names:
        report(name)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
