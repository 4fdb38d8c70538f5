"""Timing and tracing (counterpart of ``graphflow_tpu/utils/profiling.py``).

The reference hand-rolls wall-clock timers in each test program
(``tests/test_SMP_omega.cpp:151-207``).  Here:

  * ``Timer`` -- wall-clock context manager and accumulator
  * ``time_torch`` -- a callable's time per call, every call fenced by
    ``torch.cuda.synchronize`` (the JAX package's ``block_until_ready``),
    after a warm-up, as {mean, min, max, std} seconds
  * ``trace`` -- a ``torch.profiler`` trace of the block, written as a
    Chrome trace
  * ``risi18_layer_flops`` -- analytic FLOPs of the fused contraction layer
  * ``step_timer`` -- a train step wrapped in a fenced ``Timer``

A kernel's device time alone is taken with CUDA events behind a spin
kernel (``tools/measure.py:time_in_turns``); these functions time what the
host waits for.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


class Timer:
    """Accumulating wall-clock timer.

    >>> t = Timer()
    >>> with t:
    ...     work()
    >>> t.total, t.count, t.mean
    """

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def _fence() -> None:
    """Wait for the card's queued work, where this process has used it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_torch(fn: Callable, *args, iters: int = 10, warmup: int = 2,
               **kwargs) -> Dict[str, float]:
    """Seconds per call of ``fn(*args, **kwargs)``: ``warmup`` calls, then
    ``iters`` timed on the host clock, each ended by a synchronise.
    Returns {mean, min, max, std}."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _fence()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _fence()
        samples.append(time.perf_counter() - t0)
    a = np.asarray(samples)
    return {"mean": float(a.mean()), "min": float(a.min()),
            "max": float(a.max()), "std": float(a.std())}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (the card's kernels too,
    where this process can see a card) and write ``logdir/trace.json``, a
    Chrome trace.  Yields the profiler, whose ``key_averages()`` sum the
    time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _fence()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def risi18_layer_flops(B: int, P: int, C: int, Cout: Optional[int] = None,
                       fused: bool = True) -> int:
    """Analytic FLOPs of the fused contraction layer, as the JAX package
    counts them (``bench.py``)."""
    Cout = Cout or C
    contraction = 2 * B * (10 * P ** 3 * C)
    k_cols = 11 if fused else 18
    return contraction + 2 * B * P * P * k_cols * C * Cout


def step_timer(step_fn: Callable):
    """Wrap a train step with a Timer whose every call ends in a
    synchronise; returns (wrapped, timer)."""
    t = Timer()

    def wrapped(*args, **kwargs):
        with t:
            out = step_fn(*args, **kwargs)
            _fence()
        return out

    return wrapped, t
