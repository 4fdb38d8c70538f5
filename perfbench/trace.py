"""The traced run: ``torch.profiler`` around the measured window, reduced
to what the metrics read.

Busy time is the union of the device's kernel, copy and set intervals
inside the window; an idle gap is named by the innermost host operation of
the window's thread that covers its middle (a benchmark span,
``perfbench.*``, where no PyTorch operation does).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import sys

import numpy as np

WINDOW = "perfbench.window"
# The profiler's activity types of work on the device.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")
TOP = 10
GAPS_NAMED = 4000


# Device-side events that are no work: the profiler's mirrors of host
# annotations, and waits.
NOT_WORK = ("perfbench.", "Context Sync", "Stream Sync", "Event Sync",
            "Stream Wait")


def _name(e) -> str:
    return e.name()[:200]


def _kind(e):
    """The profiler's activity type of an event, where this version of
    torch reports one; else None."""
    f = getattr(e, "activity_type", None)
    return f() if f is not None else None


def _device_work(e, kind) -> bool:
    if e.device_type().name == "CPU":
        return False
    if kind is not None:
        return kind in DEVICE_WORK
    ann = getattr(e, "is_user_annotation", None)
    return not ((ann is not None and ann())
                or e.name().startswith(NOT_WORK))


def summarize(events, log=None) -> dict:
    """Reduce the profiler's raw events to {window_s, busy_s, kernels:
    {name: [launches, seconds]}, copies: {name: [count, seconds]},
    device_ops, idle_gaps}; None where the window span is missing."""
    win = [e for e in events if e.name() == WINDOW
           and e.device_type().name == "CPU"]
    if not win:
        return None
    w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    thread = win[0].start_thread_id()
    kinds = collections.Counter()
    dev, host = [], []
    for e in events:
        kind = _kind(e)
        s, d = e.start_ns(), e.duration_ns()
        if _device_work(e, kind):
            kinds[(e.device_type().name, kind, "work")] += 1
            if s < w1 and s + d > w0:
                dev.append((max(s, w0), min(s + d, w1), _name(e)))
        elif e.device_type().name == "CPU":
            kinds[("CPU", kind)] += 1
            if (e.start_thread_id() == thread and w0 <= s <= w1
                    and e.name() != WINDOW):
                host.append((s, s + d, _name(e)))
        else:
            kinds[(e.device_type().name, kind, e.name()[:40])] += 1
    if log:
        log(f"trace: event kinds {dict(kinds)}")
    kernels, copies = {}, {}
    for s, t, name in dev:
        table = copies if name.startswith(("Memcpy", "Memset")) else kernels
        row = table.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (t - s) / 1e9
    # Union of the device intervals, and the gaps between them.
    dev.sort()
    busy, gaps, end = 0, [], w0
    for s, t, _ in dev:
        if s > end:
            gaps.append((s - end, end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps.append((w1 - end, end, w1))
    host.sort()
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    named = collections.Counter()
    gaps.sort(reverse=True)
    for length, g0, g1 in gaps[:GAPS_NAMED]:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        lo = max(0, i - 5000)
        cover = np.nonzero(ends[lo:i] >= mid)[0]
        name = host[lo + cover[-1]][2] if len(cover) else "(no host span)"
        named[name] += length / 1e9
    ops = collections.Counter({k: v[1] for k, v in
                               {**kernels, **copies}.items()})
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "kernels": kernels, "copies": copies,
            "device_ops": [[k, v] for k, v in ops.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in named.most_common(TOP)]}


class Tracer:
    """``with Tracer(on) as tr: ... with tr.window(): <measured loop>``;
    afterwards ``tr.summary`` (None when off)."""

    def __init__(self, on: bool, log=None):
        self.on, self.summary, self.log = on, None, log or (
            lambda m: print(m, file=sys.stderr, flush=True))
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def window(self):
        from torch.profiler import record_function

        return record_function(WINDOW) if self.on else contextlib.nullcontext()

    def span(self, name):
        from torch.profiler import record_function

        return (record_function(f"perfbench.{name}") if self.on
                else contextlib.nullcontext())

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(
                    list(self._prof.profiler.kineto_results.events()),
                    self.log)
            self._prof = None
        return False


def match(table: dict, patterns) -> tuple:
    """(launches, seconds) of the rows of ``table`` whose name holds one of
    ``patterns``."""
    n, s = 0, 0.0
    for name, (count, sec) in table.items():
        if any(p in name for p in patterns):
            n += count
            s += sec
    return n, s
