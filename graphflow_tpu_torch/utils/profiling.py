"""Timing and tracing (counterpart of ``graphflow_tpu/utils/profiling.py``).

The reference hand-rolls wall-clock timers in each test program
(``tests/test_SMP_omega.cpp:151-207``).  Here:

  * ``Timer`` -- wall-clock context manager and accumulator
  * ``time_torch`` -- a callable's time per call, every call fenced by
    ``torch.cuda.synchronize`` (the JAX package's ``block_until_ready``),
    after a warm-up, as {mean, min, max, std} seconds
  * ``trace`` -- a ``torch.profiler`` trace of the block, written as a
    Chrome trace, the program's spans beside the kernels and copies
  * ``risi18_layer_flops`` -- analytic FLOPs of the fused contraction layer
  * ``step_timer`` -- a train step wrapped in a fenced ``Timer``
  * ``span``, ``count``, ``snapshot``, ``roots``, ``tail``, ``reset`` --
    the program's own spans and counters

**Spans.**  ``span(name)`` marks a layer boundary of a step or request:
``graphflow.batch_learn`` (a ``GraphModel.BatchLearn`` step) and
``graphflow.predict`` (a ``Predict``, ``Threaded_Predict`` or ``Feature``
request) are roots; under them ``graphflow.stack`` (``stack_graphs``, with
``graphflow.stack.host``, the NumPy stacking, and ``graphflow.stack.h2d``,
the hand-over to the model's device), ``graphflow.forward``,
``graphflow.backward`` (``torch.autograd.grad``), ``graphflow.optimizer``
(``opt.update``, with ``graphflow.optimizer.wait``, Adam's copy of its
step count to the device, which waits for the device's queue) and
``graphflow.readback`` (the host waiting for the loss or answer and copying
it back); inside ``graphflow.forward``, a level of the 4-, 10- and 50-case
variants (``models/smp2d.py:contraction_level``) gives
``graphflow.level.gather`` (the aligned tensor T) and
``graphflow.level.bank`` (the bank with K).  A ``torch.profiler`` profile
active in the process is their only switch: with none, ``span`` costs one
check of the profiler's flag and records nothing.  With one, each span is a
``record_function`` on the profiler's timeline, on the clock of the kernels
and copies (``trace`` exports it), and goes into the recorder's last
``ROOTS`` roots, each with the ns and self ns (the ns less what its child
spans cover) of itself and of every span under it; ``snapshot()`` sums
them by name.

**Counters** are always on: ``h2d.bytes`` (the bytes ``stack_graphs``
hands to the model's device, whatever it is) and ``h2d.bytes_avoided``
(the bytes of prepared fields it left on the host: fields the model does
not read, and ``smask`` where the device builds it from ``sizes``; with
``h2d.bytes`` it sums to what stacking every field hands over), and
``aligned_t.bytes`` (the bytes of each T that ``contraction_level``
materialises).
``snapshot()`` also holds the counters as they stood when the first root
span under the profiler opened and when the latest one closed, so that a
reader can take the window's share.

A kernel's device time alone is taken with CUDA events behind a spin
kernel (``tools/measure.py:time_in_turns``); these functions time what the
host waits for.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

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


# -- the program's spans and counters ---------------------------------------

# How many root spans (steps or requests) the recorder keeps, the latest.
ROOTS = 8192

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """A span that closed under a root: its name, the id of that root, its
    ns, and its self ns (the ns less what its child spans cover)."""
    name: str
    root: int
    ns: int
    self_ns: int


class RootRecord(NamedTuple):
    """A root span (one step or request): its id, name, ns and self ns,
    and every span that closed under it, in the order they closed."""
    id: int
    name: str
    ns: int
    self_ns: int
    children: List[SpanRecord]


class Recorder:
    """Spans and counters of one process.  Spans are recorded only while
    a ``torch.profiler`` profile is active (``span`` checks); counters
    always.  The module's functions act on the process's ``RECORDER``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open = threading.local()
        self.reset()

    def reset(self) -> None:
        """Clear the counters, the roots and the window."""
        with self._lock:
            self.counters: Dict[str, int] = {}
            self.kept = collections.deque(maxlen=ROOTS)  # RootRecords
            # Counters as they stood when the first root opened and when
            # the latest closed.
            self.window = None
            self._ids = 0

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _close(self, s: "_Span", ns: int) -> None:
        stack = self._stack()
        stack.pop()
        self_ns = ns - s.child_ns
        with self._lock:
            if stack:
                stack[-1].child_ns += ns
                s.root.children.append(SpanRecord(s.name, s.root.id, ns,
                                                  self_ns))
            else:
                self.kept.append(RootRecord(s.id, s.name, ns, self_ns,
                                            s.children))
                if self.window is not None:  # else reset while it ran
                    self.window[1] = dict(self.counters)

    def roots(self, name: Optional[str] = None) -> List[RootRecord]:
        with self._lock:
            return [r for r in self.kept if name is None or r.name == name]

    def snapshot(self) -> dict:
        """{"counters": {name: n}, "spans": {name: {"count", "ns",
        "self_ns"}} summed over the kept roots, "window": {"start", "end"}
        counters or None}."""
        with self._lock:
            spans: Dict[str, Dict[str, int]] = {}
            for r in self.kept:
                for s in (r, *r.children):
                    row = spans.setdefault(
                        s.name, {"count": 0, "ns": 0, "self_ns": 0})
                    row["count"] += 1
                    row["ns"] += s.ns
                    row["self_ns"] += s.self_ns
            return {"counters": dict(self.counters), "spans": spans,
                    "window": (None if self.window is None else
                               {"start": self.window[0],
                                "end": self.window[1]})}


class _Span:
    """An open span under the profiler: a ``record_function`` on its
    timeline and an entry of the recorder."""

    __slots__ = ("rec", "name", "rf", "t0", "child_ns", "id", "root",
                 "children")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name, self.child_ns = rec, name, 0

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec = self.rec
        stack = rec._stack()
        if stack:
            self.root = stack[0]
        else:
            self.root, self.children = self, []
            with rec._lock:
                self.id = rec._ids
                rec._ids += 1
                if rec.window is None:
                    rec.window = [dict(rec.counters), None]
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec._close(self, time.perf_counter_ns() - self.t0)
        self.rf.__exit__(*exc)
        return False


RECORDER = Recorder()


def span(name: str):
    """A context manager around a layer of a step or request.  Without an
    active profiler it is a shared null context: one flag check, no
    ``record_function``."""
    if not _profiling():
        return _OFF
    return _Span(RECORDER, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    RECORDER.count(name, n)


def snapshot() -> dict:
    """The counters, the kept roots' span totals and the window's
    counters (``Recorder.snapshot``)."""
    return RECORDER.snapshot()


def roots(name: Optional[str] = None) -> List[RootRecord]:
    """The kept root spans, oldest first; of ``name`` only, if given."""
    return RECORDER.roots(name)


def tail(q: float, name: Optional[str] = None) -> List[RootRecord]:
    """The kept root spans (of ``name``, if given) longer than their
    ``q``-quantile."""
    rs = roots(name)
    if not rs:
        return []
    cut = np.quantile([r.ns for r in rs], q)
    return [r for r in rs if r.ns > cut]


def reset() -> None:
    """Clear the counters, the roots and the window."""
    RECORDER.reset()
