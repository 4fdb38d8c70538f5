"""What the readers of the program's own spans and counters share.

The program (``graphflow_tpu_torch.utils.profiling``) records its spans
while a ``torch.profiler`` profile is active, which in a traced run is the
window, and keeps its counters always; a reader reads them in the run's
own process, after the window.  Each function returns None in an untraced
run, in a cell of another kind, or where the program records no such span
or counter (a program without the recorder).
"""

from __future__ import annotations

import numpy as np

from perfbench import harness

# The root span of each kind of cell: one step or one request.
ROOT = {"train": "graphflow.batch_learn", "predict": "graphflow.predict"}
WHAT = {"train": "step", "predict": "request"}


def recorder(record: dict, kind: str):
    """The program's profiling module in a traced run of ``kind``, or
    None."""
    if record["kind"] != kind:
        return None
    if not any(r.get("trace") for r in record["ranks"]):
        return None
    try:
        from graphflow_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("snapshot", "roots", "tail")):
        return None
    return profiling


def self_ms_per_root(record: dict, kind: str, span: str):
    """Self milliseconds of ``span`` (its time less its child spans') over
    the window's roots (steps or requests)."""
    prof = recorder(record, kind)
    if prof is None:
        return None
    spans = prof.snapshot()["spans"]
    roots = spans.get(ROOT[kind], {}).get("count", 0)
    if not roots or span not in spans:
        return None
    return spans[span]["self_ns"] / roots / 1e6


def window_growth(record: dict, kind: str, counter: str):
    """How much ``counter`` grew over the window: from its first root's
    start to its last root's end."""
    prof = recorder(record, kind)
    w = None if prof is None else prof.snapshot()["window"]
    if w is None or w["end"] is None or counter not in w["end"]:
        return None
    return w["end"][counter] - w["start"].get(counter, 0)


def root_p95_ms(record: dict, kind: str):
    """The 95th percentile of the window's roots in ms (linear between
    order statistics); logs the tail line."""
    prof = recorder(record, kind)
    roots = [] if prof is None else prof.roots(ROOT[kind])
    if not roots:
        return None
    log_tail(record, kind)
    return float(np.percentile([r.ns / 1e6 for r in roots], 95))


def self_ms_by_span(root) -> dict:
    """{span name: self ms} of one root and the spans under it."""
    out = {root.name: root.self_ns / 1e6}
    for c in root.children:
        out[c.name] = out.get(c.name, 0.0) + c.self_ns / 1e6
    return out


def tail_line(roots, tail, q: float, what: str) -> str:
    """One line on ``tail``, the roots above the ``q``-quantile of
    ``roots``: the mean self ms of each span in them, beside the median
    root's, so that a stalled step or request names the layer that held
    it."""
    median = sorted(roots, key=lambda r: r.ns)[len(roots) // 2]
    mid = self_ms_by_span(median)
    mean = {}
    for r in tail:
        for name, ms in self_ms_by_span(r).items():
            mean[name] = mean.get(name, 0.0) + ms / len(tail)
    names = list(mid) + [n for n in mean if n not in mid]
    parts = ", ".join(f"{n} {mean.get(n, 0.0):.3f} ({mid.get(n, 0.0):.3f})"
                      for n in names)
    return (f"{len(tail)} of {len(roots)} {what}s above p{100 * q:g}; self "
            f"ms by span, their mean (the median {what}'s, "
            f"{median.ns / 1e6:.3f} ms): {parts}")


def log_tail(record: dict, kind: str, q: float = 0.95) -> None:
    prof = recorder(record, kind)
    roots = [] if prof is None else prof.roots(ROOT[kind])
    if roots:
        harness.log(tail_line(roots, prof.tail(q, ROOT[kind]), q,
                              WHAT[kind]))


def h2d_bytes_per_graph(record: dict, kind: str):
    """``h2d.bytes`` grown over the window over its graphs."""
    grown = window_growth(record, kind, "h2d.bytes")
    if grown is None or not record["graphs"]:
        return None
    return grown / record["graphs"]
