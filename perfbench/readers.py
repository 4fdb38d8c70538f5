"""What the metric readers (``metrics/<name>.py``) share.  A reader takes
the run's record and returns a number, or None where it finds nothing to
read (the metric is then left out of the result line)."""

from __future__ import annotations

from perfbench import harness, trace


def traced(record: dict, kind: str):
    """The traced process that device metrics read (of several, the one
    idle longest), or None in an untraced run or another kind of cell."""
    if record["kind"] != kind or record["platform"] != "gpu":
        return None
    r = harness.busiest_idle(record)
    return r if r.get("trace") else None


def launches(record, kind):
    r = traced(record, kind)
    if r is None:
        return None
    return sum(c for c, _ in r["trace"]["kernels"].values()) / r["steps"]


def h2d_ms(record, kind):
    r = traced(record, kind)
    if r is None:
        return None
    seconds = sum(s for name, (_, s) in r["trace"]["copies"].items()
                  if "HtoD" in name)
    return 1e3 * seconds / r["steps"]


def idle_pct(record, kind):
    r = traced(record, kind)
    if r is None:
        return None
    t = r["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(record, kind, which, name):
    """The least time of the window's launches of a level kernel (by bytes
    or by operations, launch by launch; ``counts``) over their device
    time.  ``which``: "fwd" (K1) or "bwd" (K2, its kernels 0-2 as one
    backward, counted by its kernel 1's launches)."""
    r = traced(record, kind)
    if r is None or r["work"] is None:
        return None
    k = record["kernels"]
    time_names = k["k1"] if which == "fwd" else k["k2"]
    count_names = k["k1"] if which == "fwd" else k["k2_launch"]
    launches_, _ = trace.match(r["trace"]["kernels"], count_names)
    _, seconds = trace.match(r["trace"]["kernels"], time_names)
    if not launches_ or not seconds:
        return None
    w = r["work"]
    scale = launches_ / (w["batches"] * w["levels"])
    side = ("bytes" if w[which]["bytes_s"] > w[which]["ops_s"]
            else "operations")
    harness.log(f"{name}: {launches_} launches, {seconds:.6f} s on the "
                f"device, bound {w[which]['bound_s'] * scale:.6f} s, mostly "
                f"by {side}; {record.get('card', '')}")
    return 100.0 * w[which]["bound_s"] * scale / seconds


def mfu_pct(record, kind):
    """The model's operations in the traced window over the window times
    the peak, summed over the ranks."""
    if record["kind"] != kind or record["platform"] != "gpu":
        return None
    ranks = [r for r in record["ranks"] if r.get("trace") and r.get("work")]
    if not ranks:
        return None
    ops = sum(r["work"]["model_ops"] for r in ranks)
    cap = sum(r["trace"]["window_s"] * r["work"]["peak_flops"] for r in ranks)
    return 100.0 * ops / cap

