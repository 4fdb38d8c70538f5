"""Device milliseconds of K7 (the aligned tensor's kernel) a request in
the traced prediction window (profiler)."""

from perfbench import readers, trace


def read(record):
    r = readers.traced(record, "predict")
    names = record["kernels"].get("k7")
    if r is None or not names:
        return None
    launches, seconds = trace.match(r["trace"]["kernels"], names)
    if not launches:
        return None
    return 1e3 * seconds / r["steps"]
