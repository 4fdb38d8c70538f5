"""Host milliseconds a request of the program's stacking of the batch on
the host (self time of its span ``graphflow.stack.host``) in the traced
window; logs the requests above p95 by span."""

from perfbench import program_spans


def read(record):
    value = program_spans.self_ms_per_root(record, "predict",
                                           "graphflow.stack.host")
    if value is not None:
        program_spans.log_tail(record, "predict")
    return value
