"""Host milliseconds a step of the program's stacking of the batch on the
host (self time of its span ``graphflow.stack.host``) in the traced
window."""

from perfbench import program_spans


def read(record):
    return program_spans.self_ms_per_root(record, "train", "graphflow.stack.host")
