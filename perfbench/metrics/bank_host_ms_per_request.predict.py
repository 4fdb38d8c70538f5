"""Host milliseconds a request of the contraction bank with K (self time of
the program's span ``graphflow.level.bank``: the enqueue of the bank's
launches) in the traced window."""

from perfbench import program_spans


def read(record):
    return program_spans.self_ms_per_root(record, "predict",
                                          "graphflow.level.bank")
