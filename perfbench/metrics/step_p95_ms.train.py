"""The 95th percentile of the traced window's step times (the program's
root span ``graphflow.batch_learn``; linear between order statistics);
logs the steps above it by span."""

from perfbench import program_spans


def read(record):
    return program_spans.root_p95_ms(record, "train")
