"""Device milliseconds of host-to-device copies a step (profiler)."""

from perfbench import readers


def read(record):
    return readers.h2d_ms(record, "train")
