"""Device milliseconds of host-to-device copies a request (profiler)."""

from perfbench import readers


def read(record):
    return readers.h2d_ms(record, "predict")
