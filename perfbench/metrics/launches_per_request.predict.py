"""Device kernels launched in the traced window over the requests."""

from perfbench import readers


def read(record):
    return readers.launches(record, "predict")
