"""Device kernels launched in the traced window over the steps."""

from perfbench import readers


def read(record):
    return readers.launches(record, "train")
