"""100 - the union of device activity over the traced training window, %."""

from perfbench import readers


def read(record):
    return readers.idle_pct(record, "train")
