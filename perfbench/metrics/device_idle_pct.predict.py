"""100 - the union of device activity over the traced prediction window, %."""

from perfbench import readers


def read(record):
    return readers.idle_pct(record, "predict")
