"""The model's operations in the traced prediction window (a forward a
request) over the window times the card's peak, %."""

from perfbench import readers


def read(record):
    return readers.mfu_pct(record, "predict")
