"""The model's operations in the traced training window (two forwards
and a backward a BatchLearn step) over the window times the card's peak,
%."""

from perfbench import readers


def read(record):
    return readers.mfu_pct(record, "train")
