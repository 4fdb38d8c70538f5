"""K1's least time over its device time in the training window, %."""

from perfbench import readers


def read(record):
    return readers.roofline_pct(record, "train", "fwd",
                                "k1_roofline.train")
