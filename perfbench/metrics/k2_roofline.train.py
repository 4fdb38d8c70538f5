"""K2's (kernels 0-2 as one backward) least time over its device time
in the training window, %."""

from perfbench import readers


def read(record):
    return readers.roofline_pct(record, "train", "bwd",
                                "k2_roofline.train")
