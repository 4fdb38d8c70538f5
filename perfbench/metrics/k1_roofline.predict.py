"""K1's least time over its device time in the prediction window, %."""

from perfbench import readers


def read(record):
    return readers.roofline_pct(record, "predict", "fwd",
                                "k1_roofline.predict")
