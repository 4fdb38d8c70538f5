"""The 95th percentile of every request's latency in the window, from the
call to the returned NumPy array (linear between order statistics)."""

import numpy as np


def read(record):
    if record["kind"] != "predict":
        return None
    return float(np.percentile(np.asarray(record["latencies_s"]) * 1e3, 95))
