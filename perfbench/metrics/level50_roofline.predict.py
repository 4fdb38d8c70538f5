"""The ver7 level's least time (K7's aligned tensor, the 50-case bank and
K, by ``counts_ver7``) over the device time of every kernel of the traced
prediction window, copies left out (level 0, the head and the mask's
kernels are in it), %.  Only a family with K7 has such a level."""

from perfbench import harness, readers


def read(record):
    r = readers.traced(record, "predict")
    if r is None or r["work"] is None or "k7" not in record["kernels"]:
        return None
    seconds = sum(s for _, s in r["trace"]["kernels"].values())
    if not seconds:
        return None
    w = r["work"]["fwd"]
    side = "bytes" if w["bytes_s"] > w["ops_s"] else "operations"
    harness.log(f"level50_roofline.predict: {seconds:.6f} s of kernels, "
                f"levels bound {w['bound_s']:.6f} s, mostly by {side}; "
                f"{record.get('card', '')}")
    return 100.0 * w["bound_s"] / seconds
