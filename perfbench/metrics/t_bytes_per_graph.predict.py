"""Bytes of the aligned tensors T the program materialises a graph
predicted in the traced window (its counter ``aligned_t.bytes``)."""

from perfbench import program_spans


def read(record):
    grown = program_spans.window_growth(record, "predict", "aligned_t.bytes")
    if grown is None or not record["graphs"]:
        return None
    return grown / record["graphs"]
