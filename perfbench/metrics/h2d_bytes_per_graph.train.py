"""Bytes the program hands to the device a graph trained in the traced
window (its counter ``h2d.bytes``)."""

from perfbench import program_spans


def read(record):
    return program_spans.h2d_bytes_per_graph(record, "train")
