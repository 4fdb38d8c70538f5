"""Seconds from the start of the process to the start of the window:
imports, kernel builds or loads, the pool and its host prep, the weights,
the followed steps or warm requests."""


def read(record):
    return record["setup_s"]
