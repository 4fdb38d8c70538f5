"""Graphs trained in the window over its seconds."""


def read(record):
    if record["kind"] != "train":
        return None
    return record["graphs"] / record["window_s"]
