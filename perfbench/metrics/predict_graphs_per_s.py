"""Graphs predicted in the window over its seconds."""


def read(record):
    if record["kind"] != "predict":
        return None
    return record["graphs"] / record["window_s"]
