"""Host milliseconds a step of the program's optimizer update, less its
waits for the device (self time of its span ``graphflow.optimizer``: the
enqueue of Adam, without ``graphflow.optimizer.wait``, the step count's
copies that wait for the backward's kernels) in the traced window."""

from perfbench import program_spans


def read(record):
    return program_spans.self_ms_per_root(record, "train",
                                          "graphflow.optimizer")
