"""Host milliseconds a graph of the program's prep (``model.prepare``)
over the pool in set-up, on the benchmark's clock."""


def read(record):
    return 1e3 * record["prep_s"] / record["prep_graphs"]
