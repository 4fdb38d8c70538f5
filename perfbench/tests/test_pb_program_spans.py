"""The readers of the program's own spans and counters
(``program_spans.py`` and its metrics): None where there is nothing to
read, the program's numbers on a tiny traced CPU run, a program span in
the trace's reduction, and the tail line's arithmetic."""

import types

import numpy as np
import pytest

from perfbench import harness, program_spans, trace
from perfbench.tests import tiny

SPANS = ("stack_host_ms_per_step.train", "stack_host_ms_per_request.predict",
         "h2d_bytes_per_graph.train", "h2d_bytes_per_graph.predict",
         "optimizer_host_ms_per_step.train", "step_p95_ms.train")
CELLS = ("omega_train_b64", "beta_train_b32", "omega_predict_b256")


def _cells_of(name):
    return next(m["workloads"] for m in harness.load_spec(CELLS[0]).per_layer
                + harness.load_spec(CELLS[2]).per_layer if m["name"] == name)


def _tiny_bytes_per_graph(cell):
    """Bytes a graph of the tiny cell's batch, from the prepared fields'
    shapes: what the program should hand to the device, which is every
    stacked field but a ``smask`` that the model names in its
    ``batch_fields`` (built on the device from ``sizes``)."""
    from perfbench import graphs
    from perfbench.drivers import common
    import torch

    s = tiny.spec(cell)
    pool, targets = graphs.make_pool(1, s.traffic)
    fam = harness.family(s)
    model, _, dense, _ = common.model_and_pool(fam, s.config, 1,
                                               torch.device("cpu"), pool)
    built = {"smask"} & set(model.batch_fields or ())
    per = sum(x.nbytes for k, x in model._stack(dense[:1]).items()
              if k not in built)
    return per + (4 if harness.driver(s).KIND == "train" else 0)


@pytest.fixture(scope="module")
def runs():
    """Each cell's tiny traced run: (record, every new reader's value, the
    program's snapshot and roots as the readers found them)."""
    from graphflow_tpu_torch.utils import profiling

    out = {}
    for cell in CELLS:
        profiling.reset()
        record, _ = tiny.run(cell, trace=True, seconds=0.3)
        values = {m: harness.reader(m)(record) for m in SPANS}
        out[cell] = (record, values, profiling.snapshot(),
                     profiling.roots())
    profiling.reset()
    return out


@pytest.mark.parametrize("name", SPANS)
def test_reader_reads_its_cells_only(runs, name):
    cells = _cells_of(name)
    for cell in CELLS:
        value = runs[cell][1][name]
        if cell in cells:
            assert value is not None and np.isfinite(value) and value > 0
        else:
            assert value is None, (name, cell)


@pytest.mark.parametrize("name", SPANS)
def test_reader_is_none_untraced(name):
    cell = _cells_of(name)[0]
    record, _ = tiny.run(cell, trace=False, seconds=0.1)
    assert harness.reader(name)(record) is None


@pytest.mark.parametrize("name", SPANS)
def test_reader_is_none_without_the_recorder(runs, name, monkeypatch):
    """A program that records no spans (the parent of this reader) gives
    nothing to read, and the reader raises nothing."""
    from graphflow_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    record = runs[_cells_of(name)[0]][0]
    assert harness.reader(name)(record) is None


@pytest.mark.parametrize("cell", CELLS)
def test_values_are_the_programs_numbers(runs, cell):
    record, values, snap, roots = runs[cell]
    kind = record["kind"]
    root = program_spans.ROOT[kind]
    spans = snap["spans"]
    steps = spans[root]["count"]
    assert steps == record["steps"] == len(roots)
    assert {r.name for r in roots} == {root}
    host = spans["graphflow.stack.host"]["self_ns"] / steps / 1e6
    w = snap["window"]
    grown = w["end"]["h2d.bytes"] - w["start"]["h2d.bytes"]
    assert grown == _tiny_bytes_per_graph(cell) * record["graphs"]
    if kind == "train":
        assert values["stack_host_ms_per_step.train"] == pytest.approx(host)
        assert values["h2d_bytes_per_graph.train"] == grown / record["graphs"]
        assert values["optimizer_host_ms_per_step.train"] == pytest.approx(
            spans["graphflow.optimizer"]["self_ns"] / steps / 1e6)
        assert (spans["graphflow.optimizer"]["self_ns"]
                < spans["graphflow.optimizer"]["ns"])
        assert values["step_p95_ms.train"] == pytest.approx(
            np.percentile([r.ns / 1e6 for r in roots], 95))
    else:
        assert values["stack_host_ms_per_request.predict"] == pytest.approx(
            host)
        assert values["h2d_bytes_per_graph.predict"] == (
            grown / record["graphs"])


def event(name, device, start, dur, kind, thread=1):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: types.SimpleNamespace(
            name=device), start_ns=lambda: start, duration_ns=lambda: dur,
        activity_type=lambda: kind, start_thread_id=lambda: thread)


def test_a_program_span_names_the_gap_and_its_mirror_is_no_work():
    ev = [event(trace.WINDOW, "CPU", 0, 1000, "user_annotation"),
          event("perfbench.step", "CPU", 0, 1000, "user_annotation"),
          event("graphflow.batch_learn", "CPU", 10, 980, "user_annotation"),
          event("graphflow.stack.host", "CPU", 100, 400, "user_annotation"),
          event("graphflow.stack.host", "CUDA", 100, 400,
                "gpu_user_annotation"),
          event("graphflow.batch_learn", "CUDA", 10, 980,
                "gpu_user_annotation"),
          event("k_a", "CUDA", 0, 100, "kernel"),
          event("k_b", "CUDA", 600, 400, "kernel")]
    s = trace.summarize(ev)
    assert abs(s["busy_s"] - 500e-9) < 1e-15      # the kernels alone
    names = dict(s["idle_gaps"])
    assert set(names) == {"graphflow.stack.host"}
    assert abs(names["graphflow.stack.host"] - 500e-9) < 1e-15


def _root(i, ns, children):
    from graphflow_tpu_torch.utils.profiling import RootRecord, SpanRecord

    kids = [SpanRecord(n, i, c, c) for n, c in children]
    return RootRecord(i, "graphflow.batch_learn", ns,
                      ns - sum(c for _, c in children), kids)


def test_tail_line_arithmetic():
    # Twenty steps of 10 ms (stack 2, forward 5, self 3); two of 30 ms, one
    # held 20 ms in the stack, the other 18 ms in the forward.
    from graphflow_tpu_torch.utils import profiling

    ms = 1_000_000
    roots = [_root(i, 10 * ms, [("graphflow.stack", 2 * ms),
                                ("graphflow.forward", 5 * ms)])
             for i in range(20)]
    roots.append(_root(20, 30 * ms, [("graphflow.stack", 22 * ms),
                                     ("graphflow.forward", 5 * ms)]))
    roots.append(_root(21, 30 * ms, [("graphflow.stack", 2 * ms),
                                     ("graphflow.forward", 23 * ms)]))
    profiling.reset()
    profiling.RECORDER.kept.extend(roots)
    tail = profiling.tail(0.9, "graphflow.batch_learn")
    profiling.reset()
    assert [r.id for r in tail] == [20, 21]
    line = program_spans.tail_line(roots, tail, 0.9, "step")
    assert line.startswith("2 of 22 steps above p90")
    assert "the median step's, 10.000 ms" in line
    assert "graphflow.batch_learn 4.000 (3.000)" in line
    assert "graphflow.stack 12.000 (2.000)" in line
    assert "graphflow.forward 14.000 (5.000)" in line
