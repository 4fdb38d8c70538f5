"""The readers of the ver7 cell's own metrics: the program's T bytes and
bank span on a tiny traced CPU run, nothing where there is nothing to read
(an untraced run, another cell, a program without the span or counter, the
CPU for the device's metrics), and the device readers' arithmetic on a
record of the card's shape."""

import contextlib
import types

import pytest

from perfbench import harness
from perfbench.tests import tiny

CELL = "ver7_predict_b256"
SPANS = ("t_bytes_per_graph.predict", "bank_host_ms_per_request.predict")
DEVICE = ("level50_roofline.predict", "k7_ms_per_request.predict")


def _read(record):
    return {m: harness.reader(m)(record) for m in SPANS + DEVICE}


def _run(cell, **kw):
    """A tiny run in a recorder of its own, as a run's process has."""
    from graphflow_tpu_torch.utils import profiling

    profiling.reset()
    return tiny.run(cell, **kw)


@pytest.fixture(scope="module")
def traced():
    from graphflow_tpu_torch.utils import profiling

    record, _ = _run(CELL, trace=True, seconds=0.3)
    values = _read(record)
    snap = profiling.snapshot()
    profiling.reset()
    return record, values, snap


def test_the_cell_lists_its_metrics():
    names = {m["name"] for m in harness.load_spec(CELL).per_layer}
    assert set(SPANS + DEVICE) <= names
    assert "k1_roofline.predict" not in names


def test_t_bytes_are_every_level_s_t(traced):
    """Each graph's V rows, at the tiny cut's P and C, float32, twice."""
    record, values, snap = traced
    cfg = tiny.spec(CELL).config
    per_level = (cfg["max_nVertices"] * cfg["max_receptive_field"] ** 3
                 * cfg["nChanels"] * 4)
    assert values["t_bytes_per_graph.predict"] == cfg["nLevels"] * per_level
    w = snap["window"]
    assert (w["end"]["aligned_t.bytes"] - w["start"]["aligned_t.bytes"]
            == record["graphs"] * cfg["nLevels"] * per_level)


def test_bank_host_ms_is_the_span_s_self_time(traced):
    record, values, snap = traced
    spans = snap["spans"]
    requests = spans["graphflow.predict"]["count"]
    assert requests == record["steps"]
    assert spans["graphflow.level.bank"]["count"] == 2 * requests
    assert values["bank_host_ms_per_request.predict"] == pytest.approx(
        spans["graphflow.level.bank"]["self_ns"] / requests / 1e6)
    assert values["bank_host_ms_per_request.predict"] > 0


def test_device_readers_read_nothing_on_the_cpu(traced):
    _, values, _ = traced
    assert all(values[m] is None for m in DEVICE)


def test_nothing_untraced_or_in_another_cell():
    record, _ = _run(CELL, trace=False, seconds=0.1)
    assert set(_read(record).values()) == {None}
    record, _ = _run("omega_predict_b256", trace=True, seconds=0.1)
    assert set(_read(record).values()) == {None}


def test_nothing_from_a_program_without_the_span_or_counter(monkeypatch):
    """The parent's program: its contraction level records neither."""
    from graphflow_tpu_torch.models import smp2d

    monkeypatch.setattr(smp2d, "profiling", types.SimpleNamespace(
        span=lambda name: contextlib.nullcontext(),
        count=lambda name, n=1: None))
    record, out = _run(CELL, trace=True, seconds=0.1)
    assert out["correct"]
    assert all(_read(record)[m] is None for m in SPANS)


def _card_record(kernels):
    work = {"fwd": {"bound_s": 0.004, "bytes_s": 0.001, "ops_s": 0.004},
            "bwd": {"bound_s": 0.0, "bytes_s": 0.0, "ops_s": 0.0},
            "model_ops": 1.0, "batches": 4, "levels": 2,
            "peak_flops": 495e12}
    trace = {"window_s": 1.0, "busy_s": 0.5, "kernels": kernels,
             "copies": {"Memcpy HtoD (Pageable -> Device)": [8, 0.3]}}
    return {"kind": "predict", "platform": "gpu", "graphs": 1024,
            "kernels": {"k7": ("risi_aligned_t2_kernel",)},
            "ranks": [{"trace": trace, "work": work, "steps": 4}]}


def test_device_readers_arithmetic():
    """Least time over every kernel's time, copies left out; K7's time a
    request."""
    record = _card_record({
        "void (anonymous namespace)::risi_aligned_t2_kernel<float, uint4>("
        "float const*, int const*, int const*, float*, int, int, int)":
            [8, 0.02],
        "ampere_sgemm_128x64_nn": [400, 0.3],
        "reduce_kernel": [200, 0.08]})
    values = _read(record)
    assert values["level50_roofline.predict"] == pytest.approx(
        100 * 0.004 / 0.4)
    assert values["k7_ms_per_request.predict"] == pytest.approx(
        1e3 * 0.02 / 4)


def test_device_readers_without_k7():
    """A family without K7, or a window in which it never ran."""
    record = _card_record({"ampere_sgemm_128x64_nn": [400, 0.3]})
    assert _read(record)["k7_ms_per_request.predict"] is None
    record["kernels"] = {"k1": ("risi18_level_kernel",)}
    assert _read(record)["level50_roofline.predict"] is None
