"""The port's spans and counters (``graphflow_tpu_torch/utils/profiling.py``)
and the layer boundaries that record them: ``GraphModel.BatchLearn`` and
``_run``, ``stack_graphs`` field by field, Adam's wait for the device, and
the gather and bank of a 4-, 10- or 50-case level with the bytes of its T.
CPU only: the profiler traces the host here, which is all a span needs."""

import contextlib
import json

import numpy as np
import pytest
import torch

from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
from graphflow_tpu_torch.utils import datasets, profiling

torch.set_num_threads(1)

CFG = dict(max_nVertices=10, max_receptive_field=4, nLevels=2, nChanels=6,
           nFeatures=4, nDepth=3)
# The spans under a root, a span of each field stacked (the tiny model
# stacks the 6 it hands over: its batch_fields less smask, and sizes) and
# handed over, one for smask's build on the device and one for nVertices
# and the targets; a wait of Adam's for each of the 6 leaves of its
# schedule.
FIELDS = 6
STEP_CHILDREN = {"graphflow.stack": 1, "graphflow.stack.host": FIELDS,
                 "graphflow.stack.h2d": FIELDS + 2, "graphflow.forward": 2,
                 "graphflow.backward": 1, "graphflow.optimizer": 1,
                 "graphflow.optimizer.wait": 6, "graphflow.readback": 2}
REQUEST_CHILDREN = {"graphflow.stack": 1, "graphflow.stack.host": FIELDS,
                    "graphflow.stack.h2d": FIELDS + 2,
                    "graphflow.forward": 1, "graphflow.readback": 1}
# The span directly over each span that is not directly under the root.
PARENT = {"graphflow.stack.host": "graphflow.stack",
          "graphflow.stack.h2d": "graphflow.stack",
          "graphflow.optimizer.wait": "graphflow.optimizer"}


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _model(dtype="float32", contraction=18):
    return SMP2D(SMP2DConfig(**CFG, dtype=dtype, contraction=contraction),
                 seed=1, device="cpu")


def _graphs(n=4):
    return [datasets.random_graph(6 + i % 4, 0.4, seed=i) for i in range(n)]


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _unspanned(graphs, targets=None, device=None, dtype=None):
    """``stack_graphs`` as it was before its spans and counter."""
    batch = {}
    for f in batching.STACK_FIELDS:
        vals = [getattr(g, f) for g in graphs]
        if any(v is None for v in vals):
            continue
        if f.startswith("ell_") and len({v.shape[1] for v in vals}) > 1:
            vals = batching._pad_ell(f, vals)
        x = torch.from_numpy(np.stack(vals)).to(device)
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        batch[f] = x
    batch["nVertices"] = torch.tensor([g.nVertices for g in graphs],
                                      dtype=torch.int32, device=device)
    if targets is not None:
        batch["target"] = torch.as_tensor(
            np.asarray(targets, dtype=np.float32), device=device)
    return batch


def test_off_span_records_nothing_and_builds_no_record_function(
        clean, monkeypatch):
    built = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: built.append(name))
    assert not torch._C._autograd._profiler_enabled()
    with profiling.span("graphflow.batch_learn") as outer:
        with profiling.span("graphflow.forward") as inner:
            pass
    assert outer is None and inner is None
    assert profiling.span("a") is profiling.span("b")   # one shared context
    assert built == []
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["window"] is None
    assert profiling.roots() == [] and profiling.tail(0.5) == []


def test_counters_are_always_on(clean):
    profiling.count("c", 3)
    profiling.count("c")
    assert profiling.snapshot()["counters"] == {"c": 4}
    profiling.reset()
    assert profiling.snapshot()["counters"] == {}


def _children(root):
    names = {}
    for c in root.children:
        names[c.name] = names.get(c.name, 0) + 1
    return names


def test_batch_learn_records_its_root_and_each_child(clean):
    model, graphs = _model(), _graphs()
    for g in graphs:
        model.prepare(g)
    with _profile() as prof:
        model.BatchLearn(graphs, np.arange(4.0), 1e-3)
    (root,) = profiling.roots()
    assert root.name == "graphflow.batch_learn"
    assert _children(root) == STEP_CHILDREN
    assert all(c.root == root.id for c in root.children)
    spans = profiling.snapshot()["spans"]
    assert spans["graphflow.batch_learn"]["count"] == 1
    for name, n in STEP_CHILDREN.items():
        assert spans[name]["count"] == n
    # The spans are on the profiler's own timeline.
    names = {e.key for e in prof.key_averages()}
    assert {"graphflow.batch_learn", *STEP_CHILDREN} <= names


@pytest.mark.parametrize("call", ["Threaded_Predict", "Predict", "Feature"])
def test_a_request_is_one_predict_root(clean, call):
    model, graphs = _model(), _graphs()
    with _profile():
        if call == "Threaded_Predict":
            out = model.Threaded_Predict(graphs)
            assert out.shape == (4,)
        else:
            getattr(model, call)(graphs[0])
    (root,) = profiling.roots()
    assert root.name == "graphflow.predict"
    assert _children(root) == REQUEST_CHILDREN
    assert all(c.root == root.id for c in root.children)


def test_roots_carry_their_own_ids(clean):
    model, graphs = _model(), _graphs()
    with _profile():
        model.BatchLearn(graphs[:2], [1.0, 2.0], 1e-3)
        model.Threaded_Predict(graphs)
    a, b = profiling.roots()
    assert a.id != b.id
    assert {c.root for c in a.children} == {a.id}
    assert {c.root for c in b.children} == {b.id}
    assert profiling.roots("graphflow.predict") == [b]


def test_self_time_is_the_total_less_the_children(clean):
    model, graphs = _model(), _graphs()
    with _profile():
        model.BatchLearn(graphs, np.arange(4.0), 1e-3)
    (root,) = profiling.roots()
    direct = sum(c.ns for c in root.children if c.name not in PARENT)
    assert root.self_ns == root.ns - direct >= 0
    for name in set(PARENT.values()):
        (c,) = [c for c in root.children if c.name == name]
        under = sum(k.ns for k in root.children if PARENT.get(k.name) == name)
        assert c.self_ns == c.ns - under >= 0
    for c in root.children:
        if c.name not in PARENT.values():
            assert c.self_ns == c.ns
    spans = profiling.snapshot()["spans"]
    assert spans["graphflow.batch_learn"]["self_ns"] == root.self_ns
    assert spans["graphflow.batch_learn"]["ns"] == root.ns


def test_nested_spans_self_time_exactly(clean):
    with _profile():
        with profiling.span("r"):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                pass
    (root,) = profiling.roots()
    by = {}
    for c in root.children:
        by.setdefault(c.name, []).append(c)
    (a,), (c,), bs = by["a"], by["c"], by["b"]
    assert a.self_ns == a.ns - sum(b.ns for b in bs)
    assert root.self_ns == root.ns - a.ns - c.ns
    spans = profiling.snapshot()["spans"]
    assert spans["b"]["count"] == 2
    assert spans["b"]["ns"] == sum(b.ns for b in bs)


@pytest.mark.parametrize("model_fields", [False, True])
@pytest.mark.parametrize("targets", [None, [0.5, 1.5, 2.5, 3.5]])
def test_h2d_bytes_are_the_batch_bytes(clean, targets, model_fields):
    """The bytes of the batch's fields that crossed: every value, but
    ``smask`` where the device built it from ``sizes``."""
    model = _model()
    pgs = [model.prepare(g) for g in _graphs()]
    fields = model.batch_fields if model_fields else None
    profiling.reset()
    batch = batching.stack_graphs(pgs, targets, device="cpu", fields=fields)
    built = {"smask"} if model_fields else set()
    counters = profiling.snapshot()["counters"]
    assert counters["h2d.bytes"] == sum(x.nbytes for k, x in batch.items()
                                        if k not in built)
    assert ("target" in batch) == (targets is not None)


def test_window_counters_span_the_roots_under_the_profiler(clean):
    model, graphs = _model(), _graphs()
    model.BatchLearn(graphs, np.arange(4.0), 1e-3)     # before: not counted
    before = profiling.snapshot()["counters"]["h2d.bytes"]
    with _profile():
        model.BatchLearn(graphs, np.arange(4.0), 1e-3)
        model.BatchLearn(graphs, np.arange(4.0), 1e-3)
    model.BatchLearn(graphs, np.arange(4.0), 1e-3)     # after: not counted
    w = profiling.snapshot()["window"]
    assert w["start"]["h2d.bytes"] == before
    assert w["end"]["h2d.bytes"] - w["start"]["h2d.bytes"] == 2 * before


def _prepared_sets():
    model = _model()
    dense = [model.prepare(g) for g in _graphs()]
    sparse = [prep.prepare_graph_sparse(
        datasets.random_graph(8, p, seed=4), 10) for p in (0.2, 0.7)]
    assert sparse[0].ell_nbr.shape[1] < sparse[1].ell_nbr.shape[1]
    return {"dense": dense, "ell": sparse}


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("with_targets", [False, True])
@pytest.mark.parametrize("traced", [False, True])
def test_spanned_stack_equals_unspanned(clean, kind, dtype, with_targets,
                                        traced):
    pgs = _prepared_sets()[kind]
    targets = np.linspace(0.0, 1.0, len(pgs)) if with_targets else None
    with _profile() if traced else contextlib.nullcontext():
        got = batching.stack_graphs(pgs, targets, device="cpu", dtype=dtype)
    assert bool(profiling.roots()) == traced
    ref = _unspanned(pgs, targets, device="cpu", dtype=dtype)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k


def test_tail_is_the_roots_above_the_quantile(clean):
    rec = profiling.RECORDER
    for i, ns in enumerate([5, 1, 9, 3, 7]):
        rec.kept.append(profiling.RootRecord(i, "r", ns, ns, []))
    rec.kept.append(profiling.RootRecord(5, "s", 100, 100, []))
    assert [r.ns for r in profiling.tail(0.5, "r")] == [9, 7]
    assert [r.id for r in profiling.tail(0.6)] == [2, 5]   # above 7
    assert [r.id for r in profiling.roots("s")] == [5]


def test_roots_keep_the_latest(clean):
    with _profile():
        for _ in range(profiling.ROOTS + 3):
            with profiling.span("r"):
                pass
    rs = profiling.roots()
    assert len(rs) == profiling.ROOTS
    assert rs[0].id == 3 and rs[-1].id == profiling.ROOTS + 2
    assert profiling.snapshot()["spans"]["r"]["count"] == profiling.ROOTS


def test_trace_exports_the_program_spans(clean, tmp_path):
    model, graphs = _model(), _graphs()
    with profiling.trace(str(tmp_path)):
        model.Threaded_Predict(graphs)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"graphflow.predict", *REQUEST_CHILDREN} <= names


LEVEL_SPANS = ("graphflow.level.gather", "graphflow.level.bank")


def _t_bytes(n_graphs, levels=CFG["nLevels"]):
    """The bytes of the T [B*V, P, P, P, C] of every level, float32."""
    P = CFG["max_receptive_field"]
    return (levels * n_graphs * CFG["max_nVertices"] * P ** 3
            * CFG["nChanels"] * 4)


@pytest.mark.parametrize("contraction", [4, 10, 50])
def test_a_contraction_level_spans_its_gather_and_bank(clean, contraction):
    """Once a level each, inside ``graphflow.forward``: the forward's self
    time is its time less theirs."""
    model, graphs = _model(contraction=contraction), _graphs()
    with _profile() as prof:
        model.Threaded_Predict(graphs)
    (root,) = profiling.roots()
    kids = _children(root)
    assert kids == dict(REQUEST_CHILDREN, **{
        s: CFG["nLevels"] for s in LEVEL_SPANS})
    (fwd,) = [c for c in root.children if c.name == "graphflow.forward"]
    under = sum(c.ns for c in root.children if c.name in LEVEL_SPANS)
    assert fwd.self_ns == fwd.ns - under >= 0
    assert root.self_ns == root.ns - sum(
        c.ns for c in root.children
        if c.name not in LEVEL_SPANS and c.name not in PARENT)
    assert set(LEVEL_SPANS) <= {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("contraction", [4, 10, 50])
def test_aligned_t_bytes_count_each_level_s_t(clean, contraction, traced):
    """N * P^3 * C * 4 bytes a level, profiler or not."""
    model, graphs = _model(contraction=contraction), _graphs()
    with _profile() if traced else contextlib.nullcontext():
        model.Threaded_Predict(graphs)
    assert profiling.snapshot()["counters"]["aligned_t.bytes"] == _t_bytes(
        len(graphs))


def test_a_ver7_step_spans_both_forwards(clean):
    """A BatchLearn step of the 50-case model (the take-gather) gathers
    and contracts in its two forwards."""
    model, graphs = _model(contraction=50), _graphs()
    with _profile():
        model.BatchLearn(graphs, np.arange(4.0), 1e-3)
    (root,) = profiling.roots()
    kids = _children(root)
    for s in LEVEL_SPANS:
        assert kids[s] == 2 * CFG["nLevels"]
    assert profiling.snapshot()["counters"]["aligned_t.bytes"] == _t_bytes(
        len(graphs), 2 * CFG["nLevels"])


@pytest.mark.parametrize("call", ["Threaded_Predict", "BatchLearn"])
def test_smp_omega_records_no_level_span_or_t(clean, call):
    model, graphs = _model(), _graphs()
    with _profile():
        if call == "BatchLearn":
            model.BatchLearn(graphs, np.arange(4.0), 1e-3)
        else:
            model.Threaded_Predict(graphs)
    assert not set(LEVEL_SPANS) & set(profiling.snapshot()["spans"])
    assert "aligned_t.bytes" not in profiling.snapshot()["counters"]
