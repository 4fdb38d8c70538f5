"""What a batch hands to the device (``core/batching.py:stack_graphs``'s
``fields``, ``GraphModel.batch_fields``): a model that declares the fields
its forward reads stacks only those and builds ``smask`` on the device from
``sizes``; its predictions, loss and gradients are the full batch's bit for
bit, and the byte counters say what crossed and what stayed on the host.
A field missing from a declaration shows as a ``KeyError`` here."""

import functools

import numpy as np
import pytest
import torch

from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.models import (GCN_1D, SMP1D, SMP1DConfig, SMP2D,
                                        SMP2DConfig, SMP2DSteerable,
                                        SMP2DSteerableConfig)
from graphflow_tpu_torch.utils import datasets, profiling

torch.set_num_threads(1)

V, P = 10, 4
SMALL = dict(max_nVertices=V, nLevels=2, nChanels=4, nFeatures=4, nDepth=3)
MODELS = {
    "smp2d": lambda dt: SMP2D(SMP2DConfig(**SMALL, max_receptive_field=P,
                                          dtype=dt), seed=1, device="cpu"),
    "smp2d_beta": lambda dt: SMP2D(SMP2DConfig(
        **SMALL, max_receptive_field=None, dtype=dt), seed=2, device="cpu"),
    "smp1d": lambda dt: SMP1D(SMP1DConfig(**SMALL, max_receptive_field=P,
                                          dtype=dt), seed=3, device="cpu"),
    "smp1d_sparse": lambda dt: SMP1D(SMP1DConfig(
        **SMALL, max_receptive_field=P, sparse_max_degree=V, dtype=dt),
        seed=4, device="cpu"),
    "steerable": lambda dt: SMP2DSteerable(SMP2DSteerableConfig(
        **SMALL, dtype=dt), seed=5, device="cpu"),
}
# fit_bucketed pads a bucket to its boundary: the models whose _prepare
# takes pad_nVertices and whose P is a cap that does not follow V.
PADDABLE = ("smp2d", "smp1d", "smp1d_sparse")
CASES = [(m, dt, route, pad)
         for m in MODELS for dt in ("float32", "bfloat16")
         for route in ("native", "numpy")
         for pad in ((None, 8) if m in PADDABLE else (None,))]
TARGETS = [0.5, -1.0, 2.0, 0.25]


@pytest.fixture
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _graphs(most=V):
    """Four graphs of fewer vertices than ``most``: every batch has padding
    vertices (sizes 0)."""
    return [datasets.random_graph(5 + i % (most - 4), 0.4, seed=10 + i)
            for i in range(4)]


def _numpy_prep(monkeypatch):
    monkeypatch.setattr(prep, "prepare_graph", functools.partial(
        prep.prepare_graph, backend="python"))


def _both(model, pgs, targets=None):
    """(the full batch, the batch of the model's fields)."""
    kw = dict(device=model.device, dtype=model.dtype)
    return (batching.stack_graphs(pgs, targets, **kw),
            batching.stack_graphs(pgs, targets, fields=model.batch_fields,
                                  **kw))


@pytest.mark.parametrize("name,dtype,route,pad", CASES)
def test_declared_fields_give_the_full_batch_bit_for_bit(
        clean, monkeypatch, name, dtype, route, pad):
    if route == "numpy":
        _numpy_prep(monkeypatch)
    model = MODELS[name](dtype)
    assert model.batch_fields is not None
    graphs = _graphs(pad or V)
    pgs = [model._prepare(g, pad_nVertices=pad) if pad else model.prepare(g)
           for g in graphs]
    full, part = _both(model, pgs, TARGETS)
    assert set(part) < set(full)
    for k, x in part.items():
        assert x.dtype == full[k].dtype and torch.equal(x, full[k]), k
    with torch.no_grad():
        for a, b in zip(model._forward(model.params, full),
                        model._forward(model.params, part)):
            assert torch.equal(a, b)
    loss, grads = model._loss_and_grads(full)
    loss_p, grads_p = model._loss_and_grads(part)
    assert loss == loss_p
    assert list(grads) == list(grads_p)
    for k, g in grads.items():
        assert torch.equal(g, grads_p[k]), k


@pytest.mark.parametrize("name", list(MODELS) + ["gcn_1d"])
def test_stack_hands_over_the_models_fields(clean, name):
    """``_stack`` stacks ``batch_fields`` (every field where a model
    declares none) and the requests it serves read that batch."""
    model = (GCN_1D(2, V, 4, 4, 2, 2, device="cpu") if name == "gcn_1d"
             else MODELS[name]("float32"))
    graphs = _graphs()
    full, part = _both(model, [model.prepare(g) for g in graphs], TARGETS)
    got = model._stack(graphs, TARGETS)
    assert list(got) == list(full if model.batch_fields is None else part)
    for k, x in got.items():
        assert torch.equal(x, full[k]), k
    with torch.no_grad():
        ref = model._forward(model.params, full)[0]
    assert np.array_equal(model.Threaded_Predict(graphs),
                          ref.float().numpy())


@pytest.mark.parametrize("route", ["native", "python", "fo_degree"])
@pytest.mark.parametrize("cap", [P, None])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16, torch.float64])
def test_device_smask_is_the_hosts(clean, route, cap, dtype):
    kw = dict(backend="python") if route == "python" else {}
    if route == "fo_degree":
        kw = dict(fo_degree=V)
    pgs = [prep.prepare_graph(g, 2, V, cap, 3, **kw) for g in _graphs()]
    assert any((pg.sizes == 0).any() for pg in pgs)
    full = batching.stack_graphs(pgs, device="cpu", dtype=dtype)
    got = batching.stack_graphs(pgs, device="cpu", dtype=dtype,
                                fields=("smask",))
    assert set(got) == {"sizes", "smask", "nVertices"}
    assert got["smask"].dtype == full["smask"].dtype
    assert torch.equal(got["smask"], full["smask"])
    assert torch.equal(got["smask"], batching.smask_from_sizes(
        torch.from_numpy(np.stack([pg.sizes for pg in pgs])),
        pgs[0].smask.shape[-1], full["smask"].dtype))


# Bytes a graph at the benchmark's shapes (V 40, 28 features, WL depth 5,
# two levels): wl_feat, vmask, sizes, nbr, pos and radj, then nVertices
# and the target.  P = 16 (SMP_omega) and P = V = 40 (SMP_beta).
@pytest.mark.parametrize("cap,per_graph", [(16, 196_488), (None, 1_064_328)])
@pytest.mark.parametrize("with_targets", [False, True])
def test_h2d_bytes_at_the_benchmark_shapes(clean, cap, per_graph,
                                           with_targets):
    model = SMP2D(SMP2DConfig(max_nVertices=40, max_receptive_field=cap,
                              nLevels=2, nChanels=4, nFeatures=28,
                              nDepth=5), device="cpu")
    graphs = [datasets.random_graph(n, 0.15, nFeatures=28, seed=n)
              for n in (9, 37)]
    model._stack(graphs, [1.0, 2.0] if with_targets else None)
    n = profiling.snapshot()["counters"]["h2d.bytes"]
    assert n == 2 * (per_graph - (0 if with_targets else 4))


@pytest.mark.parametrize("name", list(MODELS) + ["gcn_1d"])
@pytest.mark.parametrize("with_targets", [False, True])
def test_bytes_and_bytes_avoided_sum_to_the_full_count(clean, name,
                                                       with_targets):
    model = (GCN_1D(2, V, 4, 4, 2, 2, device="cpu") if name == "gcn_1d"
             else MODELS[name]("float32"))
    pgs = [model.prepare(g) for g in _graphs()]
    targets = TARGETS if with_targets else None
    batching.stack_graphs(pgs, targets, device="cpu", dtype=model.dtype)
    before = profiling.snapshot()["counters"]
    assert before["h2d.bytes_avoided"] == 0
    profiling.reset()
    batching.stack_graphs(pgs, targets, device="cpu", dtype=model.dtype,
                          fields=model.batch_fields)
    after = profiling.snapshot()["counters"]
    assert (after["h2d.bytes"] + after["h2d.bytes_avoided"]
            == before["h2d.bytes"])
    assert (after["h2d.bytes_avoided"] > 0) == (model.batch_fields
                                                is not None)


def test_unknown_field_is_refused():
    pgs = [prep.prepare_graph(g, 2, V, P, 3) for g in _graphs()]
    with pytest.raises(ValueError, match="STACK_FIELDS"):
        batching.stack_graphs(pgs, fields=("wl_feat", "mask"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [16, None])
def test_declared_fields_on_the_card(cuda, cap, dtype):
    """At the benchmark's shapes on the card (K1 and K2): the mask built
    there is the host's, and the fields' batch serves the full batch's
    answers and loss bit for bit."""
    model = SMP2D(SMP2DConfig(max_nVertices=40, max_receptive_field=cap,
                              nLevels=2, nChanels=32, nFeatures=28,
                              nDepth=5, dtype=dtype), device=cuda)
    graphs = [datasets.random_graph(n, 0.1, nFeatures=28, seed=n)
              for n in range(9, 38, 4)]
    targets = np.linspace(-1.0, 1.0, len(graphs))
    full, part = _both(model, [model.prepare(g) for g in graphs], targets)
    for k, x in part.items():
        assert x.device.type == "cuda" and torch.equal(x, full[k]), k
    with torch.no_grad():
        for a, b in zip(model._forward(model.params, full),
                        model._forward(model.params, part)):
            assert torch.equal(a, b)
        assert torch.equal(model._loss(model.params, full),
                           model._loss(model.params, part))
