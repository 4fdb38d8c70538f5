"""The port's GCN family (``models/gcn.py``) and its two new pieces,
``ops/activations.py:softmax`` and ``core/prep.py:prepare_graph_sparse``,
against ``graphflow_tpu``: the softmax's reference (diagonal-only) gradient
against the JAX custom VJP and the exact one against the true Jacobian; the
six RisiLayer GCNs in float64 (prediction and loss to 1e-9, every gradient
to 1e-8, three Momentum steps to 1e-8); GCN_MW and NeuralFingerprint on the
dense and the ELL route in float32, as their parameters are, to 1e-5 of
the scale; the sparse prep field for field, from a DenseGraph and from an
edge list; ``gcn_inspect``; and the channel-blocked text checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.core import prep as jprep
from graphflow_tpu.models import gcn as jgcn
from graphflow_tpu.ops import activations as jactivations
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.models import gcn
from graphflow_tpu_torch.ops.activations import softmax, softmax_exact
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL_FWD, RTOL_GRAD, RTOL32 = 1e-9, 1e-8, 1e-5
LR = 1e-3
V = 8
RISI = dict(nLevels=2, max_nVertices=V, nFeatures=4, nHiddens=4, nDepth=2,
            max_Radius=1)
RISI_CTORS = ["GCN_1D", "GCN_2D", "GCN_3D", "GCN_1D_Distance",
              "GCN_2D_Distance", "GCN_3D_Distance"]
# The 1-hop models: name -> constructor arguments.
SPARSE = {"GCN_MW": dict(nLevels=2, max_nVertices=V, nFeatures=4,
                         nHiddens=5, nDepth=0),
          "NeuralFingerprint": dict(nLevels=2, max_nVertices=V, nFeatures=4,
                                    nHiddens=5)}
SPARSE_CASES = [(n, a) for n in SPARSE for a in ("dense", "ell")]
TARGETS = [0.5, -1.0, 2.0, 1.5]


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _graphs(mod):
    """A molecule and three random graphs of 4..6 vertices, with geometric
    distances of half the hop count (exact in float32)."""
    graphs = [mod.toy_molecule("C2H4")] + [
        mod.random_graph(4 + s, 0.5, nFeatures=4, seed=30 + s)
        for s in range(3)]
    for g in graphs:
        g.distance = 0.5 * prep.floyd_warshall(g.adj).astype(np.float64)
    return graphs


@pytest.fixture(scope="module")
def jax_models():
    """(name, aggregation) -> the JAX model (the RisiLayer GCNs in float64),
    built and compiled once for the module; its initial parameters and
    optimizer state are put back on every call."""
    cache = {}

    def get(name, aggregation=None):
        key = (name, aggregation)
        if key not in cache:
            if aggregation is None:
                jm = getattr(jgcn, name)(**RISI, seed=3)
                jm.params = jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.float64), jm.params)
                jm._finish_init()
            else:
                jm = getattr(jgcn, name)(**SPARSE[name], seed=3,
                                         aggregation=aggregation)
            cache[key] = (jm, jm.params)
        jm, init = cache[key]
        jm.params, jm.opt_state = init, jm.opt.init(init)
        return jm

    return get


def _port(name, jm, aggregation=None):
    if aggregation is None:
        tm = getattr(models, name)(**RISI, device="cpu").double()
    else:
        tm = getattr(models, name)(**SPARSE[name], device="cpu",
                                   aggregation=aggregation)
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    return tm


def _match(tm, jm, rtol_fwd, rtol_grad):
    """Loss and gradients, serving, then three BatchLearn steps: every
    parameter and velocity."""
    tg, jg = _graphs(datasets), _graphs(jdatasets)
    loss, grads = tm._loss_and_grads(tm._stack(tg, TARGETS))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, TARGETS))
    _close(loss, jloss, rtol_fwd)
    jflat = _flat(jgrads)
    assert set(grads) == set(jflat)
    for path, x in grads.items():
        _close(x, jflat[path].numpy(), rtol_grad)
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), rtol_fwd)
    _close(tm.Predict(tg[2]), jm.Predict(jg[2]), rtol_fwd)
    _close(tm.Feature(tg[1]), jm.Feature(jg[1]), rtol_fwd)
    for _ in range(3):
        _close(tm.BatchLearn(tg, TARGETS, LR),
               jm.BatchLearn(jg, TARGETS, LR), rtol_grad)
    ref, velocity = _flat(jm.params), _flat(jm.opt_state)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), rtol_grad)
        _close(tm.opt_state[path], velocity[path].numpy(), rtol_grad)


@pytest.mark.parametrize("shape,dim", [((5,), -1), ((3, 6), -1),
                                       ((2, 4, 3), 1)])
def test_softmax_gradients(shape, dim):
    """``softmax``: the forward equals the JAX one and its gradient the
    JAX custom VJP, g * y * (1 - y), which is not the true one;
    ``softmax_exact``'s gradient is the true Jacobian's product."""
    rng = np.random.default_rng(len(shape))
    x, g = rng.normal(size=shape) * 3, rng.normal(size=shape)
    jy, jvjp = jax.vjp(lambda a: jactivations.softmax(a, dim), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y = softmax(tx, dim)
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    _close(y, np.asarray(jy), 1e-12)
    _close(dx, np.asarray(jvjp(jnp.asarray(g))[0]), 1e-12)
    yy = np.asarray(jy)
    _close(dx, g * yy * (1 - yy), 1e-12)

    _, true_vjp = jax.vjp(lambda a: jax.nn.softmax(a, axis=dim),
                          jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (dx_exact,) = torch.autograd.grad(softmax_exact(tx, dim), tx,
                                      torch.from_numpy(g))
    true = np.asarray(true_vjp(jnp.asarray(g))[0])
    _close(dx_exact, true, 1e-12)
    # y (g - <g, y>) by hand, and far from the reference's gradient.
    _close(dx_exact, yy * (g - (g * yy).sum(axis=dim, keepdims=True)), 1e-12)
    assert np.abs(dx.numpy() - true).max() > 1e-3


@pytest.mark.parametrize("name", RISI_CTORS)
def test_risi_gcn_matches_jax_float64(name, jax_models):
    jm = jax_models(name)
    tm = _port(name, jm)
    assert tm.param_order == jm.param_order
    _match(tm, jm, RTOL_FWD, RTOL_GRAD)


@pytest.mark.parametrize("name,aggregation", SPARSE_CASES)
def test_one_hop_models_match_jax_float32(name, aggregation, jax_models):
    """GCN_MW and NeuralFingerprint keep float32 parameters in both
    packages, and their dense and ELL routes prepare the graphs
    differently (``prepare_graph`` / ``prepare_graph_sparse``)."""
    jm = jax_models(name, aggregation)
    tm = _port(name, jm, aggregation)
    assert tm.aggregation == jm.aggregation == aggregation
    assert tm.param_order == jm.param_order and tm.dtype == torch.float32
    before = prep.ROUTES["sparse"]
    _match(tm, jm, RTOL32, RTOL32)
    assert (prep.ROUTES["sparse"] > before) == (aggregation == "ell")


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_ell_route_equals_dense_route(name):
    """On the same weights the ELL route gives the dense route's outputs."""
    dense = getattr(models, name)(**SPARSE[name], seed=1, device="cpu",
                                  aggregation="dense")
    ell = getattr(models, name)(**SPARSE[name], seed=1, device="cpu",
                                aggregation="ell")
    graphs = _graphs(datasets)
    _close(ell.Threaded_Predict(graphs), dense.Threaded_Predict(graphs),
           RTOL32)
    _close(ell.getLoss(graphs, TARGETS), dense.getLoss(graphs, TARGETS),
           RTOL32)


def _parting_graphs(mod):
    """Two 5-vertex paths with one-hot features on which the routes part:
    one with a self loop at vertex 2, one whose edge (1, 2) weighs 2."""
    feats = np.eye(4)[[0, 1, 2, 3, 0]]
    path = [(i, i + 1) for i in range(4)]
    loop = mod.DenseGraph.from_edges(5, 4, path, feats)
    loop.adj[2, 2] = 1
    heavy = mod.DenseGraph.from_edges(5, 4, path, feats)
    heavy.adj[1, 2] = heavy.adj[2, 1] = 2
    return [loop, heavy]


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_route_disagreement_follows_jax(name):
    """Where the routes part, the port parts as the JAX package does: the
    dense route reads a self loop and an edge's weight (D^-1/2 (A+I)
    D^-1/2 of the weighted adj), the ELL route keeps triu(adj, 1) > 0
    (``graphflow_tpu/core/prep.py:367-369``).  The port's dense-minus-ELL
    prediction difference equals the JAX package's, both models in
    float64 on the same weights, graph by graph; the difference is not
    zero, so a change to either route shows here."""
    diffs = {}
    for pkg, mod in (("jax", jdatasets), ("port", datasets)):
        preds = {}
        for aggregation in ("dense", "ell"):
            jm = getattr(jgcn, name)(**SPARSE[name], seed=3,
                                     aggregation=aggregation)
            jm.params = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float64), jm.params)
            jm._finish_init()
            model = jm
            if pkg == "port":
                model = getattr(models, name)(**SPARSE[name], device="cpu",
                                              aggregation=aggregation)
                model = model.double()
                model.load_params(_flat(jm.params))
                model._finish_init()
            preds[aggregation] = np.asarray(
                model.Threaded_Predict(_parting_graphs(mod)),
                dtype=np.float64)
        diffs[pkg] = preds["dense"] - preds["ell"]
    _close(diffs["port"], diffs["jax"], RTOL_FWD)
    # A material share of the prediction: the self loop in both models,
    # the weight in GCN_MW (NeuralFingerprint reads no edge weight).
    parted = np.abs(diffs["jax"]) > 1e-4 * np.abs(preds["ell"])
    assert parted[0] and (parted[1] or name == "NeuralFingerprint")


def test_aggregation_auto():
    """"auto" takes ELL from 1024 vertices, for GCN_MW only at nDepth 0."""
    def route(ctor, **kw):
        return ctor(nLevels=1, nFeatures=2, nHiddens=2, device="cpu",
                    **kw).aggregation

    assert route(models.GCN_MW, max_nVertices=1024, nDepth=0) == "ell"
    assert route(models.GCN_MW, max_nVertices=1024, nDepth=1) == "dense"
    assert route(models.GCN_MW, max_nVertices=1023, nDepth=0) == "dense"
    assert route(models.NeuralFingerprint, max_nVertices=1024) == "ell"
    assert route(models.NeuralFingerprint, max_nVertices=64) == "dense"
    with pytest.raises(ValueError):
        route(models.GCN_MW, max_nVertices=8, nDepth=1, aggregation="ell")


@pytest.mark.parametrize("source", ["DenseGraph", "edges"])
def test_prepare_graph_sparse_matches_jax(source):
    """Every field the JAX function fills, equal in value and dtype; None
    where it leaves one out; the tuple form never needs an adjacency."""
    g = datasets.random_graph(9, 0.4, seed=7)
    jg = jdatasets.random_graph(9, 0.4, seed=7)
    if source == "edges":
        edges = [(int(u), int(v))
                 for u, v in np.argwhere(np.triu(g.adj, 1) > 0)]
        g = jg = (g.nVertices, edges, g.feature)
    got = prep.prepare_graph_sparse(g, 12)
    ref = jprep.prepare_graph_sparse(jg, 12)
    for field in jprep.PreparedGraph.__dataclass_fields__:
        a, b = getattr(got, field), getattr(ref, field)
        if b is None or field == "nVertices":
            assert a == b if field == "nVertices" else a is None, field
            continue
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_gcn_inspect_matches_jax(jax_models):
    jm = jax_models("GCN_3D")
    tm = _port("GCN_3D", jm)
    graph, jgraph = _graphs(datasets)[0], _graphs(jdatasets)[0]
    got, ref = gcn.gcn_inspect(tm, graph), jgcn.gcn_inspect(jm, jgraph)
    assert len(got["states"]) == len(ref["states"]) == 3
    for a, b in zip(got["states"], ref["states"]):
        _close(a, b, RTOL_FWD)
    _close(got["final_feature"], ref["final_feature"], RTOL_FWD)


@pytest.mark.parametrize("name", ["GCN_2D_Distance", "NeuralFingerprint"])
def test_checkpoint_matches_jax_file(name, jax_models, tmp_path):
    """Channel-blocked (every vertex-channel weight, then every
    distance-channel one, then W): the port writes the JAX model's bytes,
    loads its file, and hands back its tree."""
    aggregation = "dense" if name in SPARSE else None
    jm = jax_models(name, aggregation)
    tm = _port(name, jm, aggregation)
    tm.save_model(str(tmp_path / "port.txt"))
    jm.save_model(str(tmp_path / "jax.txt"))
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())
    if aggregation is None:
        fresh = getattr(models, name)(**RISI, seed=9, device="cpu").double()
    else:
        fresh = getattr(models, name)(**SPARSE[name], seed=9, device="cpu",
                                      aggregation=aggregation)
    fresh.load_model(str(tmp_path / "jax.txt"))
    graphs = _graphs(datasets)
    np.testing.assert_array_equal(fresh.Threaded_Predict(graphs),
                                  tm.Threaded_Predict(graphs))
    tree = params_to_numpy(tm.param_dict())
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                np.asarray, jm.params)))


@pytest.mark.parametrize("name", RISI_CTORS + sorted(SPARSE))
def test_model_without_device_does_not_land_on_the_cpu(name):
    """Built without ``device`` a model takes the CUDA device, and with none
    (as here) raises rather than run on the CPU."""
    kw = SPARSE.get(name, RISI)
    if torch.cuda.is_available():
        assert getattr(models, name)(**kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(models, name)(**kw)
