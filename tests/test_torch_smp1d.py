"""The port's first-order SMP family (``models/smp1d.py``) and
SMP_theta_physics against ``graphflow_tpu.models.smp1d`` /
``graphflow_tpu.models.physics`` with the JAX weights, in float64 on the
CPU: prediction, ``Feature`` and the loss to 1e-9, every gradient to 1e-8
with the reference's shared-node lambda gradients and with the true ones,
every parameter and the optimizer state after three ``BatchLearn`` steps
(Adam or Momentum, the model's own) to 1e-8, which also holds the
registration order; the sparse first-order sum (``fo_idx``) against the
dense one; ``persize_gather_refgrad`` against the JAX custom VJP; the text
checkpoint across packages; and the device a model lands on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.core import batching as jbatching
from graphflow_tpu.core import prep as jprep
from graphflow_tpu.models import physics as jphysics
from graphflow_tpu.models import smp1d as jsmp1d
from graphflow_tpu.ops import activations as jactivations
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.models import smp1d
from graphflow_tpu_torch.ops.activations import persize_gather_refgrad
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
V = 8
# name -> constructor arguments; uncapped models have P = V = 8.
CTORS = {
    "SMP_theta": dict(max_nVertices=V, max_receptive_field=4, nLevels=2,
                      nChanels=6, nFeatures=4, nDepth=2),
    "SMP_1D": dict(max_nVertices=V, nLevels=2, nChanels=5, nFeatures=4,
                   nDepth=2),
    "SMP_1D_classification": dict(max_nVertices=V, nLevels=2, nChanels=4,
                                  nFeatures=4, nDepth=2, nClasses=3),
    "Unrestricted_SMP_1D": dict(max_nVertices=V, nLevels=2, nChanels=4,
                                nFeatures=4, nDepth=2),
    "SMP_1D_ver2": dict(max_nVertices=V, nLevels=2, nChanels=2, nFeatures=4,
                        nDepth=2),
    "SMP_1D_ver3": dict(max_nVertices=V, nLevels=2, nChanels=2, nFeatures=4,
                        nDepth=2),
    "SMP_1D_ver3_classification": dict(max_nVertices=V, nLevels=2,
                                       nChanels=2, nFeatures=4, nDepth=2,
                                       nClasses=3),
    "Unrestricted_SMP_1D_ver2": dict(max_nVertices=V, nLevels=2, nChanels=2,
                                     nFeatures=4, nDepth=2),
    "SMP_theta_physics": dict(max_nVertices=V, max_receptive_field=4,
                              nLevels=2, nChanels=8, nFeatures=3),
}
LR = {"adam": 1e-3, "momentum": 1e-3}


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _jax_ctor(name):
    return getattr(jphysics if name.endswith("physics") else jsmp1d, name)


def _graphs(mod, name):
    """Five graphs of 4..8 vertices; raw normal features for the physics
    model (it takes no WL histogram)."""
    graphs = [mod.toy_molecule("C2H4")]
    for s in range(4):
        graphs.append(mod.random_graph(4 + s % 5 + (s > 1), 0.45,
                                       nFeatures=CTORS[name]["nFeatures"],
                                       seed=30 + s))
    if name.endswith("physics"):
        graphs = graphs[1:]
        for s, g in enumerate(graphs):
            g.feature = np.random.default_rng(40 + s).normal(
                size=g.feature.shape)
    return graphs


def _targets(name, n):
    if "classification" in name:
        return [float(i % 3) for i in range(n)]
    return [0.5, -1.0, 2.0, 1.5, -0.5][:n]


def _pair(name, faithful=True):
    """The JAX model and the port's, in float64, on the JAX weights."""
    jm = _jax_ctor(name)(**CTORS[name], seed=3)
    tm = getattr(models, name)(**CTORS[name], device="cpu")
    if not faithful:
        jm.cfg = dataclasses.replace(jm.cfg, faithful_lambda_grads=False)
        tm.cfg = dataclasses.replace(tm.cfg, faithful_lambda_grads=False)
    jm.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                       jm.params)
    jm._finish_init()
    tm = tm.double()
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    return jm, tm


def _assert_same_state(tm, jm, rtol):
    ref = _flat(jm.params)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), rtol)
    if isinstance(tm.opt_state, dict) and "m" in tm.opt_state:
        for key in ("m", "v"):
            jstate = _flat(jm.opt_state[key])
            for path, x in tm.opt_state[key].items():
                _close(x, jstate[path].numpy(), rtol)
        assert tm.opt_state["t"] == int(jm.opt_state["t"])
    else:
        jstate = _flat(jm.opt_state)
        for path, x in tm.opt_state.items():
            _close(x, jstate[path].numpy(), rtol)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("with_valid", [False, True])
def test_persize_gather_refgrad_matches_jax(depth, with_valid):
    """The gather's forward is table[s]; its backward weights vertex v's
    cotangent by C(r + depth - 1, depth), r counting the same-size vertices
    up to v in its own graph (two graphs here)."""
    rng = np.random.default_rng(depth)
    table = rng.normal(size=(7, 3))
    s = np.array([[3, 2, 3, 3, 1, 2, 0, 0], [1, 1, 4, 1, 4, 6, 2, 0]])
    valid = (s > 0).astype(np.float64) if with_valid else None
    g = rng.normal(size=(2, 8, 3))

    tt = torch.from_numpy(table).requires_grad_()
    out = persize_gather_refgrad(
        tt, torch.from_numpy(s), depth,
        None if valid is None else torch.from_numpy(valid))
    (dt,) = torch.autograd.grad(out, tt, torch.from_numpy(g))

    def f(tbl):
        return jax.vmap(lambda s_, v_: jactivations.persize_gather_refgrad(
            tbl, s_, depth, v_), in_axes=(0, None if valid is None else 0))(
                jnp.asarray(s), None if valid is None else jnp.asarray(valid))

    ref, vjp = jax.vjp(f, jnp.asarray(table))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    _close(dt, vjp(jnp.asarray(g))[0], 1e-12)
    # Not the true gradient, which scatters g itself.
    true = np.zeros_like(table)
    np.add.at(true, s, g)
    assert np.abs(dt.numpy() - true).max() > 0.1


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("name", sorted(CTORS))
def test_model_matches_jax_float64(name, faithful):
    """The loss and every gradient in both lambda-gradient modes (the full
    filters of the Unrestricted models have no lambdas); with the
    reference's gradients, the default, also serving and three BatchLearn
    steps with the model's own optimizer (Adam's per-element schedule
    follows registration order, so a permuted order would differ here).
    The mode changes the backward only."""
    jm, tm = _pair(name, faithful)
    assert tm.param_order == jm.param_order
    jg, tg = _graphs(jdatasets, name), _graphs(datasets, name)
    targets = _targets(name, len(tg))
    loss, grads = tm._loss_and_grads(tm._stack(tg, targets))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, targets))
    _close(loss, jloss, RTOL_FWD)
    jflat = _flat(jgrads)
    assert set(grads) == set(jflat)
    for path, x in grads.items():
        _close(x, jflat[path].numpy(), RTOL_GRAD)
    if not faithful:
        return
    # Serving: batched, one graph, the graph feature.
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    _close(tm.Feature(tg[1]), jm.Feature(jg[1]), RTOL_FWD)
    if "classification" not in name:
        _close(tm.Predict(tg[2]), jm.Predict(jg[2]), RTOL_FWD)
    lr = LR[tm.cfg.optimizer]
    for _ in range(3):
        _close(tm.BatchLearn(tg, targets, lr), jm.BatchLearn(jg, targets, lr),
               RTOL_GRAD)
    _assert_same_state(tm, jm, RTOL_GRAD)


def _sparse_graph(mod):
    """The graph of tests/test_smp1d.py:122-150: a path with two chords."""
    r = np.random.default_rng(11)
    n = 9
    edges = [(u, u + 1) for u in range(n - 1)] + [(0, 4), (2, 7)]
    feats = np.zeros((n, 4))
    feats[np.arange(n), r.integers(0, 4, n)] = 1.0
    return mod.DenseGraph.from_edges(n, 4, edges, feats)


@pytest.mark.parametrize("filter_", ["theta", "steerable", "unrestricted2"])
def test_sparse_route_matches_dense(filter_):
    """``sparse_max_degree`` routes the 1-hop sum through ELLPACK over
    fo_idx: every level state equals the dense route's, and the JAX
    package's sparse route, with the gradients."""
    from graphflow_tpu.core.graph import DenseGraph as JDenseGraph
    from graphflow_tpu_torch.core.graph import DenseGraph

    class J:
        pass

    jmod, tmod = J(), J()
    jmod.DenseGraph, tmod.DenseGraph = JDenseGraph, DenseGraph
    cfg = smp1d.SMP1DConfig(max_nVertices=10, max_receptive_field=5,
                            nLevels=2, nChanels=4, nFeatures=4, nDepth=2,
                            filter=filter_, dtype="float64")
    jcfg = jsmp1d.SMP1DConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(jsmp1d.SMP1DConfig)})
    jparams = jsmp1d.init_smp1d_params(jax.random.PRNGKey(0), jcfg)
    tparams = smp1d.SMP1D(cfg, device="cpu")
    tparams.load_params(_flat(jparams))
    params = tparams.params

    def run(degree):
        pg = prep.prepare_graph(_sparse_graph(tmod), 2, 10, 5, 2,
                                dtype=np.float64, fo_degree=degree)
        assert (pg.fo_idx is None) == (degree is None)
        g = batching.stack_graphs([pg, pg])
        return smp1d.smp1d_states(params, g, dataclasses.replace(
            cfg, sparse_max_degree=degree)), g

    dense, _ = run(None)
    sparse, g = run(6)
    for l, (a, b) in enumerate(zip(dense, sparse)):
        _close(b, a.detach().numpy(), 1e-12)
    jpg = jprep.prepare_graph(_sparse_graph(jmod), 2, 10, 5, 2,
                              dtype=np.float64, fo_degree=6)
    np.testing.assert_array_equal(g["fo_idx"][0].numpy(), jpg.fo_idx)
    jb = jax.tree_util.tree_map(lambda x: x[0],
                                jbatching.stack_graphs([jpg]))
    jstates = jsmp1d.smp1d_states(jparams, jb, dataclasses.replace(
        jcfg, sparse_max_degree=6))
    for a, b in zip(sparse, jstates):
        _close(a[0], np.asarray(b), 1e-9)

    def loss(degree):
        states, _ = run(degree)
        return states[-1].square().sum()

    pd = [p for k, p in tparams.param_dict().items() if k != "W"]
    gd = torch.autograd.grad(loss(None), pd)
    gs = torch.autograd.grad(loss(6), pd)
    for x, y in zip(gs, gd):
        _close(x, y.numpy(), 1e-10)


def test_fo_degree_too_small_raises():
    g = datasets.random_graph(8, 0.6, seed=2)
    with pytest.raises(ValueError):
        prep.prepare_graph(g, 2, 8, 4, 1, fo_degree=1)


@pytest.mark.parametrize("name", ["SMP_theta", "Unrestricted_SMP_1D_ver2",
                                  "SMP_1D_ver3", "SMP_theta_physics"])
def test_checkpoint_round_trip_across_packages(name, tmp_path):
    """Saved in registration order: the port's file loads into the JAX
    model and the JAX model's into the port's."""
    jm, tm = _pair(name)
    tg, jg = _graphs(datasets, name), _graphs(jdatasets, name)
    tm.save_model(str(tmp_path / "port.txt"))
    jm.save_model(str(tmp_path / "jax.txt"))
    assert ((tmp_path / "port.txt").read_text().split()
            == (tmp_path / "jax.txt").read_text().split())
    fresh = getattr(models, name)(**CTORS[name], seed=9,
                                  device="cpu").double()
    fresh.load_model(str(tmp_path / "jax.txt"))
    _close(fresh.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    jfresh = _jax_ctor(name)(**CTORS[name], seed=9)
    jfresh.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                           jfresh.params)
    jfresh.load_model(str(tmp_path / "port.txt"))
    _close(tm.Threaded_Predict(tg), jfresh.Threaded_Predict(jg), RTOL_FWD)
    # params_to_numpy gives the JAX tree back.
    tree = params_to_numpy(tm.param_dict())
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                np.asarray, jm.params)))


def test_inspect_and_level_features_match_jax():
    jm, tm = _pair("SMP_1D_ver3")
    jg, tg = _graphs(jdatasets, "SMP_1D_ver3"), _graphs(datasets,
                                                         "SMP_1D_ver3")
    got, ref = smp1d.smp1d_inspect(tm, tg[2]), jsmp1d.smp1d_inspect(jm,
                                                                    jg[2])
    for a, b in zip(got["states"], ref["states"]):
        _close(a, b, RTOL_FWD)
    _close(got["vertex_features"], ref["vertex_features"], RTOL_FWD)
    _close(got["graph_feature"], ref["graph_feature"], RTOL_FWD)
    feats = smp1d.smp1d_level_features(tm.params, tm._stack(tg), tm.cfg)
    assert [f.shape[1] for f in feats] == [2, 4, 8]


@pytest.mark.parametrize("name", sorted(CTORS))
def test_model_without_device_does_not_land_on_the_cpu(name):
    """Built without ``device`` a model takes the CUDA device, and with none
    (as here) raises rather than run on the CPU."""
    if torch.cuda.is_available():
        m = getattr(models, name)(**CTORS[name])
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(models, name)(**CTORS[name])
