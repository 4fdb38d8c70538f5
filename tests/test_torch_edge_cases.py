"""Degenerate graphs through the port and the JAX package side by side, the
twin of tests/test_edge_cases.py:41-109: one vertex, no edges, two
components, the complete graph under a cap of 3, integer adjacency weights
above 1, ``nLevels=0``, and a graph with a self loop.

Both models run in float64 on the CPU with the JAX weights (carried by
``utils/convert.py``); the prediction and the losses before and after one
``BatchLearn`` must agree to 1e-9 of their scale (the self loop's loss after
the step to 1e-8: one more product of rounding errors).

The JAX models prepare with ``backend="auto"``, the native C++ pipeline
where its library loads.  The port's preparation follows that pipeline on a
self loop (``core/prep.py:floyd_warshall``); the JAX package's NumPy path
differs there, so the self-loop cases skip where the library is missing."""

import jax
import numpy as np
import pytest
import torch

from graphflow_tpu.core import prep as jprep
from graphflow_tpu.core.graph import DenseGraph as JaxDenseGraph
from graphflow_tpu.models import SMP2D as JaxSMP2D
from graphflow_tpu.models import SMP2DConfig as JaxSMP2DConfig
from graphflow_tpu.runtime import native
from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
from graphflow_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL = 1e-9
RTOL_STEP = 1e-8
LR = 1e-3
CFG = dict(max_nVertices=8, max_receptive_field=4, nLevels=2, nChanels=4,
           nFeatures=4, nDepth=2)


def _single_vertex(G):
    g = G(1, 4)
    g.feature[0, 0] = 1.0
    return g


def _edgeless(G):
    g = G(3, 4)
    g.feature[:] = np.eye(4)[[0, 1, 2]]
    return g


def _disconnected(G):
    return G.from_edges(6, 4, [(0, 1), (3, 4)], np.eye(4)[[0, 1, 2, 3, 0, 1]])


def _complete(G):
    edges = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    return G.from_edges(6, 4, edges, np.eye(4)[[0, 1, 2, 3, 0, 1]])


def _weighted(G):
    g = G(3, 4)
    g.adj[0, 1] = g.adj[1, 0] = 5
    g.feature[:] = np.eye(4)[[0, 1, 2]]
    return g


def _self_loop(G):
    g = G.from_edges(3, 4, [(0, 1)], np.eye(4)[[0, 1, 2]])
    g.adj[2, 2] = 1
    return g


# name -> (graph, configuration changes)
DEGENERATES = {
    "single_vertex": (_single_vertex, {}),
    "edgeless": (_edgeless, {}),
    "disconnected": (_disconnected, {}),
    "complete_cap3": (_complete, dict(max_nVertices=6,
                                      max_receptive_field=3)),
    "weighted": (_weighted, {}),
    "nlevels0": (_edgeless, dict(max_nVertices=4, max_receptive_field=2,
                                 nLevels=0, nDepth=1)),
}


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _pair(contraction=18, **changes):
    """The JAX model in float64 and the port's, sharing the JAX weights."""
    kw = dict(CFG, **changes, contraction=contraction, dtype="float64")
    jm = JaxSMP2D(JaxSMP2DConfig(**kw), seed=5)
    tm = SMP2D(SMP2DConfig(**kw), device="cpu")
    tm.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jm.params)))
    return jm, tm


def _assert_same_model_outputs(jm, tm, jg, tg, rtol_step=RTOL):
    _close(tm.Predict(tg), jm.Predict(jg))
    _close(tm.Feature(tg), jm.Feature(jg))
    got = tm.BatchLearn([tg], [1.0], LR)
    ref = jm.BatchLearn([jg], [1.0], LR)
    _close(got[0], ref[0])
    _close(got[1], ref[1], rtol_step)


@pytest.mark.parametrize("name", DEGENERATES)
def test_prepare_matches_jax_on_degenerate_graphs(name):
    make, changes = DEGENERATES[name]
    kw = dict(CFG, **changes)
    args = (kw["nLevels"], kw["max_nVertices"], kw["max_receptive_field"],
            kw["nDepth"])
    jp = jprep.prepare_graph(make(JaxDenseGraph), *args, backend="python")
    tp = prep.prepare_graph(make(DenseGraph), *args)
    n = tp.nVertices
    assert tp.sizes[0, :n].min() == 1 and np.isfinite(tp.wl_feat).all()
    for f in ("wl_feat", "vmask", "sizes", "nbr", "pos", "radj", "smask"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f),
                                      err_msg=f)
    if name == "complete_cap3":
        # Every distance-1 group is dropped under the cap: phi = {v}.
        assert (tp.sizes[1:, :n] == 1).all()
    if name == "weighted":
        s = tp.sizes[1, 0]
        assert tp.radj[0, 0, :s, :s].max() == 5.0


@pytest.mark.parametrize("name", DEGENERATES)
def test_model_matches_jax_on_degenerate_graphs(name):
    """Prediction, feature, and the loss before and after one step."""
    make, changes = DEGENERATES[name]
    jm, tm = _pair(**changes)
    _assert_same_model_outputs(jm, tm, make(JaxDenseGraph), make(DenseGraph))


@pytest.mark.parametrize("contraction", [10, 50])
@pytest.mark.parametrize("name", ["single_vertex", "disconnected",
                                  "weighted"])
def test_bank_variants_match_jax_on_degenerate_graphs(name, contraction):
    """The 10- and 50-case banks apply no positivity guard and read the
    adjacency weights as they are."""
    make, changes = DEGENERATES[name]
    jm, tm = _pair(contraction, **changes)
    _assert_same_model_outputs(jm, tm, make(JaxDenseGraph), make(DenseGraph))


needs_native = pytest.mark.skipif(
    not native.available(),
    reason="the JAX package's native preparation library cannot load; its "
           "NumPy path puts a self loop at distance 1")


@needs_native
def test_self_loop_prepares_as_the_native_backend():
    """A vertex is 0 hops from itself whatever adj[v, v] is."""
    tg = _self_loop(DenseGraph)
    sp = prep.floyd_warshall(tg.adj)
    assert (np.diagonal(sp) == 0).all() and sp[0, 1] == 1
    assert sp[0, 2] >= prep.INF
    jp = jprep.prepare_graph(_self_loop(JaxDenseGraph), 2, 8, 4, 2,
                             backend="auto")
    tp = prep.prepare_graph(tg, 2, 8, 4, 2)
    for f in ("wl_feat", "vmask", "sizes", "nbr", "pos", "radj", "smask"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f),
                                      err_msg=f)
    # The JAX NumPy path counts the looped vertex's own feature at depth 1.
    py = jprep.prepare_graph(_self_loop(JaxDenseGraph), 2, 8, 4, 2,
                             backend="python")
    assert not np.array_equal(py.wl_feat, tp.wl_feat)


@needs_native
@pytest.mark.parametrize("contraction", [18, 50])
def test_self_loop_model_matches_jax_default_backend(contraction):
    jm, tm = _pair(contraction)
    _assert_same_model_outputs(jm, tm, _self_loop(JaxDenseGraph),
                               _self_loop(DenseGraph), RTOL_STEP)
