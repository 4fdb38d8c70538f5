"""The port's host preparation and batching against the JAX package's NumPy
path, array for array (toy molecules and Erdos-Renyi graphs, including
capped receptive fields, padded vertices and ranking ties)."""

import numpy as np
import pytest
import torch

from graphflow_tpu.core import batching as jbatching
from graphflow_tpu.core import prep as jprep
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.utils import datasets

torch.set_num_threads(1)

_ARRAYS = ("wl_feat", "vmask", "sizes", "nbr", "pos", "radj", "smask",
           "norm_adj", "adj", "sp", "raw_feat", "dist")


def _graphs(name):
    """The same graph built by each package's fixtures."""
    if name.startswith("er"):
        n, p, seed = {"er_sparse": (10, 0.25, 1), "er_dense": (12, 0.4, 2),
                      "er_padded": (7, 0.35, 3)}[name]
        return (jdatasets.random_graph(n, p, seed=seed),
                datasets.random_graph(n, p, seed=seed))
    return jdatasets.toy_molecule(name), datasets.toy_molecule(name)


def _assert_prepared_equal(jp, tp):
    assert jp.nVertices == tp.nVertices
    for f in _ARRAYS:
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", ["CH4", "NH3", "H2O", "C2H4", "er_sparse",
                                  "er_dense", "er_padded"])
@pytest.mark.parametrize("P", [4, None])
def test_prepare_graph_matches_jax(name, P):
    """P=4 caps most fields; None is the uncapped field; V=12 pads."""
    jg, tg = _graphs(name)
    kw = dict(nLevels=2, max_nVertices=12, max_receptive_field=P, nDepth=3)
    _assert_prepared_equal(jprep.prepare_graph(jg, backend="python", **kw),
                           prep.prepare_graph(tg, **kw))


@pytest.mark.parametrize("opts", [
    dict(has_WL_ordering=False),
    dict(use_wl_features=False),
    dict(use_coulomb=True),
    dict(dtype=np.float64),
])
def test_prepare_graph_options_match_jax(opts):
    jg, tg = _graphs("er_dense")
    coulomb = np.random.default_rng(4).normal(size=(12, 12))
    jg.coulomb[:] = tg.coulomb[:] = coulomb + coulomb.T
    kw = dict(nLevels=2, max_nVertices=12, max_receptive_field=5, nDepth=2,
              **opts)
    _assert_prepared_equal(jprep.prepare_graph(jg, backend="python", **kw),
                           prep.prepare_graph(tg, **kw))


def test_rank_vertices_tie_matches_jax():
    """The non-stable exchange sort reverses a tied pair."""
    hist = np.array([[3.0], [3.0], [5.0], [3.0], [1.0]])
    jo, jr = jprep.rank_vertices(hist)
    to, tr = prep.rank_vertices(hist)
    np.testing.assert_array_equal(jo, to)
    np.testing.assert_array_equal(jr, tr)
    # A stable sort would give [2, 0, 1, 3, 4].
    np.testing.assert_array_equal(to, [2, 1, 0, 3, 4])


@pytest.mark.parametrize("use_rank", [True, False])
def test_limit_receptive_field_matches_jax(use_rank):
    g = datasets.random_graph(12, 0.3, seed=5)
    sp = prep.floyd_warshall(g.adj)
    _, rank = prep.rank_vertices(prep.wl_features(sp, g.feature, 2))
    r = rank if use_rank else None
    for v in range(12):
        field = [u for u in range(12) if sp[v, u] <= 2][::-1]
        field.remove(v)
        field.insert(0, v)
        for cap in (1, 3, 6):
            assert (prep._limit_receptive_field(v, field, sp, r, cap)
                    == jprep._limit_receptive_field(v, field, sp, r, cap))


def test_prepare_graph_rejects_too_many_vertices():
    with pytest.raises(ValueError):
        prep.prepare_graph(datasets.toy_molecule("C2H4"), 2, 4, 4, 2)


def test_stack_graphs_matches_jax():
    names = ["CH4", "C2H4", "er_padded"]
    kw = dict(nLevels=2, max_nVertices=12, max_receptive_field=4, nDepth=3)
    jpgs = [jprep.prepare_graph(_graphs(n)[0], backend="python", **kw)
            for n in names]
    tpgs = [prep.prepare_graph(_graphs(n)[1], **kw) for n in names]
    targets = [1.0, 2.5, -3.0]
    jb = jbatching.stack_graphs(jpgs, targets)
    tb = batching.stack_graphs(tpgs, targets, device="cpu")
    assert set(tb) == set(_ARRAYS) | {"nVertices", "target"}
    for k, t in tb.items():
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(jb[k]), t.numpy(),
                                      err_msg=k)
    assert tb["nbr"].dtype == torch.int32 and tb["pos"].dtype == torch.int32
    assert tb["nbr"].shape == (3, 2, 12, 4)
