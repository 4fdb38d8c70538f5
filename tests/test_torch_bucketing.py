"""Bucketed batching in the port (``core/batching.py``,
``models/base.py:fit_bucketed``) against the JAX package: the buckets of
``bucket_by_size`` (``tests/test_bucketing.py:13-25``), ``stack_graphs``
skipping absent fields and padding ELLPACK degrees, ``index_batch`` and
``pad_batch_to``; a prediction that does not depend on the padding size
(a receptive field larger than the bucket included); and
``fit_bucketed``'s epoch losses, parameters and optimizer state against the
JAX package's at float64 on the same weights and seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.core import batching as jbatching
from graphflow_tpu.core import prep as jprep
from graphflow_tpu.models import smp1d as jsmp1d
from graphflow_tpu.models import smp2d as jsmp2d
from graphflow_tpu.models.base import fit_bucketed as jfit_bucketed
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.models import fit_bucketed
from graphflow_tpu_torch.ops import sparse
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL = 1e-8


def _close(got, ref, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def test_bucket_by_size_groups_as_jax():
    tg = [datasets.random_graph(n, 0.3, seed=n) for n in (3, 7, 9, 15, 20)]
    jg = [jdatasets.random_graph(n, 0.3, seed=n) for n in (3, 7, 9, 15, 20)]
    got = batching.bucket_by_size(tg, list(range(5)), boundaries=(8, 16, 32))
    ref = jbatching.bucket_by_size(jg, list(range(5)), boundaries=(8, 16, 32))
    assert list(got) == list(ref) == [8, 16, 32]
    assert [g.nVertices for g in got[8][0]] == [3, 7]
    assert got[16][1] == [2, 3]
    for b in got:
        assert [g.nVertices for g in got[b][0]] == [g.nVertices
                                                    for g in ref[b][0]]
        assert got[b][1] == ref[b][1]
    # First met, first listed; no targets, empty target lists.
    order = batching.bucket_by_size([tg[3], tg[0]], boundaries=(8, 16))
    assert list(order) == [16, 8] and order[16][1] == []


def test_bucket_overflow_raises():
    with pytest.raises(ValueError):
        batching.bucket_by_size([datasets.random_graph(40, 0.2)],
                                boundaries=(8, 16))


def _with_ell(mod_prep, g, V):
    """A prepared graph with ELLPACK fields of the graph's own degree."""
    pg = mod_prep.prepare_graph(g, 2, V, 4, 2, backend="python")
    pg.ell_nbr, pg.ell_w = sparse.ell_from_adj(g.norm_adj(), pad_rows=V)
    pg.ell_nbr_a, pg.ell_w_a = sparse.ell_from_adj(
        g.adj.astype(np.float32), pad_rows=V)
    return pg


def test_stack_graphs_pads_ell_and_skips_absent_fields():
    """Two graphs of different degrees: the ELLPACK fields pad to the
    larger (sentinel V, weight 0), as in the JAX package; a field that one
    graph lacks is left out."""
    tg = [datasets.random_graph(8, p, seed=4) for p in (0.2, 0.7)]
    jg = [jdatasets.random_graph(8, p, seed=4) for p in (0.2, 0.7)]
    tp = [_with_ell(prep, g, 10) for g in tg]
    jp = [_with_ell(jprep, g, 10) for g in jg]
    assert tp[0].ell_nbr.shape[1] < tp[1].ell_nbr.shape[1]
    got = batching.stack_graphs(tp, [1.0, 2.0])
    ref = jbatching.stack_graphs(jp, [1.0, 2.0])
    assert set(got) == set(ref)
    assert "fo_idx" not in got
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    tp[1].ell_w = None
    assert "ell_w" not in batching.stack_graphs(tp)


def test_stack_graphs_stacks_fo_idx():
    graphs = [datasets.random_graph(n, 0.4, seed=n) for n in (5, 7)]
    pgs = [prep.prepare_graph(g, 2, 8, 4, 2, fo_degree=8) for g in graphs]
    batch = batching.stack_graphs(pgs)
    assert batch["fo_idx"].shape == (2, 2, 8, 4, 8)
    assert batch["fo_idx"].dtype == torch.int32
    np.testing.assert_array_equal(batch["fo_idx"][1].numpy(), pgs[1].fo_idx)


def test_index_and_pad_batch_as_jax():
    tg = [datasets.random_graph(n, 0.4, seed=n) for n in (4, 6, 7)]
    jg = [jdatasets.random_graph(n, 0.4, seed=n) for n in (4, 6, 7)]
    kw = dict(nLevels=2, max_nVertices=8, max_receptive_field=4, nDepth=2)
    got = batching.stack_graphs([prep.prepare_graph(g, **kw) for g in tg],
                                [1.0, 2.0, 3.0])
    ref = jbatching.stack_graphs([jprep.prepare_graph(g, **kw) for g in jg],
                                 [1.0, 2.0, 3.0])
    assert batching.batch_size(got) == jbatching.batch_size(ref) == 3
    for idx in (slice(0, 2), np.array([2, 0])):
        sub, jsub = batching.index_batch(got, idx), jbatching.index_batch(
            ref, idx)
        for k in jsub:
            np.testing.assert_array_equal(sub[k].numpy(),
                                          np.asarray(jsub[k]))
    padded, jpadded = batching.pad_batch_to(got, 5), jbatching.pad_batch_to(
        ref, 5)
    for k in jpadded:
        assert padded[k].dtype == got[k].dtype
        np.testing.assert_array_equal(padded[k].numpy(),
                                      np.asarray(jpadded[k]), err_msg=k)
    assert batching.pad_batch_to(got, 3) is got
    with pytest.raises(ValueError):
        batching.pad_batch_to(got, 2)


MODELS = {
    "SMP_omega": dict(max_nVertices=12, max_receptive_field=8, nLevels=2,
                      nChanels=4, nFeatures=4, nDepth=2),
    "SMP_theta": dict(max_nVertices=12, max_receptive_field=8, nLevels=2,
                      nChanels=4, nFeatures=4, nDepth=2),
    "SMP_theta_physics": dict(max_nVertices=12, max_receptive_field=8,
                              nLevels=2, nChanels=4, nFeatures=4),
    "SMP_omega_physics": dict(max_nVertices=12, max_receptive_field=8,
                              nLevels=2, nChanels=4, nFeatures=4),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prediction_invariant_to_padding_size(name):
    """A 5-vertex graph padded to 6 (smaller than P = 8), 8 and 12
    vertices predicts the same, in float64."""
    m = getattr(models, name)(**MODELS[name], seed=1, device="cpu").double()
    g = datasets.random_graph(5, 0.5, seed=3)
    preds = []
    for V in (6, 8, 12):
        batch = batching.stack_graphs([m._prepare(g, pad_nVertices=V)],
                                      dtype=torch.float64)
        with torch.no_grad():
            preds.append(float(m._forward(m.params, batch)[0][0]))
    assert preds[0] == pytest.approx(m.Predict(g), rel=1e-12, abs=1e-12)
    _close(preds[1:], preds[:1] * 2, 1e-12)


def _bucket_graphs(mod):
    rng = np.random.default_rng(0)
    return [mod.random_graph(int(n), 0.35, seed=i)
            for i, n in enumerate(rng.integers(3, 13, 9))]


JAX_MODELS = {"SMP_omega": jsmp2d.SMP_omega, "SMP_theta": jsmp1d.SMP_theta}


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
@pytest.mark.parametrize("nEpochs", [1, 2, 3])
def test_fit_bucketed_matches_jax(name, nEpochs):
    """The same buckets (6 < P = 8, 8, 12), the same shuffled order from the
    seed, the same Adam steps: the loss of each epoch (the last of a run of
    1, 2 and 3), every parameter and the optimizer state match the JAX
    package's at float64."""
    jm = JAX_MODELS[name](**MODELS[name], seed=2)
    jm.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                       jm.params)
    jm._finish_init()
    tm = getattr(models, name)(**MODELS[name], device="cpu").double()
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    jg, tg = _bucket_graphs(jdatasets), _bucket_graphs(datasets)
    targets = [0.1 * g.nVertices for g in tg]
    kw = dict(learning_rate=1e-3, nEpochs=nEpochs, boundaries=(6, 8, 12),
              seed=5)
    got = fit_bucketed(tm, tg, targets, **kw)
    ref = jfit_bucketed(jm, jg, targets, **kw)
    _close(got, ref)
    flat = _flat(jm.params)
    for path, p in tm.param_dict().items():
        _close(p, flat[path].numpy())
    for key in ("m", "v"):
        jstate = _flat(jm.opt_state[key])
        for path, x in tm.opt_state[key].items():
            _close(x, jstate[path].numpy())
    assert tm.opt_state["t"] == int(jm.opt_state["t"]) == 3 * nEpochs


def test_fit_bucketed_learns():
    """As tests/test_bucketing.py:39-47: the total loss halves."""
    rng = np.random.default_rng(0)
    graphs = [datasets.random_graph(int(n), 0.3, seed=i)
              for i, n in enumerate(rng.integers(4, 12, 10))]
    targets = [float(g.nVertices) for g in graphs]
    m = models.SMP_omega(max_nVertices=12, max_receptive_field=4, nLevels=1,
                         nChanels=6, nFeatures=4, nDepth=2, device="cpu")
    l0 = m.getLoss(graphs, targets)
    l1 = fit_bucketed(m, graphs, targets, 3e-3, 60, boundaries=(8, 12))
    assert l1 < 0.5 * l0, (l0, l1)
