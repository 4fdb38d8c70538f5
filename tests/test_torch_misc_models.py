"""The port's other graph families against the JAX package on the CPU,
with the JAX weights: GRU_GCN_1D/2D/3D (``models/gru_gcn.py``), GCA_1D with
Reconstruct and CGCN_1D/2D (``models/gca.py``), and LCNN with its vertex
sequence (``models/lcnn.py``): Threaded_Predict, Predict, Feature, getLoss,
the loss and every gradient, and three Momentum BatchLearn steps (every
parameter and velocity).  Then the device rule for every constructor this
slice adds.

Tolerances.  The JAX constructors make float32 parameters over float32
host arrays; the tests cast every parameter of both models to float64
(``tests/test_model_parity2.py:_cast64``), which both packages then take
with the float32 arrays promoted exactly: predictions and losses to
1e-9 * max(1, scale), every gradient leaf and the three steps to 1e-8.
LCNN runs in float32 only: the JAX package's ``conv1d`` refuses a float64
filter over its float32 rows, so both models run as constructed, to 1e-5
of the scale (they sum in float32 in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.core import prep as jprep
from graphflow_tpu.models import gca as jgca
from graphflow_tpu.models import gru_gcn as jgru_gcn
from graphflow_tpu.models import lcnn as jlcnn
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.models.lcnn import find_sequence
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
RTOL32 = 1e-5
LR = 1e-3
V = 9
GCN_ARGS = dict(nLevels=2, max_nVertices=V, nFeatures=4, nHiddens=4,
                nDepth=2, max_Radius=2)
# name -> (JAX module, constructor arguments).
CASES = {
    "GRU_GCN_1D": (jgru_gcn, GCN_ARGS),
    "GRU_GCN_2D": (jgru_gcn, GCN_ARGS),
    "GRU_GCN_3D": (jgru_gcn, dict(GCN_ARGS, nHiddens=3)),
    "GCA_1D": (jgca, GCN_ARGS),
    "CGCN_1D": (jgca, dict(nLevels=2, max_nVertices=V, nFeatures=4,
                           nDepth=2)),
    "CGCN_2D": (jgca, dict(nLevels=2, max_nVertices=V, nFeatures=4,
                           nDepth=2)),
    "LCNN": (jlcnn, dict(nVertices=V, nFeatures=4, nNeighbors=3, nDepth=2,
                         nChanels1=4, nChanels2=3, nDense=5)),
}
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
    """A molecule, two connected random graphs and one with an isolated
    pair (for LCNN's sequence across components), 3..V vertices."""
    return [mod.toy_molecule("C2H4"),
            mod.random_graph(7, 0.5, nFeatures=4, seed=61),
            mod.random_graph(V, 0.35, nFeatures=4, seed=62),
            mod.random_graph(5, 0.25, nFeatures=4, seed=63)]


def _pair(name):
    """(the JAX model, the port's with its weights), in float64 but LCNN."""
    jmod, kw = CASES[name]
    jm = getattr(jmod, name)(**kw, seed=3)
    tm = getattr(models, name)(**kw, device="cpu")
    if name != "LCNN":
        jm.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                           jm.params)
        jm._finish_init()
        tm = tm.double()
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    return jm, tm


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_jax(name):
    jm, tm = _pair(name)
    fwd, grad = (RTOL32, RTOL32) if name == "LCNN" else (RTOL_FWD, RTOL_GRAD)
    assert tm.param_order == jm.param_order
    jg, tg = _graphs(jdatasets), _graphs(datasets)
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), fwd)
    if name == "GCA_1D":
        for a, b in zip(jg, tg):
            rec = tm.Reconstruct(b)
            assert rec.shape == (b.nVertices, b.nVertices)
            _close(rec, jm.Reconstruct(a), fwd)
        _close(tm.getLoss(tg), jm.getLoss(jg), fwd)
    else:
        _close(tm.Predict(tg[1]), jm.Predict(jg[1]), fwd)
        _close(tm.getLoss(tg, TARGETS), jm.getLoss(jg, TARGETS), fwd)
    _close(tm.Feature(tg[2]), jm.Feature(jg[2]), fwd)
    loss, grads = tm._loss_and_grads(tm._stack(tg, TARGETS))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, TARGETS))
    _close(loss, jloss, fwd)
    ref = _flat(jgrads)
    assert list(grads) == tm.param_order and set(ref) == set(grads)
    for path, g in grads.items():
        _close(g, ref[path].numpy(), grad)
    for step in range(3):
        if name == "GCA_1D":      # a float in place of the targets is lr
            got = (tm.BatchLearn(tg, LR) if step == 0
                   else tm.BatchLearn(tg, learning_rate=LR))
            want = jm.BatchLearn(jg, learning_rate=LR)
        else:
            got = tm.BatchLearn(tg, TARGETS, LR)
            want = jm.BatchLearn(jg, TARGETS, LR)
        _close(np.array(got), np.array(want), grad)
        ref, velocity = _flat(jm.params), _flat(jm.opt_state)
        for path, p in tm.param_dict().items():
            _close(p, ref[path].numpy(), grad)
            _close(tm.opt_state[path], velocity[path].numpy(), grad)


def test_lcnn_sequence_matches_jax():
    """The prepared sequence equals the JAX package's, graph by graph: WL
    rank on the padded graph, the sentinel n_real; and the seq row for a
    graph with fewer real vertices than nNeighbors in reach."""
    jm, tm = _pair("LCNN")
    for a, b in zip(_graphs(jdatasets), _graphs(datasets)):
        seq = tm.prepare(b).seq
        np.testing.assert_array_equal(seq, jm.prepare(a).seq)
        assert seq.shape == (V * 3,) and seq.max() <= b.nVertices
    batch = tm._stack(_graphs(datasets))
    assert batch["seq"].dtype == torch.int64
    assert tuple(batch["seq"].shape) == (4, V * 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_sequence_matches_jax(seed):
    """Connected and disconnected graphs (sp of the padded graph has
    unreachable entries), rank ties (repeated features), a random order
    and the WL order."""
    rng = np.random.default_rng(seed)
    n, Vp, K = 6 + seed, 9, 3 + seed
    g = datasets.random_graph(n, 0.2 + 0.2 * seed, nFeatures=2,
                              seed=70 + seed)
    pg = models.LCNN(Vp, 2, K, 1, 2, 2, 2, device="cpu").prepare(g)
    sp = np.asarray(pg.sp)
    order = rng.permutation(Vp)
    np.testing.assert_array_equal(
        find_sequence(sp, order, n, K, Vp),
        jlcnn.find_sequence(sp, order, n, K, Vp))
    jorder, _ = jprep.rank_vertices(np.asarray(pg.wl_feat, np.float64))
    np.testing.assert_array_equal(
        find_sequence(sp, jorder, n, K, Vp),
        jlcnn.find_sequence(sp, jorder, n, K, Vp))


def test_gca_autoencoder_api():
    """getLoss and BatchLearn take no targets; Reconstruct is n x n."""
    m = models.GCA_1D(**GCN_ARGS, device="cpu")
    graphs = _graphs(datasets)
    loss = m.getLoss(graphs)
    assert loss == m.getLoss(graphs, [7.0] * 4)
    before, after = m.BatchLearn(graphs, 0.05)
    assert before == pytest.approx(loss) and np.isfinite(after)
    assert m.Reconstruct(graphs[0]).shape == (6, 6)


def _sample(name):
    """Each new constructor at a small size, with the device keyword."""
    seq = dict(nFeatures=3, nHiddens=4, nClasses=2, max_nLevels=5)
    table = {
        "SMP_omega_pairgraphs": lambda **kw: models.SMP_omega_pairgraphs(
            6, 5, 3, 2, 4, 2, 2, **kw),
        "SMP_beta_pairgraphs": lambda **kw: models.SMP_beta_pairgraphs(
            5, 6, 2, 4, 2, 2, **kw),
        "SMP_gamma_pairgraphs": lambda **kw: models.SMP_gamma_pairgraphs(
            6, 5, 3, 2, 4, 2, 2, **kw),
        "SMP_sigma_pairgraphs": lambda **kw: models.SMP_sigma_pairgraphs(
            6, 5, 3, 2, 4, 2, 2, **kw),
        "SMP_theta_pairgraphs": lambda **kw: models.SMP_theta_pairgraphs(
            6, 5, 3, 2, 4, 2, 2, **kw),
        "CCN_1D": lambda **kw: models.CCN_1D(6, 5, 3, 2, 16, 2, 2, **kw),
        "LCNN": lambda **kw: models.LCNN(6, 2, 2, 1, 2, 2, 2, **kw),
        "LSTM": lambda **kw: models.LSTM(**seq, **kw),
        "GRU": lambda **kw: models.GRU(**seq, **kw),
        "MLP": lambda **kw: models.MLP([6, 4, 3], **kw),
        "CNN": lambda **kw: models.CNN(height=8, width=8, c1=2, c2=3,
                                       kernel=3, **kw),
    }
    for gcn in ("GCN_1D_Kernel", "GCN_2D_Kernel", "GCN_3D_Kernel",
                "GRU_GCN_1D", "GRU_GCN_2D", "GRU_GCN_3D", "GCA_1D"):
        table[gcn] = (lambda g: lambda **kw: getattr(models, g)(
            2, 6, 2, 3, 1, 1, **kw))(gcn)
    for cgcn in ("CGCN_1D", "CGCN_2D"):
        table[cgcn] = (lambda g: lambda **kw: getattr(models, g)(
            2, 6, 2, 1, **kw))(cgcn)
    return table[name]


NEW_CONSTRUCTORS = [
    "SMP_omega_pairgraphs", "SMP_beta_pairgraphs", "SMP_gamma_pairgraphs",
    "SMP_sigma_pairgraphs", "SMP_theta_pairgraphs", "CCN_1D",
    "GCN_1D_Kernel", "GCN_2D_Kernel", "GCN_3D_Kernel", "GRU_GCN_1D",
    "GRU_GCN_2D", "GRU_GCN_3D", "GCA_1D", "CGCN_1D", "CGCN_2D", "LCNN",
    "LSTM", "GRU", "MLP", "CNN"]


@pytest.mark.parametrize("name", NEW_CONSTRUCTORS)
def test_entry_point_never_lands_on_the_cpu_unasked(name, monkeypatch):
    """A model built without ``device`` goes to the CUDA device, and raises
    where there is none; only ``device="cpu"`` builds it on the CPU (the
    rule of ``tests/test_torch_smp2d.py``'s test of the same name)."""
    build = _sample(name)
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.Tensor, "to", lambda self, *a, **kw: asked.append(
            kw.get("device")) or self)
    build()
    assert asked and all(d == torch.device("cuda") for d in asked)
    monkeypatch.undo()
    assert build(device="cpu").device == torch.device("cpu")
