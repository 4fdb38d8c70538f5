"""The physics family in the port (``models/physics.py``) against
``graphflow_tpu.models.physics`` with the JAX weights: SMP_omega_physics,
SMP_beta_physics and SMP_gamma_physics, with and without the Coulomb
adjacency (whose negative entries meet the adj>0 guard in the 18-case bank
and no guard in the 4-case one): prediction, the concatenated per-level
feature, the loss, every gradient, every parameter and the Adam state after
each of three steps, and the text checkpoint.

Dtypes.  The JAX constructor has no dtype: every parameter (the tower's,
W1, W2) is float32, and its ``_prepare`` passes none either, so the host
arrays are float32 too.  The float64 tests cast every parameter of both
models to float64 and keep the float32 host arrays, which both packages
then promote exactly; they hold 1e-9 forward and 1e-8 for gradients and
trained parameters.  The float32 tests compare the models as constructed:
both sum in float32 in another order, 1e-5 of the scale forward and 1e-4
for gradients."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models import physics as jphysics
from graphflow_tpu.models import smp2d as jsmp2d
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.models import smp2d as tsmp2d
from graphflow_tpu_torch.models.physics import halving_schedule
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
RTOL32_FWD, RTOL32_GRAD = 1e-5, 1e-4
LR = 1e-3
V, NFEAT = 8, 3
# name -> constructor arguments after max_nVertices.
FAMILY = {
    "SMP_omega_physics": dict(max_receptive_field=4, nLevels=2, nChanels=8),
    "SMP_beta_physics": dict(nLevels=2, nChanels=4),
    "SMP_gamma_physics": dict(max_receptive_field=4, nLevels=3, nChanels=4),
}
CASES = [(n, c) for n in FAMILY for c in (False, True)]


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _physics_graphs(mod):
    """Six graphs (n = 5..8) for package ``mod``: Erdos-Renyi edges, raw
    normal features, and a symmetric Coulomb matrix with negative entries
    and a diagonal.  Its entries are multiples of 1/8: the JAX package
    sums the prepared float32 adjacency in float32 (S, R, trA) before it
    meets the float64 weights, and such sums are exact, so the float64
    comparison is not limited by them."""
    graphs = []
    for s in range(6):
        n = 5 + s % 4
        g = mod.random_graph(n, 0.4, nFeatures=NFEAT, seed=10 + s)
        rng = np.random.default_rng(100 + s)
        g.feature = rng.normal(size=(n, NFEAT))
        c = rng.normal(size=(n, n))
        g.coulomb = np.round((c + c.T) * 4) / 8
        graphs.append(g)
    return graphs


TARGETS = [0.5, -1.0, 2.0, 1.5, -0.5, 3.0]


def _pair(name, use_coulomb, float64):
    kw = dict(FAMILY[name], nFeatures=NFEAT, use_coulomb=use_coulomb)
    jm = getattr(jphysics, name)(V, **kw, seed=3)
    tm = getattr(models, name)(V, **kw, device="cpu")
    if float64:
        jm.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                           jm.params)
        jm._finish_init()
        tm = tm.double()
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    return jm, tm


def _assert_same_model(tm, jm, rtol):
    ref = _flat(jm.params)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), rtol)
    for key in ("m", "v"):
        jstate = _flat(jm.opt_state[key])
        for path, x in tm.opt_state[key].items():
            _close(x, jstate[path].numpy(), rtol)
    assert tm.opt_state["t"] == int(jm.opt_state["t"])


@pytest.mark.parametrize("name,use_coulomb", CASES)
def test_physics_model_matches_jax_float64(name, use_coulomb):
    jm, tm = _pair(name, use_coulomb, float64=True)
    jg, tg = _physics_graphs(jdatasets), _physics_graphs(datasets)
    # The same registration order and shapes, the halving schedule.
    assert tm.param_order == jm.param_order
    assert tm.cfg.channel_schedule == tuple(jm.cfg.channel_schedule)
    assert (tm.cfg.nDepth, tm.cfg.has_WL_ordering, tm.cfg.use_wl_features,
            tm.cfg.contraction, tm.cfg.P) == (0, False, False,
                                              jm.cfg.contraction, jm.cfg.P)
    # The prepared batch: float32 on the host, raw features, the Coulomb
    # block with its diagonal and its negative entries.
    jb, tb = jm._stack(jg), tm._stack(tg)
    assert tm.prepare(tg[0]).radj.dtype == np.float32
    for f in ("wl_feat", "radj", "smask", "nbr", "pos"):
        _close(tb[f], jb[f], 0)
    assert bool((tb["radj"] < 0).any()) == use_coulomb
    # Serving.
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    nTotal = sum(tm.cfg.channel_schedule)
    for a, b in zip(jg[:3], tg[:3]):
        feat = tm.Feature(b)
        assert feat.shape == (nTotal,)
        _close(feat, jm.Feature(a), RTOL_FWD)
    _close(tm.Predict(tg[1]), jm.Predict(jg[1]), RTOL_FWD)
    # The loss and every gradient.
    _close(tm.getLoss(tg, TARGETS), jm.getLoss(jg, TARGETS), RTOL_FWD)
    loss, grads = tm._loss_and_grads(tm._stack(tg, TARGETS))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, TARGETS))
    _close(loss, jloss, RTOL_FWD)
    ref = _flat(jgrads)
    assert list(grads) == tm.param_order
    for path, g in grads.items():
        _close(g, ref[path].numpy(), RTOL_GRAD)
    # Three Adam steps, then a backtracking one.
    for _ in range(3):
        got = tm.BatchLearn(tg, TARGETS, LR)
        _close(np.array(got), np.array(jm.BatchLearn(jg, TARGETS, LR)),
               RTOL_GRAD)
        _assert_same_model(tm, jm, RTOL_GRAD)
    got = tm.Learn(tg[0], 1.0, 4 * LR, nIterations=2)
    _close(np.array(got), np.array(jm.Learn(jg[0], 1.0, 4 * LR,
                                            nIterations=2)), RTOL_GRAD)
    _assert_same_model(tm, jm, RTOL_GRAD)


@pytest.mark.parametrize("name,use_coulomb", CASES)
def test_physics_model_matches_jax_as_constructed(name, use_coulomb):
    """Both models in float32, as their constructors make them."""
    jm, tm = _pair(name, use_coulomb, float64=False)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(x.dtype == jnp.float32
               for x in jax.tree_util.tree_leaves(jm.params))
    jg, tg = _physics_graphs(jdatasets), _physics_graphs(datasets)
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL32_FWD)
    _close(tm.Feature(tg[2]), jm.Feature(jg[2]), RTOL32_FWD)
    loss, grads = tm._loss_and_grads(tm._stack(tg, TARGETS))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, TARGETS))
    _close(loss, jloss, RTOL32_FWD)
    ref = _flat(jgrads)
    for path, g in grads.items():
        _close(g, ref[path].numpy(), RTOL32_GRAD)
    for _ in range(3):
        got = tm.BatchLearn(tg, TARGETS, LR)
        _close(np.array(got), np.array(jm.BatchLearn(jg, TARGETS, LR)),
               RTOL32_GRAD)
    _assert_same_model(tm, jm, RTOL32_GRAD)


@pytest.mark.parametrize("name", FAMILY)
def test_physics_checkpoint_and_convert_round_trip(name, tmp_path):
    """The nested tree (tower/..., W1, W2) and the scheduled tower's unequal
    shapes cross ``params_from_jax``/``params_to_numpy`` and the text
    checkpoint both ways; the two packages write the same file."""
    jm, tm = _pair(name, True, float64=True)
    jg, tg = _physics_graphs(jdatasets), _physics_graphs(datasets)
    tree = params_to_numpy(tm.param_dict())
    jtree = jax.tree_util.tree_map(np.asarray, jm.params)
    assert jax.tree_util.tree_structure(tree) == (
        jax.tree_util.tree_structure(jtree))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    assert list(params_from_jax(tree)) == tm.param_order
    fn, fn2 = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jm.save_model(fn)
    tm.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()
    fresh = getattr(models, name)(
        V, **FAMILY[name], nFeatures=NFEAT, use_coulomb=True, seed=9,
        device="cpu").double()
    fresh._finish_init()
    fresh.BatchLearn(tg, TARGETS, LR)
    assert fresh.opt_state["t"] == 1
    fresh.load_model(fn)
    assert fresh.opt_state["t"] == 0
    _close(fresh.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    # And back: the JAX model loads the port's file.
    tm.BatchLearn(tg, TARGETS, LR)
    tm.save_model(fn2)
    jm.load_model(fn2)
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)


def test_constructors_and_reexports():
    assert halving_schedule(32, 2) == (32, 16, 8)
    assert halving_schedule(4, 4) == (4, 2, 1, 1, 1)
    for name in FAMILY:
        assert getattr(tsmp2d, name) is getattr(models, name)
        assert getattr(jsmp2d, name) is getattr(jphysics, name)
    m = models.SMP_omega_physics(V, 4, 2, 8, NFEAT, use_coulomb=True, seed=1,
                                 device="cpu")
    shapes = {p: tuple(v.shape) for p, v in m.param_dict().items()}
    assert shapes == {
        "tower/H": (8, NFEAT), "tower/levels/0/K": (144, 4),
        "tower/levels/0/b": (4,), "tower/levels/1/K": (72, 2),
        "tower/levels/1/b": (2,), "W1": (7, 14), "W2": (7,)}
    assert isinstance(m, models.SMPPhysics) and m.order == 2
    assert m.params["tower"]["levels"][1]["K"] is m.param_dict()[
        "tower/levels/1/K"]
    assert "W" not in m.params["tower"]
    again = models.SMP_omega_physics(V, 4, 2, 8, NFEAT, use_coulomb=True,
                                     seed=1, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 again.parameters()))


def test_theta_physics_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        models.SMP_theta_physics(V, 4, 2, 8, NFEAT, device="cpu")
    assert jphysics.SMP_theta_physics(V, 4, 2, 8, NFEAT).order == 1
