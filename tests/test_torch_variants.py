"""The SMP_2D contraction variants in the port against the JAX package at
float64, with the JAX weights: SMP_gamma (4 cases, Adam), SMP_2D_ver6 (10,
Momentum), ver7 (50, Momentum), ver8 (18, Momentum) and the ver6/ver7
classification heads (log loss, Momentum).  Serving (Threaded_Predict,
Feature), getLoss, the loss and every gradient of one batch, every
parameter and the optimizer state after each of 3 BatchLearn steps and
after a backtracking BatchLearn, the optimizers and the log loss alone,
the text checkpoint of a classification model, and the routing of the
10- and 50-case banks (the inference gather refuses gradients)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu import optim as joptim
from graphflow_tpu.models import smp2d as jsmp2d
from graphflow_tpu.ops.losses import log_loss as jax_log_loss
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models, optim
from graphflow_tpu_torch.models.smp2d import smp2d_forward
from graphflow_tpu_torch.ops.losses import log_loss
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
LR = 1e-3
CFG = dict(max_nVertices=8, max_receptive_field=4, nLevels=2, nChanels=4,
           nFeatures=4, nDepth=2)
# name -> (contraction, nClasses, optimizer), as the JAX constructors set.
VARIANTS = {
    "SMP_gamma": (4, None, "adam"),
    "SMP_2D_ver6": (10, None, "momentum"),
    "SMP_2D_ver7": (50, None, "momentum"),
    "SMP_2D_ver8": (18, None, "momentum"),
    "SMP_2D_ver6_classification": (10, 3, "momentum"),
    "SMP_2D_ver7_classification": (50, 3, "momentum"),
}


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _pair(name, seed=3):
    """The JAX model in float64, configured as its constructor configures
    it, and the port's, sharing the JAX weights."""
    k, ncls, opt = VARIANTS[name]
    kw = dict(CFG, contraction=k, nClasses=ncls, optimizer=opt,
              dtype="float64")
    jm = jsmp2d.SMP2D(jsmp2d.SMP2DConfig(**kw), seed=seed)
    tm = models.SMP2D(models.SMP2DConfig(**kw), device="cpu")
    tm.load_params(_flat(jm.params))
    return jm, tm


def _data(name):
    """Toy molecules plus two random graphs, for each package; class labels
    for a classification head, else regression targets."""
    jg, jt = jdatasets.toy_molecules()
    tg, tt = datasets.toy_molecules()
    jg += [jdatasets.random_graph(8, 0.3, seed=s) for s in (1, 2)]
    tg += [datasets.random_graph(8, 0.3, seed=s) for s in (1, 2)]
    targets = ([0.0, 1.0, 2.0, 1.0, 0.0, 2.0] if VARIANTS[name][1]
               else jt + [3.0, 4.5])
    return jg, tg, targets


def _assert_same_model(tm, jm):
    ref = _flat(jm.params)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), RTOL_GRAD)
    if tm.cfg.optimizer == "momentum":
        jstate = _flat(jm.opt_state)
        assert list(tm.opt_state) == tm.param_order
        for path, v in tm.opt_state.items():
            _close(v, jstate[path].numpy(), RTOL_GRAD)
    else:
        for key in ("m", "v"):
            jstate = _flat(jm.opt_state[key])
            for path, x in tm.opt_state[key].items():
                _close(x, jstate[path].numpy(), RTOL_GRAD)
        assert tm.opt_state["t"] == int(jm.opt_state["t"])


@pytest.mark.parametrize("name", VARIANTS)
def test_serving_and_gradients_match_jax(name):
    jm, tm = _pair(name)
    jg, tg, targets = _data(name)
    pred = tm.Threaded_Predict(tg)
    ncls = VARIANTS[name][1]
    assert pred.shape == ((len(tg), ncls) if ncls else (len(tg),))
    _close(pred, jm.Threaded_Predict(jg), RTOL_FWD)
    for a, b in zip(jg, tg):
        _close(tm.Feature(b), jm.Feature(a), RTOL_FWD)
    _close(tm.getLoss(tg, targets), jm.getLoss(jg, targets), RTOL_FWD)
    loss, grads = tm._loss_and_grads(tm._stack(tg, targets))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, targets))
    _close(loss, jloss, RTOL_FWD)
    ref = _flat(jgrads)
    assert list(grads) == tm.param_order
    for path, g in grads.items():
        _close(g, ref[path].numpy(), RTOL_GRAD)


@pytest.mark.parametrize("name", VARIANTS)
def test_three_steps_and_backtracking_match_jax(name):
    jm, tm = _pair(name)
    jg, tg, targets = _data(name)
    for _ in range(3):
        got = tm.BatchLearn(tg, targets, LR)
        _close(np.array(got), np.array(jm.BatchLearn(jg, targets, LR)),
               RTOL_GRAD)
        _assert_same_model(tm, jm)
    got = tm.BatchLearn(tg, targets, 4 * LR, nIterations=3)
    _close(np.array(got), np.array(jm.BatchLearn(jg, targets, 4 * LR,
                                                 nIterations=3)), RTOL_GRAD)
    _assert_same_model(tm, jm)


@pytest.mark.parametrize("name", ["SMP_2D_ver6", "SMP_2D_ver7"])
def test_inference_gather_refuses_gradients(name):
    """The 10- and 50-case variants serve through ``risi18_aligned_t2``,
    which has no backward; the training route (``training=True``) gathers
    with the take-gather, which autograd differentiates."""
    _, tm = _pair(name)
    _, tg, targets = _data(name)
    batch = tm._stack(tg, targets)
    with pytest.raises(RuntimeError, match="no backward"):
        smp2d_forward(tm.params, batch, tm.cfg)
    pred, _ = smp2d_forward(tm.params, batch, tm.cfg, training=True)
    with torch.no_grad():
        served, _ = smp2d_forward(tm.params, batch, tm.cfg)
    torch.testing.assert_close(pred.detach(), served, rtol=0, atol=0)


def test_constructors_pick_contraction_head_and_optimizer():
    """Each port constructor configures its model as the JAX constructor of
    the same name does."""
    C = CFG["nChanels"]
    for name, (k, ncls, opt) in VARIANTS.items():
        kw = dict(CFG, nClasses=ncls) if ncls else CFG
        m = getattr(models, name)(**kw, device="cpu")
        jcfg = getattr(jsmp2d, name)(**kw).cfg
        assert (m.cfg.contraction, m.cfg.nClasses, m.cfg.optimizer) == (
            jcfg.contraction, jcfg.nClasses, jcfg.optimizer) == (k, ncls, opt)
        assert m.param_dict()["levels/1/K"].shape == (k * C, C)
        assert m.param_dict()["W"].shape == ((ncls, C) if ncls else (C,))
        assert isinstance(m.opt_state, dict)
        assert ("t" in m.opt_state) == (opt == "adam")
    thread = models.SMP_2D_ver8_thread(**CFG, nThreads=4, seed=2,
                                       device="cpu")
    ver8 = models.SMP_2D_ver8(**CFG, seed=2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(thread.parameters(),
                                                 ver8.parameters()))


@pytest.mark.parametrize("nBatch", [None, 4])
def test_momentum_matches_jax(nBatch):
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (7,)}
    p0 = {k: rng.normal(size=s) for k, s in shapes.items()}
    jopt, topt = joptim.momentum(), optim.make_optimizer("Momentum")
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert topt.set_element_schedule is None
    for _ in range(3):
        g = {k: rng.normal(size=s) for k, s in shapes.items()}
        old, kept = ts, {k: v.clone() for k, v in ts.items()}
        jp, js = jopt.update(jp, js, {k: jnp.asarray(v) for k, v in g.items()},
                             0.05, nBatch=nBatch)
        tp, ts = topt.update(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in g.items()}, 0.05,
                             nBatch=nBatch)
        for k in shapes:
            _close(tp[k], jp[k], RTOL_GRAD)
            _close(ts[k], js[k], RTOL_GRAD)
        # The old state is never written, so backtracking can restore it.
        assert all(torch.equal(old[k], kept[k]) for k in shapes)


@pytest.mark.parametrize("B,n", [(1, 3), (5, 4)])
def test_log_loss_matches_jax(B, n):
    rng = np.random.default_rng(B + n)
    scores = rng.normal(size=(B, n)) * 3
    labels = rng.integers(0, n, size=B).astype(np.float32)
    ref = sum(float(jax_log_loss(jnp.asarray(s), int(t)))
              for s, t in zip(scores, labels))
    _close(log_loss(torch.from_numpy(scores), torch.from_numpy(labels)),
           ref, RTOL_FWD)


def test_classification_checkpoint_round_trip(tmp_path):
    """A [nClasses, C] W crosses the text checkpoint both ways, byte for
    byte, and load_model resets the Momentum state."""
    name = "SMP_2D_ver7_classification"
    jm, _ = _pair(name)
    jg, tg, targets = _data(name)
    fn = str(tmp_path / "ver7_cls.dat")
    jm.save_model(fn)
    tm = models.SMP2D(models.SMP2DConfig(
        **CFG, contraction=50, nClasses=3, optimizer="momentum",
        dtype="float64"), seed=9, device="cpu")
    tm.BatchLearn(tg, targets, LR)
    assert any(v.any() for v in tm.opt_state.values())
    # The Momentum state is a parameter-shaped tree, as the JAX package's.
    tree = params_to_numpy(tm.opt_state)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jm.opt_state))
    for path, v in params_from_jax(tree).items():
        torch.testing.assert_close(v, tm.opt_state[path], rtol=0, atol=0)
    tm.load_model(fn)
    assert tm.param_dict()["W"].shape == (3, CFG["nChanels"])
    assert not any(v.any() for v in tm.opt_state.values())
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    fn2 = str(tmp_path / "ver7_cls_port.dat")
    tm.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()


def test_classification_predict_fails_in_both_packages():
    """Predict converts the first row to a float, which an [nClasses] row
    of scores refuses in both packages (no new feature in the port)."""
    jm, tm = _pair("SMP_2D_ver6_classification")
    jg, tg, _ = _data("SMP_2D_ver6_classification")
    with pytest.raises(TypeError):
        jm.Predict(jg[0])
    with pytest.raises(ValueError, match="one element"):
        tm.Predict(tg[0])
    _close(tm.Threaded_Predict(tg[:1])[0], jm.Threaded_Predict(jg[:1])[0],
           RTOL_FWD)
