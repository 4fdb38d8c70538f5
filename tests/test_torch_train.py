"""The port's training slice against the JAX package on the CPU, float64:
the level's gradients, the squared loss, Adam (both overloads, with the
per-element schedule), the backtracking loop, and SMP_omega's getLoss,
BatchLearn (with and without nIterations), Learn and the checkpoint after
training.  On the CPU the JAX package trains through its XLA composition
(smp2d.py:252-256), and the port's level runs its plain version under
torch autograd; no kernel is launched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu import optim as joptim
from graphflow_tpu.models import SMP2D as JaxSMP2D
from graphflow_tpu.models import SMP2DConfig as JaxSMP2DConfig
from graphflow_tpu.ops.losses import squared_loss as jax_squared_loss
from graphflow_tpu.ops.risi_fused_pallas import _reference_level
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import optim
from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level, risi18_level_backward, risi18_level_backward_reference)
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from graphflow_tpu_torch.utils.datasets import random_level_case

torch.set_num_threads(1)

# float64 against float64: every comparison holds to 1e-8 * max(1, scale).
RTOL = 1e-8
# XLA and torch round the float32 pow of Adam's schedule differently in
# the last place at some exponents (beta2 first at 168), which moves a step
# by ~1e-7 of itself; the slice trains at a rate where no step blows the
# loss up, so that this stays far below RTOL.
LR = 1e-3
CFG = dict(max_nVertices=10, max_receptive_field=4, nLevels=2, nChanels=6,
           nFeatures=4, nDepth=3)


def _close(got, ref, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the level's gradients --------------------------------------------------

LEVEL_SHAPES = [(6, 4, 4, 4), (5, 8, 4, 6), (4, 4, 8, 8)]


def _level_case(V, P, C, Cout, negative):
    """Seeded level inputs with sentinel slots, one all-absent vertex and,
    when ``negative``, an all-negative adjacency; plus a cotangent."""
    d = random_level_case(V, P, C, Cout, seed=V * P + C, empty_vertex=1)
    if negative:
        d["radj"] = -np.abs(d["radj"]) - 0.1
    g = np.random.default_rng(V + P).normal(size=(V, P * P, Cout))
    return d, g


def _jax_level_grads(d, g):
    """jax.grad of the JAX package's plain level, jitted: run op by op on
    the CPU, ``_reference_level`` at P=8, C=4 returns NaN rows in some
    calls and not in others (see ROADMAP queue 3)."""
    structure = [jnp.asarray(d[k]) for k in ("nbr", "pos", "radj")]

    def f(state, K, b):
        return jnp.sum(_reference_level(state, *structure, K, b) * g)

    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *[jnp.asarray(d[k]) for k in ("state", "K", "b")])


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("V,P,C,Cout", LEVEL_SHAPES)
def test_level_gradients_match_jax(V, P, C, Cout, negative):
    d, g = _level_case(V, P, C, Cout, negative)
    state, K, b = (_t(d[k]).requires_grad_() for k in ("state", "K", "b"))
    out = risi18_level(state, _t(d["nbr"]), _t(d["pos"]), _t(d["radj"]), K, b)
    got = torch.autograd.grad(out, (state, K, b), _t(g))
    for x, ref in zip(got, _jax_level_grads(d, g)):
        _close(x, ref)


@pytest.mark.parametrize("V,P,C,Cout", LEVEL_SHAPES)
def test_backward_reference_matches_jax_without_launch(V, P, C, Cout):
    d, g = _level_case(V, P, C, Cout, negative=False)
    args = [_t(d[k]) for k in ("state", "nbr", "pos", "radj", "K", "b")]
    counts = (risi18_level.launches, risi18_level_backward.launches,
              risi18_level_backward.reduce_launches)
    ref = _jax_level_grads(d, g)
    plain = risi18_level_backward_reference(*args, _t(g))
    wrapped = risi18_level_backward(*args, risi18_level(*args), _t(g))
    for x, y, r in zip(plain, wrapped, ref):
        _close(x, r)
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    assert not any(t.requires_grad for t in args)
    assert (risi18_level.launches, risi18_level_backward.launches,
            risi18_level_backward.reduce_launches) == counts == (0, 0, 0)


# -- loss, Adam, backtracking ------------------------------------------------

@pytest.mark.parametrize("n", [1, 5])
def test_squared_loss_matches_jax(n):
    rng = np.random.default_rng(n)
    p, t = rng.normal(size=n), rng.normal(size=n)
    _close(squared_loss(_t(p), _t(t)), jax_squared_loss(jnp.asarray(p),
                                                         jnp.asarray(t)))


SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 2)}
ORDER = ["a", "b", "c"]


def _adam_pair(p0):
    jopt, topt = joptim.adam(), optim.adam()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v.copy()) for k, v in p0.items()}
    jopt.set_element_schedule(jp, ORDER)
    topt.set_element_schedule(tp, ORDER)
    return jopt, jp, jopt.init(jp), topt, tp, topt.init(tp)


@pytest.mark.parametrize("nBatch", [None, 4])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adam_matches_jax(dtype, nBatch):
    """Three steps of both overloads with the schedule installed.  float32
    holds to 2e-6 * max(1, scale): XLA and torch round the float32 pow
    differently in the last place."""
    rtol = RTOL if dtype == "float64" else 2e-6
    rng = np.random.default_rng(5)
    p0 = {k: rng.normal(size=s).astype(dtype) for k, s in SHAPES.items()}
    jopt, jp, js, topt, tp, ts = _adam_pair(p0)
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(dtype) for k, s in SHAPES.items()}
        jp, js = jopt.update(jp, js,
                             {k: jnp.asarray(v) for k, v in grads.items()},
                             0.05, nBatch=nBatch)
        tp, ts = topt.update(tp, ts, {k: _t(v) for k, v in grads.items()},
                             0.05, nBatch=nBatch)
        assert ts["t"] == int(js["t"])
        for k in ORDER:
            assert tp[k].dtype == getattr(torch, dtype)
            _close(tp[k], jp[k], rtol)
            _close(ts["m"][k], js["m"][k], rtol)
            _close(ts["v"][k], js["v"][k], rtol)


def test_adam_nbatch_matches_reference_element_loop():
    """The nBatch overload against a NumPy transcription of Adam.h:108-136
    (beta^t advanced per element in registration order, as in
    tests/test_ops.py).  The transcription's running product is float64,
    the port holds the exponent and the pow in float32 as the JAX package
    does, so the bound is that test's rtol 2e-5, atol 1e-6."""
    rng = np.random.default_rng(5)
    p0 = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    opt = optim.adam()
    p = {k: _t(v.copy()) for k, v in p0.items()}
    opt.set_element_schedule(p, ORDER)
    state = opt.init(p)
    ref = {k: v.copy() for k, v in p0.items()}
    m = {k: np.zeros(SHAPES[k]) for k in ORDER}
    v = {k: np.zeros(SHAPES[k]) for k in ORDER}
    beta1, beta2, eps, lr, nBatch = 0.9, 0.999, 1e-8, 0.05, 4
    b1t = b2t = 1.0
    for _ in range(3):
        grads = {k: rng.normal(size=SHAPES[k]) for k in ORDER}
        for k in ORDER:
            gk, mk, vk, pk = (grads[k].reshape(-1), m[k].reshape(-1),
                              v[k].reshape(-1), ref[k].reshape(-1))
            for j in range(gk.size):
                g = gk[j] / nBatch
                mk[j] = beta1 * mk[j] + (1 - beta1) * g
                vk[j] = beta2 * vk[j] + (1 - beta2) * g * g
                b1t *= beta1
                b2t *= beta2
                pk[j] -= lr * (mk[j] / (1 - b1t)) / (
                    np.sqrt(vk[j] / (1 - b2t)) + eps)
        p, state = opt.update(p, state, {k: _t(g) for k, g in grads.items()},
                              lr, nBatch=nBatch)
        for k in ORDER:
            np.testing.assert_allclose(p[k].numpy(), ref[k], rtol=2e-5,
                                       atol=1e-6)


def test_adam_without_schedule_uses_no_correction():
    p0 = {"w": np.array([1.0, -2.0])}
    opt = optim.adam()
    p = {"w": _t(p0["w"].copy())}
    p, _ = opt.update(p, opt.init(p), {"w": _t(np.array([0.4, 0.8]))}, 0.1,
                      nBatch=2)
    g = np.array([0.2, 0.4])
    expect = p0["w"] - 0.1 * (0.1 * g) / (np.sqrt(0.001 * g * g) + 1e-8)
    _close(p["w"], expect)


@pytest.mark.parametrize("name", ["rmsprop", "lbfgs"])
def test_other_optimizers_raise(name):
    """Names the JAX package's registry lacks too."""
    with pytest.raises(NotImplementedError, match="JAX package has no"):
        optim.make_optimizer(name)


def _state_leaves(state):
    """{name: array} of an optimizer state: dicts of {path: x}, or the
    scalar ``t``."""
    if not isinstance(state, dict):
        return {}
    out = {}
    for key, sub in state.items():
        if isinstance(sub, dict):
            out.update({f"{key}/{k}": np.asarray(v) for k, v in sub.items()})
        else:
            out[key] = np.asarray(sub)
    return out


@pytest.mark.parametrize("nBatch", [None, 3])
@pytest.mark.parametrize("name", ["sgd", "adamax", "adadelta"])
def test_other_reference_optimizers_match_jax(name, nBatch):
    """SGD, AdaMax and AdaDelta, built by name, against the JAX ones over
    four float64 steps: every parameter and every state tensor to 1e-8 of
    the scale.  Tensor "c" gets an all-zero gradient at every step: AdaMax
    keeps one infinity norm per tensor, which stays 0 there, so both
    packages update "c" by 0 / 0 (NaN, compared as equal); AdaDelta
    ignores its learning rate."""
    rng = np.random.default_rng(11)
    p0 = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    jopt, topt = joptim.make_optimizer(name), optim.make_optimizer(name)
    assert topt.set_element_schedule is None
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        grads = {k: rng.normal(size=s) * (k != "c")
                 for k, s in SHAPES.items()}
        lr = 0.05 * (step + 1)
        jp, js = jopt.update(jp, js,
                             {k: jnp.asarray(v) for k, v in grads.items()},
                             lr, nBatch=nBatch)
        tp, ts = topt.update(tp, ts, {k: _t(v) for k, v in grads.items()},
                             lr, nBatch=nBatch)
        for k in ORDER:
            _close(tp[k], jp[k])
        jleaves = _state_leaves(js)
        tleaves = _state_leaves(ts)
        assert set(tleaves) == set(jleaves)
        for k, x in tleaves.items():
            _close(x, jleaves[k])
    nan = np.isnan(tp["c"].numpy()).all()
    assert nan == (name == "adamax")
    if name == "adadelta":
        again = optim.adadelta()
        q = {k: _t(v.copy()) for k, v in p0.items()}
        q, _ = again.update(q, again.init(q), {k: _t(np.ones(s)) for k, s in
                                                SHAPES.items()}, 123.0)
        r = {k: _t(v.copy()) for k, v in p0.items()}
        r, _ = again.update(r, again.init(r), {k: _t(np.ones(s)) for k, s in
                                                SHAPES.items()}, None)
        for k in ORDER:
            assert torch.equal(q[k], r[k])


def _quadratic(target, weight, log):
    """loss = sum w (p - target)^2 over the leaves, in NumPy; ``log``
    records every loss evaluated."""
    def loss_and_grads(params):
        p = {k: np.asarray(x, dtype=np.float64) for k, x in params.items()}
        loss = sum(float(np.sum(weight[k] * (p[k] - target[k]) ** 2))
                   for k in ORDER)
        log.append(loss)
        return loss, {k: 2 * weight[k] * (p[k] - target[k]) for k in ORDER}
    return loss_and_grads


@pytest.mark.parametrize("lr,min_lr", [(4.0, 1e-6), (4.0, 2.0)])
def test_backtracking_matches_jax(lr, min_lr):
    """A rejected first step (lr too large) in both cases; with min_lr=2
    the loop stops at the first rejection and the cached parameters and
    state come back unchanged."""
    rng = np.random.default_rng(9)
    p0 = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    target = {k: rng.normal(size=s) * 0.1 for k, s in SHAPES.items()}
    weight = {k: rng.uniform(0.5, 2.0, size=s) for k, s in SHAPES.items()}
    jopt, jp, js, topt, tp, ts = _adam_pair(p0)
    jlog, tlog = [], []
    jf, tf = _quadratic(target, weight, jlog), _quadratic(target, weight, tlog)

    def jloss(params):
        loss, g = jf(params)
        return loss, {k: jnp.asarray(x) for k, x in g.items()}

    def tloss(params):
        loss, g = tf({k: x.numpy() for k, x in params.items()})
        return loss, {k: _t(x) for k, x in g.items()}

    jp, js, jl0, jl1 = joptim.backtracking_learn(
        jp, js, jloss, jopt.update, lr, 6,
        min_lr=min_lr, nBatch=2)
    tp, ts, tl0, tl1 = optim.backtracking_learn(
        tp, ts, tloss, topt.update, lr, 6, min_lr=min_lr, nBatch=2)
    assert tlog[1] > tlog[0]                      # the first step is rejected
    _close(np.array(tlog), np.array(jlog))
    _close(np.array([tl0, tl1]), np.array([jl0, jl1]))
    assert ts["t"] == int(js["t"])
    for k in ORDER:
        _close(tp[k], jp[k])
        _close(ts["m"][k], js["m"][k])
        _close(ts["v"][k], js["v"][k])
    if min_lr == 2.0:
        assert len(tlog) == 2 and ts["t"] == 0 and tl1 == tl0
        for k in ORDER:
            np.testing.assert_array_equal(tp[k].numpy(), p0[k])
    else:
        assert tl1 < tl0


# -- the slice: SMP_omega trained by both packages ----------------------------

def _pair():
    """A JAX SMP_omega and the port's, float64, sharing the JAX weights."""
    jm = JaxSMP2D(JaxSMP2DConfig(**CFG, dtype="float64"), seed=3)
    tm = SMP2D(SMP2DConfig(**CFG, dtype="float64"), device="cpu")
    tm.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jm.params)))
    return jm, tm


def _data():
    """Toy molecules plus two random graphs, for each package."""
    jg, jt = jdatasets.toy_molecules()
    tg, tt = datasets.toy_molecules()
    jg += [jdatasets.random_graph(10, 0.3, seed=s) for s in (1, 2)]
    tg += [datasets.random_graph(10, 0.3, seed=s) for s in (1, 2)]
    return jg, jt + [3.0, 4.5], tg, tt + [3.0, 4.5]


def _assert_same_model(tm, jm):
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy())
    for key in ("m", "v"):
        jstate = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jm.opt_state[key]))
        for path, x in tm.opt_state[key].items():
            _close(x, jstate[path].numpy())
    assert tm.opt_state["t"] == int(jm.opt_state["t"])


def test_getloss_and_gradients_match_jax():
    jm, tm = _pair()
    jg, jt, tg, tt = _data()
    _close(tm.getLoss(tg, tt), jm.getLoss(jg, jt))
    loss, grads = tm._loss_and_grads(tm._stack(tg, tt))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, jt))
    _close(loss, jloss)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert list(grads) == tm.param_order
    for path, g in grads.items():
        _close(g, ref[path].numpy())


def test_batch_learn_matches_jax_over_two_steps():
    jm, tm = _pair()
    jg, jt, tg, tt = _data()
    for _ in range(2):
        got = tm.BatchLearn(tg, tt, LR)
        assert all(isinstance(x, float) for x in got)
        _close(np.array(got), np.array(jm.BatchLearn(jg, jt, LR)))
        _assert_same_model(tm, jm)


def test_batch_learn_backtracking_and_learn_match_jax():
    jm, tm = _pair()
    jg, jt, tg, tt = _data()
    got = tm.Threaded_BatchLearn(tg, tt, 4 * LR, nIterations=3)
    _close(np.array(got), np.array(jm.BatchLearn(jg, jt, 4 * LR,
                                                 nIterations=3)))
    _assert_same_model(tm, jm)
    for j, t, target in zip(jg[:2], tg[:2], jt[:2]):
        got = tm.Learn(t, target, LR)
        _close(np.array(got), np.array(jm.Learn(j, target, LR)))
        _assert_same_model(tm, jm)


def test_trained_checkpoint_round_trip_and_state_reset(tmp_path):
    _, tm = _pair()
    _, _, tg, tt = _data()
    tm.BatchLearn(tg, tt, 0.01)
    assert tm.opt_state["t"] == 1
    fn = str(tmp_path / "trained.dat")
    tm.save_model(fn)
    fresh = SMP2D(SMP2DConfig(**CFG, dtype="float64"), seed=99,
                  device="cpu")
    fresh.BatchLearn(tg, tt, 0.01)
    fresh.load_model(fn)
    assert fresh.opt_state["t"] == 0
    assert not any(x.any() for x in fresh.opt_state["m"].values())
    _close(fresh.Threaded_Predict(tg), tm.Threaded_Predict(tg))
    _close(fresh.getLoss(tg, tt), tm.getLoss(tg, tt))


def test_cache_and_restore_parameters():
    _, tm = _pair()
    _, _, tg, tt = _data()
    tm.cache_parameters()
    before = params_to_numpy(tm.param_dict())
    loss0, loss1 = tm.BatchLearn(tg, tt, 0.01)
    assert tm.opt_state["t"] == 1 and loss1 != loss0
    tm.restore_parameters()
    assert tm.opt_state["t"] == 0
    _close(tm.getLoss(tg, tt), loss0)
    after = params_to_numpy(tm.param_dict())
    np.testing.assert_array_equal(after["H"], before["H"])
    np.testing.assert_array_equal(after["levels"][1]["K"],
                                  before["levels"][1]["K"])
