"""The port's library models and their ops against the JAX package on the
CPU, with the JAX weights: the convolutions and pools (``ops/conv.py``:
forward and gradient, a bias of rank 1 and 2, stride and padding), LSTM and
GRU (``models/rnn.py``: getLoss, Predict and Learn over three iterations,
the GRU's sigmoid candidate and the double softmax included), MLP and CNN
(``models/mlp.py``: both pools, the L2 regularizer, three BatchLearn steps
with each of the five optimizers), the L1 and L2 regularizers, the four
elementwise activations, ``optim/utils.py`` and the text checkpoints.

Tolerances.  The ops run in float64 in both packages: 1e-12 of the scale.
LSTM, GRU and MLP: the JAX constructors make float32 parameters; the tests
cast both models' parameters to float64 (``tests/test_model_parity2.py:
_cast64``) and feed float32 inputs, which both promote exactly: losses and
outputs to 1e-9 * max(1, scale), parameters after training to 1e-8.  The
CNN runs in float32 only (the JAX package's ``conv2d`` refuses a float64
filter over float32 images), so both models run as constructed, to 1e-5 of
the scale."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu import optim as joptim
from graphflow_tpu.models import mlp as jmlp
from graphflow_tpu.models import rnn as jrnn
from graphflow_tpu.ops import activations as jactivations
from graphflow_tpu.ops import conv as jconv
from graphflow_tpu.ops import losses as jlosses
from graphflow_tpu_torch import models, optim
from graphflow_tpu_torch.models.rnn import clip_gradients_l1
from graphflow_tpu_torch.ops import activations, conv, losses
from graphflow_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL_OP = 1e-12
RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
RTOL32 = 1e-5
OPTIMIZERS = ["sgd", "momentum", "adam", "adamax", "adadelta"]


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _with_jax_weights(jm, tm, float64):
    """Put the JAX model's weights into the port's, in float64 if asked."""
    if float64:
        jm.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                           jm.params)
        tm = tm.double()
    jm.opt_state = jm.opt.init(jm.params)
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    return tm


def _same_params(tm, jm, rtol):
    ref = _flat(jm.params)
    assert set(ref) == set(tm.param_order)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), rtol)


# -- ops --------------------------------------------------------------------

CONV2D = [((6, 7, 2), (3, 3, 2, 4), (2, 4), 1, 0),
          ((6, 7, 2), (3, 2, 2, 3), (2, 3), 2, 1),
          ((2, 8, 6, 3), (5, 5, 3, 2), (3, 2), 1, 2),
          ((2, 7, 7, 1), (2, 2, 1, 2), None, 2, 0)]


@pytest.mark.parametrize("x_shape,f_shape,b_shape,stride,pad", CONV2D)
def test_conv2d_matches_jax(x_shape, f_shape, b_shape, stride, pad):
    """The forward and the gradients of x, the filter and the bias."""
    rng = np.random.default_rng(sum(x_shape) + stride)
    args = [rng.normal(size=x_shape), rng.normal(size=f_shape)]
    if b_shape is not None:
        args.append(rng.normal(size=b_shape))

    def jf(*a):
        return jconv.conv2d(*a[:2], a[2] if len(a) > 2 else None, stride, pad)

    jy, jvjp = jax.vjp(jf, *map(jnp.asarray, args))
    targs = [_t(a).requires_grad_() for a in args]
    y = conv.conv2d(*targs[:2], targs[2] if len(targs) > 2 else None,
                    stride, pad)
    _close(y, np.asarray(jy), RTOL_OP)
    g = rng.normal(size=jy.shape)
    for x, r in zip(torch.autograd.grad(y, targs, _t(g)),
                    jvjp(jnp.asarray(g))):
        _close(x, np.asarray(r), RTOL_OP)


def test_conv2d_refuses_a_bias_of_rank_1():
    """The JAX conv2d indexes its summed bias as a vector, which a [C2]
    bias (summed to a scalar) is not; the port raises too."""
    x, f, b = np.ones((4, 4, 2)), np.ones((2, 2, 2, 3)), np.ones(3)
    with pytest.raises(IndexError):
        jconv.conv2d(jnp.asarray(x), jnp.asarray(f), jnp.asarray(b))
    with pytest.raises(ValueError, match="bias"):
        conv.conv2d(_t(x), _t(f), _t(b))


CONV1D = [((9, 3), (3, 3, 2), (2,), 3, 0),
          ((10, 2), (4, 2, 3), (2, 3), 2, 1),
          ((3, 8, 2), (2, 2, 4), (4,), 2, 0)]


@pytest.mark.parametrize("x_shape,f_shape,b_shape,stride,pad", CONV1D)
def test_conv1d_matches_jax(x_shape, f_shape, b_shape, stride, pad):
    """The JAX conv1d takes one sequence; the port's also a batch, each
    held against the JAX function on its own."""
    rng = np.random.default_rng(sum(x_shape) + 7 * stride)
    x, f, b = (rng.normal(size=s) for s in (x_shape, f_shape, b_shape))
    tx, tf, tb = (_t(a).requires_grad_() for a in (x, f, b))
    y = conv.conv1d(tx, tf, tb, stride, pad)
    g = rng.normal(size=tuple(y.shape))
    dx, df, db = torch.autograd.grad(y, (tx, tf, tb), _t(g))
    xs, gs = (x, g) if x.ndim == 3 else (x[None], g[None])
    jdf = jdb = 0.0
    for i, (xi, gi) in enumerate(zip(xs, gs)):
        jy, jvjp = jax.vjp(lambda a, w, c: jconv.conv1d(a, w, c, stride, pad),
                           jnp.asarray(xi), jnp.asarray(f), jnp.asarray(b))
        _close(y[i] if x.ndim == 3 else y, np.asarray(jy), RTOL_OP)
        jdx, jdf_i, jdb_i = jvjp(jnp.asarray(gi))
        _close(dx[i] if x.ndim == 3 else dx, np.asarray(jdx), RTOL_OP)
        jdf, jdb = jdf + np.asarray(jdf_i), jdb + np.asarray(jdb_i)
    _close(df, jdf, RTOL_OP)
    _close(db, jdb, RTOL_OP)


@pytest.mark.parametrize("pool", ["max_pool2d", "avg_pool2d"])
@pytest.mark.parametrize("shape,window,stride", [((7, 6, 3), 2, 2),
                                                 ((2, 9, 9, 2), 3, 2)])
def test_pools_match_jax(pool, shape, window, stride):
    """VALID pools, forward and gradient."""
    rng = np.random.default_rng(len(shape) * window)
    x = rng.normal(size=shape)
    jy, jvjp = jax.vjp(lambda a: getattr(jconv, pool)(a, window, stride),
                       jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y = getattr(conv, pool)(tx, window, stride)
    _close(y, np.asarray(jy), RTOL_OP)
    g = rng.normal(size=jy.shape)
    (dx,) = torch.autograd.grad(y, tx, _t(g))
    _close(dx, np.asarray(jvjp(jnp.asarray(g))[0]), RTOL_OP)


@pytest.mark.parametrize("name", ["identity", "sigmoid", "tanh", "relu"])
def test_elementwise_activations_match_jax(name):
    """Forward and gradient; relu at 0 splits its gradient as
    ``jnp.maximum`` does."""
    x = np.array([-2.0, -0.5, 0.0, 0.3, 4.0])
    jy, jvjp = jax.vjp(getattr(jactivations, name), jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y = getattr(activations, name)(tx)
    _close(y, np.asarray(jy), RTOL_OP)
    g = np.arange(1.0, 6.0)
    (dx,) = torch.autograd.grad(y, tx, _t(g))
    _close(dx, np.asarray(jvjp(jnp.asarray(g))[0]), RTOL_OP)


@pytest.mark.parametrize("name", ["l1_regularization", "l2_regularization"])
def test_regularizers_match_jax(name):
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(5,))}
    jl, jg = jax.value_and_grad(lambda p: getattr(jlosses, name)(p, 0.3))(
        {k: jnp.asarray(v) for k, v in tree.items()})
    params = {k: _t(v).requires_grad_() for k, v in tree.items()}
    loss = getattr(losses, name)(params, 0.3)
    _close(loss, np.asarray(jl), RTOL_OP)
    for k, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
        _close(g, np.asarray(jg[k]), RTOL_OP)
    # A list of tensors, as the CNN passes it, gives the same.
    _close(getattr(losses, name)(list(params.values()), 0.3), np.asarray(jl),
           RTOL_OP)


def test_optim_utils():
    """Xavier's bound and default fan; init_like keeps the tree; the
    gradient sums; a snapshot survives an in-place step and comes back."""
    gen = torch.Generator().manual_seed(0)
    x = optim.xavier_init((30, 40), gen, torch.float64)
    assert float(x.abs().max()) <= np.sqrt(3.0 / 1200)
    assert float(x.abs().max()) > 0.9 * np.sqrt(3.0 / 1200)
    assert float(optim.xavier_init((4,), gen, fan=3).abs().max()) <= 1.0
    tree = optim.init_like(gen, {"b": (2, 3), "a": [(4,), (1, 2)]},
                           dtype=torch.float64)
    assert list(tree) == ["b", "a"] and tuple(tree["a"][1].shape) == (1, 2)
    assert float(tree["b"].abs().max()) <= 0.9 / 2
    p = {"w": torch.ones(3), "v": torch.arange(2.0)}
    acc = optim.sum_gradients_init(p)
    acc = optim.sum_gradients_add(acc, p)
    acc = optim.sum_gradients_add(acc, p)
    assert torch.equal(acc["w"], 2 * torch.ones(3))
    snap = optim.cache_parameters(p)
    p["w"].add_(5.0)
    assert torch.equal(snap["w"], torch.ones(3))
    assert optim.restore_parameters(snap) is snap
    assert optim.restore_parameters(snap, p) is p
    assert torch.equal(p["w"], torch.ones(3))
    jtree = joptim.init_like(jax.random.PRNGKey(0), {"b": (2, 3), "a": (4,)})
    assert {k: v.shape for k, v in jtree.items()} == {"b": (2, 3),
                                                      "a": (4,)}


def test_clip_gradients_l1():
    rng = np.random.default_rng(4)
    grads = {"a": rng.normal(size=(3, 3)), "b": np.array([0.2, -0.3])}
    got = clip_gradients_l1({k: _t(v) for k, v in grads.items()})
    ref = jrnn.clip_gradients_l1({k: jnp.asarray(v) for k, v in
                                  grads.items()})
    for k in grads:
        _close(got[k], np.asarray(ref[k]), RTOL_OP)
    assert float(got["a"].abs().sum()) == pytest.approx(1.0)
    assert torch.equal(got["b"], _t(grads["b"]))


# -- LSTM and GRU ------------------------------------------------------------

SEQ = dict(nFeatures=3, nHiddens=5, nClasses=4, max_nLevels=8)


def _sequence(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(8, SEQ["nFeatures"])).astype(np.float32),
            rng.integers(0, SEQ["nClasses"], size=8))


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
def test_sequence_model_matches_jax(name):
    jm = getattr(jrnn, name)(**SEQ, seed=5)
    tm = _with_jax_weights(jm, getattr(models, name)(**SEQ, device="cpu"),
                           True)
    xs, ts = _sequence(1)
    _close(tm.getLoss(xs, ts), jm.getLoss(xs, ts), RTOL_FWD)
    np.testing.assert_array_equal(tm.Predict(xs), jm.Predict(xs))
    # The per-step losses and every gradient.
    txs, tts = tm._inputs(xs, ts)
    params = tm.param_dict()
    seq = tm._seq_losses(tm.params, txs, tts)
    jseq = jm._seq_losses(jm.params, jnp.asarray(xs), jnp.asarray(ts))
    _close(seq, np.asarray(jseq), RTOL_FWD)
    _, jgrads = jm._grad(jm.params, jnp.asarray(xs), jnp.asarray(ts))
    ref = _flat(jgrads)
    for path, g in zip(params, torch.autograd.grad(seq.sum(),
                                                   list(params.values()))):
        _close(g, ref[path].numpy(), RTOL_GRAD)
    # Learn: three iterations at a rate that takes some and rejects some.
    for lr in (0.5, 40.0):
        got = tm.Learn(xs, ts, 3, lr)
        _close(np.array(got), np.array(jm.Learn(xs, ts, 3, lr)), RTOL_GRAD)
        _same_params(tm, jm, RTOL_GRAD)
        velocity = _flat(jm.opt_state)
        for path, v in tm.opt_state.items():
            _close(v, velocity[path].numpy(), RTOL_GRAD)


def test_gru_candidate_is_a_sigmoid():
    """With z = 1 (b_z large) h_1 is the candidate: sigmoid(W_h x + b_h),
    not its tanh."""
    m = models.GRU(**SEQ, device="cpu").double()
    with torch.no_grad():
        m.param_dict()["b_z"].fill_(50.0)
    x = torch.tensor([[0.3, -0.2, 0.5]], dtype=torch.float64)
    p = m.params
    with torch.no_grad():
        h1 = m._run(p, x)[0]
        ref = torch.sigmoid(p["W_h"] @ x[0] + p["b_h"])
    _close(h1, ref, 1e-12)


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
def test_sequence_checkpoint(name, tmp_path):
    """Both packages write the same text (the names sorted), and each loads
    the other's."""
    jm = getattr(jrnn, name)(**SEQ, seed=5)
    tm = _with_jax_weights(jm, getattr(models, name)(**SEQ, device="cpu"),
                           True)
    assert tm.param_order == sorted(tm.param_order)
    fn, fn2 = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jm.save_model(fn)
    tm.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()
    xs, ts = _sequence(2)
    tm.Learn(xs, ts, 2, 0.5)
    tm.save_model(fn2)
    jm.load_model(fn2)
    fresh = getattr(models, name)(**SEQ, seed=8, device="cpu").double()
    fresh.load_model(fn2)
    _close(fresh.getLoss(xs, ts), jm.getLoss(xs, ts), RTOL_FWD)


# -- MLP and CNN ------------------------------------------------------------

MLP_DIMS = [20, 8, 5]
CNN_ARGS = dict(height=12, width=12, in_channels=1, nOutputs=4, c1=3, c2=4,
                kernel=5)


def _images(n, shape, classes, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n,) + shape).astype(np.float32),
            rng.integers(0, classes, size=n))


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_mlp_matches_jax(optimizer, tmp_path):
    jm = jmlp.MLP(MLP_DIMS, optimizer=optimizer, seed=4)
    tm = _with_jax_weights(
        jm, models.MLP(MLP_DIMS, optimizer=optimizer, device="cpu"), True)
    fn, fn2 = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jm.save_model(fn)
    tm.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()
    xs, ys = _images(6, (4, 5), MLP_DIMS[-1], 1)
    for _ in range(3):
        _close(tm.BatchLearn(xs, ys, 0.3), jm.BatchLearn(xs, ys, 0.3),
               RTOL_FWD)
        _same_params(tm, jm, RTOL_GRAD)
    np.testing.assert_array_equal(tm.Predict(xs), jm.Predict(xs))
    assert tm.accuracy(xs, ys) == jm.accuracy(xs, ys)


@pytest.mark.parametrize("pool,optimizer", [("max", o) for o in OPTIMIZERS]
                         + [("avg", "sgd")])
def test_cnn_matches_jax(pool, optimizer, tmp_path):
    """lam > 0: the L2 regularizer over filter1, filter2 and W."""
    jm = jmlp.CNN(**CNN_ARGS, lam=0.01, pool=pool, optimizer=optimizer,
                  seed=4)
    tm = _with_jax_weights(
        jm, models.CNN(**CNN_ARGS, lam=0.01, pool=pool, optimizer=optimizer,
                       device="cpu"), False)
    xs, ys = _images(5, (12, 12), CNN_ARGS["nOutputs"], 2)
    for _ in range(3):
        _close(tm.BatchLearn(xs, ys, 0.05), jm.BatchLearn(xs, ys, 0.05),
               RTOL32)
        _same_params(tm, jm, RTOL32)
    with torch.no_grad():
        scores = tm._scores(tm.params, tm._inputs(xs))
    _close(scores, np.asarray(jm._forward(jm.params, jm._shape(xs))), RTOL32)
    np.testing.assert_array_equal(tm.Predict(xs), jm.Predict(xs))
    fn, fn2 = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    tm.save_model(fn2)
    jm.load_model(fn2)
    jm.save_model(fn)
    assert Path(fn2).read_text() == Path(fn).read_text()


def test_cnn_shapes_and_defaults():
    """The reference net: 28 x 28, 8 and 16 channels, SGD, the filters at
    the scale 1 / kernel, the output bias zeros (the JAX net's shapes);
    [H, W] images take a channel axis."""
    m = models.CNN(device="cpu")
    shapes = {k: tuple(v.shape) for k, v in m.param_dict().items()}
    jshapes = {k: tuple(v.shape) for k, v in jmlp.CNN().params.items()}
    assert shapes == jshapes == {
        "W": (10, 7 * 7 * 16), "bias": (10,), "bias1": (1, 8),
        "bias2": (8, 16), "filter1": (5, 5, 1, 8), "filter2": (5, 5, 8, 16)}
    assert m.opt_state == ()
    assert float(m.param_dict()["filter2"].detach().abs().max()) <= 0.9 / 5
    assert not m.param_dict()["bias"].any()
    assert tuple(m._inputs(np.zeros((2, 28, 28))).shape) == (2, 28, 28, 1)
