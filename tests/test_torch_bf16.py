"""SMP_omega in bfloat16: the port against the JAX package's bfloat16 model
on the CPU, with the same weights: Threaded_Predict, Predict and Feature,
the first step's loss and gradients, every parameter after BatchLearn
steps, a backtracking BatchLearn and Learn, convergence, the routing of
the levels, host data, Adam, Momentum and backtracking in bfloat16, weights
across packages and the text checkpoint.

On the CPU the JAX package takes its XLA route (smp2d.py:324-336):
RisiContraction_18 in bfloat16, which rounds the 18C bank to bfloat16,
then the product with K.  The port runs the plain fused level, float32
inside and rounded once after the bias and LeakyReLU
(``ops/risi_level.py``), as the Pallas kernel does.  The bound 3e-2 *
max(1, max|ref|) is the bfloat16 bound of
tests/test_fused_kernel.py:133-134 and covers both roundings.

A fault of the reference shows at the bias gradients: the JAX package's
bfloat16 model on the CPU reduces them in bfloat16 and lands 7-16 % of
their scale away from float64 autodiff on the same weights, where the port
(whose sums run in float32) stays within 0.2 %.  So every gradient is held
against the JAX package's float64 gradient on the same bfloat16 weights,
and every gradient but the biases also against its bfloat16 gradient."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu import optim as joptim
from graphflow_tpu.models import SMP2D as JaxSMP2D
from graphflow_tpu.models import SMP2DConfig as JaxSMP2DConfig
from graphflow_tpu.utils import checkpoint as jckpt
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import optim
from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
from graphflow_tpu_torch.models import smp2d as smp2d_module
from graphflow_tpu_torch.utils import checkpoint, datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL = 3e-2
# Adam and backtracking run the same bfloat16 operations in both packages,
# but XLA may keep an intermediate in float32 (excess precision), which
# moves a result by one bfloat16 step (2^-8 relative): 1e-2 of the scale.
RTOL_OPT = 1e-2
LR = 1e-3
CFG = dict(max_nVertices=10, nLevels=2, nChanels=6, nFeatures=4, nDepth=3)
BF16 = torch.bfloat16


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def _close(got, ref, rtol=RTOL):
    got, ref = _f64(got), _f64(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _pair(P):
    """The JAX package's bfloat16 SMP_omega and the port's, sharing the JAX
    weights."""
    jm = JaxSMP2D(JaxSMP2DConfig(**CFG, max_receptive_field=P,
                                 dtype="bfloat16"), seed=3)
    tm = SMP2D(SMP2DConfig(**CFG, max_receptive_field=P, dtype="bfloat16"),
               device="cpu")
    tm.load_params(params_from_jax(_tree(jm.params)))
    return jm, tm


def _data():
    """Toy molecules plus two random graphs, for each package."""
    jg, jt = jdatasets.toy_molecules()
    tg, tt = datasets.toy_molecules()
    jg += [jdatasets.random_graph(10, 0.3, seed=s) for s in (1, 2)]
    tg += [datasets.random_graph(10, 0.3, seed=s) for s in (1, 2)]
    return jg, jt + [3.0, 4.5], tg, tt + [3.0, 4.5]


def _assert_same_params(tm, jm):
    ref = params_from_jax(_tree(jm.params))
    for path, p in tm.param_dict().items():
        assert p.dtype == BF16
        _close(p, ref[path])


@pytest.fixture(scope="module", params=[4, 8], ids=["P4", "P8"])
def pair(request):
    return _pair(request.param)


def test_predict_threaded_predict_feature_match_jax(pair):
    jm, tm = pair
    jg, _, tg, _ = _data()
    got = tm.Threaded_Predict(tg)
    assert got.dtype == np.float32
    # The port hands back float32 holding the bfloat16 values.
    assert np.array_equal(got, torch.from_numpy(got).to(BF16).float().numpy())
    _close(got, jm.Threaded_Predict(jg))
    for a, b in zip(jg, tg):
        _close(tm.Predict(b), jm.Predict(a))
        feat = tm.Feature(b)
        assert feat.dtype == np.float32 and feat.shape == (CFG["nChanels"],)
        _close(feat, jm.Feature(a))


def test_first_step_loss_and_gradients_match_jax(pair):
    jm, tm = pair
    jg, jt, tg, tt = _data()
    _close(tm.getLoss(tg, tt), jm.getLoss(jg, jt))
    loss, grads = tm._loss_and_grads(tm._stack(tg, tt))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, jt))
    _close(loss, jloss)
    jm64 = JaxSMP2D(JaxSMP2DConfig(**CFG, max_receptive_field=tm.cfg.P,
                                   dtype="float64"), seed=3)
    params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                      jm.params)
    loss64, grads64 = jm64._batch_grad(params64, jm64._stack(jg, jt))
    _close(loss, loss64)
    ref16 = params_from_jax(_tree(jgrads))
    ref64 = params_from_jax(_tree(grads64))
    assert list(grads) == tm.param_order
    for path, g in grads.items():
        assert g.dtype == BF16
        _close(g, ref64[path])
        if not path.endswith("/b"):
            _close(g, ref16[path])


@pytest.mark.parametrize("P", [4, 8])
def test_batch_learn_matches_jax_over_three_steps(P):
    jm, tm = _pair(P)
    jg, jt, tg, tt = _data()
    for _ in range(3):
        got = tm.BatchLearn(tg, tt, LR)
        assert all(isinstance(x, float) for x in got)
        _close(np.array(got), np.array(jm.BatchLearn(jg, jt, LR)))
        _assert_same_params(tm, jm)
        assert tm.opt_state["t"] == int(jm.opt_state["t"])


def test_backtracking_batch_learn_and_learn_match_jax():
    jm, tm = _pair(4)
    jg, jt, tg, tt = _data()
    got = tm.BatchLearn(tg, tt, 4 * LR, nIterations=2)
    _close(np.array(got), np.array(jm.BatchLearn(jg, jt, 4 * LR,
                                                 nIterations=2)))
    _assert_same_params(tm, jm)
    assert tm.opt_state["t"] == int(jm.opt_state["t"])
    for j, t, target in zip(jg[:2], tg[:2], jt[:2]):
        got = tm.Learn(t, target, LR)
        _close(np.array(got), np.array(jm.Learn(j, target, LR)))
        _assert_same_params(tm, jm)


def test_bfloat16_training_converges():
    """tests/test_smp2d.py:150-160 for the port: 80 BatchLearn steps on the
    toy molecules bring the loss below a fifth of the first."""
    graphs, targets = datasets.toy_molecules()
    m = SMP2D(SMP2DConfig(max_nVertices=10, max_receptive_field=4,
                          nLevels=2, nChanels=8, nFeatures=4, nDepth=3,
                          dtype="bfloat16"), seed=7, device="cpu")
    l0 = m.getLoss(graphs, targets)
    for _ in range(80):
        _, l1 = m.BatchLearn(graphs, targets, 0.005)
    assert all(p.dtype == BF16 for p in m.parameters())
    assert l1 < 0.2 * l0, (l0, l1)


def test_levels_route_by_dtype(monkeypatch):
    """bfloat16 and float32 levels both run the fused level, on a float32
    adjacency; the bank runs only where ``level_fn=`` asks for it."""
    calls = {"bank": 0, "level": 0}
    radj_dtypes = set()

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            if name == "level":
                radj_dtypes.add(args[3].dtype)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(smp2d_module, "risi18_bank",
                        counting("bank", smp2d_module.risi18_bank))
    monkeypatch.setattr(smp2d_module, "risi18_level",
                        counting("level", smp2d_module.risi18_level))
    graphs, targets = datasets.toy_molecules()
    nL = CFG["nLevels"]
    m16 = SMP2D(SMP2DConfig(**CFG, max_receptive_field=4, dtype="bfloat16"),
                device="cpu")
    m16.Threaded_Predict(graphs)
    m16.BatchLearn(graphs, targets, LR)       # forward, backward, forward
    assert calls == {"bank": 0, "level": 3 * nL}
    assert radj_dtypes == {torch.float32}
    m32 = SMP2D(SMP2DConfig(**CFG, max_receptive_field=4), device="cpu")
    m32.Threaded_Predict(graphs)
    assert calls == {"bank": 0, "level": 4 * nL}
    with torch.no_grad():
        got, _ = smp2d_module.smp2d_forward(
            m16.params, m16._stack(graphs), m16.cfg,
            level_fn=smp2d_module.risi18_bank_level)
    assert calls == {"bank": nL, "level": 4 * nL}
    # Two roundings of one function: the bank route rounds Z, then adds the
    # bias and applies LeakyReLU in bfloat16; the fused level rounds once.
    _close(got, m16.Threaded_Predict(graphs))


def test_host_data_matches_jax_bfloat16_batch(pair):
    """The port prepares in float32 and casts on the device; for SMP_omega's
    fields that gives the JAX package's bfloat16 arrays exactly."""
    jm, tm = pair
    jg, jt, tg, tt = _data()
    assert tm.prepare(tg[0]).radj.dtype == np.float32
    got, ref = tm._stack(tg, tt), jm._stack(jg, jt)
    for f in ("wl_feat", "vmask", "radj", "smask"):
        assert got[f].dtype == BF16
        np.testing.assert_array_equal(_f64(got[f]), _f64(ref[f]))
    for f in ("nbr", "pos"):
        assert got[f].dtype == torch.int32
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(ref[f]))
    assert got["target"].dtype == torch.float32


def test_convert_carries_bfloat16_weights(pair):
    jm, tm = pair
    tree = _tree(jm.params)
    flat = params_from_jax(tree)
    assert all(t.dtype == BF16 for t in flat.values())
    np.testing.assert_array_equal(_f64(flat["levels/1/K"]),
                                  _f64(tree["levels"][1]["K"]))
    back = params_to_numpy(tm.param_dict())
    assert back["H"].dtype == np.float32
    np.testing.assert_array_equal(back["H"], np.asarray(tree["H"],
                                                        np.float32))
    assert params_from_jax(tree, dtype=torch.float32)["W"].dtype == \
        torch.float32


def test_text_checkpoint_round_trip(tmp_path):
    _, tm = _pair(4)
    _, _, tg, tt = _data()
    tm.BatchLearn(tg, tt, LR)
    fn, fn2 = str(tmp_path / "bf16.dat"), str(tmp_path / "bf16_again.dat")
    tm.save_model(fn)
    fresh = SMP2D(SMP2DConfig(**CFG, max_receptive_field=4,
                              dtype="bfloat16"), seed=99, device="cpu")
    fresh.load_model(fn)
    for a, b in zip(fresh.parameters(), tm.parameters()):
        assert a.dtype == BF16 and torch.equal(a, b)
    fresh.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()


def test_jax_bfloat16_checkpoint_loads_bit_for_bit(tmp_path, pair):
    jm, _ = pair
    fn, fn2 = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jm.save_model(fn)
    tm = SMP2D(SMP2DConfig(**CFG, max_receptive_field=jm.cfg.P,
                           dtype="bfloat16"), seed=99, device="cpu")
    tm.load_model(fn)
    ref = params_from_jax(_tree(jm.params))
    for path, p in tm.param_dict().items():
        assert torch.equal(p.detach(), ref[path])
    tm.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()


def test_load_text_rounds_like_jax(tmp_path, pair):
    """Values that bfloat16 cannot hold, ties included, round as the JAX
    package's NumPy cast rounds them."""
    jm, tm = pair
    n = sum(p.numel() for p in tm.parameters())
    rng = np.random.default_rng(0)
    vals = rng.normal(size=n) * 0.1
    vals[:4] = [1 + 2**-8, 1 + 2**-8 + 2**-30, 1 + 3 * 2**-8 - 2**-30,
                -(1 + 2**-8 + 2**-30)]
    fn = tmp_path / "values.dat"
    fn.write_text("".join(f"{float(v)!r} " for v in vals))
    got = checkpoint.load_text(str(fn), tm.param_dict(), tm.param_order)
    ref = params_from_jax(_tree(jckpt.load_text(str(fn), jm.params,
                                                jm.param_order)))
    for path in tm.param_order:
        assert got[path].dtype == BF16
        assert torch.equal(got[path], ref[path])


SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 2)}
ORDER = ["a", "b", "c"]


def _bf16_pair(values):
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in values.items()}
    tp = {k: torch.from_numpy(np.asarray(jp[k], np.float32)).to(BF16)
          for k in values}
    return jp, tp


def test_adam_bfloat16_matches_jax():
    """Three nBatch steps with the per-element schedule: m and v stay in
    the parameter's dtype, c1 and c2 are float32 cast to it."""
    rng = np.random.default_rng(5)
    jp, tp = _bf16_pair({k: rng.normal(size=s) for k, s in SHAPES.items()})
    jopt, topt = joptim.adam(), optim.adam()
    jopt.set_element_schedule(jp, ORDER)
    topt.set_element_schedule(tp, ORDER)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jg, tg = _bf16_pair({k: rng.normal(size=s)
                             for k, s in SHAPES.items()})
        jp, js = jopt.update(jp, js, jg, 0.05, nBatch=4)
        tp, ts = topt.update(tp, ts, tg, 0.05, nBatch=4)
        for k in ORDER:
            for got, ref in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                             (ts["v"][k], js["v"][k])):
                assert got.dtype == BF16
                _close(got, ref, RTOL_OPT)


@pytest.mark.parametrize("nBatch", [None, 4])
def test_momentum_bfloat16_matches_jax(nBatch):
    """Three steps on bfloat16 parameters: the velocity stays in the
    parameter's dtype in both packages, and the old state is never
    written."""
    rng = np.random.default_rng(7)
    jp, tp = _bf16_pair({k: rng.normal(size=s) for k, s in SHAPES.items()})
    jopt, topt = joptim.momentum(), optim.make_optimizer("Momentum")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jg, tg = _bf16_pair({k: rng.normal(size=s)
                             for k, s in SHAPES.items()})
        old, kept = ts, {k: v.clone() for k, v in ts.items()}
        jp, js = jopt.update(jp, js, jg, 0.05, nBatch=nBatch)
        tp, ts = topt.update(tp, ts, tg, 0.05, nBatch=nBatch)
        for k in ORDER:
            for got, ref in ((tp[k], jp[k]), (ts[k], js[k])):
                assert got.dtype == BF16 and str(ref.dtype) == "bfloat16"
                _close(got, ref, RTOL_OPT)
        assert all(torch.equal(old[k], kept[k]) for k in ORDER)


def test_backtracking_bfloat16_matches_jax():
    """A rejected first step and the restore, on bfloat16 parameters, with
    a quadratic loss evaluated in float64 from them."""
    rng = np.random.default_rng(9)
    jp, tp = _bf16_pair({k: rng.normal(size=s) for k, s in SHAPES.items()})
    target = {k: rng.normal(size=s) * 0.1 for k, s in SHAPES.items()}
    jopt, topt = joptim.adam(), optim.adam()
    jopt.set_element_schedule(jp, ORDER)
    topt.set_element_schedule(tp, ORDER)
    logs = ([], [])

    def quadratic(log, to_leaf):
        def loss_and_grads(params):
            p = {k: _f64(x) for k, x in params.items()}
            log.append(sum(float(np.sum((p[k] - target[k]) ** 2))
                           for k in ORDER))
            return log[-1], {k: to_leaf(2 * (p[k] - target[k]))
                             for k in ORDER}
        return loss_and_grads

    jp, js, jl0, jl1 = joptim.backtracking_learn(
        jp, jopt.init(jp), quadratic(logs[0], lambda x: jnp.asarray(
            x, jnp.bfloat16)), jopt.update, 4.0, 6, nBatch=2)
    tp, ts, tl0, tl1 = optim.backtracking_learn(
        tp, topt.init(tp), quadratic(logs[1], lambda x: torch.from_numpy(
            x).to(BF16)), topt.update, 4.0, 6, nBatch=2)
    assert logs[1][1] > logs[1][0]               # the first step is rejected
    _close(np.array(logs[1]), np.array(logs[0]), RTOL_OPT)
    _close(np.array([tl0, tl1]), np.array([jl0, jl1]), RTOL_OPT)
    assert tl1 < tl0 and ts["t"] == int(js["t"])
    for k in ORDER:
        assert tp[k].dtype == BF16
        _close(tp[k], jp[k], RTOL_OPT)
