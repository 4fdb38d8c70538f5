"""The port's steerable second-order family (``models/smp2d_steerable.py``)
against ``graphflow_tpu.models.smp2d_steerable`` with the JAX weights, in
float64 on the CPU: prediction, ``Feature`` and the loss to 1e-9; every
gradient to 1e-8 with the reference's shared-node lambda gradients and the
true ones, and for ver2, ver3 and Unrestricted_ver2 with the TENSORMUL-cast
filter and the declared contraction; every parameter and the Momentum state
after three ``BatchLearn`` steps to 1e-8; the per-level pre-filter sums;
the text checkpoint byte for byte; the cast's read indices against the JAX
package's tables; the reduced-adjacency conventions; and the JAX package's
own properties (permutation invariance, channel growth).

The JAX models keep float32 host arrays (their ``_prepare`` takes the
config's dtype) and float64 parameters, as the port does: both promote the
same float32 values exactly."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models import smp2d_steerable as jsteer
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.models import smp2d_steerable as steer
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
LR = 1e-3
V = 7
BASE = dict(max_nVertices=V, nLevels=2, nChanels=3, nFeatures=4, nDepth=2)
# name -> constructor arguments (the doubling variants start narrower).
CTORS = {
    "SMP_2D": BASE,
    "SMP_2D_classification": dict(BASE, nClasses=3),
    "SMP_2D_ver2": dict(BASE, nChanels=2),
    "SMP_2D_ver3": dict(BASE, nChanels=2),
    "SMP_2D_ver4": dict(BASE, nChanels=2),
    "SMP_2D_ver4_classification": dict(BASE, nChanels=2, nClasses=3),
    "SMP_2D_ver5": BASE,
    "Unrestricted_SMP_2D": BASE,
    "Unrestricted_SMP_2D_ver2": dict(BASE, nChanels=2),
}
CAST = ("SMP_2D_ver2", "SMP_2D_ver3", "Unrestricted_SMP_2D_ver2")
# (name, faithful_lambda_grads, engine_faithful) beyond each model's
# defaults (True, True); the full filters have no lambdas.
MODES = ([(n, False, True) for n in CTORS if not n.startswith("Unres")]
         + [(n, f, False) for n in CAST for f in (True, False)])


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
    """A molecule and three random graphs of 4..7 vertices."""
    return [mod.toy_molecule("C2H4")] + [
        mod.random_graph(4 + s, 0.5, nFeatures=4, seed=30 + s)
        for s in range(3)]


def _targets(name):
    if "classification" in name:
        return [0.0, 1.0, 2.0, 1.0]
    return [0.5, -1.0, 2.0, 1.5]


@pytest.fixture(scope="module")
def jax_models():
    """name -> (the JAX model in float64, its initial parameters), each
    built and compiled once for the module; a test that trains it puts
    the initial parameters back first."""
    cache = {}

    def get(name):
        if name not in cache:
            jm = getattr(jsteer, name)(**CTORS[name], seed=3)
            jm.params = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float64), jm.params)
            jm._finish_init()
            cache[name] = (jm, jm.params)
        jm, init = cache[name]
        jm.params, jm.opt_state = init, jm.opt.init(init)
        return jm

    return get


def _port(name, jm, **cfg):
    """The port's model on the JAX model's float64 weights."""
    tm = getattr(models, name)(**CTORS[name], device="cpu").double()
    if cfg:
        tm.cfg = dataclasses.replace(tm.cfg, **cfg)
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    return tm


@pytest.mark.parametrize("name", sorted(CTORS))
def test_model_matches_jax_float64(name, jax_models):
    """Serving, the loss and every gradient with the defaults, then three
    BatchLearn steps with Momentum: every parameter and velocity."""
    jm = jax_models(name)
    tm = _port(name, jm)
    jg, tg = _graphs(jdatasets), _graphs(datasets)
    targets = _targets(name)
    loss, grads = tm._loss_and_grads(tm._stack(tg, targets))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, targets))
    _close(loss, jloss, RTOL_FWD)
    jflat = _flat(jgrads)
    assert set(grads) == set(jflat)
    for path, x in grads.items():
        _close(x, jflat[path].numpy(), RTOL_GRAD)
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    _close(tm.Feature(tg[1]), jm.Feature(jg[1]), RTOL_FWD)
    if "classification" not in name:
        _close(tm.Predict(tg[2]), jm.Predict(jg[2]), RTOL_FWD)
    _close(tm.getLoss(tg, targets), jm.getLoss(jg, targets), RTOL_FWD)
    for _ in range(3):
        _close(tm.BatchLearn(tg, targets, LR),
               jm.BatchLearn(jg, targets, LR), RTOL_GRAD)
    ref = _flat(jm.params)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), RTOL_GRAD)
    velocity = _flat(jm.opt_state)
    for path, x in tm.opt_state.items():
        _close(x, velocity[path].numpy(), RTOL_GRAD)


@pytest.mark.parametrize("name,faithful,engine", MODES)
def test_gradient_modes_match_jax(name, faithful, engine, jax_models):
    """The true lambda gradients, and the declared contraction in place of
    the TENSORMUL cast; only the backward (lambda modes) or the whole
    filter (engine modes) changes."""
    base = jax_models(name)
    jm = copy.copy(base)
    jm.cfg = dataclasses.replace(base.cfg, faithful_lambda_grads=faithful,
                                 engine_faithful=engine)
    jm._finish_init()
    tm = _port(name, jm, faithful_lambda_grads=faithful,
               engine_faithful=engine)
    targets = _targets(name)
    loss, grads = tm._loss_and_grads(tm._stack(_graphs(datasets), targets))
    jloss, jgrads = jm._batch_grad(jm.params,
                                   jm._stack(_graphs(jdatasets), targets))
    _close(loss, jloss, RTOL_FWD)
    jflat = _flat(jgrads)
    for path, x in grads.items():
        _close(x, jflat[path].numpy(), RTOL_GRAD)
    if not faithful and "lambda1" in tm.cfg.level_keys():
        # Not the reference's gradients: those differ for a lambda.
        _, ref_grads = _port(name, jm, engine_faithful=engine)._loss_and_grads(
            tm._stack(_graphs(datasets), targets))
        assert any(float((ref_grads[p] - grads[p]).abs().max()) > 1e-6
                   for p in grads if "lambda" in p)


@pytest.mark.parametrize("name", ["SMP_2D", "SMP_2D_ver3",
                                  "Unrestricted_SMP_2D_ver2"])
def test_states_and_presum_match_jax(name, jax_models):
    """``steerable_states`` with ``collect_presum``: every level's state and
    pre-filter aggregate, against the JAX function vmapped over the
    graphs."""
    jm = jax_models(name)
    tm = _port(name, jm)
    tg, jg = _graphs(datasets), _graphs(jdatasets)
    presum = []
    states = steer.steerable_states(tm.params, tm._stack(tg), tm.cfg,
                                    collect_presum=presum)
    assert len(states) == 3 and len(presum) == 2

    def per_graph(g):
        jpresum = []
        jstates = jsteer.steerable_states(jm.params, g, jm.cfg,
                                          collect_presum=jpresum)
        return jstates + jpresum

    refs = jax.jit(jax.vmap(per_graph))(jm._stack(jg))
    for got, ref in zip(states + presum, refs):
        _close(got, np.asarray(ref), RTOL_FWD)


@pytest.mark.parametrize("V_", [4, 7, 10])
def test_cast_indices_equal_jax_tables(V_):
    """The device-side indices of the TENSORMUL cast, expanded over the
    output channel d = delta * prevC + c, equal the JAX package's tables
    for every size s = 1..V (and are all masked out at s = 0)."""
    for prevC in (1, 2, 3):
        tb = jsteer._tensormul_cast_tables(V_, V_, prevC)
        ix = steer.tensormul_cast_indices(torch.arange(V_ + 1), V_, prevC)
        d = np.arange(2 * prevC)
        delta, c = d // prevC, d % prevC

        def wide(key):
            return ix[key].numpy()[..., delta]

        dw = (~ix["iseye"]).numpy()[..., delta] * prevC + c
        got = {"w_x": wide("x"), "w_y": wide("y"), "w_cw": wide("cw"),
               "w_dw": dw, "w_iseye": wide("iseye"), "w_diag": wide("diag"),
               "a_ok": wide("a_ok"), "q_row": wide("q_row"),
               "q_col": wide("q_col"), "q_ok": wide("q_ok")}
        for key, val in got.items():
            np.testing.assert_array_equal(val[1:], tb[key][1:], err_msg=key)
        for key in ("a_ok", "q_ok"):
            assert not got[key][0].any()
        np.testing.assert_array_equal(tb["ccol"], c)


def test_reduced_adjacency_conventions_match_jax():
    """The raw diagonal (a self-looped vertex keeps its 1, the others 0)
    and the row normalisation, on one prepared graph through the JAX
    functions and the port's."""
    g = datasets.random_graph(6, 0.5, seed=4)
    g.adj[2, 2] = 1
    pg = prep.prepare_graph(g, 2, 7, None, 1, backend="python")
    for port_fn, jax_fn in (
            (lambda p: steer.strip_radj_self_loops(p, g),
             lambda p: jsteer.strip_radj_self_loops(p, g)),
            (steer.row_normalize_radj, jsteer.row_normalize_radj)):
        got, ref = port_fn(pg).radj, jax_fn(pg).radj
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    stripped = steer.strip_radj_self_loops(pg, g).radj
    assert not np.array_equal(stripped, pg.radj)
    rows = steer.row_normalize_radj(pg).radj.sum(axis=3)
    np.testing.assert_allclose(rows[pg.smask[1:, :, :, 0] > 0], 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CTORS))
def test_checkpoint_matches_jax_file(name, jax_models, tmp_path):
    """The JAX model sets no registration order, so its file follows
    tree_flatten (keys sorted): the port writes the same bytes, and each
    package's file loads into the other."""
    jm = jax_models(name)
    tm = _port(name, jm)
    tm.save_model(str(tmp_path / "port.txt"))
    jm.save_model(str(tmp_path / "jax.txt"))
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())
    fresh = getattr(models, name)(**CTORS[name], seed=9,
                                  device="cpu").double()
    fresh.load_model(str(tmp_path / "jax.txt"))
    for path, p in fresh.param_dict().items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      tm.get_parameter(path).detach().numpy())
    tree = params_to_numpy(tm.param_dict())
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                np.asarray, jm.params)))


@pytest.mark.parametrize("name", ["SMP_2D", "SMP_2D_ver4", "SMP_2D_ver5"])
def test_permutation_invariance(name, rng):
    """``tests/test_smp2d_steerable.py:105``: relabelling the vertices
    leaves the graph feature unchanged, for the filters that treat every
    position of a receptive field alike."""
    g = datasets.random_graph(8, 0.4, seed=11)
    m = getattr(models, name)(max_nVertices=8, nLevels=2, nChanels=5,
                              nFeatures=4, nDepth=3, seed=2,
                              device="cpu").double()
    f0 = m.Feature(g)
    for _ in range(3):
        fp = m.Feature(g.permuted(rng.permutation(8)))
        np.testing.assert_allclose(fp, f0, rtol=1e-9, atol=1e-9)


def test_channel_growth():
    """ver2, ver4 and Unrestricted_ver2 double the channels per level, ver5
    keeps them with its K (C x 2C) reducer, ver3 has no scalar
    (``tests/test_smp2d_steerable.py:58-98``)."""
    kw = dict(max_nVertices=10, nLevels=2, nChanels=4, nFeatures=4,
              nDepth=2, device="cpu")
    m2 = models.SMP_2D_ver2(**kw)
    assert m2.params["W"].shape == (16,)
    assert m2.params["levels"][0]["lambda1"].shape[1:] == (4, 4)
    assert m2.params["levels"][1]["lambda1"].shape[1:] == (8, 8)
    assert "scalar" not in models.SMP_2D_ver3(**kw).params["levels"][0]
    m4 = models.SMP_2D_ver4(**kw)
    assert m4.params["levels"][1]["lambda1"].shape[1:] == (8,)
    assert m4.params["levels"][1]["b"].shape[1:] == (16,)
    m5 = models.SMP_2D_ver5(**kw)
    assert m5.params["W"].shape == (4,)
    assert m5.params["levels"][1]["K"].shape == (4, 8)
    u2 = models.Unrestricted_SMP_2D_ver2(**kw)
    assert u2.params["levels"][1]["Wf"].shape[1:] == (10, 10, 8, 16)
    g = datasets.random_graph(9, 0.4, seed=5)
    for m in (m2, m4, u2):
        assert m.Feature(g).shape == (16,)


@pytest.mark.parametrize("name", sorted(CTORS))
def test_model_without_device_does_not_land_on_the_cpu(name):
    """Built without ``device`` a model takes the CUDA device, and with none
    (as here) raises rather than run on the CPU."""
    if torch.cuda.is_available():
        assert getattr(models, name)(**CTORS[name]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(models, name)(**CTORS[name])
