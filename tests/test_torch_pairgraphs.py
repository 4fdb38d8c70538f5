"""The port's pair-of-graphs models (``models/pairgraphs.py``) against
``graphflow_tpu.models.pairgraphs`` on the CPU, with the JAX weights:
every constructor (SMP_omega_pairgraphs with and without the Coulomb
adjacency, SMP_beta_pairgraphs with V1 != V2, so that tower 1's receptive
field is larger than its graph, SMP_gamma, SMP_sigma with one explicit case
mask, SMP_theta, CCN_1D and GCN_1D/2D/3D_Kernel): Predict, getLoss, the
loss and every gradient, and three BatchLearn steps (every parameter and
the optimizer state after each); the text checkpoint byte for byte; the
registration order and shapes.

Tolerances.  The JAX constructors make float32 parameters and prepare
float32 host arrays; the float64 tests cast every parameter of both models
to float64 (``tests/test_model_parity2.py:_cast64``) and keep the float32
host arrays, which both packages promote exactly: predictions and losses
to 1e-9 * max(1, scale), every gradient leaf and three optimizer steps to
1e-8.  The float32 test compares the models as constructed, which sum in
float32 in another order: 1e-5 of the scale forward, 1e-4 for gradients
and steps."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models import pairgraphs as jpair
from graphflow_tpu.ops import contractions as jcontractions
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.models import pairgraphs as tpair
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
RTOL32_FWD, RTOL32_GRAD = 1e-5, 1e-4
LR = 1e-3
F1, F2 = 3, 2
# name -> (constructor arguments, the vertex counts of the two towers).
CASES = {
    "SMP_omega_pairgraphs": ((7, 6, 4, 2, 8, F1, F2), (7, 6)),
    "SMP_omega_pairgraphs_coulomb": ((7, 6, 4, 2, 8, F1, F2), (7, 6)),
    "SMP_beta_pairgraphs": ((5, 7, 2, 4, F1, F2), (5, 7)),
    "SMP_gamma_pairgraphs": ((7, 6, 4, 2, 6, F1, F2), (7, 6)),
    "SMP_sigma_pairgraphs": ((7, 6, 4, 2, 4, F1, F2), (7, 6)),
    "SMP_theta_pairgraphs": ((7, 6, 4, 2, 8, F1, F2), (7, 6)),
    "CCN_1D": ((7, 6, 4, 2, 16, F1, F2), (7, 6)),
    "GCN_1D_Kernel": ((2, 8, 4, 4, 2, 1), (8, 8)),
    "GCN_2D_Kernel": ((2, 8, 4, 4, 2, 1), (8, 8)),
    "GCN_3D_Kernel": ((2, 8, 4, 3, 2, 2), (8, 8)),
}
TARGETS = [0.5, -1.0, 2.0]


def _ctor(mod, name):
    return getattr(mod, name.replace("_coulomb", ""))


def _kwargs(name):
    return {"use_coulomb": True} if name.endswith("_coulomb") else {}


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.nanmax(np.abs(ref)))) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _pairs(mod, name):
    """Three pairs for package ``mod``: Erdos-Renyi graphs of up to each
    tower's vertex count, one-hot features for the GCN kernels (which read
    WL histograms), else raw features of both signs in quarters whose L1
    norm is 1, and a symmetric Coulomb matrix with both signs and a
    diagonal (multiples of 1/8).  The JAX package takes CCN_1D's L1
    normalisation and the Coulomb sums in the float32 of the prepared
    arrays, before they meet the float64 weights; these values keep them
    exact, so that the float64 comparison is not limited by them."""
    (V1, V2), gcn = CASES[name][1], name.startswith("GCN")
    out = []
    for t, V in ((1, V1), (2, V2)):
        nF = 4 if gcn else (F1 if t == 1 else F2)
        graphs = []
        for s in range(3):
            n = V - (s % 2)
            g = mod.random_graph(n, 0.45, nFeatures=nF, seed=40 + 10 * t + s)
            rng = np.random.default_rng(400 + 10 * t + s)
            if not gcn:
                g.feature = (rng.multinomial(4, [1 / nF] * nF, size=n) / 4
                             * rng.choice([-1.0, 1.0], size=(n, nF)))
            c = rng.normal(size=(n, n))
            g.coulomb = np.round((c + c.T) * 4) / 8
            graphs.append(g)
        out.append(graphs)
    return out


@pytest.fixture(scope="module")
def jax_models():
    """(name, float64) -> the JAX model, built and compiled once for the
    module; its initial parameters and optimizer state are put back on
    every call."""
    cache = {}

    def get(name, float64):
        key = (name, float64)
        if key not in cache:
            jm = _ctor(jpair, name)(*CASES[name][0], **_kwargs(name), seed=3)
            if float64:
                jm.params = jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.float64), jm.params)
                jm._finish_init()
            cache[key] = (jm, jm.params)
        jm, init = cache[key]
        jm.params, jm.opt_state = init, jm.opt.init(init)
        return jm

    return get


def _port(name, jm, float64):
    tm = _ctor(models, name)(*CASES[name][0], **_kwargs(name), device="cpu")
    if float64:
        tm = tm.double()
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    return tm


def _assert_same_state(tm, jm, rtol):
    ref = _flat(jm.params)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), rtol)
    if isinstance(tm.opt_state, dict) and "m" in tm.opt_state:     # Adam
        for key in ("m", "v"):
            jstate = _flat(jm.opt_state[key])
            for path, x in tm.opt_state[key].items():
                _close(x, jstate[path].numpy(), rtol)
        assert tm.opt_state["t"] == int(jm.opt_state["t"])
    else:                                                         # Momentum
        velocity = _flat(jm.opt_state)
        for path, x in tm.opt_state.items():
            _close(x, velocity[path].numpy(), rtol)


def _steps_with_masks(monkeypatch, masks):
    """Make both packages' sigma steps draw ``masks`` in turn."""
    jseq, tseq = iter(masks), iter(masks)
    jreal, real = jcontractions.dropout_case_mask, tpair.dropout_case_mask
    monkeypatch.setattr(
        jcontractions, "dropout_case_mask",
        lambda key, n, train: (jnp.asarray(next(jseq)) if train
                               else jreal(key, n, train)))
    monkeypatch.setattr(
        tpair, "dropout_case_mask",
        lambda gen, n, train, device=None: (
            torch.as_tensor(next(tseq), device=device) if train
            else real(gen, n, train, device=device)))


def _match(name, tm, jm, rtol_fwd, rtol_grad, monkeypatch=None):
    (jg1, jg2), (tg1, tg2) = _pairs(jdatasets, name), _pairs(datasets, name)
    for a, b, c, d in zip(jg1, jg2, tg1, tg2):
        _close(tm.Predict(c, d), jm.Predict(a, b), rtol_fwd)
    _close(tm.getLoss(tg1, tg2, TARGETS), jm.getLoss(jg1, jg2, TARGETS),
           rtol_fwd)
    # The loss and every gradient (sigma: one explicit case mask).
    mask = None
    jbatch = jm._stack(jg1, jg2, TARGETS)
    if tm.dropout_nKept:
        mask = np.zeros(18)
        mask[[0, 2, 3, 7, 8, 11, 12, 16, 17]] = 1.0
        jbatch["case_mask"] = jnp.asarray(mask)
        mask = torch.from_numpy(mask)
    tbatch = tm._stack(tg1, tg2, TARGETS)
    params = tm.param_dict()
    loss = tm._loss(tm.params, tbatch, case_mask=mask)
    grads = torch.autograd.grad(loss, list(params.values()))
    jloss, jgrads = jm._batch_grad(jm.params, jbatch)
    _close(loss, jloss, rtol_fwd)
    ref = _flat(jgrads)
    assert set(ref) == set(params)
    for path, g in zip(params, grads):
        _close(g, ref[path].numpy(), rtol_grad)
    # Three steps; sigma draws the same masks in both packages.
    if tm.dropout_nKept:
        rng = np.random.default_rng(7)
        masks = [(rng.permutation(18) < tm.dropout_nKept).astype(np.float64)
                 for _ in range(3)]
        _steps_with_masks(monkeypatch, masks)
    for _ in range(3):
        got = tm.BatchLearn(tg1, tg2, TARGETS, LR)
        _close(np.array(got), np.array(jm.BatchLearn(jg1, jg2, TARGETS, LR)),
               rtol_grad)
        _assert_same_state(tm, jm, rtol_grad)


@pytest.mark.parametrize("name", list(CASES))
def test_pair_model_matches_jax_float64(name, jax_models, monkeypatch):
    jm = jax_models(name, True)
    tm = _port(name, jm, True)
    assert tm.param_order == jm.param_order
    if isinstance(tm, models.SMPPairGraphs):
        for t in (1, 2):
            a, b = getattr(tm, f"cfg{t}"), getattr(jm, f"cfg{t}")
            assert (a.P, a.nDepth, a.has_WL_ordering, a.use_wl_features) == (
                b.P, 0, False, False)
            assert a.channel_schedule == tuple(b.channel_schedule)
        assert tm.head_dims == tuple(jm.head_dims)
    _match(name, tm, jm, RTOL_FWD, RTOL_GRAD, monkeypatch)


@pytest.mark.parametrize("name", ["SMP_omega_pairgraphs", "GCN_2D_Kernel"])
def test_pair_model_matches_jax_as_constructed(name, jax_models):
    """Both models in float32, as their constructors make them."""
    jm = jax_models(name, False)
    tm = _port(name, jm, False)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _match(name, tm, jm, RTOL32_FWD, RTOL32_GRAD)


def test_beta_pairs_take_one_field_larger_than_tower_1():
    """SMP_beta_pairgraphs(5, 7): P = 7 in both towers; tower 1's graphs
    have at most 5 vertices."""
    m = models.SMP_beta_pairgraphs(5, 7, 2, 4, F1, F2, device="cpu")
    assert (m.cfg1.P, m.cfg2.P) == (7, 7)
    assert (m.cfg1.max_nVertices, m.cfg2.max_nVertices) == (5, 7)
    g1, g2 = _pairs(datasets, "SMP_beta_pairgraphs")
    batch = m._stack(g1, g2)
    assert tuple(batch["g1"]["nbr"].shape[1:]) == (2, 5, 7)
    assert tuple(batch["g2"]["nbr"].shape[1:]) == (2, 7, 7)


def test_sigma_masks():
    """getLoss takes the evaluation mask (nKept / 18 everywhere): equal to
    the loss through an explicit mask of 9/18; a step draws nKept ones from
    the model's generator, seeded with 1234 + seed."""
    m = models.SMP_sigma_pairgraphs(7, 6, 4, 2, 4, F1, F2, nKept=5, seed=2,
                                    device="cpu")
    g1, g2 = _pairs(datasets, "SMP_sigma_pairgraphs")
    batch = m._stack(g1, g2, TARGETS)
    with torch.no_grad():
        ref = m._loss(m.params, batch,
                      case_mask=torch.full((18,), 5 / 18))
    _close(m.getLoss(g1, g2, TARGETS), ref.numpy(), RTOL32_FWD)
    drawn = m._case_mask(True)
    assert sorted(drawn.unique().tolist()) == [0.0, 1.0]
    assert int(drawn.sum()) == 5
    again = models.SMP_sigma_pairgraphs(7, 6, 4, 2, 4, F1, F2, nKept=5,
                                        seed=2, device="cpu")
    assert torch.equal(again._case_mask(True), drawn)
    assert models.SMP_omega_pairgraphs(
        7, 6, 4, 2, 4, F1, F2, device="cpu")._case_mask(True) is None


@pytest.mark.parametrize("name", ["SMP_omega_pairgraphs_coulomb",
                                  "SMP_theta_pairgraphs", "GCN_3D_Kernel"])
def test_pair_checkpoint_round_trip(name, jax_models, tmp_path):
    """Both packages write the same text file, in param_order, and each
    loads the other's."""
    jm = jax_models(name, True)
    tm = _port(name, jm, True)
    (jg1, jg2), (tg1, tg2) = _pairs(jdatasets, name), _pairs(datasets, name)
    fn, fn2 = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jm.save_model(fn)
    tm.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()
    fresh = _ctor(models, name)(*CASES[name][0], **_kwargs(name), seed=9,
                                device="cpu").double()
    fresh._finish_init()
    fresh.BatchLearn(tg1, tg2, TARGETS, LR)
    fresh.load_model(fn)
    _close(fresh.Predict(tg1[0], tg2[0]), jm.Predict(jg1[0], jg2[0]),
           RTOL_FWD)
    tm.BatchLearn(tg1, tg2, TARGETS, LR)
    tm.save_model(fn2)
    jm.load_model(fn2)
    _close(tm.Predict(tg1[1], tg2[1]), jm.Predict(jg1[1], jg2[1]), RTOL_FWD)


def test_constructors_shapes_and_guards():
    m = models.SMP_omega_pairgraphs(8, 6, 4, 2, 32, F1, F2, device="cpu")
    assert m.cfg1.channel_schedule == (32, 16, 8)
    assert m.head_dims == (56, 28)
    shapes = {p: tuple(v.shape) for p, v in m.param_dict().items()}
    assert shapes["tower1/H"] == (32, F1) and shapes["tower2/H"] == (32, F2)
    assert shapes["tower2/levels/0/K"] == (18 * 32, 16)
    assert shapes["tower1/levels/1/K"] == (18 * 16, 8)
    assert (shapes["W1"], shapes["W2"], shapes["W3"]) == (
        (56, 112), (28, 56), (28,))
    assert m.param_order[:4] == ["tower1/H", "tower2/H",
                                 "tower1/levels/0/K", "tower1/levels/0/b"]
    assert m.params["tower2"]["levels"][1]["b"] is m.param_dict()[
        "tower2/levels/1/b"]
    # Small towers: the head's widths floor at 10.
    assert models.SMP_theta_pairgraphs(6, 6, 3, 1, 2, 2, 2,
                                       device="cpu").head_dims == (10, 10)
    # CCN_1D: ceil-decay channels and head, 16 at the least.
    c = models.CCN_1D(6, 6, 3, 2, 20, 2, 2, nChanels_decay=0.5,
                      device="cpu")
    assert c.cfg1.channel_schedule == (20, 16, 16)
    assert c.head_dims == (52, 26) and c.cfg1.l1_normalize_features
    with pytest.raises(ValueError, match="nChanels >= 16"):
        models.CCN_1D(6, 6, 3, 2, 8, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="nChanels_decay"):
        models.CCN_1D(6, 6, 3, 2, 16, 2, 2, nChanels_decay=1.5,
                      device="cpu")
    k = models.GCN_2D_Kernel(2, 8, 4, 5, 2, 1, device="cpu")
    assert k.cfg.order == 2 and not k.cfg.uncapped_radius
    assert k.param_order == ["tower/levels/0/W1", "tower/levels/1/W1",
                             "tower/levels/1/W2", "tower/levels/2/W1",
                             "tower/levels/2/W2", "W"]
    assert tuple(k.param_dict()["W"].shape) == (10,)
    assert k.Threaded_BatchLearn == k.BatchLearn
