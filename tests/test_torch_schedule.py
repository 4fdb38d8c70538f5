"""The rest of the second-order family in the port against the JAX package
at float64, with the JAX weights: towers under a channel schedule (SMP_omega
and SMP_gamma at (8, 4, 2, 1)), ``smp2d_level_features``, the per-case
dropout mask (``case_mask``, train and eval masks, all four banks),
``SMP_beta`` (no receptive-field cap) and the reference's GPU class names.
Serving, the loss and every gradient of one batch, every parameter and the
Adam state after each of 3 BatchLearn steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models import smp2d as jsmp2d
from graphflow_tpu.ops import contractions as jcontractions
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.models.smp2d import (case_mask_level_reference,
                                              smp2d_level_features,
                                              smp2d_states)
from graphflow_tpu_torch.ops.contractions import (dropout_case_mask,
                                                  risi_contraction_18_dropout)
from graphflow_tpu_torch.ops.risi_level import SMEM_LIMIT_BYTES, check_smem
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# float64 on both sides: outputs at 1e-9, gradients and trained parameters
# at 1e-8 of max(1, scale), as the other slices' tests hold them.
RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
LR = 1e-3
SCHEDULE = (8, 4, 2, 1)
CFG = dict(max_nVertices=8, max_receptive_field=4, nLevels=3, nChanels=8,
           nFeatures=4, nDepth=2, dtype="float64")
N_CASES = {"SMP_gamma": 4, "SMP_2D_ver6": 10, "SMP_omega": 18,
           "SMP_2D_ver7": 50}


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _pair(**kw):
    """A JAX SMP2D in float64 and the port's with the same weights."""
    kw = {**CFG, **kw}
    jm = jsmp2d.SMP2D(jsmp2d.SMP2DConfig(**kw), seed=3)
    tm = models.SMP2D(models.SMP2DConfig(**kw), device="cpu")
    tm.load_params(_flat(jm.params))
    return jm, tm


def _data():
    jg, jt = jdatasets.toy_molecules()
    tg, _ = datasets.toy_molecules()
    jg += [jdatasets.random_graph(8, 0.3, seed=s) for s in (1, 2)]
    tg += [datasets.random_graph(8, 0.3, seed=s) for s in (1, 2)]
    return jg, tg, jt + [3.0, 4.5]


def _assert_same_model(tm, jm):
    ref = _flat(jm.params)
    for path, p in tm.param_dict().items():
        _close(p, ref[path].numpy(), RTOL_GRAD)
    for key in ("m", "v"):
        jstate = _flat(jm.opt_state[key])
        for path, x in tm.opt_state[key].items():
            _close(x, jstate[path].numpy(), RTOL_GRAD)
    assert tm.opt_state["t"] == int(jm.opt_state["t"])


def _serve_grads_steps(jm, tm, lr=LR):
    jg, tg, targets = _data()
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    for a, b in zip(jg, tg):
        _close(tm.Feature(b), jm.Feature(a), RTOL_FWD)
    loss, grads = tm._loss_and_grads(tm._stack(tg, targets))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, targets))
    _close(loss, jloss, RTOL_FWD)
    ref = _flat(jgrads)
    assert list(grads) == tm.param_order
    for path, g in grads.items():
        _close(g, ref[path].numpy(), RTOL_GRAD)
    for _ in range(3):
        got = tm.BatchLearn(tg, targets, lr)
        _close(np.array(got), np.array(jm.BatchLearn(jg, targets, lr)),
               RTOL_GRAD)
        _assert_same_model(tm, jm)


@pytest.mark.parametrize("contraction", [18, 4])
def test_scheduled_tower_matches_jax(contraction):
    jm, tm = _pair(contraction=contraction, channel_schedule=SCHEDULE)
    shapes = {p: tuple(v.shape) for p, v in tm.param_dict().items()}
    k = contraction
    assert shapes == {
        "H": (8, 12), "levels/0/K": (k * 8, 4), "levels/0/b": (4,),
        "levels/1/K": (k * 4, 2), "levels/1/b": (2,),
        "levels/2/K": (k * 2, 1), "levels/2/b": (1,), "W": (1,)}
    _serve_grads_steps(jm, tm)


def test_fresh_scheduled_parameters_have_the_jax_shapes():
    kw = dict(CFG, channel_schedule=SCHEDULE, nClasses=3, contraction=10)
    jm = jsmp2d.SMP2D(jsmp2d.SMP2DConfig(**kw))
    tm = models.SMP2D(models.SMP2DConfig(**kw), seed=5, device="cpu")
    assert {p: tuple(v.shape) for p, v in tm.param_dict().items()} == {
        p: tuple(v.shape) for p, v in _flat(jm.params).items()}
    assert [tm.cfg.channels_at(l) for l in range(4)] == list(SCHEDULE)
    assert models.SMP2DConfig(**CFG).channels_at(2) == 8
    with pytest.raises(ValueError, match="nLevels \\+ 1 = 4 entries"):
        models.SMP2DConfig(**dict(CFG, channel_schedule=(8, 4)))


def test_raw_features_match_jax():
    """``use_wl_features=False``: H takes the raw features, and the
    prepared batch carries them."""
    jm, tm = _pair(use_wl_features=False, has_WL_ordering=False, nDepth=0)
    assert tm.cfg.feat_dim == jm.cfg.feat_dim == 4
    assert tm.param_dict()["H"].shape == (8, 4)
    jg, tg, _ = _data()
    _close(tm._stack(tg)["wl_feat"], jm._stack(jg)["wl_feat"], 0)
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)


def _jax_level_features(jm, jg, case_mask=None, training=False):
    batch = jm._stack(jg)
    mask = None if case_mask is None else jnp.asarray(case_mask)
    return jax.vmap(lambda g: jsmp2d.smp2d_level_features(
        jm.params, g, jm.cfg, case_mask=mask, training=training))(batch)


@pytest.mark.parametrize("schedule", [None, SCHEDULE])
def test_level_features_match_jax(schedule):
    jm, tm = _pair(channel_schedule=schedule)
    jg, tg, _ = _data()
    with torch.no_grad():
        got = smp2d_level_features(tm.params, tm._stack(tg), tm.cfg)
    ref = _jax_level_features(jm, jg)
    assert len(got) == len(ref) == 4
    widths = schedule or (8, 8, 8, 8)
    for l, (x, r) in enumerate(zip(got, ref)):
        assert x.shape == (len(tg), widths[l])
        _close(x, r, RTOL_FWD)


def _masks(n_cases):
    """A train mask (0/1, some cases dropped) and the eval mask."""
    rng = np.random.default_rng(n_cases)
    train = np.zeros(n_cases)
    train[rng.permutation(n_cases)[:max(n_cases // 2, 2)]] = 1.0
    return {"train": train, "eval": np.full(n_cases, 0.5)}


@pytest.mark.parametrize("kind", ["train", "eval"])
@pytest.mark.parametrize("name", N_CASES)
def test_case_mask_matches_jax(name, kind):
    """The port scales K's row blocks where the JAX package scales the
    bank's cases: the same product up to the order of one multiplication
    (1e-9 of the scale at float64); the gradients of K and H through the
    masked tower agree at 1e-8."""
    k = N_CASES[name]
    jm, tm = _pair(contraction=k, nLevels=2, channel_schedule=(8, 4, 2))
    jg, tg, _ = _data()
    mask = _masks(k)[kind]
    tmask = torch.from_numpy(mask)
    batch = tm._stack(tg)
    with torch.no_grad():
        got = smp2d_level_features(tm.params, batch, tm.cfg, case_mask=tmask)
        plain = smp2d_level_features(
            tm.params, batch, tm.cfg, level_fn=lambda *a:
            case_mask_level_reference(k, tmask, *a))
    ref = _jax_level_features(jm, jg, mask)
    for x, p, r in zip(got, plain, ref):
        _close(x, r, RTOL_FWD)
        _close(p, r, RTOL_FWD)
    # A dropped case's rows of K get no gradient; the rest match JAX's.
    feats = smp2d_level_features(tm.params, batch, tm.cfg, case_mask=tmask,
                                 training=True)
    params = tm.param_dict()
    grads = dict(zip(params, torch.autograd.grad(
        sum((f ** 2).sum() for f in feats), list(params.values()),
        allow_unused=True)))
    jbatch = jm._stack(jg)

    def jloss(p):
        fs = jax.vmap(lambda g: jsmp2d.smp2d_level_features(
            p, g, jm.cfg, case_mask=jnp.asarray(mask), training=True))(jbatch)
        return sum((f ** 2).sum() for f in fs)

    ref = _flat(jax.grad(jloss)(jm.params))
    for path in ("H", "levels/0/K", "levels/0/b", "levels/1/K", "levels/1/b"):
        _close(grads[path], ref[path].numpy(), RTOL_GRAD)
    if kind == "train":
        dropped = np.flatnonzero(mask == 0)
        dK = grads["levels/0/K"].reshape(k, 8, 4)
        assert not dK[dropped].any() and dK.any()


def test_case_mask_changes_the_states_and_none_is_the_default():
    _, tm = _pair(nLevels=2, channel_schedule=(8, 4, 2))
    _, tg, _ = _data()
    batch = tm._stack(tg)
    with torch.no_grad():
        base = smp2d_states(tm.params, batch, tm.cfg)
        ones = smp2d_states(tm.params, batch, tm.cfg,
                            case_mask=torch.ones(18, dtype=torch.float64))
        half = smp2d_states(tm.params, batch, tm.cfg,
                            case_mask=torch.full((18,), 0.5))
    assert all(torch.equal(a, b) for a, b in zip(base, ones))
    assert float((base[-1] - half[-1]).abs().max()) > 1e-6


@pytest.mark.parametrize("shape", [(2, 4, 3), (5, 6, 2)])
def test_contraction_18_dropout_matches_jax(shape):
    B, P, C = shape
    rng = np.random.default_rng(B)
    T = rng.normal(size=(B, P, P, P, C))
    A = rng.normal(size=(B, P, P))
    mask = _masks(18)["train"]
    ref = jax.vmap(lambda t, a: jcontractions.risi_contraction_18_dropout(
        t, a, jnp.asarray(mask)))(jnp.asarray(T), jnp.asarray(A))
    got = risi_contraction_18_dropout(torch.from_numpy(T),
                                      torch.from_numpy(A),
                                      torch.from_numpy(mask))
    _close(got, ref, 1e-12)


@pytest.mark.parametrize("n_cases", [18, 50])
def test_dropout_case_mask(n_cases):
    """Eval: the constant nKept / n_cases, as JAX's.  Train: nKept ones at
    places drawn from the generator (not JAX's places: another PRNG)."""
    nKept = 7
    ref = jcontractions.dropout_case_mask(jax.random.PRNGKey(0), nKept, False,
                                          n_cases)
    gen = torch.Generator().manual_seed(0)
    _close(dropout_case_mask(gen, nKept, False, n_cases), ref, 1e-7)
    drawn = [dropout_case_mask(gen, nKept, True, n_cases) for _ in range(4)]
    jdrawn = jcontractions.dropout_case_mask(jax.random.PRNGKey(1), nKept,
                                             True, n_cases)
    for m in drawn:
        assert m.shape == jdrawn.shape and m.dtype == torch.float32
        assert sorted(m.tolist()) == sorted(np.asarray(jdrawn).tolist())
    assert any(not torch.equal(drawn[0], m) for m in drawn[1:])
    again = dropout_case_mask(torch.Generator().manual_seed(0), nKept, True,
                              n_cases)
    assert torch.equal(again, dropout_case_mask(
        torch.Generator().manual_seed(0), nKept, True, n_cases))


def test_smp_beta_matches_jax():
    """No receptive-field cap: P = max_nVertices.  XLA and torch round
    Adam's float32 pow differently in the last place at some exponents, so
    a step moves by ~1e-7 of itself; the uncapped field's gradients are
    steep enough that the rate must be 1e-4 for the next step's state to
    stay within 1e-8."""
    kw = dict(max_nVertices=8, nLevels=2, nChanels=4, nFeatures=4, nDepth=2)
    jm = jsmp2d.SMP_beta(**kw, seed=3)
    jm.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                       jm.params)
    jm.cfg.dtype = "float64"
    jm._finish_init()
    tm = models.SMP_beta(**kw, device="cpu").double()
    tm.cfg.dtype = "float64"
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    assert tm.cfg.P == jm.cfg.P == 8 and tm.cfg.max_receptive_field is None
    assert tm._stack(_data()[1])["radj"].shape[-2:] == (8, 8)
    _serve_grads_steps(jm, tm, lr=1e-4)


def test_gpu_class_names_build_the_models_themselves():
    kw = dict(max_nVertices=8, nLevels=2, nChanels=4, nFeatures=4, nDepth=2)
    pairs = [(models.SMP_omega_gpu, models.SMP_omega, dict(
                 kw, max_receptive_field=4), {}),
             (models.SMP_omega_gpu_multistreams, models.SMP_omega, dict(
                 kw, max_receptive_field=4), {"nThreads": 4}),
             (models.SMP_beta_gpu, models.SMP_beta, kw, {}),
             (models.SMP_beta_gpu_multistreams, models.SMP_beta, kw,
              {"nThreads": 2})]
    for alias, ctor, args, extra in pairs:
        a = alias(**args, **extra, seed=2, device="cpu")
        m = ctor(**args, seed=2, device="cpu")
        assert a.cfg == m.cfg
        assert a.cfg == models.SMP2DConfig(**{
            f: getattr(getattr(jsmp2d, alias.__name__)(**args, **extra).cfg, f)
            for f in ("max_nVertices", "max_receptive_field", "nLevels",
                      "nChanels", "nFeatures", "nDepth", "has_WL_ordering",
                      "use_coulomb", "use_wl_features", "contraction",
                      "nClasses", "optimizer", "dtype", "channel_schedule")})
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                     m.parameters()))


def test_shared_memory_arithmetic_of_the_level_kernels():
    """The wrappers refuse a receptive field whose [P*P, Cout] maps do not
    fit one block's 227 KB, with the sizes in the message.  The bytes a
    block needs are the kernel library's own count (its layout at a channel
    chunk of one), which ``check_smem`` asks for (P, Cout); here a stand-in
    gives the least a field can need: P=64 at Cout=32 holds Z alone at
    32 * 4097 * 4 = 524 KB, and the backward keeps two [P*P, Cout + 1] maps
    and so already refuses P=32."""
    asked = []

    def z_alone(P, Cout):
        asked.append((P, Cout))
        return Cout * (P * P + 1) * 4

    assert SMEM_LIMIT_BYTES == 227 * 1024
    check_smem("k", z_alone, 16, 32)
    check_smem("k", lambda P, Cout: SMEM_LIMIT_BYTES, 32, 32)
    with pytest.raises(RuntimeError, match="risi18_bank: .*P=64 at Cout=32 "
                                           "needs 524416 bytes \\(512 KB\\)"
                                           ".*232448 bytes"):
        check_smem("risi18_bank", z_alone, 64, 32)
    with pytest.raises(RuntimeError, match="P=32 at Cout=32 needs 270336 "):
        check_smem("k2", lambda P, Cout: 2 * P * P * (Cout + 1) * 4, 32, 32)
    assert asked == [(16, 32), (64, 32)]
