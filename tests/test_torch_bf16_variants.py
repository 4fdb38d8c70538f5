"""The SMP_2D contraction variants in bfloat16: the port against the JAX
package's bfloat16 models on the CPU, with the JAX weights (SMP_gamma, 4
cases, Adam; SMP_2D_ver6, 10, Momentum; SMP_2D_ver7, 50, Momentum;
SMP_2D_ver7_classification, log loss).  Threaded_Predict and Feature, the
first step's loss and every gradient, every parameter after each of three
BatchLearn steps, the weights across packages and the text checkpoint.

Both packages take the same route here: the take-gather, then the bank
with K, whose shared reductions and products accumulate in float32 and
round where they are stored.  The bound 3e-2 * max(1, max|ref|) is the
bfloat16 bound of tests/test_fused_kernel.py:133-134, as in
tests/test_torch_bf16.py.  Gradients are held against the JAX package's
float64 gradients on the same bfloat16 weights, and all but the biases also
against its bfloat16 gradients (its bias gradients are reduced in bfloat16,
tests/test_torch_bf16.py).

The three steps use a learning rate at which Momentum descends without
overshooting (it has no per-element normalisation): past that rate the loss
oscillates and one bfloat16 step of difference grows from step to step in
either package, which compares two chaotic runs and not two models."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models import smp2d as jsmp2d
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL = 3e-2
BF16 = torch.bfloat16
CFG = dict(max_nVertices=8, nLevels=2, nChanels=4, nFeatures=4, nDepth=2)
# name -> (contraction, nClasses, optimizer), as the JAX constructors set.
VARIANTS = {
    "SMP_gamma": (4, None, "adam"),
    "SMP_2D_ver6": (10, None, "momentum"),
    "SMP_2D_ver7": (50, None, "momentum"),
    "SMP_2D_ver7_classification": (50, 3, "momentum"),
}
# Receptive field -> a learning rate of steady descent (module docstring).
STEP_LR = {4: 1e-4, 8: 2e-5}


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def _close(got, ref, rtol=RTOL):
    got, ref = _f64(got), _f64(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _kw(name, P, dtype="bfloat16"):
    k, ncls, opt = VARIANTS[name]
    return dict(CFG, max_receptive_field=P, contraction=k, nClasses=ncls,
                optimizer=opt, dtype=dtype)


def _pair(name, P):
    """The JAX package's bfloat16 model and the port's, sharing the JAX
    weights."""
    jm = jsmp2d.SMP2D(jsmp2d.SMP2DConfig(**_kw(name, P)), seed=3)
    tm = models.SMP2D(models.SMP2DConfig(**_kw(name, P)), device="cpu")
    tm.load_params(params_from_jax(_tree(jm.params)))
    return jm, tm


def _data(name):
    """Toy molecules plus two random graphs, for each package; class labels
    for a classification head, else regression targets."""
    jg, jt = jdatasets.toy_molecules()
    tg, _ = datasets.toy_molecules()
    jg += [jdatasets.random_graph(8, 0.3, seed=s) for s in (1, 2)]
    tg += [datasets.random_graph(8, 0.3, seed=s) for s in (1, 2)]
    targets = ([0.0, 1.0, 2.0, 1.0, 0.0, 2.0] if VARIANTS[name][1]
               else jt + [3.0, 4.5])
    return jg, tg, targets


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("name", VARIANTS)
def test_serving_matches_jax(name, P):
    jm, tm = _pair(name, P)
    jg, tg, _ = _data(name)
    got = tm.Threaded_Predict(tg)
    ncls = VARIANTS[name][1]
    assert got.shape == ((len(tg), ncls) if ncls else (len(tg),))
    # The port hands back float32 holding the bfloat16 values.
    assert got.dtype == np.float32
    assert np.array_equal(got, torch.from_numpy(got).to(BF16).float().numpy())
    _close(got, jm.Threaded_Predict(jg))
    for a, b in zip(jg, tg):
        _close(tm.Feature(b), jm.Feature(a))


@pytest.mark.parametrize("name", VARIANTS)
def test_first_step_loss_and_gradients_match_jax(name):
    jm, tm = _pair(name, 4)
    jg, tg, targets = _data(name)
    _close(tm.getLoss(tg, targets), jm.getLoss(jg, targets))
    loss, grads = tm._loss_and_grads(tm._stack(tg, targets))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, targets))
    _close(loss, jloss)
    jm64 = jsmp2d.SMP2D(jsmp2d.SMP2DConfig(**_kw(name, 4, "float64")),
                        seed=3)
    params64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                      jm.params)
    loss64, grads64 = jm64._batch_grad(params64, jm64._stack(jg, targets))
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
@pytest.mark.parametrize("name", VARIANTS)
def test_batch_learn_matches_jax_over_three_steps(name, P):
    jm, tm = _pair(name, P)
    jg, tg, targets = _data(name)
    for _ in range(3):
        got = tm.BatchLearn(tg, targets, STEP_LR[P])
        _close(np.array(got), np.array(jm.BatchLearn(jg, targets,
                                                     STEP_LR[P])))
        ref = params_from_jax(_tree(jm.params))
        for path, p in tm.param_dict().items():
            assert p.dtype == BF16
            _close(p, ref[path])
    if tm.cfg.optimizer == "momentum":
        jstate = params_from_jax(_tree(jm.opt_state))
        for path, v in tm.opt_state.items():
            assert v.dtype == BF16
            _close(v, jstate[path])


@pytest.mark.parametrize("name", VARIANTS)
def test_convert_and_checkpoint_carry_bfloat16_weights(name, tmp_path):
    """K's first axis is 4C, 10C or 50C; every value crosses both ways bit
    for bit, through the tree and through the text checkpoint."""
    jm, tm = _pair(name, 4)
    k, ncls, _ = VARIANTS[name]
    C = CFG["nChanels"]
    tree = _tree(jm.params)
    flat = params_from_jax(tree)
    assert all(t.dtype == BF16 for t in flat.values())
    assert flat["levels/1/K"].shape == (k * C, C)
    assert flat["W"].shape == ((ncls, C) if ncls else (C,))
    back = params_to_numpy(tm.param_dict())
    for l in range(CFG["nLevels"]):
        np.testing.assert_array_equal(
            back["levels"][l]["K"], np.asarray(tree["levels"][l]["K"],
                                               np.float32))
    fn, fn2 = str(tmp_path / "jax.dat"), str(tmp_path / "port.dat")
    jm.save_model(fn)
    fresh = models.SMP2D(models.SMP2DConfig(**_kw(name, 4)), seed=99,
                         device="cpu")
    fresh.load_model(fn)
    for path, p in fresh.param_dict().items():
        assert p.dtype == BF16 and torch.equal(p.detach(), flat[path])
    fresh.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()


@pytest.mark.parametrize("contraction", [10, 50])
def test_case_mask_and_channel_schedule_in_bfloat16(contraction):
    """A case mask scales K before the level and a channel schedule gives
    C != Cout; both run the usual route in bfloat16 and agree with the plain
    masked level, which masks the whole bank."""
    import functools

    from graphflow_tpu_torch.models.smp2d import (case_mask_level_reference,
                                                  smp2d_level_features)

    cfg = models.SMP2DConfig(**CFG, max_receptive_field=4,
                             contraction=contraction, dtype="bfloat16",
                             channel_schedule=(4, 6, 3))
    tm = models.SMP2D(cfg, seed=2, device="cpu")
    _, tg, _ = _data("SMP_2D_ver6")
    mask = (torch.arange(contraction) % 3 != 0).to(BF16)
    with torch.no_grad():
        got = smp2d_level_features(tm.params, tm._stack(tg), cfg,
                                   case_mask=mask)
        ref = smp2d_level_features(
            tm.params, tm._stack(tg), cfg, level_fn=functools.partial(
                case_mask_level_reference, contraction, mask))
    assert [x.shape[1] for x in got] == [4, 6, 3]
    for x, r in zip(got, ref):
        assert x.dtype == BF16
        _close(x, r)
