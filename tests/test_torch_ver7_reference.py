"""SMP_2D_ver7 in the port against the benchmark's plain reference
(``perfbench/reference_smp2d_ver7.py``: T materialised, each of the 50
cases one einsum of the case table, the whole bank times K), on seeded
random weights and molecule-shaped graphs, on the CPU: the predictions in
float64 and float32, one Momentum ``BatchLearn`` step (loss, gradient,
parameters after), and a reference with a case taken out, or in TF32,
rejected at the float32 tolerance.

Tolerances, each relative to the reference's scale (a prediction's root
mean square; a leaf's largest magnitude):
- float64, 1e-10: the same function summed in another order (the program
  factors the bank into shared reductions, the reference sums each case
  whole); float64's unit roundoff 1.1e-16 times sums of a few hundred
  terms over two levels stays below 1e-13.
- float32 predictions, 1e-5: float32's unit roundoff 6e-8 times the
  ~P^3 = 125 terms of the largest sum and two levels is ~1.5e-5 at worst,
  ~1e-7 as rounding errors cancel (read here); a reference with one case
  zeroed or in TF32 (10 mantissa bits, ~5e-4 a product) lies above it.
- float32 training, 1e-4: the gradient's adjoint sums run over the batch
  too, and a leaf's entries that cancel to a small sum carry the most
  rounding.
"""

import numpy as np
import pytest
import torch

from graphflow_tpu_torch.models.smp2d import SMP2D, SMP2DConfig
from perfbench import compare, family_smp2d_ver7, graphs
from perfbench import reference_smp2d_ver7 as ref

torch.set_num_threads(1)

CFG = dict(max_nVertices=10, max_receptive_field=5, nLevels=2, nChanels=6,
           nFeatures=4, nDepth=2, has_WL_ordering=True,
           optimizer="momentum", momentum={"gamma": 0.9})
TRAFFIC = dict(pool=6, atoms=[6, 10], rings_per_atom=0.12, valence=4,
               atom_types=4, target_scale=1.0)
TOL = {"float64": 1e-10, "float32": 1e-5}
TRAIN_TOL = {"float64": 1e-10, "float32": 1e-4}
SEEDS = [3, 2**31 + 5]
LR = 1e-2


def _cfg(dtype):
    return dict(CFG, dtype=dtype)


def _setup(dtype, seed):
    """(model, its graphs, the reference's preps, the weights, targets)."""
    cfg = _cfg(dtype)
    keys = ("max_nVertices", "max_receptive_field", "nLevels", "nChanels",
            "nFeatures", "nDepth", "has_WL_ordering", "optimizer", "dtype")
    model = SMP2D(SMP2DConfig(**{k: cfg[k] for k in keys}, contraction=50),
                  seed=0, device="cpu")
    weights = family_smp2d_ver7.make_weights(cfg, seed, "cpu")
    model.load_params(weights)
    model.opt_state = model.opt.init(model.param_dict())
    pool, targets = graphs.make_pool(seed, TRAFFIC)
    # Stacking hands the targets over in float32: take values it keeps.
    targets = targets.astype(np.float32).astype(np.float64)
    dense = [family_smp2d_ver7.program_graph(a, f) for a, f in pool]
    preps = [ref.prepare(a, f, cfg) for a, f in pool]
    return model, dense, preps, weights, targets


def _gap(prog, expect):
    return compare.prediction_numbers(prog, expect)["pred"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_predictions_match_the_reference(dtype, seed):
    model, dense, preps, weights, _ = _setup(dtype, seed)
    prog = model.Threaded_Predict(dense)
    expect = ref.predict(preps, weights, _cfg(dtype))
    assert np.abs(expect).max() > 0
    assert _gap(prog, expect) <= TOL[dtype]


def _zero_case(case):
    """The reference's bank with case ``case`` (1-based) zeroed."""
    bank = ref.bank_50

    def zeroed(T, A, mm):
        Y = bank(T, A, mm)
        C = T.shape[-1]
        Y[..., (case - 1) * C:case * C] = 0
        return Y

    return zeroed


@pytest.mark.parametrize("case", [50, 1, 26])
def test_a_reference_without_a_case_fails_float32(case, monkeypatch):
    model, dense, preps, weights, _ = _setup("float32", SEEDS[0])
    prog = model.Threaded_Predict(dense)
    monkeypatch.setattr(ref, "bank_50", _zero_case(case))
    expect = ref.predict(preps, weights, _cfg("float32"))
    assert _gap(prog, expect) > TOL["float32"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_reference_fails_float32(seed):
    model, dense, preps, weights, _ = _setup("float32", seed)
    exact = ref.predict(preps, weights, _cfg("float32"))
    control = ref.predict(preps, weights, _cfg("float32"), precision="tf32")
    assert _gap(control, exact) > TOL["float32"]
    assert _gap(model.Threaded_Predict(dense), exact) <= TOL["float32"]


def test_the_case_table_is_the_reference_order():
    """Cases 1, 11, 17, 41 and 50 as ``RisiContraction_50.h:94-431``
    writes them: (a,b) with c, d, e summed; (a,b) with c = d; (a,d) with
    b = c; (a,b) with c = d = e; (d,e) with a = b = c."""
    assert len(ref.CASES) == len(set(ref.CASES)) == 50
    assert ref.equation(*ref.CASES[0]) == "vabcf,vde->vabf"
    assert ref.equation(*ref.CASES[10]) == "vabcf,vce->vabf"
    assert ref.equation(*ref.CASES[16]) == "vabbf,vde->vadf"
    assert ref.equation(*ref.CASES[40]) == "vabcf,vcc->vabf"
    assert ref.equation(*ref.CASES[49]) == "vaaaf,vde->vdef"


def _leaf_gap(got, expect):
    scale = max(float(expect.abs().max()), 1e-300)
    return float((got.double() - expect).abs().max()) / scale


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_one_momentum_step_matches_the_reference(dtype):
    model, dense, preps, weights, targets = _setup(dtype, SEEDS[0])
    batch = list(range(4))
    loss, _ = model.BatchLearn([dense[i] for i in batch], targets[batch], LR)
    grad = family_smp2d_ver7.first_gradient(model, _cfg(dtype),
                                            learning_rate=LR)
    after = {p: x.detach() for p, x in model.param_dict().items()}
    losses, first, expect = ref.train([([preps[i] for i in batch],
                                        targets[batch])], weights,
                                      _cfg(dtype), LR)
    tol = TRAIN_TOL[dtype]
    assert compare.loss_gap(loss, losses[0]) <= tol
    assert set(grad) == set(first) == set(after) == set(expect)
    for p in first:
        assert first[p].abs().max() > 0, p
        assert _leaf_gap(grad[p], first[p]) <= tol, p
        assert _leaf_gap(after[p], expect[p]) <= tol, p


def test_first_gradient_needs_the_learning_rate():
    model, *_ = _setup("float64", SEEDS[0])
    with pytest.raises(ValueError, match="learning rate"):
        family_smp2d_ver7.first_gradient(model, _cfg("float64"))
