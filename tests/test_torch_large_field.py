"""Receptive fields beyond one block of the level kernels (P = 33 to 40),
on the CPU: the functions the kernels are held against, at the sizes
where the kernels walk a vertex's rows in tiles.

* The plain level and bank, forward and backward, against the JAX
  package's XLA compositions at float64 (rtol 1e-10).
* The row-tiled decomposition the kernels use
  (``ops/risi_bank.py:risi18_bank_tiled_reference`` and
  ``risi18_bank_backward_tiled_reference``: each tile of rows from the
  whole slots in it and its rows of every slot only, the scalars in a pass
  of their own) against the untiled factored bank, for tiles that divide P
  and tiles that do not (float64, 1e-10).
* SMP_beta, whose field is the whole graph (P = V), at V = 36 against the
  JAX SMP_beta: a request at 1e-9 and one step's loss and gradients at 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models import smp2d as jsmp2d
from graphflow_tpu.ops.fused import risi18_matmul_fused as jax_fused
from graphflow_tpu.ops.risi_fused_pallas import _reference_level
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.ops.risi_bank import (
    risi18_bank_backward_reference, risi18_bank_backward_tiled_reference,
    risi18_bank_factored_reference, risi18_bank_reference,
    risi18_bank_tiled_reference)
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level_backward_reference, risi18_level_reference)
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# float64 on both sides: the same sums in another order.
RTOL64 = 1e-10
# The model: outputs at 1e-9, gradients at 1e-8 of max(1, scale), as the
# other slices' model tests hold them.
RTOL_FWD, RTOL_GRAD = 1e-9, 1e-8
# Small: N <= 3 vertices, C <= 3 channels, Cout <= 4 outputs.
FIELDS = [(3, 33, 2, 4), (2, 36, 3, 3), (2, 40, 2, 4)]


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _level_case(N, P, C, Cout):
    d = datasets.random_level_case(N, P, C, Cout, seed=P,
                                   empty_vertex=N - 1)
    g = np.random.default_rng(P).normal(size=(N, P * P, Cout))
    return d, g


def _level_args(d, to):
    return [to(d[k]) for k in ("state", "nbr", "pos", "radj", "K", "b")]


def _bank_case(N, P, C, Cout):
    rng = np.random.default_rng(P + C)
    return (rng.normal(size=(N, P, P, P, C)), rng.normal(size=(N, P, P)),
            rng.normal(size=(18 * C, Cout)),
            rng.normal(size=(N, P, P, Cout)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("N,P,C,Cout", FIELDS)
def test_plain_level_matches_jax_on_large_fields(N, P, C, Cout):
    d, _ = _level_case(N, P, C, Cout)
    _close(risi18_level_reference(*_level_args(d, _t)),
           _reference_level(*_level_args(d, jnp.asarray)), RTOL64)


@pytest.mark.parametrize("N,P,C,Cout", FIELDS)
def test_plain_level_backward_matches_jax_on_large_fields(N, P, C, Cout):
    d, g = _level_case(N, P, C, Cout)
    got = risi18_level_backward_reference(*_level_args(d, _t), _t(g))
    state, nbr, pos, radj, K, b = _level_args(d, jnp.asarray)
    _, vjp = jax.vjp(lambda s, k, bb: _reference_level(s, nbr, pos, radj, k,
                                                       bb), state, K, b)
    for x, r in zip(got, vjp(jnp.asarray(g))):
        _close(x, r, RTOL64)


@pytest.mark.parametrize("N,P,C,Cout", FIELDS)
def test_plain_bank_matches_jax_on_large_fields(N, P, C, Cout):
    T, A, K, _ = _bank_case(N, P, C, Cout)
    ref = jax.vmap(jax_fused, in_axes=(0, 0, None))(
        jnp.asarray(T), jnp.asarray(A), jnp.asarray(K))
    _close(risi18_bank_reference(_t(T), _t(A), _t(K)), ref, RTOL64)


@pytest.mark.parametrize("N,P,C,Cout", FIELDS)
def test_plain_bank_backward_matches_jax_on_large_fields(N, P, C, Cout):
    T, A, K, g = _bank_case(N, P, C, Cout)
    dT, dK = risi18_bank_backward_reference(_t(T), _t(A), _t(K), _t(g))
    bank = jax.vmap(jax_fused, in_axes=(0, 0, None))
    _, vjp = jax.vjp(lambda t, k: bank(t, jnp.asarray(A), k), jnp.asarray(T),
                     jnp.asarray(K))
    ref_dT, ref_dK = vjp(jnp.asarray(g))
    _close(dT, ref_dT, RTOL64)
    _close(dK, ref_dK, RTOL64)


# Tiles that divide the field (4 of 36, 8 of 40, one tile of all rows) and
# tiles that leave a short last tile (5 and 16 of 36; 7 and 16 of 40).
TILES = [(36, 4), (36, 5), (36, 16), (36, 36), (40, 7), (40, 8), (40, 16)]


@pytest.mark.parametrize("P,rows", TILES)
def test_row_tiled_bank_equals_the_untiled_one(P, rows):
    T, A, K, _ = _bank_case(2, P, 2, 3)
    T[1, 3] = 0.0                      # an empty slot, as padding leaves one
    args = (_t(T), _t(A), _t(K))
    _close(risi18_bank_tiled_reference(*args, rows),
           risi18_bank_factored_reference(*args), RTOL64)


@pytest.mark.parametrize("P,rows", TILES)
def test_row_tiled_bank_backward_equals_the_untiled_one(P, rows):
    T, A, K, g = _bank_case(2, P, 2, 3)
    T[1, 3] = 0.0
    got = risi18_bank_backward_tiled_reference(_t(T), _t(A), _t(K), _t(g),
                                               rows)
    ref = risi18_bank_backward_reference(_t(T), _t(A), _t(K), _t(g))
    for x, r in zip(got, ref):
        assert x.dtype == r.dtype
        _close(x, r, RTOL64)


def test_row_tiled_bank_keeps_the_dtypes():
    """float32 in, float32 sums and T's and K's dtypes out, as the plain
    versions compute; bfloat16 is rounded once."""
    T, A, K, g = (torch.as_tensor(x, dtype=torch.float32)
                  for x in _bank_case(1, 9, 2, 3))
    for dt in (torch.float32, torch.bfloat16):
        Z = risi18_bank_tiled_reference(T.to(dt), A, K.to(dt), 4)
        dT, dK = risi18_bank_backward_tiled_reference(T.to(dt), A, K.to(dt),
                                                      g.to(dt), 4)
        assert Z.dtype == dT.dtype == dK.dtype == dt
        ref = risi18_bank_reference(T.to(dt), A, K.to(dt))
        scale = max(1.0, float(ref.float().abs().max()))
        tol = 1e-5 if dt == torch.float32 else 2 * 2.0 ** -7
        assert float((Z.float() - ref.float()).abs().max()) <= tol * scale


def _flat(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def test_smp_beta_on_a_field_of_36_rows_matches_jax():
    """SMP_beta has no receptive-field cap: P = V = 36, the first field
    whose forward the kernels walk in row tiles.  One graph, one level, two
    channels, float64; the JAX weights carried across."""
    kw = dict(max_nVertices=36, nLevels=1, nChanels=2, nFeatures=4,
              nDepth=1)
    jm = jsmp2d.SMP_beta(**kw, seed=3)
    jm.params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                       jm.params)
    jm.cfg.dtype = "float64"
    jm._finish_init()
    tm = models.SMP_beta(**kw, device="cpu").double()
    tm.cfg.dtype = "float64"
    tm.load_params(_flat(jm.params))
    tm._finish_init()
    assert tm.cfg.P == jm.cfg.P == 36
    jg = [jdatasets.random_graph(36, 0.1, seed=11)]
    tg = [datasets.random_graph(36, 0.1, seed=11)]
    targets = [2.5]
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg), RTOL_FWD)
    loss, grads = tm._loss_and_grads(tm._stack(tg, targets))
    jloss, jgrads = jm._batch_grad(jm.params, jm._stack(jg, targets))
    _close(loss, jloss, RTOL_FWD)
    ref = _flat(jgrads)
    assert list(grads) == tm.param_order
    for path, g in grads.items():
        _close(g, ref[path].numpy(), RTOL_GRAD)
