"""The cluster decomposition of K1's and K2 kernel 1's row-tiled plans, on
the CPU: a vertex's row tiles spread over a cluster of blocks, block
``rank`` taking the tiles rank, rank + cluster, ..., the scalar cases (and
in the backward GA, db and dK) as the blocks' parts added in rank order.

* The plain version of that decomposition
  (``ops/risi_bank.py:risi18_bank_cluster_reference``,
  ``risi18_bank_backward_cluster_reference``; the level's
  ``ops/risi_level.py:risi18_level_cluster_reference``,
  ``risi18_level_backward_cluster_reference``) against the JAX package:
  the bank against ``risi_contraction_18`` times K and its ``jax.vjp``, the
  level against the XLA level ``_reference_level`` and its ``jax.vjp``, in
  float64 at 1e-10.
* The same against the untiled factored references, for tiles that divide
  P and tiles that leave a short last tile, and clusters of 1, 2, 4 and 8
  blocks (float64, 1e-10).
* float32 and bfloat16 in, float32 sums, rounded once.

Small: N <= 3 vertices, P in {33, 36, 40}, C <= 3, Cout <= 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.ops.contractions import risi_contraction_18
from graphflow_tpu.ops.risi_fused_pallas import _reference_level
from graphflow_tpu_torch.ops.risi_bank import (
    risi18_bank_backward_cluster_reference,
    risi18_bank_backward_factored_reference, risi18_bank_cluster_reference,
    risi18_bank_factored_reference, risi18_bank_reference)
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level_backward_cluster_reference,
    risi18_level_backward_factored_reference, risi18_level_cluster_reference,
    risi18_level_factored_reference)
from graphflow_tpu_torch.utils import datasets

torch.set_num_threads(1)

# float64 on both sides: the same sums in another order.
RTOL64 = 1e-10
CLUSTERS = [1, 2, 4, 8]
# (N, P, C, Cout, rows): tiles that divide P (4 of 36, 8 of 40) and tiles
# that leave a short last tile (4 and 8 of 33, 5 of 36, 7 of 40).
TILED = [(3, 33, 2, 4, 4), (2, 33, 3, 3, 8), (2, 36, 2, 3, 4),
         (2, 36, 3, 4, 5), (2, 40, 2, 4, 7), (2, 40, 3, 2, 8)]


def _close(got, ref, rtol=RTOL64):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bank_case(N, P, C, Cout):
    rng = np.random.default_rng(P + 7 * C + Cout)
    T = rng.normal(size=(N, P, P, P, C))
    T[-1, 3] = 0.0                     # an empty slot, as padding leaves one
    return (T, rng.normal(size=(N, P, P)), rng.normal(size=(18 * C, Cout)),
            rng.normal(size=(N, P, P, Cout)))


def _level_case(N, P, C, Cout):
    d = datasets.random_level_case(N, P, C, Cout, seed=P + C,
                                   empty_vertex=N - 1)
    g = np.random.default_rng(P + Cout).normal(size=(N, P * P, Cout))
    return [d[k] for k in ("state", "nbr", "pos", "radj", "K", "b")], g


def _jax_bank(T, A, K):
    """Z [N, P, P, Cout] of the JAX package's 18-case contraction times K."""
    N, P = T.shape[:2]
    Y = jax.vmap(risi_contraction_18)(T, A)
    return (Y.reshape(N, P * P, -1) @ K).reshape(N, P, P, -1)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("N,P,C,Cout,rows", TILED[::2])
def test_cluster_bank_matches_jax(N, P, C, Cout, rows, cluster):
    T, A, K, g = _bank_case(N, P, C, Cout)
    jT, jA, jK = (jnp.asarray(x) for x in (T, A, K))
    _close(risi18_bank_cluster_reference(_t(T), _t(A), _t(K), rows, cluster),
           _jax_bank(jT, jA, jK))
    dT, dK = risi18_bank_backward_cluster_reference(_t(T), _t(A), _t(K),
                                                    _t(g), rows, cluster)
    _, vjp = jax.vjp(lambda t, k: _jax_bank(t, jA, k), jT, jK)
    ref_dT, ref_dK = vjp(jnp.asarray(g))
    _close(dT, ref_dT)
    _close(dK, ref_dK)


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("N,P,C,Cout,rows", TILED[1::2])
def test_cluster_level_matches_jax(N, P, C, Cout, rows, cluster):
    args, g = _level_case(N, P, C, Cout)
    targs = [_t(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    _close(risi18_level_cluster_reference(*targs, rows, cluster),
           _reference_level(*jargs))
    got = risi18_level_backward_cluster_reference(*targs, _t(g), rows,
                                                  cluster)
    state, nbr, pos, radj, K, b = jargs
    _, vjp = jax.vjp(lambda s, k, bb: _reference_level(s, nbr, pos, radj, k,
                                                       bb), state, K, b)
    for x, r in zip(got, vjp(jnp.asarray(g))):
        _close(x, r)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("N,P,C,Cout,rows", TILED)
def test_cluster_bank_equals_the_untiled_one(N, P, C, Cout, rows, cluster):
    T, A, K, g = (_t(x) for x in _bank_case(N, P, C, Cout))
    _close(risi18_bank_cluster_reference(T, A, K, rows, cluster),
           risi18_bank_factored_reference(T, A, K))
    got = risi18_bank_backward_cluster_reference(T, A, K, g, rows, cluster)
    for x, r in zip(got, risi18_bank_backward_factored_reference(T, A, K,
                                                                 g)):
        assert x.dtype == r.dtype
        _close(x, r)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("N,P,C,Cout,rows", TILED[:4])
def test_cluster_level_equals_the_untiled_one(N, P, C, Cout, rows, cluster):
    args, g = _level_case(N, P, C, Cout)
    targs = [_t(a) for a in args]
    _close(risi18_level_cluster_reference(*targs, rows, cluster),
           risi18_level_factored_reference(*targs))
    got = risi18_level_backward_cluster_reference(*targs, _t(g), rows,
                                                  cluster)
    ref = risi18_level_backward_factored_reference(*targs, _t(g))
    for x, r in zip(got, ref):
        assert x.dtype == r.dtype
        _close(x, r)


def test_cluster_decomposition_keeps_the_dtypes():
    """float32 and bfloat16 in: float32 sums, the inputs' dtypes out, each
    rounded once (within a rounding or two of the plain bank)."""
    T, A, K, g = (torch.as_tensor(x, dtype=torch.float32)
                  for x in _bank_case(1, 33, 2, 3))
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 * 2.0 ** -7)):
        Z = risi18_bank_cluster_reference(T.to(dt), A, K.to(dt), 4, 8)
        dT, dK = risi18_bank_backward_cluster_reference(
            T.to(dt), A, K.to(dt), g.to(dt), 4, 8)
        assert Z.dtype == dT.dtype == dK.dtype == dt
        ref = risi18_bank_reference(T.to(dt), A, K.to(dt))
        scale = max(1.0, float(ref.float().abs().max()))
        assert float((Z.float() - ref.float()).abs().max()) <= tol * scale
