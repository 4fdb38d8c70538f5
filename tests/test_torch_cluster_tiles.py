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
* The shapes the cluster plans take for the bank (K4, K5 kernel 1) and
  the level: tiles balanced as the planners make them (P = 40 in tiles of
  14, 14 and 12 rows) on clusters of 3, 2 (a block with two tiles, one
  with one) and 1 block, against the JAX package and the untiled
  references (float64, 1e-10).
* Kernel 0 of K2's and K5's cluster plans (GAp and the row sums GR,
  GAx, GSx of G once a vertex: ``ops/risi_bank.py:
  risi18_bank_backward_sums``, ``ops/risi_level.py:
  risi18_level_backward_sums`` on the CPU) against the same sums in JAX,
  and the dT of one pass a row tile that the references now form against
  the vjp of ``risi_contraction_18`` for tiles that leave a short last
  tile and balanced ones, on clusters of 1, 2, 4 and 8 (float64, 1e-10).
* float32 and bfloat16 in, float32 sums, rounded once.
* The plans the kernels take at the beta pairs' first level (P = 40):
  K2 kernel 1's tiles of 8 rows on a cluster of one block, gathered and
  scattered in chunks of 8 channels, and K1's tiles of 4 rows on 5 and 3
  blocks in chunks of 8 (bfloat16) and of 14 rows on 3 and 1 in chunks of
  4 (float32), for graphs of V = 24 vertices in the field (every
  slot and position past V a hole: neighbour 0, position P) and of
  V = 40, against the JAX level and its ``jax.vjp`` (float64, 1e-10).

Small: N <= 3 vertices, P in {33, 35, 36, 37, 40}, C <= 3, Cout <= 4.
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
    risi18_bank_backward_factored_reference, risi18_bank_backward_sums,
    risi18_bank_cluster_reference, risi18_bank_factored_reference,
    risi18_bank_reference)
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level_backward_cluster_reference,
    risi18_level_backward_factored_reference, risi18_level_backward_sums,
    risi18_level_cluster_reference, risi18_level_factored_reference)
from graphflow_tpu_torch.utils import datasets

torch.set_num_threads(1)

# float64 on both sides: the same sums in another order.
RTOL64 = 1e-10
CLUSTERS = [1, 2, 4, 8]
# (N, P, C, Cout, rows): tiles that divide P (4 of 36, 8 of 40) and tiles
# that leave a short last tile (4 and 8 of 33, 5 of 36, 7 of 40).
TILED = [(3, 33, 2, 4, 4), (2, 33, 3, 3, 8), (2, 36, 2, 3, 4),
         (2, 36, 3, 4, 5), (2, 40, 2, 4, 7), (2, 40, 3, 2, 8)]
# balanced_rows of csrc/risi18_level_common.cuh: 16-row tiles of P = 40
# become 14, 14, 12 (and of P = 33, 11, 11, 11); cluster_shape spreads
# three tiles over 3, 2 or 1 blocks as the grid grows.
BALANCED = [(2, 40, 3, 4, 14), (3, 33, 2, 3, 11)]
BALANCED_CLUSTERS = [3, 2, 1]


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


@pytest.mark.parametrize("cluster", BALANCED_CLUSTERS)
@pytest.mark.parametrize("N,P,C,Cout,rows", BALANCED)
def test_balanced_cluster_bank_matches_jax(N, P, C, Cout, rows, cluster):
    T, A, K, g = _bank_case(N, P, C, Cout)
    jT, jA, jK = (jnp.asarray(x) for x in (T, A, K))
    tT, tA, tK = _t(T), _t(A), _t(K)
    Z = risi18_bank_cluster_reference(tT, tA, tK, rows, cluster)
    _close(Z, _jax_bank(jT, jA, jK))
    _close(Z, risi18_bank_factored_reference(tT, tA, tK))
    dT, dK = risi18_bank_backward_cluster_reference(tT, tA, tK, _t(g), rows,
                                                    cluster)
    _, vjp = jax.vjp(lambda t, k: _jax_bank(t, jA, k), jT, jK)
    ref_dT, ref_dK = vjp(jnp.asarray(g))
    _close(dT, ref_dT)
    _close(dK, ref_dK)


@pytest.mark.parametrize("cluster", BALANCED_CLUSTERS)
def test_balanced_cluster_level_matches_jax(cluster):
    N, P, C, Cout, rows = BALANCED[0]
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


def _jax_sums(G, A):
    """GAp and the row sums GR, GAx, GSx of G [N,P,P,Cout] in JAX."""
    Ap = jnp.maximum(A, 0.0)
    R = Ap.sum(-1)
    return (jnp.einsum("nxyo,nye->nxeo", G, Ap),
            jnp.stack([jnp.einsum("nxyo,ny->nxo", G, R),
                       jnp.einsum("nxy,nxyo->nxo", Ap, G), G.sum(2)], 1))


@pytest.mark.parametrize("N,P,Cout", [(2, 33, 3), (3, 36, 4), (1, 40, 1)])
def test_bank_backward_sums_match_jax(N, P, Cout):
    """Kernel 0's function for the bank (G = g) on the CPU: float64 in,
    float64 out, against the same sums in JAX."""
    rng = np.random.default_rng(P + Cout)
    G, A = rng.normal(size=(N, P, P, Cout)), rng.normal(size=(N, P, P))
    gap, sums = risi18_bank_backward_sums(_t(A), _t(G))
    assert gap.dtype == sums.dtype == torch.float64
    for got, ref in zip((gap, sums), _jax_sums(jnp.asarray(G),
                                               jnp.asarray(A))):
        _close(got, ref)


@pytest.mark.parametrize("N,P,C,Cout", [(2, 33, 2, 3), (2, 37, 1, 4)])
def test_level_backward_sums_take_geff(N, P, C, Cout):
    """Kernel 0's function for the level: G = g through LeakyReLU' of the
    level's output (the JAX XLA level's), then the sums, against JAX."""
    args, g = _level_case(N, P, C, Cout)
    out = np.array(_reference_level(*(jnp.asarray(a) for a in args)))
    gap, sums = risi18_level_backward_sums(_t(args[3]), _t(g), _t(out))
    G = np.where(out > 0, g, 0.01 * g).reshape(N, P, P, Cout)
    for got, ref in zip((gap, sums), _jax_sums(jnp.asarray(G),
                                               jnp.asarray(args[3]))):
        _close(got, ref)


# One dT pass a row tile: fields whose tiles leave a short last tile (4 of
# 35, 8 of 37) and balanced ones (13 of 37: 13, 13, 11).
DT_PASSES = [(2, 35, 2, 3, 4), (2, 37, 1, 4, 8), (2, 37, 2, 2, 13)]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("N,P,C,Cout,rows", DT_PASSES)
def test_dT_one_pass_a_tile_matches_jax(N, P, C, Cout, rows, cluster):
    """dT of the bank as the row-tiled blocks now form it, one pass a row
    tile from kernel 0's sums, against the vjp of the JAX package's
    18-case contraction times K (float64, 1e-10)."""
    T, A, K, g = _bank_case(N, P, C, Cout)
    dT, _ = risi18_bank_backward_cluster_reference(_t(T), _t(A), _t(K),
                                                   _t(g), rows, cluster)
    jA = jnp.asarray(A)
    _, vjp = jax.vjp(lambda t: _jax_bank(t, jA, jnp.asarray(K)),
                     jnp.asarray(T))
    (ref,) = vjp(jnp.asarray(g))
    _close(dT, ref)


# The beta pairs' first level: (N, P, C, Cout, V), V the vertices of a
# graph in the field (tower 1's 24 of 40, tower 2's 40).
PAIR_CASES = [(2, 40, 3, 2, 24), (3, 40, 2, 3, 40)]
# (rows, cluster, chunk) of K1's plans there: bfloat16 at a step's N (96,
# 160) and a Predict's tower 2 (N = 40), float32 at N = 160 and 96.
PAIR_FORWARD_PLANS = [(4, 5, 8), (4, 3, 8), (14, 3, 4), (14, 1, 4)]


def _pair_case(N, P, C, Cout, V):
    """_level_case with every slot and position past V absent, as the prep
    lays out a graph of V vertices in a field of P rows."""
    args, g = _level_case(N, P, C, Cout)
    state, nbr, pos, radj, K, b = args
    nbr, pos = nbr.copy(), pos.copy()
    nbr[:, V:] = 0
    pos[:, V:] = P
    pos[pos >= V] = P
    return [state, nbr, pos, radj, K, b], g


@pytest.mark.parametrize("N,P,C,Cout,V", PAIR_CASES)
def test_pair_field_backward_plan_matches_jax(N, P, C, Cout, V):
    """K2 kernel 1's plan at the beta pairs' first level: tiles of 8 rows
    on a cluster of one block, the slots gathered and dT scattered in
    chunks of 8 channels, against the vjp of the JAX level."""
    args, g = _pair_case(N, P, C, Cout, V)
    got = risi18_level_backward_cluster_reference(
        *(_t(a) for a in args), _t(g), 8, 1, chunk=8)
    state, nbr, pos, radj, K, b = (jnp.asarray(a) for a in args)
    _, vjp = jax.vjp(lambda s, k, bb: _reference_level(s, nbr, pos, radj, k,
                                                       bb), state, K, b)
    for x, r in zip(got, vjp(jnp.asarray(g))):
        _close(x, r)


@pytest.mark.parametrize("rows,cluster,chunk", PAIR_FORWARD_PLANS)
@pytest.mark.parametrize("N,P,C,Cout,V", PAIR_CASES)
def test_pair_field_forward_plans_match_jax(N, P, C, Cout, V, rows, cluster,
                                            chunk):
    """K1's plans at the beta pairs' first level against the JAX level."""
    args, _ = _pair_case(N, P, C, Cout, V)
    _close(risi18_level_cluster_reference(*(_t(a) for a in args), rows,
                                          cluster, chunk=chunk),
           _reference_level(*(jnp.asarray(a) for a in args)))
