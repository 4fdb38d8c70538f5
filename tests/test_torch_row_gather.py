"""The gathered slots as the cluster plans' tensor-copy route forms them
(``ops/risi_level.py:risi18_row_gather_reference``: a neighbour's row
state[n, p1, :, c0:c0+chunk] copied in storage order, zeros past C and for
an absent n or p1, then read through the slot's permutation pos[a, .],
zeros where a position is absent), on the CPU.

* Bit for bit against the port's take-gather
  (``ops/risi_aligned.py:risi18_aligned_t2_reference``) and the JAX
  package's (``graphflow_tpu/models/smp2d.py:
  _gather_neighbor_tensors_take``), in float64 and bfloat16: it only
  indexes.  Chunks that divide C and chunks that leave a last chunk
  narrower than the box; the JAX tests' sentinel (``nbr`` = V), the
  prepared graphs' (``nbr`` = 0 with ``pos`` = P), graphs smaller than P.
* Its cotangent: autograd scatters dT back into the state as through the
  take-gather.
* The level's cluster references, which now take their T from it, in
  chunks narrower than C, against the JAX XLA level and its ``jax.vjp``
  (float64, 1e-10).

Small: N <= 3 vertices, C <= 3; P = 33 only where a row tile needs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models.smp2d import (
    _gather_neighbor_tensors_take as jax_take)
from graphflow_tpu.ops.risi_fused_pallas import _reference_level
from graphflow_tpu_torch.ops.risi_aligned import risi18_aligned_t2_reference
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level_backward_cluster_reference, risi18_level_cluster_reference,
    risi18_row_gather_reference)
from graphflow_tpu_torch.utils.datasets import random_level_case

torch.set_num_threads(1)

RTOL64 = 1e-10


def _random_case(V, P, C):
    """Seeded state, nbr and pos with the JAX tests' sentinels (ids V,
    positions P) and one all-absent vertex."""
    d = random_level_case(V, P, C, C, seed=V * P + C, empty_vertex=V - 1)
    assert (d["nbr"] == V).any() and (d["pos"] == P).any()
    return d["state"], d["nbr"], d["pos"]


def _prepared_case(V, P, C, sizes):
    """A prepared graph's layout: vertex v's field holds sizes[v] < P
    vertices of a graph of V < P vertices, its padding slots nbr = 0 with
    pos = P, every position past the field P."""
    rng = np.random.default_rng(V + P + C)
    state = rng.normal(size=(V, P, P, C))
    nbr = np.zeros((V, P), np.int32)
    pos = np.full((V, P, P), P, np.int32)
    for v, k in enumerate(sizes):
        nbr[v, :k] = rng.permutation(V)[:k]
        for a in range(k):
            pos[v, a, :k] = rng.permutation(k)
    return state, nbr, pos


def _jax_take(state, nbr, pos):
    """The JAX take-gather over the state padded by one row and column of
    zeros (where the sentinel position P lands)."""
    padded = jnp.pad(jnp.asarray(state), ((0, 0), (0, 1), (0, 1), (0, 0)))
    return np.asarray(jax_take(padded, jnp.asarray(nbr), jnp.asarray(pos)),
                      np.float64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_equal(state, nbr, pos, chunk):
    got = risi18_row_gather_reference(_t(state), _t(nbr), _t(pos), chunk)
    assert got.dtype == torch.float64 and got.shape == (*pos.shape,
                                                        pos.shape[-1],
                                                        state.shape[-1])
    assert torch.equal(got, risi18_aligned_t2_reference(_t(state), _t(nbr),
                                                        _t(pos)))
    np.testing.assert_array_equal(got.numpy(), _jax_take(state, nbr, pos))
    return got


# (V, P, C, chunk): one chunk as wide as C, chunks that divide C, and last
# chunks narrower than the box (3 in chunks of 2, 3 in one of 4 or 16).
@pytest.mark.parametrize("V,P,C,chunk", [(3, 6, 3, 3), (3, 6, 2, 1),
                                         (2, 5, 3, 2), (3, 4, 3, 4),
                                         (2, 7, 3, 16)])
def test_row_gather_equals_the_take_gathers(V, P, C, chunk):
    state, nbr, pos = _random_case(V, P, C)
    got = _check_equal(state, nbr, pos, chunk)
    assert not got[V - 1].any()          # the all-absent vertex


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_row_gather_of_a_prepared_graph_smaller_than_its_field(chunk):
    """Graphs of 3 vertices in fields of 5 (and one vertex with a field of
    1): the padding slots (nbr 0, pos P) and the positions past the graph
    read zeros."""
    state, nbr, pos = _prepared_case(3, 5, 3, sizes=(3, 2, 1))
    got = _check_equal(state, nbr, pos, chunk)
    assert not got[:, 3:].any() and not got[:, :, 3:].any()
    assert not got[:, :, :, 3:].any() and got[0, :3, :3, :3].any()


def test_row_gather_of_out_of_range_ids_and_positions():
    """Ids outside [0, V) and positions outside [0, P) besides the
    sentinels: negative ones and large ones read zeros."""
    state, nbr, pos = _random_case(3, 5, 2)
    nbr[0, 0], nbr[1, 2] = -1, 9
    pos[0, 1, 2], pos[1, 0, 0], pos[0, 3, 4] = -1, 8, -4
    got = risi18_row_gather_reference(_t(state), _t(nbr), _t(pos), 2)
    assert torch.equal(got, risi18_aligned_t2_reference(_t(state), _t(nbr),
                                                        _t(pos)))
    assert not got[0, 0].any() and not got[1, 2].any()


@pytest.mark.parametrize("chunk", [2, 8])
def test_row_gather_in_bfloat16_equals_the_take_gathers(chunk):
    state, nbr, pos = _random_case(3, 6, 3)
    jstate = jnp.asarray(state).astype(jnp.bfloat16)
    take = jax_take(jnp.pad(jstate, ((0, 0), (0, 1), (0, 1), (0, 0))),
                    jnp.asarray(nbr), jnp.asarray(pos))
    tstate = _t(state).to(torch.bfloat16)
    got = risi18_row_gather_reference(tstate, _t(nbr), _t(pos), chunk)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, risi18_aligned_t2_reference(tstate, _t(nbr),
                                                        _t(pos)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(take, np.float32))


@pytest.mark.parametrize("chunk", [2, 3])
def test_row_gather_scatters_its_cotangent_as_the_take_gather(chunk):
    state, nbr, pos = _random_case(3, 5, 3)
    dT = np.random.default_rng(5).normal(size=(3, 5, 5, 5, 3))
    grads = []
    for gather in (lambda s: risi18_row_gather_reference(s, _t(nbr), _t(pos),
                                                         chunk),
                   lambda s: risi18_aligned_t2_reference(s, _t(nbr),
                                                         _t(pos))):
        leaf = _t(state).requires_grad_()
        (g,) = torch.autograd.grad(gather(leaf), leaf, _t(dT))
        grads.append(g.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-13, atol=1e-13)
    assert np.abs(grads[0]).max() > 0


def _close(got, ref):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL64, atol=RTOL64 * scale)


# (N, P, C, Cout, rows, cluster, chunk): the row-tiled level in chunks of
# 2 of 3 channels (a last chunk of 1) and of 1, on clusters of 2 and 1.
@pytest.mark.parametrize("N,P,C,Cout,rows,cluster,chunk",
                         [(2, 33, 3, 3, 8, 2, 2), (2, 33, 2, 2, 11, 1, 1)])
def test_cluster_level_in_narrow_chunks_matches_jax(N, P, C, Cout, rows,
                                                    cluster, chunk):
    d = random_level_case(N, P, C, Cout, seed=P + C + chunk,
                          empty_vertex=N - 1)
    args = [d[k] for k in ("state", "nbr", "pos", "radj", "K", "b")]
    g = np.random.default_rng(P + Cout).normal(size=(N, P * P, Cout))
    targs = [_t(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    _close(risi18_level_cluster_reference(*targs, rows, cluster,
                                          chunk=chunk),
           _reference_level(*jargs))
    got = risi18_level_backward_cluster_reference(*targs, _t(g), rows,
                                                  cluster, chunk=chunk)
    state, nbr, pos, radj, K, b = jargs
    _, vjp = jax.vjp(lambda s, k, bb: _reference_level(s, nbr, pos, radj, k,
                                                       bb), state, K, b)
    for x, r in zip(got, vjp(jnp.asarray(g))):
        _close(x, r)
