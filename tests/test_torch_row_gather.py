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
  (float64, 1e-10), also where positions repeat within a slot.
* The producer route's consumers' order of the row sums
  (``risi18_slot_row_sums_reference``: a whole slot's row in storage order
  against the slot's weights, ``risi18_slot_weights``) against the sums
  over the JAX take-gather's T (float64, 1e-10); the piece list a tile's
  producer reads (``producer_pieces``): each needed row once, within the
  words the plan adds; the plan query's name of the route.

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
    PLAN_KEYS, STREAMS, producer_pieces, query_plan,
    risi18_level_backward_cluster_reference, risi18_level_cluster_reference,
    risi18_row_gather_reference, risi18_slot_row_sums_reference,
    risi18_slot_weights)
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


# -- the tensor-copy route's producer and consumers --------------------------

def _repeated_case(N, P, C, Cout, seed):
    """random_level_case with some positions repeated within a slot (two
    columns c reading one cell of the neighbour's row), as no prepared graph
    has but the kernels take."""
    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=N - 1)
    rng = np.random.default_rng(seed)
    pos = d["pos"]
    for v in range(N - 1):
        for a in rng.choice(P, size=3, replace=False):
            c, c2 = rng.choice(P, size=2, replace=False)
            pos[v, a, c2] = pos[v, a, c] if pos[v, a, c] < P else 0
    d["pos"] = pos
    return d


@pytest.mark.parametrize("case", ["random", "prepared", "repeated"])
def test_slot_row_sums_in_storage_order_match_jax(case):
    """T_ab and M6 of every slot as the consumers read a whole slot's rows
    outside its tile (storage order against the slot's weights, no index a
    cell) against the sums over c of the JAX take-gather's T and of R[c]
    times it (float64, 1e-10), with the sentinels, a graph smaller than its
    field and positions that repeat within a slot."""
    V, P, C = 3, 7, 3
    if case == "prepared":
        state, nbr, pos = _prepared_case(V, P, C, (3, 2, 0))
        radj = np.random.default_rng(5).normal(size=(V, P, P))
    else:
        d = (_repeated_case(V, P, C, C, seed=4) if case == "repeated"
             else random_level_case(V, P, C, C, seed=4, empty_vertex=V - 1))
        state, nbr, pos, radj = d["state"], d["nbr"], d["pos"], d["radj"]
    tab, m6 = risi18_slot_row_sums_reference(_t(state), _t(nbr), _t(pos),
                                             _t(radj))
    T = _jax_take(state, nbr, pos)                  # [V, a, b, c, C]
    R = np.clip(radj, 0, None).sum(-1)
    _close(tab, T.sum(3))
    _close(m6, np.einsum("vabcf,vc->vabf", T, R))
    assert np.abs(T.sum(3)).max() > 0


def test_slot_weights_count_the_columns_of_each_cell():
    """A cell read by two columns weighs 2 and the sum of their R; a cell
    no column reads, and absent positions (the sentinel P, -1), weigh 0."""
    P = 4
    pos = torch.tensor([[[2, 2, 0, P], [1, -1, 3, 0], [P, P, P, P],
                         [3, 2, 1, 0]]])
    R = torch.tensor([[1.0, 10.0, 100.0, 1000.0]], dtype=torch.float64)
    cols, rw = risi18_slot_weights(pos, R)
    assert cols[0].tolist() == [[1, 0, 2, 0], [1, 1, 0, 1], [0, 0, 0, 0],
                                [1, 1, 1, 1]]
    assert rw[0].tolist() == [[100.0, 0, 11.0, 0], [1000.0, 1.0, 0, 100.0],
                              [0, 0, 0, 0], [1000.0, 100.0, 10.0, 1.0]]


# (N, P, C, Cout, rows, cluster): tiles of 8 on clusters of 2, and a
# last tile of one row.
@pytest.mark.parametrize("N,P,C,Cout,rows,cluster",
                         [(2, 33, 2, 3, 8, 2), (2, 33, 3, 2, 16, 1)])
def test_cluster_level_with_repeated_positions_matches_jax(N, P, C, Cout,
                                                           rows, cluster):
    """The level's cluster references, whose whole slots' rows outside a
    tile are read against the slot's weights, on positions that repeat
    within a slot, against the JAX XLA level and its jax.vjp (float64,
    1e-10)."""
    d = _repeated_case(N, P, C, Cout, seed=P + rows)
    args = [d[k] for k in ("state", "nbr", "pos", "radj", "K", "b")]
    g = np.random.default_rng(rows).normal(size=(N, P * P, Cout))
    targs = [_t(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    _close(risi18_level_cluster_reference(*targs, rows, cluster, chunk=2),
           _reference_level(*jargs))
    got = risi18_level_backward_cluster_reference(*targs, _t(g), rows,
                                                  cluster, chunk=2)
    state, nbr, pos, radj, K, b = jargs
    _, vjp = jax.vjp(lambda s, k, bb: _reference_level(s, nbr, pos, radj, k,
                                                       bb), state, K, b)
    for x, r in zip(got, vjp(jnp.asarray(g))):
        _close(x, r)


@pytest.mark.parametrize("P,rows", [(33, 4), (40, 14), (37, 15), (64, 4),
                                    (50, 1), (36, 7)])
def test_producer_pieces_stream_each_needed_row_once(P, rows):
    """Every tile's piece list (``producer_pieces``, the list the producer
    reads) fits the words the plan adds for it (``producer_words``: fewer
    than 2P pieces, the slot, first row and present rows of a piece in one
    int, ``piece_entry``)
    and streams each row the tile's maps need exactly once: the rows X of
    every listed slot and the other rows of the listed slots in X, those
    whose neighbour and p1 are present and no other; on a random field with
    the sentinels and on a field of all-present slots."""
    d = random_level_case(3, P, 1, 1, seed=P + rows, empty_vertex=2)
    full_nbr = np.arange(P, dtype=np.int32) % 3
    full_pos = np.tile(np.arange(P, dtype=np.int32), (P, 1))
    fields = [(d["nbr"][v], d["pos"][v]) for v in range(3)]
    fields.append((full_nbr, full_pos))
    for nbr, pos in fields:
        n_ok = (nbr >= 0) & (nbr < 3)
        p_ok = (pos >= 0) & (pos < P)
        listed = [a for a in range(P) if n_ok[a] and p_ok[a].any()]
        for tile in range(-(-P // rows)):
            x0, x1 = tile * rows, min(P, (tile + 1) * rows)
            pieces = producer_pieces(nbr, pos, 3, rows, tile)
            assert len(pieces) < 2 * P and P < 256 and rows < 16
            streamed = []
            for a, b0, present in pieces:
                assert b0 % rows == 0 and len(present) == min(rows, P - b0)
                streamed += [(a, b0 + bl) for bl, ok in enumerate(present)
                             if ok]
            need = [(a, b) for a in listed for b in range(P)
                    if (x0 <= b < x1 or x0 <= a < x1) and p_ok[a, b]]
            assert sorted(streamed) == sorted(need)
            assert len(set(streamed)) == len(streamed)


def test_plan_query_names_the_producer_route():
    """A plan's ``stream`` field 1 is the tensor-copy route with its
    producer warp, 0 cp.async (``query_plan``, whatever library answers)."""
    def answer(route):
        def plan_fn(N, P, C, Cout, bf16, aligned, plan):
            for i in range(len(PLAN_KEYS)):
                plan[i] = 1
            plan[len(PLAN_KEYS) - 1] = route
            return 0
        return plan_fn

    assert STREAMS == ("cp_async", "tma_producer")
    for route, name in enumerate(STREAMS):
        got = query_plan(answer(route), 64, 64, 32, 32)
        assert got["stream"] == name and got["rows"] == 1
