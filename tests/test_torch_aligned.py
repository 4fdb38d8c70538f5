"""The aligned neighbour tensor (``ops/risi_aligned.py``) against the JAX
package: the plain version against the Pallas function
``risi18_aligned_t2`` itself, run in interpret mode as tests/test_fused.py
runs the Pallas kernels, exactly (every element is one copied value);
against the JAX take-gather at float64; and against the definition, with
out-of-range ids and positions; in bfloat16 against both, exactly.  On
the CPU the wrapper runs the plain version and launches nothing; it refuses
a state that needs a gradient."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphflow_tpu.models.smp2d import (
    _gather_neighbor_tensors_take as jax_take)
from graphflow_tpu.ops.risi_fused_pallas import (
    risi18_aligned_t2 as jax_aligned)
from graphflow_tpu_torch.ops.risi_aligned import (
    risi18_aligned_t2, risi18_aligned_t2_reference)
from graphflow_tpu_torch.utils.datasets import random_level_case

torch.set_num_threads(1)


def _case(V, P, C, dtype=np.float32):
    """Seeded state, nbr and pos: sentinel ids (N), sentinel positions (P)
    and one all-absent vertex."""
    d = random_level_case(V, P, C, C, seed=V * P + C, empty_vertex=1)
    assert (d["nbr"] == V).any() and (d["pos"] == P).any()
    return d["state"].astype(dtype), d["nbr"], d["pos"]


def _definition(state, nbr, pos):
    """T[v,i,p1,p2] = state[nbr[v,i], pos[v,i,p1], pos[v,i,p2]], zero where
    an id lies outside [0, N) or a position outside [0, P); a loop."""
    N, P, _, C = state.shape
    T = np.zeros((N, P, P, P, C), state.dtype)
    for v in range(N):
        for i in range(P):
            n = nbr[v, i]
            if not 0 <= n < N:
                continue
            for p1 in range(P):
                for p2 in range(P):
                    q1, q2 = pos[v, i, p1], pos[v, i, p2]
                    if 0 <= q1 < P and 0 <= q2 < P:
                        T[v, i, p1, p2] = state[n, q1, q2]
    return T


@pytest.mark.parametrize("V,P,C", [(6, 4, 8), (5, 6, 4)])
def test_reference_equals_pallas_function_exactly(V, P, C):
    state, nbr, pos = _case(V, P, C)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_aligned(jnp.asarray(state), jnp.asarray(nbr),
                          jnp.asarray(pos))
    got = risi18_aligned_t2_reference(*map(torch.from_numpy,
                                           (state, nbr, pos)))
    assert str(ref.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[1].any()


@pytest.mark.parametrize("V,P,C", [(6, 4, 8), (5, 6, 4), (4, 3, 2),
                                   (7, 5, 3)])
def test_reference_equals_jax_take_gather_float64(V, P, C):
    state, nbr, pos = _case(V, P, C, np.float64)
    ref = np.asarray(jax_take(
        jnp.pad(jnp.asarray(state), ((0, 0), (0, 1), (0, 1), (0, 0))),
        jnp.asarray(nbr), jnp.asarray(pos)))
    got = risi18_aligned_t2_reference(*map(torch.from_numpy,
                                           (state, nbr, pos)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), _definition(state, nbr, pos))


@pytest.mark.parametrize("V,P,C", [(4, 16, 8), (6, 4, 8), (5, 6, 3)])
def test_bfloat16_equals_pallas_function_and_take_gather_exactly(V, P, C):
    """A bfloat16 state: T has the state's dtype and holds the values the
    Pallas function selects (it hands them back as float32, its residual's
    type) and the JAX take-gather's bfloat16 T, bit for bit."""
    state, nbr, pos = _case(V, P, C)
    jstate = jnp.asarray(state).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_aligned(jstate, jnp.asarray(nbr), jnp.asarray(pos))
    take = jax_take(jnp.pad(jstate, ((0, 0), (0, 1), (0, 1), (0, 0))),
                    jnp.asarray(nbr), jnp.asarray(pos))
    tstate = torch.from_numpy(state).to(torch.bfloat16)
    for fn in (risi18_aligned_t2, risi18_aligned_t2_reference):
        got = fn(tstate, torch.from_numpy(nbr), torch.from_numpy(pos))
        assert got.dtype == torch.bfloat16 and str(take.dtype) == "bfloat16"
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(take, np.float32))
        assert not got[1].any()


def test_out_of_range_ids_and_positions_read_zero():
    state, nbr, pos = _case(5, 4, 3, np.float64)
    nbr[0, 0], nbr[2, 1], nbr[3, 3] = -1, 7, -5
    pos[0, 1, 2], pos[4, 0, 0], pos[2, 2, 3] = -1, 9, -3
    got = risi18_aligned_t2_reference(*map(torch.from_numpy,
                                           (state, nbr, pos)))
    np.testing.assert_array_equal(got.numpy(), _definition(state, nbr, pos))
    assert not got[0, 0].any() and not got[2, 1].any()


def test_wrapper_on_cpu_is_the_plain_version_without_launch():
    args = tuple(map(torch.from_numpy, _case(6, 4, 8)))
    before = risi18_aligned_t2.launches
    got = risi18_aligned_t2(*args)
    torch.testing.assert_close(got, risi18_aligned_t2_reference(*args),
                               rtol=0, atol=0)
    assert risi18_aligned_t2.launches == before == 0


def test_wrapper_refuses_a_state_that_needs_a_gradient():
    state, nbr, pos = map(torch.from_numpy, _case(4, 3, 2, np.float64))
    leaf = state.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        risi18_aligned_t2(leaf, nbr, pos)
    with torch.no_grad():
        risi18_aligned_t2(leaf, nbr, pos)
    # The plain version is the one training differentiates.
    out = risi18_aligned_t2_reference(leaf, nbr, pos)
    (grad,) = torch.autograd.grad(out.sum(), leaf)
    assert grad.shape == state.shape and grad.sum() == out.detach().ne(
        0).sum()
