"""The port's 4-, 10- and 50-case banks and the fused 10- and 50-case banks
with K (``ops/contractions.py``) against the JAX package at float64: the
JAX functions, the JAX case-table engine (``_spec``) and, for the fused
forms, the bank followed by the product with K.  The adjacency has
negative entries: the 10- and 50-case banks apply no positivity guard.
In bfloat16 the same functions are held against the JAX ones on the same
bfloat16 values, and against float64 arithmetic on those values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.ops import contractions as jc
from graphflow_tpu_torch.ops.contractions import (
    risi_contraction_4, risi_contraction_10, risi_contraction_10_matmul,
    risi_contraction_50, risi_contraction_50_matmul)

torch.set_num_threads(1)

RTOL = 1e-10
SHAPES = [(2, 3, 2), (3, 4, 3), (2, 5, 4)]          # (V, N, C)
BANKS = {10: (risi_contraction_10, jc.risi_contraction_10,
              jc.risi_contraction_10_spec),
         50: (risi_contraction_50, jc.risi_contraction_50,
              jc.risi_contraction_50_spec)}
FUSED = {10: (risi_contraction_10_matmul, jc.risi_contraction_10_matmul),
         50: (risi_contraction_50_matmul, jc.risi_contraction_50_matmul)}


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


def _inputs(V, N, C, k=10, seed=0):
    """T [V,N,N,N,C], A [V,N,N] with about half its entries negative, and
    K [kC, Cout], float64."""
    rng = np.random.default_rng(seed + 10 * N + C)
    T = rng.normal(size=(V, N, N, N, C))
    A = rng.normal(size=(V, N, N))
    K = rng.normal(size=(k * C, C + 1)) * 0.3
    assert (A < 0).any() and (A > 0).any()
    return T, A, K


def _jax_vmap(fn, *args):
    return jax.vmap(fn)(*map(jnp.asarray, args))


@pytest.mark.parametrize("V,N,C", SHAPES)
def test_contraction_4_matches_jax(V, N, C):
    T, _, _ = _inputs(V, N, C)
    got = risi_contraction_4(torch.from_numpy(T))
    assert got.shape == (V, N, N, 4 * C)
    _close(got, _jax_vmap(jc.risi_contraction_4, T))


@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("V,N,C", SHAPES)
def test_bank_matches_jax_and_spec(V, N, C, k):
    port, jax_fn, spec = BANKS[k]
    T, A, _ = _inputs(V, N, C, k)
    got = port(torch.from_numpy(T), torch.from_numpy(A))
    assert got.shape == (V, N, N, k * C) and got.dtype == torch.float64
    _close(got, _jax_vmap(jax_fn, T, A))
    _close(got, _jax_vmap(spec, T, A))


@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("V,N,C", SHAPES)
def test_fused_bank_matches_jax_and_bank_times_k(V, N, C, k):
    port_fused, jax_fused = FUSED[k]
    T, A, K = _inputs(V, N, C, k)
    t, a, kk = map(torch.from_numpy, (T, A, K))
    got = port_fused(t, a, kk)
    assert got.shape == (V, N, N, K.shape[1])
    _close(got, jax_fused(*map(jnp.asarray, (T, A, K))))
    bank = BANKS[k][0](t, a)
    _close(got, (bank.reshape(V, N, N, k * C) @ kk).numpy())


@pytest.mark.parametrize("k", [10, 50])
def test_no_positivity_guard(k):
    """Clipping A's negative entries changes the 10- and 50-case banks."""
    T, A, K = _inputs(2, 4, 3, k, seed=5)
    t, a, kk = map(torch.from_numpy, (T, A, K))
    clipped = a.clamp(min=0)
    assert (BANKS[k][0](t, a) - BANKS[k][0](t, clipped)).abs().max() > 1e-3
    assert (FUSED[k][0](t, a, kk)
            - FUSED[k][0](t, clipped, kk)).abs().max() > 1e-3


@pytest.mark.parametrize("k", [4, 10, 50])
def test_leading_batch_dimensions(k):
    """Two leading dimensions equal the banks taken one batch row at a
    time."""
    rng = np.random.default_rng(k)
    T = torch.from_numpy(rng.normal(size=(2, 3, 4, 4, 4, 2)))
    A = torch.from_numpy(rng.normal(size=(2, 3, 4, 4)))
    K = torch.from_numpy(rng.normal(size=(k * 2, 3)))
    if k == 4:
        got = risi_contraction_4(T)
        rows = [risi_contraction_4(T[i]) for i in range(2)]
    else:
        got = FUSED[k][0](T, A, K)
        rows = [FUSED[k][0](T[i], A[i], K) for i in range(2)]
    _close(got, torch.stack(rows).numpy())


@pytest.mark.parametrize("k", [10, 50])
def test_fused_bank_gradients_match_jax(k):
    """Gradients of the fused bank for T and K, by torch autograd and by
    jax.vjp of the JAX fused bank."""
    T, A, K = _inputs(2, 4, 3, k, seed=2)
    g = np.random.default_rng(3).normal(size=(2, 4, 4, K.shape[1]))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (T, K)]
    out = FUSED[k][0](leaves[0], torch.from_numpy(A), leaves[1])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda t, kk: FUSED[k][1](t, jnp.asarray(A), kk),
                     jnp.asarray(T), jnp.asarray(K))
    for x, r in zip(got, vjp(jnp.asarray(g))):
        _close(x, r)


# -- bfloat16 ---------------------------------------------------------------

BF16 = torch.bfloat16
# Both packages accumulate in float32 and round where a result is stored;
# the orders of the sums and the places of the roundings differ by a few
# bfloat16 steps (2^-8 relative each).  The bound is the bfloat16 bound of
# tests/test_fused_kernel.py:133-134.
RTOL_BF16 = 3e-2
SHAPES_BF16 = [(2, 3, 2), (2, 4, 8), (2, 8, 4)]


def _bf16_inputs(V, N, C, k, seed=0):
    """The inputs of :func:`_inputs` rounded to bfloat16, for each package,
    and the rounded values in float64."""
    T, A, K = _inputs(V, N, C, k, seed)
    port = [torch.from_numpy(x.astype(np.float32)).to(BF16)
            for x in (T, A, K)]
    jx = [jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
          for x in (T, A, K)]
    return port, jx, [x.double() for x in port]


def _close_bf16(got, ref):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    ref = ref.detach().double().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL_BF16,
                               atol=RTOL_BF16 * scale)


@pytest.mark.parametrize("V,N,C", SHAPES_BF16)
def test_contraction_4_bfloat16_matches_jax(V, N, C):
    (T, _, _), (jT, _, _), (T64, _, _) = _bf16_inputs(V, N, C, 4)
    got = risi_contraction_4(T)
    assert got.dtype == BF16 and got.shape == (V, N, N, 4 * C)
    ref = jax.jit(jax.vmap(jc.risi_contraction_4))(jT)
    assert str(ref.dtype) == "bfloat16"
    _close_bf16(got, ref)
    _close_bf16(got, risi_contraction_4(T64))


@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("V,N,C", SHAPES_BF16)
def test_bank_bfloat16_matches_jax(V, N, C, k):
    (T, A, _), (jT, jA, _), (T64, A64, _) = _bf16_inputs(V, N, C, k)
    got = BANKS[k][0](T, A)
    assert got.dtype == BF16 and got.shape == (V, N, N, k * C)
    if k == 50 and N > 3:
        # XLA's CPU runtime has no bfloat16 x bfloat16 -> float32 dot for
        # the 50-case bank's einsums beyond the smallest shape; there the
        # JAX function runs in float32 on the same values.
        ref = jax.jit(jax.vmap(BANKS[k][1]))(jT.astype(jnp.float32),
                                             jA.astype(jnp.float32))
    else:
        ref = jax.jit(jax.vmap(BANKS[k][1]))(jT, jA)
        assert str(ref.dtype) == "bfloat16"
    _close_bf16(got, ref)
    _close_bf16(got, BANKS[k][0](T64, A64))


@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("V,N,C", SHAPES_BF16)
def test_fused_bank_bfloat16_matches_jax(V, N, C, k):
    """The fused forms keep K, the adjacency and the running sum in
    float32 and round the result once, in both packages."""
    (T, A, K), (jT, jA, jK), (T64, A64, K64) = _bf16_inputs(V, N, C, k)
    got = FUSED[k][0](T, A, K)
    assert got.dtype == BF16 and got.shape == (V, N, N, K.shape[1])
    ref = jax.jit(FUSED[k][1])(jT, jA, jK)
    assert str(ref.dtype) == "bfloat16"
    _close_bf16(got, ref)
    _close_bf16(got, FUSED[k][0](T64, A64, K64))


@pytest.mark.parametrize("k", [10, 50])
def test_fused_bank_bfloat16_gradients(k):
    """Gradients for T and K come back in bfloat16 and follow float64
    autograd on the same values."""
    (T, A, K), _, (T64, A64, K64) = _bf16_inputs(2, 4, 3, k, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 4, 4, K.shape[1])))
    leaves = [x.clone().requires_grad_() for x in (T, K)]
    got = torch.autograd.grad(FUSED[k][0](leaves[0], A, leaves[1]), leaves,
                              g.to(BF16))
    leaves64 = [x.clone().requires_grad_() for x in (T64, K64)]
    ref = torch.autograd.grad(FUSED[k][0](leaves64[0], A64, leaves64[1]),
                              leaves64, g.to(BF16).double())
    for x, r in zip(got, ref):
        assert x.dtype == BF16
        _close_bf16(x, r)


@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("V,N,C", [(2, 4, 8), (2, 8, 4), (3, 8, 12)])
def test_fused_bank_bfloat16_rounds_where_jax_does(V, N, C, k, monkeypatch):
    """Every intermediate of the fused forms that the JAX package keeps in
    float32 stays float32 here (the weighted index sums of T among them,
    also across the pieces T is cast up in: two batch rows at a time
    here): the one rounding, at the end, then falls on float32 sums that
    differ only in their order, so all but a stray element (1 %; one extra
    rounding on the way moves 14-20 %) equal the JAX result bit for bit,
    and none is more than one bfloat16 step (2^-7 relative) away."""
    from graphflow_tpu_torch.ops import contractions
    monkeypatch.setattr(contractions, "_CAST_ELEMENTS", 2 * N ** 3 * C)
    (T, A, K), (jT, jA, jK), _ = _bf16_inputs(V, N, C, k)
    got = FUSED[k][0](T, A, K).double().numpy()
    ref = np.asarray(jax.jit(FUSED[k][1])(jT, jA, jK).astype(jnp.float32),
                     np.float64)
    differ = got != ref
    assert differ.mean() <= 0.01
    assert (np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref)).all()
