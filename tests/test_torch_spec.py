"""The port's case-table engine and the banks held against it
(``ops/contractions.py``: ``_case_table_50``, ``risi_contraction_10/18/50
_spec``, ``risi_contraction_18_batched``; ``ops/fused.py``:
``risi18_matmul_reference``, ``smp2d_layer_fused``) against the JAX package
on the CPU at float64.

The engine's tables equal JAX's entry by entry; the three spec banks, the
unfused reference and the fused layer equal the JAX functions (vmapped over
a batch) in values and gradients, to 1e-12 * max(1, scale).  The port's
production banks (``risi_contraction_10/18/50``) and
``risi18_matmul_fused`` are held against the port's spec engine the way
``tests/test_contractions.py:88, 219`` hold the JAX ones.  The adjacency
has negative entries, so the 18-case guard matters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.ops import contractions as jc
from graphflow_tpu.ops import fused as jfused
from graphflow_tpu_torch import ops
from graphflow_tpu_torch.ops import contractions as tc
from graphflow_tpu_torch.ops import fused as tfused

torch.set_num_threads(1)

RTOL = 1e-12
SHAPES = [(2, 3, 2), (3, 4, 3), (2, 5, 1)]          # (B, N, C)


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _inputs(B, N, C, seed=0):
    """T [B,N,N,N,C], A [B,N,N] with entries of both signs, K [18C, C+1],
    b [C+1], float64."""
    rng = np.random.default_rng(seed + 100 * N + C)
    T = rng.normal(size=(B, N, N, N, C))
    A = rng.normal(size=(B, N, N))
    K = rng.normal(size=(18 * C, C + 1)) * 0.3
    b = rng.normal(size=(C + 1,))
    assert (A < 0).any() and (A > 0).any()
    return T, A, K, b


def _vs_jax(tfn, jfn, args, seed):
    """Values and the vjp of every argument: the port's batched function
    against the JAX one vmapped over the batch."""
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*leaves)
    _close(tout, jout)
    cot = np.random.default_rng(seed).normal(size=jout.shape)
    for tg, jg in zip(torch.autograd.grad(tout, leaves, torch.from_numpy(cot)),
                      vjp(jnp.asarray(cot))):
        _close(tg, jg)


def test_case_tables_equal_jax():
    assert tc._PAIRS == jc._PAIRS
    assert tc._case_table_50() == jc._case_table_50() == tc._TABLE_50
    assert len(tc._TABLE_50) == tc.nContractions_50
    for got, ref in zip(tc._case_table_50(), jc._case_table_50()):
        assert got == ref
    assert tc._SUBSET_18 == jc._SUBSET_18
    assert len(tc._SUBSET_18) == tc.nContractions_18
    assert (tc.nContractions_4, tc.nContractions_10, tc.nContractions_18,
            tc.nContractions_50) == (jc.nContractions_4, jc.nContractions_10,
                                     jc.nContractions_18, jc.nContractions_50)


@pytest.mark.parametrize("case", range(1, 51))
def test_each_case_einsum_matches_jax(case):
    T, A, _, _ = _inputs(1, 4, 2, seed=case)
    fixed, tie = tc._TABLE_50[case - 1]
    got = tc._case_einsum(torch.from_numpy(T[0]), torch.from_numpy(A[0]),
                          fixed, tie)
    _close(got, jc._case_einsum(jnp.asarray(T[0]), jnp.asarray(A[0]), fixed,
                                tie))


SPECS = {10: (tc.risi_contraction_10_spec, jc.risi_contraction_10_spec),
         18: (tc.risi_contraction_18_spec, jc.risi_contraction_18_spec),
         50: (tc.risi_contraction_50_spec, jc.risi_contraction_50_spec)}


@pytest.mark.parametrize("B,N,C", SHAPES)
@pytest.mark.parametrize("k", sorted(SPECS))
def test_spec_bank_matches_jax(k, B, N, C):
    T, A, _, _ = _inputs(B, N, C)
    tfn, jfn = SPECS[k]
    out = tfn(torch.from_numpy(T), torch.from_numpy(A))
    assert out.shape == (B, N, N, k * C)
    _vs_jax(tfn, jax.vmap(jfn), (T, A), seed=k)


PRODUCTION = {10: tc.risi_contraction_10, 18: tc.risi_contraction_18,
              50: tc.risi_contraction_50}


@pytest.mark.parametrize("B,N,C", SHAPES)
@pytest.mark.parametrize("k", sorted(PRODUCTION))
def test_production_bank_matches_the_spec_engine(k, B, N, C):
    T, A, _, _ = map(torch.from_numpy, _inputs(B, N, C, seed=1))
    _close(PRODUCTION[k](T, A), SPECS[k][0](T, A))


def test_spec_18_applies_the_positivity_guard_and_10_50_do_not():
    T, A, _, _ = map(torch.from_numpy, _inputs(2, 4, 2, seed=2))
    Ap = torch.where(A > 0, A, torch.zeros_like(A))
    _close(tc.risi_contraction_18_spec(T, A), tc._contract_cases(
        T, Ap, tc._SUBSET_18))
    assert not torch.allclose(tc._contract_cases(T, A, tc._SUBSET_18),
                              tc.risi_contraction_18_spec(T, A))
    _close(tc.risi_contraction_50_spec(T, A),
           tc._contract_cases(T, A, range(1, 51)))
    assert not torch.allclose(tc.risi_contraction_10_spec(T, Ap),
                              tc.risi_contraction_10_spec(T, A))


def test_spec_takes_any_leading_dimensions():
    T, A, _, _ = map(torch.from_numpy, _inputs(6, 3, 2, seed=3))
    T2, A2 = T.reshape(2, 3, 3, 3, 3, 2), A.reshape(2, 3, 3, 3)
    for k, (fn, _) in SPECS.items():
        _close(fn(T2, A2), fn(T, A).reshape(2, 3, 3, 3, k * 2))
        _close(fn(T[4], A[4]), fn(T, A)[4])


@pytest.mark.parametrize("B,N,C", SHAPES)
def test_risi18_matmul_reference_matches_jax(B, N, C):
    T, A, K, _ = _inputs(B, N, C, seed=4)
    _vs_jax(tfused.risi18_matmul_reference,
            jax.vmap(jfused.risi18_matmul_reference, in_axes=(0, 0, None)),
            (T, A, K), seed=N)


@pytest.mark.parametrize("B,N,C", SHAPES)
def test_fused_bank_matches_the_unfused_reference(B, N, C):
    """``tests/test_contractions.py:219`` for the port: the production fused
    product against the spec bank times K."""
    T, A, K, _ = map(torch.from_numpy, _inputs(B, N, C, seed=5))
    _close(tfused.risi18_matmul_fused(T, A, K),
           tfused.risi18_matmul_reference(T, A, K))


@pytest.mark.parametrize("B,N,C,alpha", [s + (a,) for s, a in
                                          zip(SHAPES, (0.01, 0.2, 0.01))])
def test_smp2d_layer_fused_matches_jax(B, N, C, alpha):
    T, A, K, b = _inputs(B, N, C, seed=6)
    _vs_jax(lambda T, A, K, b: tfused.smp2d_layer_fused(T, A, K, b, alpha),
            jax.vmap(lambda T, A, K, b: jfused.smp2d_layer_fused(
                T, A, K, b, alpha), in_axes=(0, 0, None, None)),
            (T, A, K, b), seed=C)


def test_risi_contraction_18_batched_matches_a_loop_and_jax():
    T, A, _, _ = _inputs(3, 4, 2, seed=7)
    got = ops.risi_contraction_18_batched(torch.from_numpy(T),
                                          torch.from_numpy(A))
    loop = torch.stack([tc.risi_contraction_18(torch.from_numpy(T[i]),
                                               torch.from_numpy(A[i]))
                        for i in range(3)])
    assert torch.equal(got, loop)
    _vs_jax(tc.risi_contraction_18_batched, jc.risi_contraction_18_batched,
            (T, A), seed=8)


@pytest.mark.parametrize("t_shape,a_shape", [((4, 4, 4, 2), (4, 4)),
                                             ((1, 2, 4, 4, 4, 2),
                                              (1, 2, 4, 4)),
                                             ((2, 4, 4, 4, 2), (4, 4))])
def test_risi_contraction_18_batched_needs_one_batch_dimension(t_shape,
                                                               a_shape):
    with pytest.raises(ValueError, match="B, N, N, N, C"):
        tc.risi_contraction_18_batched(torch.zeros(t_shape),
                                       torch.zeros(a_shape))
