"""The port's bank (``ops/risi_bank.py``) against the JAX package: the plain
version and its backward against the JAX fused reference at float64, and
against the Pallas kernels K4 (``risi18_matmul_pallas``) and K5
(``risi18_matmul_pallas_bwd``) themselves, run in interpret mode as
tests/test_fused.py runs them, in float32 and bfloat16.  On the CPU the
wrappers run the plain versions and launch nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphflow_tpu.ops.fused import risi18_matmul_fused as jax_fused
from graphflow_tpu.ops.risi_pallas import (risi18_matmul_pallas,
                                           risi18_matmul_pallas_bwd)
from graphflow_tpu_torch.ops.risi_bank import (
    risi18_bank, risi18_bank_backward, risi18_bank_backward_reference,
    risi18_bank_reference)

torch.set_num_threads(1)

# float64 against float64.
RTOL64 = 1e-10
# Plain bank (float32 inside) against the Pallas kernel in interpret mode
# (float32 inside, another summation order): the bounds of
# tests/test_fused.py:79 (forward) and :119-123 (backward).
RTOL_FWD32, RTOL_BWD32 = 2e-4, 1e-4
# bfloat16: both sides compute in float32 from the same bfloat16 inputs and
# round the result to bfloat16 once (2^-8 relative); 1e-2 of the scale.
RTOL16 = 1e-2


def _scaled_close(got, ref, rtol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _f(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float64).numpy()


def _inputs(N, P, C, Cout, seed, negative=True):
    """Seeded T [N,P,P,P,C] (vertex 1 all zero, as an empty vertex's slots
    come out of the take-gather), A [N,P,P] (half negative when
    ``negative``, so the adj>0 guard matters), K [18C, Cout] and a
    cotangent g [N,P,P,Cout], float64 NumPy."""
    rng = np.random.default_rng(seed)
    T = rng.normal(size=(N, P, P, P, C))
    T[1] = 0.0
    A = np.abs(rng.normal(size=(N, P, P)))
    if negative:
        A -= np.median(A)
    K = rng.normal(size=(18 * C, Cout)) * 0.1
    g = rng.normal(size=(N, P, P, Cout))
    return T, A, K, g


def _jax_bank64(T, A, K):
    return jax.vmap(lambda t, a: jax_fused(t, a, jnp.asarray(K)))(
        jnp.asarray(T), jnp.asarray(A))


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("N,P,C,Cout", [(3, 4, 3, 5), (2, 6, 2, 3),
                                        (4, 8, 4, 4)])
def test_plain_bank_matches_jax_fused_float64(N, P, C, Cout, negative):
    T, A, K, _ = _inputs(N, P, C, Cout, seed=N * P + C, negative=negative)
    got = risi18_bank_reference(*map(torch.from_numpy, (T, A, K)))
    assert got.dtype == torch.float64 and got.shape == (N, P, P, Cout)
    _scaled_close(got.numpy(), _jax_bank64(T, A, K), RTOL64)
    assert not got[1].any()


@pytest.mark.parametrize("N,P,C,Cout", [(3, 4, 3, 5), (4, 8, 4, 4)])
def test_plain_backward_matches_jax_vjp_float64(N, P, C, Cout):
    T, A, K, g = _inputs(N, P, C, Cout, seed=P + C)
    _, vjp = jax.vjp(lambda t, k: _jax_bank64(t, A, k), jnp.asarray(T),
                     jnp.asarray(K))
    ref = vjp(jnp.asarray(g))
    got = risi18_bank_backward_reference(*map(torch.from_numpy, (T, A, K, g)))
    for x, r in zip(got, ref):
        assert x.dtype == torch.float64
        _scaled_close(x.numpy(), r, RTOL64)


def _working(T, A, K, g, dtype):
    """The inputs in the working dtype for both packages: identical values
    (bfloat16 rounded once, by JAX), A in float32."""
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jax_in = (jnp.asarray(T, jt), jnp.asarray(A, jnp.float32),
              jnp.asarray(K, jt), jnp.asarray(g, jt))
    tt = getattr(torch, dtype)
    port_in = tuple(torch.from_numpy(np.array(x, np.float32)).to(
        torch.float32 if i == 1 else tt) for i, x in enumerate(jax_in))
    return jax_in, port_in


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [4, 8])
def test_plain_bank_matches_pallas_kernel(P, dtype):
    jax_in, (T, A, K, _) = _working(*_inputs(2, P, 4, 6, seed=P), dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = risi18_matmul_pallas(*jax_in[:3])
    got = risi18_bank_reference(T, A, K)
    assert got.dtype == T.dtype and str(ref.dtype) == dtype
    ref = np.asarray(ref, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(_f(got), ref, rtol=RTOL_FWD32,
                                   atol=RTOL_FWD32)
    else:
        _scaled_close(_f(got), ref, RTOL16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [4, 8])
def test_plain_backward_matches_pallas_kernel(P, dtype):
    jax_in, port_in = _working(*_inputs(2, P, 4, 6, seed=P + 1), dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = risi18_matmul_pallas_bwd(*jax_in)
    got = risi18_bank_backward_reference(*port_in)
    for x, r, leaf in zip(got, ref, (port_in[0], port_in[2])):
        assert x.dtype == leaf.dtype and str(r.dtype) == dtype
        r = np.asarray(r, np.float64)
        if dtype == "float32":
            np.testing.assert_allclose(_f(x), r, rtol=RTOL_BWD32,
                                       atol=RTOL_BWD32)
        else:
            _scaled_close(_f(x), r, RTOL16)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_autograd_through_the_wrapper_equals_backward_reference(dtype):
    """On CPU tensors the wrapper is the plain version under torch
    autograd; its gradients are those of the plain backward, bit for bit,
    and no kernel is launched."""
    T, A, K, g = (torch.from_numpy(x) for x in _inputs(3, 4, 3, 5, seed=7))
    T, K, g = T.to(dtype), K.to(dtype), g.to(dtype)
    A = A.to(torch.float32 if dtype != torch.float64 else dtype)
    counts = (risi18_bank.launches, risi18_bank_backward.launches,
              risi18_bank_backward.reduce_launches)
    leaves = [x.clone().requires_grad_() for x in (T, K)]
    out = risi18_bank(leaves[0], A, leaves[1])
    assert out.dtype == dtype
    got = torch.autograd.grad(out, leaves, g)
    wrapped = risi18_bank_backward(T, A, K, g)
    for x, y, r in zip(got, wrapped, risi18_bank_backward_reference(T, A, K,
                                                                   g)):
        assert x.dtype == dtype
        torch.testing.assert_close(x, r, rtol=0, atol=0)
        torch.testing.assert_close(y, r, rtol=0, atol=0)
    torch.testing.assert_close(out.detach(), risi18_bank_reference(T, A, K),
                               rtol=0, atol=0)
    assert (risi18_bank.launches, risi18_bank_backward.launches,
            risi18_bank_backward.reduce_launches) == counts == (0, 0, 0)


def test_bfloat16_bank_computes_in_float32():
    """The plain bfloat16 bank is the float32 bank of the same values,
    rounded once."""
    T, A, K, _ = (torch.from_numpy(x) for x in _inputs(2, 4, 3, 4, seed=2))
    Tb, Kb = T.to(torch.bfloat16), K.to(torch.bfloat16)
    got = risi18_bank_reference(Tb, A.float(), Kb)
    ref = risi18_bank_reference(Tb.float(), A.float(), Kb.float())
    torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)


def test_unsupported_dtype_raises():
    T, A, K, g = (torch.from_numpy(x) for x in _inputs(2, 4, 3, 4, seed=3))
    with pytest.raises(TypeError, match="dtype"):
        risi18_bank(T.half(), A, K.half())
    with pytest.raises(TypeError, match="dtype"):
        risi18_bank_backward(T.half(), A, K.half(), g.half())
