"""The bank as the CUDA kernels factor it, in plain PyTorch on the CPU:
``risi18_bank_factored_reference`` (K4: nine map products, the adjacency
applied once to W) and ``risi18_bank_backward_factored_reference`` (K5:
dK and the reductions' cotangents as products with G, G.Ap, G.R and GA)
against the port's plain bank and its autograd, against the JAX package's
fused bank (``risi18_matmul_fused`` and its ``jax.vjp``) in float64 at
1e-9 and in float32 at the kernels' 1e-4, and against the Pallas kernels
K4 and K5 (``risi18_matmul_pallas``, ``risi18_matmul_pallas_bwd``) in
interpret mode, as tests/test_torch_bank.py runs them.  The slots come out
of the take-gather of a seeded level case, so absent slots are zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphflow_tpu.ops.fused import risi18_matmul_fused as jax_fused
from graphflow_tpu.ops.risi_pallas import (risi18_matmul_pallas,
                                           risi18_matmul_pallas_bwd)
from graphflow_tpu_torch.ops.risi_aligned import risi18_aligned_t2_reference
from graphflow_tpu_torch.ops.risi_bank import (
    risi18_bank_backward_factored_reference, risi18_bank_backward_reference,
    risi18_bank_factored_reference, risi18_bank_reference)
from graphflow_tpu_torch.utils.datasets import random_level_case

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# Against the Pallas kernels in interpret mode (float32 inside, another
# order of sums): the bounds of tests/test_torch_bank.py; bfloat16: one
# rounding of the result to bfloat16 on either side.
RTOL_PALLAS = {"float32": (2e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}

CASES = ["square", "wider_out", "narrower_out", "one_channel",
         "one_channel_in", "empty_vertex", "negative_adjacency",
         "all_absent"]


def _case(name):
    """Seeded slots T [V,P,P,P,C] (the take-gather of a level case, so
    absent slots are zero), adjacency A [V,P,P], K [18C, Cout] and a
    cotangent g [V,P,P,Cout], float64 NumPy."""
    V, P, C, Cout, seed = {"square": (6, 4, 8, 8, 0),
                           "wider_out": (5, 8, 4, 7, 1),
                           "narrower_out": (12, 5, 6, 2, 2),
                           "one_channel": (7, 4, 1, 1, 3),
                           "one_channel_in": (4, 3, 1, 5, 4),
                           "empty_vertex": (8, 4, 3, 4, 5),
                           "negative_adjacency": (6, 4, 4, 4, 6),
                           "all_absent": (3, 3, 2, 2, 7)}[name]
    d = random_level_case(V, P, C, Cout, seed=seed,
                          empty_vertex=2 if name == "empty_vertex" else None)
    if name == "negative_adjacency":
        d["radj"] = -np.abs(d["radj"]) - 0.1
    if name == "all_absent":
        d["nbr"][:] = V
        d["pos"][:] = P
    T = risi18_aligned_t2_reference(
        torch.from_numpy(np.asarray(d["state"], np.float64)),
        torch.from_numpy(np.asarray(d["nbr"], np.int32)),
        torch.from_numpy(np.asarray(d["pos"], np.int32))).numpy()
    g = np.random.default_rng(seed).normal(size=(V, P, P, Cout))
    return (T, np.asarray(d["radj"], np.float64),
            np.asarray(d["K"], np.float64), g)


def _torch(arrays, dtype):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
            for x in arrays]


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    bound = rtol * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= bound


def _jax_bank(T, A, K):
    return jax.vmap(lambda t, a: jax_fused(t, a, K))(T, A)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_factored_bank_matches_plain_bank(name, dtype):
    T, A, K, _ = _torch(_case(name)[:3], dtype) + [None]
    got = risi18_bank_factored_reference(T, A, K)
    assert got.dtype == dtype and got.shape == T.shape[:3] + (K.shape[1],)
    _close(got.numpy(), risi18_bank_reference(T, A, K).numpy(), RTOL[dtype])
    if name == "all_absent":
        assert not got.any()


@pytest.mark.parametrize("name", CASES)
def test_factored_bank_matches_jax_fused(name):
    T, A, K, _ = _case(name)
    got = risi18_bank_factored_reference(*_torch((T, A, K), torch.float64))
    ref = jax.jit(_jax_bank)(jnp.asarray(T), jnp.asarray(A), jnp.asarray(K))
    _close(got.numpy(), ref, RTOL[torch.float64])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_factored_backward_matches_plain_backward(name, dtype):
    T, A, K, g = _torch(_case(name), dtype)
    got = risi18_bank_backward_factored_reference(T, A, K, g)
    ref = risi18_bank_backward_reference(T, A, K, g)
    for x, r, param in zip(got, ref, (T, K)):
        assert x.dtype == param.dtype and x.shape == param.shape
        _close(x.numpy(), r.numpy(), RTOL[dtype])


@pytest.mark.parametrize("name", CASES)
def test_factored_backward_matches_jax_vjp(name):
    T, A, K, g = _case(name)
    got = risi18_bank_backward_factored_reference(
        *_torch((T, A, K, g), torch.float64))

    @jax.jit
    def grads(T, K, cotangent):
        return jax.vjp(lambda t, k: _jax_bank(t, jnp.asarray(A), k), T,
                       K)[1](cotangent)

    ref = grads(jnp.asarray(T), jnp.asarray(K), jnp.asarray(g))
    for x, r in zip(got, ref):
        _close(x.numpy(), r, RTOL[torch.float64])


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
@pytest.mark.parametrize("name", ["square", "wider_out", "empty_vertex"])
def test_factored_bank_matches_pallas_kernel(name, dtype):
    jax_in, (T, A, K, _) = _working(*_case(name), dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = risi18_matmul_pallas(*jax_in[:3])
    got = risi18_bank_factored_reference(T, A, K)
    assert got.dtype == T.dtype and str(ref.dtype) == dtype
    _close(got.double().numpy(), np.asarray(ref, np.float64),
           RTOL_PALLAS[dtype][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["square", "narrower_out",
                                  "negative_adjacency"])
def test_factored_backward_matches_pallas_kernel(name, dtype):
    jax_in, port_in = _working(*_case(name), dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = risi18_matmul_pallas_bwd(*jax_in)
    got = risi18_bank_backward_factored_reference(*port_in)
    for x, r, leaf in zip(got, ref, (port_in[0], port_in[2])):
        assert x.dtype == leaf.dtype and str(r.dtype) == dtype
        _close(x.double().numpy(), np.asarray(r, np.float64),
               RTOL_PALLAS[dtype][1])


def test_factored_bank_in_bfloat16_rounds_once():
    """bfloat16 inputs are summed in float32 and rounded once, as the plain
    bank and the kernels do: within a bfloat16 step or two of it."""
    T, A, K, g = _case("square")
    Tb, Kb, gb = (x.bfloat16() for x in _torch((T, K, g), torch.float32))
    Af = torch.from_numpy(A).float()
    got = risi18_bank_factored_reference(Tb, Af, Kb)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(),
           risi18_bank_reference(Tb, Af, Kb).float().numpy(), 1e-2)
    for x, r in zip(risi18_bank_backward_factored_reference(Tb, Af, Kb, gb),
                    risi18_bank_backward_reference(Tb, Af, Kb, gb)):
        assert x.dtype == torch.bfloat16
        _close(x.float().numpy(), r.float().numpy(), 1e-2)
