"""The level as the CUDA kernels factor it, in plain PyTorch on the CPU:
``risi18_level_factored_reference`` (K1: nine map products, the adjacency
applied once to W) and ``risi18_level_backward_factored_reference`` (K2:
dK and the reductions' cotangents as products with G, G.Ap, G.R and GA)
against the port's plain level and its autograd, and through them against
the JAX package's level (``_reference_level`` and its ``jax.vjp``), in
float64 at 1e-9 and in float32 at the kernels' 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.ops.risi_fused_pallas import _reference_level
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level_backward_factored_reference,
    risi18_level_backward_reference, risi18_level_factored_reference,
    risi18_level_reference)
from graphflow_tpu_torch.utils.datasets import random_level_case

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-9, torch.float32: 1e-4}
KEYS = ("state", "nbr", "pos", "radj", "K", "b")


def _case(name):
    """Seeded inputs (NumPy, float64 and int32) and a cotangent."""
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
    g = np.random.default_rng(seed).normal(size=(V, P * P, Cout))
    return d, g


CASES = ["square", "wider_out", "narrower_out", "one_channel",
         "one_channel_in", "empty_vertex", "negative_adjacency",
         "all_absent"]


def _torch_args(d, dtype):
    return [torch.from_numpy(np.ascontiguousarray(d[k])).to(
        dtype if d[k].dtype.kind == "f" else torch.int32) for k in KEYS]


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    bound = rtol * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= bound


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_factored_forward_matches_plain_level(name, dtype):
    d, _ = _case(name)
    args = _torch_args(d, dtype)
    got = risi18_level_factored_reference(*args)
    assert got.dtype == dtype
    _close(got.numpy(), risi18_level_reference(*args).numpy(), RTOL[dtype])


@pytest.mark.parametrize("name", CASES)
def test_factored_forward_matches_jax_level(name):
    d, _ = _case(name)
    got = risi18_level_factored_reference(*_torch_args(d, torch.float64))
    ref = jax.jit(_reference_level)(*[jnp.asarray(d[k]) for k in KEYS])
    _close(got.numpy(), ref, RTOL[torch.float64])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", CASES)
def test_factored_backward_matches_plain_backward(name, dtype):
    d, g = _case(name)
    args = _torch_args(d, dtype)
    gt = torch.from_numpy(g).to(dtype)
    got = risi18_level_backward_factored_reference(*args, gt)
    ref = risi18_level_backward_reference(*args, gt)
    for x, r, param in zip(got, ref, (args[0], args[4], args[5])):
        assert x.dtype == param.dtype and x.shape == param.shape
        _close(x.numpy(), r.numpy(), RTOL[dtype])


@pytest.mark.parametrize("name", CASES)
def test_factored_backward_matches_jax_vjp(name):
    d, g = _case(name)
    got = risi18_level_backward_factored_reference(
        *_torch_args(d, torch.float64), torch.from_numpy(g))
    nbr, pos, radj = (jnp.asarray(d[k]) for k in ("nbr", "pos", "radj"))

    @jax.jit
    def grads(state, K, b, cotangent):
        def level(state, K, b):
            return _reference_level(state, nbr, pos, radj, K, b)

        return jax.vjp(level, state, K, b)[1](cotangent)

    ref = grads(*(jnp.asarray(d[k]) for k in ("state", "K", "b")),
                jnp.asarray(g))
    for x, r in zip(got, ref):
        _close(x.numpy(), r, RTOL[torch.float64])


def test_factored_forward_in_bfloat16_rounds_once():
    """bfloat16 inputs are summed in float32 and rounded once, as the plain
    level and the kernels do: within a bfloat16 step or two of it."""
    d, _ = _case("square")
    args = _torch_args(d, torch.float32)
    args = [t.bfloat16() if t.is_floating_point() and i != 3 else t
            for i, t in enumerate(args)]
    got = risi18_level_factored_reference(*args)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), risi18_level_reference(*args).float().numpy(),
           1e-2)
