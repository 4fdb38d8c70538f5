"""The port's level pieces against the JAX package: the 18-case bank, the
low-rank fused product, the gather, and the plain level (float64, rtol
1e-10), plus one float32 case against the Pallas kernel K1 itself, run in
interpret mode as tests/test_fused_kernel.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models.smp2d import (
    _gather_neighbor_tensors_take as jax_gather)
from graphflow_tpu.ops.contractions import risi_contraction_18 as jax_risi18
from graphflow_tpu.ops.fused import risi18_matmul_fused as jax_fused
from graphflow_tpu.ops.risi_fused_pallas import (
    _reference_level, build_xsel, pack_state_cm, risi18_level_fused_raw,
    risi18_level_fused_v3_raw)
from graphflow_tpu_torch.ops.risi_aligned import _gather_neighbor_tensors_take
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import risi_contraction_18
from graphflow_tpu_torch.ops.fused import risi18_matmul_fused
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level, risi18_level_reference)
from graphflow_tpu_torch.utils.datasets import random_level_case

torch.set_num_threads(1)

RTOL64 = 1e-10


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bank_inputs(shape_T, shape_A, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape_T), rng.normal(size=shape_A)  # mixed sign


@pytest.mark.parametrize("P,C", [(3, 2), (4, 5), (6, 3)])
def test_risi_contraction_18_matches_jax(P, C):
    T, A = _bank_inputs((P, P, P, C), (P, P), seed=P * C)
    _close(risi_contraction_18(_t(T), _t(A)).numpy(),
           jax_risi18(jnp.asarray(T), jnp.asarray(A)), RTOL64)


def test_risi_contraction_18_batch_dims_match_vmap():
    T, A = _bank_inputs((2, 3, 4, 4, 4, 3), (2, 3, 4, 4), seed=1)
    ref = jax.vmap(jax.vmap(jax_risi18))(jnp.asarray(T), jnp.asarray(A))
    _close(risi_contraction_18(_t(T), _t(A)).numpy(), ref, RTOL64)


def test_risi_contraction_18_cases_are_distinct():
    """Each of the 18 slabs differs from every other (case order matters
    for K's row blocks case*C + f)."""
    T, A = _bank_inputs((4, 4, 4, 1), (4, 4), seed=2)
    Y = risi_contraction_18(_t(T), _t(np.abs(A))).numpy()
    for i in range(18):
        for j in range(i + 1, 18):
            assert not np.allclose(Y[..., i], Y[..., j]), (i + 1, j + 1)


@pytest.mark.parametrize("P,C,Cout", [(3, 2, 4), (5, 4, 3)])
def test_risi18_matmul_fused_matches_jax_and_bank(P, C, Cout):
    T, A = _bank_inputs((P, P, P, C), (P, P), seed=P + C)
    K = np.random.default_rng(3).normal(size=(18 * C, Cout))
    got = risi18_matmul_fused(_t(T), _t(A), _t(K)).numpy()
    _close(got, jax_fused(jnp.asarray(T), jnp.asarray(A), jnp.asarray(K)),
           RTOL64)
    bank = risi_contraction_18(_t(T), _t(A)).reshape(P * P, 18 * C) @ _t(K)
    _close(got, bank.reshape(P, P, Cout).numpy(), RTOL64)


def test_gather_matches_jax_take():
    d = random_level_case(6, 4, 3, 2, seed=4, empty_vertex=1)
    state_pad = np.pad(d["state"], ((0, 0), (0, 1), (0, 1), (0, 0)))
    got = _gather_neighbor_tensors_take(_t(state_pad), _t(d["nbr"]),
                                        _t(d["pos"])).numpy()
    ref = np.asarray(jax_gather(jnp.asarray(state_pad), jnp.asarray(d["nbr"]),
                                jnp.asarray(d["pos"])))
    np.testing.assert_array_equal(got, ref)        # pure selection
    assert not got[1].any()                         # all-absent vertex


def _level_args(d, to):
    return [to(d[k]) for k in ("state", "nbr", "pos", "radj", "K", "b")]


@pytest.mark.parametrize("V,P,C,Cout", [(6, 4, 8, 8), (5, 8, 8, 16),
                                        (4, 4, 16, 8)])
def test_level_reference_matches_jax(V, P, C, Cout):
    """The grid of tests/test_fused_kernel.py:40-50, at float64."""
    d = random_level_case(V, P, C, Cout, seed=0)
    _close(risi18_level_reference(*_level_args(d, _t)).numpy(),
           _reference_level(*_level_args(d, jnp.asarray)), RTOL64)


def test_level_reference_negative_adjacency_matches_jax():
    """All-negative adjacency zeroes every adjacency-weighted case
    (test_fused_kernel.py:53-62)."""
    d = random_level_case(5, 4, 8, 8, seed=3)
    d["radj"] = -np.abs(d["radj"]) - 0.1
    got = risi18_level_reference(*_level_args(d, _t)).numpy()
    _close(got, _reference_level(*_level_args(d, jnp.asarray)), RTOL64)
    # Every case carries a factor of Ap, R, S or trA: only b remains.
    np.testing.assert_allclose(
        got, np.broadcast_to(leaky_relu(_t(d["b"])).numpy(), got.shape))


def test_level_reference_all_absent_vertex_is_bias_only():
    """A vertex with an empty receptive field gives bias-only rows
    (test_fused_kernel.py:65-75)."""
    d = random_level_case(4, 4, 8, 8, seed=5, empty_vertex=2)
    got = risi18_level_reference(*_level_args(d, _t)).numpy()
    _close(got, _reference_level(*_level_args(d, jnp.asarray)), RTOL64)
    np.testing.assert_array_equal(
        got[2], np.broadcast_to(leaky_relu(_t(d["b"])).numpy(), (16, 8)))


@pytest.mark.parametrize("ver,P", [("v3", 8), ("v2", 4)])
def test_level_reference_matches_pallas_kernel_f32(ver, P):
    """float32, against the Pallas kernels themselves (interpret mode):
    K1 (_kernel_v3) at P=8 and K3 (_kernel) at P=4."""
    d = random_level_case(5, P, 8, 16, seed=9, empty_vertex=3)
    f32 = {k: d[k].astype(np.float32) for k in ("state", "radj", "K", "b")}
    raw = {"v3": risi18_level_fused_v3_raw, "v2": risi18_level_fused_raw}[ver]
    ref = np.asarray(raw(pack_state_cm(jnp.asarray(f32["state"])),
                         jnp.asarray(d["nbr"]), build_xsel(jnp.asarray(d["pos"])),
                         jnp.asarray(f32["radj"]), jnp.asarray(f32["K"]),
                         jnp.asarray(f32["b"]), interpret=True))
    got = risi18_level_reference(
        _t(f32["state"]), _t(d["nbr"]), _t(d["pos"]), _t(f32["radj"]),
        _t(f32["K"]), _t(f32["b"])).numpy()
    assert got.dtype == np.float32
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() < 1e-4 * scale


def test_level_wrapper_on_cpu_runs_plain_version_without_launch():
    d = random_level_case(4, 4, 4, 4, seed=6)
    before = risi18_level.launches
    got = risi18_level(*_level_args(d, _t))
    assert risi18_level.launches == before == 0
    np.testing.assert_array_equal(
        got.numpy(), risi18_level_reference(*_level_args(d, _t)).numpy())


def test_level_wrapper_rejects_other_devices():
    d = random_level_case(2, 2, 2, 2, seed=7)
    args = [t.to("meta") for t in _level_args(d, _t)]
    with pytest.raises(ValueError):
        risi18_level(*args)
