"""The port's level pieces against the JAX package: the 18-case bank, the
low-rank fused product, the gather, and the plain level (float64, rtol
1e-10), plus float32 and bfloat16 cases against the Pallas kernels K1 and
K3 themselves and the bfloat16 backward against the Pallas training path
(K2), run in interpret mode as tests/test_fused_kernel.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models.smp2d import (
    _gather_neighbor_tensors_take as jax_gather)
from graphflow_tpu.ops.contractions import risi_contraction_18 as jax_risi18
from graphflow_tpu.ops.fused import risi18_matmul_fused as jax_fused
from jax.experimental.pallas import tpu as pltpu

from graphflow_tpu.ops.risi_fused_pallas import (
    _reference_level, build_xsel, pack_state_cm, risi18_level_fused_raw,
    risi18_level_fused_v3_raw, risi18_level_train)
from graphflow_tpu_torch.ops.risi_aligned import _gather_neighbor_tensors_take
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import risi_contraction_18
from graphflow_tpu_torch.ops.fused import risi18_matmul_fused
from graphflow_tpu_torch.ops.risi_level import (
    risi18_level, risi18_level_backward, risi18_level_backward_reference,
    risi18_level_reference)
from graphflow_tpu_torch.utils.datasets import random_level_case

torch.set_num_threads(1)

RTOL64 = 1e-10
BF16 = torch.bfloat16
# bfloat16 keeps 8 significant bits: neighbouring values at the output's
# scale lie up to 2^-7 of it apart.  The port's plain level and the Pallas
# kernels both sum in float32 (in another order) and round once, so they
# differ by a step or two where a sum lands near a rounding boundary.
RTOL_BF16 = 2 * 2.0 ** -7
# The bound of tests/test_fused_kernel.py:133-134 and :161 for a bfloat16
# result held against float32 arithmetic.
RTOL_BF16_VS_F32 = 3e-2


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


def _t16(a):
    return _t(np.asarray(a, np.float32)).to(BF16)


def _j16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def _bf16_case(V, P, C, Cout, seed):
    """One level's inputs for each package: state, K and b the same
    bfloat16 values, radj float32, and a bfloat16 cotangent."""
    d = random_level_case(V, P, C, Cout, seed=seed, empty_vertex=2)
    g = np.random.default_rng(seed).normal(size=(V, P * P, Cout))
    radj = d["radj"].astype(np.float32)
    port = (_t16(d["state"]), _t(d["nbr"]), _t(d["pos"]), _t(radj),
            _t16(d["K"]), _t16(d["b"]))
    jx = (_j16(d["state"]), jnp.asarray(d["nbr"]), jnp.asarray(d["pos"]),
          jnp.asarray(radj), _j16(d["K"]), _j16(d["b"]))
    return port, jx, _t16(g), _j16(g)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("ver,V,P,C,Cout", [("v3", 6, 16, 8, 8),
                                            ("v2", 5, 4, 8, 16),
                                            ("v2", 5, 8, 8, 8)])
def test_level_bfloat16_matches_pallas_kernel(ver, V, P, C, Cout):
    """bfloat16 state, K and b, float32 adjacency: the port's level (on the
    CPU its plain version: float32 inside, one rounding) against K1
    (_kernel_v3) at P=16, as tests/test_fused_kernel.py:123-134 runs it, and
    against K3 (_kernel) at P=4 and 8."""
    port, (state, nbr, pos, radj, K, b), _, _ = _bf16_case(V, P, C, Cout, 13)
    raw = {"v3": risi18_level_fused_v3_raw, "v2": risi18_level_fused_raw}[ver]
    ref = raw(pack_state_cm(state), nbr, build_xsel(pos, jnp.bfloat16), radj,
              K, b, interpret=True)
    got = risi18_level(*port)
    assert got.dtype == BF16 and str(ref.dtype) == "bfloat16"
    _close(_f32(got), _f32(ref), RTOL_BF16)
    # Bias-only rows of the vertex whose slots are all absent, exactly.
    np.testing.assert_array_equal(
        _f32(got[2]), np.broadcast_to(_f32(leaky_relu(port[5])),
                                      (P * P, Cout)))


def test_level_bfloat16_is_float32_arithmetic_rounded_once():
    """The plain level on bfloat16 inputs equals the float32 plain level on
    the same values, rounded to bfloat16: no intermediate is rounded."""
    port, _, _, _ = _bf16_case(5, 8, 8, 16, seed=4)
    up = [t.float() if t.is_floating_point() else t for t in port]
    got = risi18_level_reference(*port)
    assert got.dtype == BF16
    assert torch.equal(got, risi18_level_reference(*up).to(BF16))
    with pytest.raises(TypeError):
        risi18_level_reference(port[0].half(), *port[1:])


def test_level_backward_bfloat16_matches_pallas_training_path():
    """The bfloat16 backward against ``risi18_level_train`` (Pallas forward
    and backward kernels in interpret mode, the scatter of ``_v3t_bwd``) at
    the shape of tests/test_fused_kernel.py:137-161: every gradient in the
    dtype of its parameter, within two bfloat16 steps of its scale."""
    port, (state, nbr, pos, radj, K, b), g, jg = _bf16_case(6, 16, 8, 8, 17)
    with pltpu.force_tpu_interpret_mode():
        ref_out, vjp = jax.vjp(
            lambda s, k, bb: risi18_level_train(s, nbr, pos, radj, k, bb),
            state, K, b)
        ref = vjp(jg)
    out = risi18_level(*port)
    _close(_f32(out), _f32(ref_out), RTOL_BF16)
    got = risi18_level_backward(*port, out, g)
    for x, r in zip(got, ref):
        assert x.dtype == BF16 and str(r.dtype) == "bfloat16"
        _close(_f32(x), _f32(r), RTOL_BF16)


@pytest.mark.parametrize("V,P,C,Cout", [(5, 4, 8, 16), (4, 8, 8, 8)])
def test_level_backward_bfloat16_tracks_float32_autodiff(V, P, C, Cout):
    """Against jax.grad of the float32 XLA composition on the same
    (bfloat16-rounded) values, at the bound of test_fused_kernel.py:161;
    through torch autograd of the wrapper, which on the CPU differentiates
    the plain level."""
    port, jx, g, _ = _bf16_case(V, P, C, Cout, seed=21)
    s32, nbr, pos, radj, k32, b32 = (
        x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x
        for x in jx)
    _, vjp = jax.vjp(lambda s, k, bb: _reference_level(s, nbr, pos, radj, k,
                                                       bb), s32, k32, b32)
    ref = vjp(jnp.asarray(_f32(g)))
    leaves = [t.clone().requires_grad_() for t in (port[0], port[4], port[5])]
    out = risi18_level(leaves[0], *port[1:4], leaves[1], leaves[2])
    got = torch.autograd.grad(out, leaves, g)
    again = risi18_level_backward_reference(*port, g)
    for x, a, r in zip(got, again, ref):
        assert x.dtype == BF16 and torch.equal(x, a)
        _close(_f32(x), _f32(r), RTOL_BF16_VS_F32)


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
