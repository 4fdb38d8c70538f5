"""The CUDA level kernels, forward (K1) and backward (K2), against their
plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
an NVIDIA GPU (sm_90a) and nvcc, run

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because the suite's conftest configures JAX, which the
port does not need).  The cases are those of ``chip_smoke.py`` phase 3:
float32 inputs from a NumPy seed with mixed-sign adjacency, absent
neighbours and positions, and one vertex whose slots are all absent.
"""

import numpy as np
import pytest
import torch

from graphflow_tpu_torch.ops.risi_level import (
    risi18_level, risi18_level_backward, risi18_level_backward_reference,
    risi18_level_reference)
from graphflow_tpu_torch.utils.datasets import random_level_case

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# Summation order on the card differs from the plain version's; the bound
# is that of tests/test_fused_kernel.py:49-50.
RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, P, C, Cout, seed, device, empty_vertex=None):
    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=empty_vertex)
    f = {k: torch.as_tensor(d[k], dtype=torch.float32, device=device)
         for k in ("state", "radj", "K", "b")}
    i = {k: torch.as_tensor(d[k], dtype=torch.int32, device=device)
         for k in ("nbr", "pos")}
    return f["state"], i["nbr"], i["pos"], f["radj"], f["K"], f["b"]


def _assert_close(got, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= RTOL * scale


# (12, 12, 40, 16) walks the channels in chunks of 16, 16 and 8; the last
# four are the levels of a halving channel schedule, down to one channel.
SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8), (5, 8, 8, 16),
          (12, 12, 40, 16), (256, 16, 32, 16), (256, 16, 16, 8),
          (64, 10, 2, 1), (32, 4, 1, 1)]


@pytest.mark.parametrize("N,P,C,Cout", SHAPES)
def test_level_kernel_matches_plain(cuda, N, P, C, Cout):
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2)
    before = risi18_level.launches
    got = risi18_level(*args)
    assert risi18_level.launches == before + 1
    assert got.shape == (N, P * P, Cout)
    _assert_close(got, risi18_level_reference(*args))


def test_level_kernel_negative_adjacency(cuda):
    """All-negative adjacency zeroes every adjacency-weighted case."""
    state, nbr, pos, radj, K, b = _inputs(16, 8, 8, 8, seed=3, device=cuda)
    radj = -radj.abs() - 0.1
    got = risi18_level(state, nbr, pos, radj, K, b)
    _assert_close(got, risi18_level_reference(state, nbr, pos, radj, K, b))


def test_level_kernel_all_absent_vertex_is_bias_only(cuda):
    state, nbr, pos, radj, K, b = _inputs(8, 4, 8, 8, seed=5, device=cuda,
                                          empty_vertex=2)
    got = risi18_level(state, nbr, pos, radj, K, b)
    torch.cuda.synchronize()
    bias = torch.where(b > 0, b, 0.01 * b)
    np.testing.assert_array_equal(got[2].cpu().numpy(),
                                  bias.expand(16, 8).cpu().numpy())


def test_level_kernel_rejects_wrong_inputs(cuda):
    state, nbr, pos, radj, K, b = _inputs(4, 4, 8, 8, seed=7, device=cuda)
    with pytest.raises(TypeError):
        risi18_level(state.double(), nbr, pos, radj, K, b)
    with pytest.raises(TypeError):
        risi18_level(state, nbr.long(), pos, radj, K, b)
    with pytest.raises(ValueError):
        risi18_level(state, nbr, pos.transpose(1, 2), radj, K, b)
    with pytest.raises(ValueError):
        risi18_level(state, nbr, pos, radj, K[:-1], b)


def test_level_kernel_rejects_shapes_beyond_shared_memory(cuda):
    """Z [P*P, Cout] lives in shared memory: at P=64, Cout=32 it does not
    fit, and the launch is refused with an error, not run."""
    args = _inputs(2, 64, 4, 32, seed=8, device=cuda)
    before = risi18_level.launches
    with pytest.raises(RuntimeError, match="P=64 at Cout=32 needs 659632 "
                                           "bytes .* shared memory"):
        risi18_level(*args)
    assert risi18_level.launches == before


def test_backward_kernel_rejects_shapes_beyond_shared_memory(cuda):
    """G and G.Ap [P*P, Cout + 1] live in shared memory: at P=32, Cout=32
    the forward fits and the backward does not."""
    args = _inputs(2, 32, 4, 32, seed=8, device=cuda)
    out = risi18_level(*args)
    _assert_close(out, risi18_level_reference(*args))
    before = risi18_level_backward.launches
    with pytest.raises(RuntimeError, match="P=32 at Cout=32 needs 310780 "
                                           "bytes .* shared memory"):
        risi18_level_backward(*args, out, torch.ones_like(out))
    assert risi18_level_backward.launches == before


# -- K2, the level backward -------------------------------------------------

def _cotangent(N, P, Cout, seed, device):
    g = np.random.default_rng(seed).normal(size=(N, P * P, Cout))
    return torch.as_tensor(g, dtype=torch.float32, device=device)


def _check_backward(args, g):
    counts = (risi18_level_backward.launches,
              risi18_level_backward.reduce_launches)
    out = risi18_level(*args)
    got = risi18_level_backward(*args, out, g)
    assert (risi18_level_backward.launches,
            risi18_level_backward.reduce_launches) == (counts[0] + 1,
                                                       counts[1] + 1)
    ref = risi18_level_backward_reference(*args, g)
    for x, r in zip(got, ref):
        assert x.shape == r.shape
        _assert_close(x, r)
    return got


@pytest.mark.parametrize("N,P,C,Cout", SHAPES)
def test_backward_kernel_matches_plain(cuda, N, P, C, Cout):
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2)
    _check_backward(args, _cotangent(N, P, Cout, seed=N, device=cuda))


def test_backward_kernel_negative_adjacency(cuda):
    state, nbr, pos, radj, K, b = _inputs(16, 8, 8, 8, seed=3, device=cuda)
    radj = -radj.abs() - 0.1
    _check_backward((state, nbr, pos, radj, K, b),
                    _cotangent(16, 8, 8, seed=3, device=cuda))


def test_backward_kernel_all_absent_vertex(cuda):
    """A vertex whose slots are all absent and that no receptive field
    holds gets an exactly zero gradient; dK and db stay right."""
    d = random_level_case(8, 4, 8, 8, seed=5, empty_vertex=2)
    d["nbr"][d["nbr"] == 2] = 8
    f = {k: torch.as_tensor(d[k], dtype=torch.float32, device=cuda)
         for k in ("state", "radj", "K", "b")}
    i = {k: torch.as_tensor(d[k], dtype=torch.int32, device=cuda)
         for k in ("nbr", "pos")}
    args = (f["state"], i["nbr"], i["pos"], f["radj"], f["K"], f["b"])
    dstate, _, _ = _check_backward(args, _cotangent(8, 4, 8, seed=5,
                                                    device=cuda))
    assert not dstate[2].any()


def test_level_autograd_on_cuda_runs_k1_and_k2(cuda):
    state, nbr, pos, radj, K, b = _inputs(32, 8, 8, 8, seed=6, device=cuda,
                                          empty_vertex=4)
    g = _cotangent(32, 8, 8, seed=6, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (state, K, b)]
    counts = (risi18_level.launches, risi18_level_backward.launches)
    out = risi18_level(leaves[0], nbr, pos, radj, leaves[1], leaves[2])
    got = torch.autograd.grad(out, leaves, g)
    assert (risi18_level.launches, risi18_level_backward.launches) == (
        counts[0] + 1, counts[1] + 1)
    ref = risi18_level_backward_reference(state, nbr, pos, radj, K, b, g)
    for x, r in zip(got, ref):
        _assert_close(x, r)


def test_backward_kernel_rejects_wrong_inputs(cuda):
    args = _inputs(4, 4, 8, 8, seed=7, device=cuda)
    g = _cotangent(4, 4, 8, seed=7, device=cuda)
    out = risi18_level(*args)
    with pytest.raises(TypeError):
        risi18_level_backward(*args, out, g.double())
    with pytest.raises(ValueError):
        risi18_level_backward(*args, out, g[:, :-1].contiguous())
    with pytest.raises(ValueError):
        risi18_level_backward(*args, out.transpose(1, 2), g)
    state, nbr, pos, radj, K, b = args
    with pytest.raises(TypeError):
        risi18_level_backward(state, nbr.long(), pos, radj, K, b, out, g)
