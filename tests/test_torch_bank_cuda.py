"""The CUDA bank kernels, forward (K4) and backward (K5), against their
plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
an NVIDIA GPU (sm_90a) and nvcc, run

    python -m pytest --noconftest -q -m cuda tests/test_torch_bank_cuda.py

The inputs are those of ``chip_smoke.py`` phase 7: a level's seeded state,
neighbours and positions from a NumPy seed, gathered into T by the
take-gather (so absent slots are zero), mixed-sign adjacency, one vertex
whose slots are all absent, in float32 and in bfloat16.
"""

import numpy as np
import pytest
import torch

from graphflow_tpu_torch.ops.risi_aligned import (
    _gather_neighbor_tensors_take)
from graphflow_tpu_torch.ops.risi_bank import (
    risi18_bank, risi18_bank_backward, risi18_bank_backward_reference,
    risi18_bank_reference)
from graphflow_tpu_torch.ops.risi_level import risi18_level
from graphflow_tpu_torch.utils.datasets import random_level_case

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# Kernel and plain version both sum in float32 from the same inputs; the
# order differs.  float32: the bound of tests/test_fused.py:79; bfloat16:
# one rounding of the output to bfloat16 (2^-8 relative) on either side.
RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Four of them are the levels of a halving channel schedule.  The last two
# have more vertices than the backward has blocks (264), so that every block
# walks several vertices and adds into its partial row of dK.
SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8),
          (12, 12, 40, 16), (6, 5, 5, 3), (256, 16, 32, 16),
          (256, 16, 16, 8), (64, 10, 2, 1), (32, 4, 1, 1),
          (600, 16, 32, 32), (600, 4, 8, 4)]
# The product paths of K4's and K5's blocks: the tensor cores where P*P is a
# multiple of 16 and Cout of 8 (P = 12, 16), the CUDA cores where P*P is no
# multiple of 16 (P = 7, 10, 4 with C = 20) or Cout no multiple of 8 (20);
# one, two and twenty channels (a chunk of 16 and one of 4).
PATH_SHAPES = [(24, 12, 20, 24), (24, 16, 16, 16), (24, 7, 8, 8),
               (16, 16, 1, 8), (16, 16, 2, 20), (8, 4, 20, 3),
               (12, 10, 20, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, P, C, Cout, seed, device, dtype):
    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=N // 2)
    state = torch.as_tensor(d["state"], dtype=torch.float32, device=device)
    nbr, pos = (torch.as_tensor(d[k], dtype=torch.int32, device=device)
                for k in ("nbr", "pos"))
    T = _gather_neighbor_tensors_take(
        torch.nn.functional.pad(state, (0, 0, 0, 1, 0, 1)), nbr, pos)
    A = torch.as_tensor(d["radj"], dtype=torch.float32, device=device)
    K = torch.as_tensor(d["K"], dtype=dtype, device=device)
    g = np.random.default_rng(seed).normal(size=(N, P, P, Cout))
    return (T.to(dtype).contiguous(), A, K,
            torch.as_tensor(g, dtype=dtype, device=device))


def _assert_close(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    rtol = RTOL[ref.dtype]
    got, ref = got.double(), ref.double()
    assert torch.isfinite(got).all()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= rtol * scale


@pytest.fixture(params=[torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def dtype(request):
    return request.param


@pytest.mark.parametrize("N,P,C,Cout", SHAPES + PATH_SHAPES)
def test_bank_kernel_matches_plain(cuda, dtype, N, P, C, Cout):
    T, A, K, _ = _inputs(N, P, C, Cout, seed=N + P, device=cuda, dtype=dtype)
    before = risi18_bank.launches
    got = risi18_bank(T, A, K)
    assert risi18_bank.launches == before + 1
    _assert_close(got, risi18_bank_reference(T, A, K))
    assert not got[N // 2].any()          # an empty vertex gives Z = 0


@pytest.mark.parametrize("N,P,C,Cout", SHAPES + PATH_SHAPES)
def test_bank_backward_kernel_matches_plain(cuda, dtype, N, P, C, Cout):
    T, A, K, g = _inputs(N, P, C, Cout, seed=N + P, device=cuda, dtype=dtype)
    counts = (risi18_bank_backward.launches,
              risi18_bank_backward.reduce_launches)
    got = risi18_bank_backward(T, A, K, g)
    assert (risi18_bank_backward.launches,
            risi18_bank_backward.reduce_launches) == (counts[0] + 1,
                                                      counts[1] + 1)
    for x, r in zip(got, risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)


@pytest.mark.parametrize("N,P,C,Cout", [(256, 16, 32, 32), (600, 4, 8, 4),
                                        (24, 7, 8, 8), (12, 10, 20, 8)])
def test_bank_kernels_repeat_bit_for_bit(cuda, dtype, N, P, C, Cout):
    """Z, dT and dK come out the same from run to run: every dT element has
    one writer and dK's partial rows are summed in a fixed order."""
    T, A, K, g = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                         dtype=dtype)
    first = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
    second = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_bank_forward_streams_fields_of_more_than_32_rows(cuda, dtype):
    """Beyond 32 rows K4 streams in shared memory (the wide stream, as K1
    does); the backward, like K2's, stops at 32 rows and refuses with its
    bytes."""
    T, A, K, g = _inputs(2, 33, 4, 8, seed=4, device=cuda, dtype=dtype)
    _assert_close(risi18_bank(T, A, K), risi18_bank_reference(T, A, K))
    with pytest.raises(RuntimeError, match="P=33 at Cout=8 needs 279168 "
                                           "bytes .* shared memory"):
        risi18_bank_backward(T, A, K, g)


def test_bank_autograd_on_cuda_runs_k4_and_k5(cuda, dtype):
    T, A, K, g = _inputs(32, 8, 8, 8, seed=6, device=cuda, dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in (T, K)]
    counts = (risi18_bank.launches, risi18_bank_backward.launches)
    out = risi18_bank(leaves[0], A, leaves[1])
    got = torch.autograd.grad(out, leaves, g)
    assert (risi18_bank.launches, risi18_bank_backward.launches) == (
        counts[0] + 1, counts[1] + 1)
    for x, r in zip(got, risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)


def test_bank_kernel_negative_adjacency(cuda, dtype):
    """All-negative adjacency zeroes every adjacency-weighted case."""
    T, A, K, g = _inputs(16, 8, 8, 8, seed=3, device=cuda, dtype=dtype)
    A = -A.abs() - 0.1
    _assert_close(risi18_bank(T, A, K), risi18_bank_reference(T, A, K))
    for x, r in zip(risi18_bank_backward(T, A, K, g),
                    risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)


def test_bank_kernels_reject_wrong_inputs(cuda):
    T, A, K, g = _inputs(4, 4, 8, 8, seed=7, device=cuda,
                         dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        risi18_bank(T.half(), A, K.half())
    with pytest.raises(TypeError):
        risi18_bank(T, A, K.float())              # K in T's dtype
    with pytest.raises(TypeError):
        risi18_bank(T, A.double(), K)             # A in float32
    with pytest.raises(ValueError):
        risi18_bank(T.transpose(1, 2), A, K)
    with pytest.raises(ValueError):
        risi18_bank(T, A, K[:-1])
    with pytest.raises(TypeError):
        risi18_bank_backward(T, A, K, g.float())
    with pytest.raises(ValueError):
        risi18_bank_backward(T, A, K, g[:, :-1].contiguous())


def test_bank_kernel_rejects_shapes_beyond_shared_memory(cuda):
    """The maps and Z [P*P, Cout] live in shared memory: at P=64, Cout=32
    they do not fit, and the launch is refused with an error, not run."""
    T, A, K, _ = _inputs(2, 64, 2, 32, seed=8, device=cuda,
                         dtype=torch.float32)
    with pytest.raises(RuntimeError, match="P=64 at Cout=32 needs 744384 "
                                           "bytes .* shared memory"):
        risi18_bank(T, A, K)
    g = torch.ones((2, 64, 64, 32), device=cuda)
    with pytest.raises(RuntimeError, match="P=64 at Cout=32 needs .* "
                                           "shared memory"):
        risi18_bank_backward(T, A, K, g)


def test_level_kernel_refuses_bfloat16(cuda):
    """bfloat16 levels go through the bank; the fused level (K1) takes
    float32 only and raises rather than falling back."""
    d = random_level_case(4, 4, 8, 8, seed=9)
    f = {k: torch.as_tensor(d[k], dtype=torch.bfloat16, device=cuda)
         for k in ("state", "radj", "K", "b")}
    i = {k: torch.as_tensor(d[k], dtype=torch.int32, device=cuda)
         for k in ("nbr", "pos")}
    with pytest.raises(TypeError):
        risi18_level(f["state"], i["nbr"], i["pos"], f["radj"], f["K"],
                     f["b"])
