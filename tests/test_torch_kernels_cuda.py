"""The CUDA level kernel against its plain PyTorch version, on the card.

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
    risi18_level, risi18_level_reference)
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


# (12, 12, 40, 16) walks the channels in chunks of 16, 16 and 8.
@pytest.mark.parametrize("N,P,C,Cout", [(256, 16, 32, 32), (64, 10, 20, 20),
                                        (32, 4, 8, 8), (5, 8, 8, 16),
                                        (12, 12, 40, 16)])
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
    with pytest.raises(NotImplementedError):
        risi18_level(state, nbr, pos, radj, K.requires_grad_(), b)


def test_level_kernel_rejects_shapes_beyond_shared_memory(cuda):
    """Z [P*P, Cout] lives in shared memory: at P=64, Cout=32 it does not
    fit, and the launch is refused with an error, not run."""
    args = _inputs(2, 64, 4, 32, seed=8, device=cuda)
    with pytest.raises(RuntimeError, match="shared memory"):
        risi18_level(*args)
