"""The CUDA aligned-tensor kernel (K7) against its plain version, the
take-gather, on the card, and the ver6/ver7 serving path through it.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
an NVIDIA GPU (sm_90a) and nvcc, run

    python -m pytest --noconftest -q -m cuda tests/test_torch_aligned_cuda.py

The inputs are those of ``chip_smoke.py`` phase 9: a level's seeded state,
neighbours and positions from a NumPy seed, with sentinel ids and
positions and one vertex whose slots are all absent.  Every element of T
is one copied value, so kernel and plain version agree exactly.
"""

import numpy as np
import pytest
import torch

from graphflow_tpu_torch.models import SMP_2D_ver7
from graphflow_tpu_torch.models.smp2d import (contraction_level,
                                              smp2d_forward)
from graphflow_tpu_torch.ops.risi_aligned import (
    risi18_aligned_t2, risi18_aligned_t2_reference)
from graphflow_tpu_torch.utils.datasets import random_graph, random_level_case

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# (N, P, C): chip_smoke.py's four shapes, then C % 4 != 0 (one float per
# access in place of 16 bytes), then the levels of a halving channel
# schedule, down to one channel.
SHAPES = [(256, 16, 32), (64, 10, 20), (32, 4, 8), (12, 12, 40), (6, 5, 3),
          (256, 16, 16), (64, 10, 2), (32, 4, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, P, C, device, seed=0):
    d = random_level_case(N, P, C, 1, seed=seed, empty_vertex=N // 2)
    state = torch.as_tensor(d["state"], dtype=torch.float32, device=device)
    nbr, pos = (torch.as_tensor(d[k], dtype=torch.int32, device=device)
                for k in ("nbr", "pos"))
    return state, nbr, pos


@pytest.mark.parametrize("N,P,C", SHAPES)
def test_kernel_equals_plain_exactly(cuda, N, P, C):
    state, nbr, pos = _inputs(N, P, C, cuda, seed=N + P)
    before = risi18_aligned_t2.launches
    got = risi18_aligned_t2(state, nbr, pos)
    torch.cuda.synchronize()
    assert risi18_aligned_t2.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (N, P, P, P, C)
    torch.testing.assert_close(got, risi18_aligned_t2_reference(
        state, nbr, pos), rtol=0, atol=0)
    assert not got[N // 2].any()          # an empty vertex reads zeros


def test_kernel_out_of_range_ids_and_positions(cuda):
    state, nbr, pos = _inputs(8, 6, 4, cuda, seed=3)
    nbr[0, 0], nbr[2, 1], nbr[3, 3] = -1, 100, -7
    pos[0, 1, 2], pos[4, 0, 0], pos[2, 2, 3] = -1, 50, -3
    torch.testing.assert_close(risi18_aligned_t2(state, nbr, pos),
                               risi18_aligned_t2_reference(state, nbr, pos),
                               rtol=0, atol=0)


def test_kernel_on_an_unaligned_view(cuda):
    """A contiguous view that starts one float into its storage takes the
    one-float path and still agrees."""
    state, nbr, pos = _inputs(8, 6, 4, cuda, seed=4)
    flat = torch.empty(state.numel() + 1, device=cuda)
    view = flat[1:].view(state.shape)
    view.copy_(state)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    torch.testing.assert_close(risi18_aligned_t2(view, nbr, pos),
                               risi18_aligned_t2_reference(state, nbr, pos),
                               rtol=0, atol=0)


def test_kernel_rejects_wrong_inputs(cuda):
    state, nbr, pos = _inputs(4, 4, 8, cuda, seed=7)
    with pytest.raises(TypeError):
        risi18_aligned_t2(state.double(), nbr, pos)
    with pytest.raises(TypeError):
        risi18_aligned_t2(state.bfloat16(), nbr, pos)
    with pytest.raises(TypeError):
        risi18_aligned_t2(state, nbr.long(), pos)
    with pytest.raises(ValueError):
        risi18_aligned_t2(state, nbr, pos[:, :-1].contiguous())
    with pytest.raises(ValueError):
        risi18_aligned_t2(state.transpose(1, 2), nbr, pos)
    with pytest.raises(ValueError):
        risi18_aligned_t2(state[:, :, :-1].contiguous(), nbr, pos)
    with pytest.raises(RuntimeError, match="no backward"):
        risi18_aligned_t2(state.clone().requires_grad_(), nbr, pos)


def test_ver7_serves_through_the_kernel(cuda):
    """Threaded_Predict of ver7 launches K7 once per level and matches the
    same model through the take-gather; a training step launches none."""
    m = SMP_2D_ver7(max_nVertices=12, max_receptive_field=6, nLevels=2,
                    nChanels=8, nFeatures=4, nDepth=2, seed=1, device=cuda)
    graphs = [random_graph(12, 0.3, seed=s) for s in range(3)]
    before = risi18_aligned_t2.launches
    pred = m.Threaded_Predict(graphs)
    assert risi18_aligned_t2.launches == before + 2
    with torch.no_grad():
        ref, _ = smp2d_forward(
            m.params, m._stack(graphs), m.cfg,
            level_fn=lambda *a: contraction_level(
                50, risi18_aligned_t2_reference, *a))
    ref = ref.cpu().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(pred - ref).max() <= 1e-4 * scale
    losses = m.BatchLearn(graphs, [1.0, 2.0, 3.0], 1e-5)
    assert np.isfinite(losses).all()
    assert risi18_aligned_t2.launches == before + 2
