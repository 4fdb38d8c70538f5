"""The CUDA ablation variants of the bank kernel (K6) against their plain
PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
an NVIDIA GPU (sm_90a) and nvcc, run

    python -m pytest --noconftest -q -m cuda tests/test_torch_ablate_cuda.py

The inputs are those of ``chip_smoke.py`` phase 11: slots T gathered from a
seeded level state (absent slots zero), mixed-sign adjacency, in float32
and bfloat16.
"""

import pytest
import torch

from graphflow_tpu_torch.ops.risi_aligned import (
    _gather_neighbor_tensors_take)
from graphflow_tpu_torch.ops.risi_bank import bank_plan, risi18_bank
from graphflow_tpu_torch.ops.risi_bank_ablate import (
    MODES, risi18_bank_variant, risi18_bank_variant_reference)
from graphflow_tpu_torch.tools import ablate_bank
from graphflow_tpu_torch.utils.datasets import random_level_case

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# As the bank kernel's (tests/test_torch_bank_cuda.py): float32 sums in
# another order; bfloat16 rounds the output once on either side.
RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The bank's shapes (tests/test_torch_bank_cuda.py): chip_smoke.py's, more
# vertices than the backward has vertex groups, and the product paths of
# K4's block: tensor cores (P*P a multiple of 16, Cout of 8) and CUDA cores,
# one, two and twenty channels.
SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8),
          (12, 12, 40, 16), (6, 5, 5, 3), (256, 16, 32, 16), (256, 16, 16, 8),
          (64, 10, 2, 1), (32, 4, 1, 1), (600, 16, 32, 32), (600, 4, 8, 4),
          (24, 12, 20, 24), (24, 7, 8, 8), (16, 16, 1, 8), (16, 16, 2, 20),
          (8, 4, 20, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=[torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def dtype(request):
    return request.param


def _inputs(N, P, C, Cout, seed, device, dtype):
    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=N // 2)
    state = torch.as_tensor(d["state"], dtype=torch.float32, device=device)
    nbr, pos = (torch.as_tensor(d[k], dtype=torch.int32, device=device)
                for k in ("nbr", "pos"))
    T = _gather_neighbor_tensors_take(
        torch.nn.functional.pad(state, (0, 0, 0, 1, 0, 1)), nbr, pos)
    A = torch.as_tensor(d["radj"], dtype=torch.float32, device=device)
    K = torch.as_tensor(d["K"], dtype=dtype, device=device)
    return T.to(dtype).contiguous(), A, K


def _assert_close(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    rtol = RTOL[ref.dtype]
    got, ref = got.double(), ref.double()
    assert torch.isfinite(got).all()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= rtol * scale


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N,P,C,Cout", SHAPES)
def test_variant_kernel_matches_plain(cuda, dtype, N, P, C, Cout, mode):
    T, A, K = _inputs(N, P, C, Cout, seed=N + P, device=cuda, dtype=dtype)
    before = dict(risi18_bank_variant.launches)
    got = risi18_bank_variant(T, A, K, mode)
    assert risi18_bank_variant.launches == {
        **before, mode: before[mode] + 1}
    ref = risi18_bank_variant_reference(T, A, K, mode)
    if mode == "dma":
        torch.cuda.synchronize()
        assert torch.equal(got, ref)          # a copy
    else:
        _assert_close(got, ref)


@pytest.mark.parametrize("N,P,C,Cout", SHAPES)
def test_full_equals_the_bank_kernel_exactly(cuda, dtype, N, P, C, Cout):
    """``full`` is the bank kernel's own body: the same bits."""
    T, A, K = _inputs(N, P, C, Cout, seed=N + P, device=cuda, dtype=dtype)
    got = risi18_bank_variant(T, A, K, "full")
    ref = risi18_bank(T, A, K)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_variant_rejects_wrong_inputs(cuda):
    T, A, K = _inputs(4, 4, 2, 9, seed=7, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="the variants are"):
        risi18_bank_variant(T, A, K, "nomxu")
    with pytest.raises(ValueError, match="Cout=9 > P\\*C=8"):
        risi18_bank_variant(T, A, K, "dma")
    with pytest.raises(TypeError):
        risi18_bank_variant(T, A, K.bfloat16(), "full")
    with pytest.raises(ValueError):
        risi18_bank_variant(T.transpose(1, 2), A, K, "full")
    # K4's reach (tests/test_torch_bank_cuda.py): P = 216 fits in row
    # tiles of one row, P = 217 does not, at any Cout.
    big = torch.zeros((1, 217, 217, 217, 1), device=cuda)
    with pytest.raises(RuntimeError, match="P=217 at Cout=32 needs 234288 "
                                           "bytes .* shared memory"):
        risi18_bank_variant(big, torch.zeros((1, 217, 217), device=cuda),
                            torch.zeros((18, 32), device=cuda), "full")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("N,P,C,Cout", [(2, 33, 4, 8), (2, 36, 4, 32),
                                        (2, 48, 8, 4), (2, 64, 4, 32)])
def test_variants_on_a_field_of_more_than_32_rows(cuda, dtype, mode, N, P, C,
                                                  Cout):
    """Beyond 32 rows K4's block streams in shared memory (the wide stream,
    to 35 rows at Cout = 32) and from 36 rows walks the rows in tiles.
    Every variant takes K4's plan where one block holds the field, and
    ``full`` is K4 there; on a row-tiled field the variants run one block
    a vertex (``forward_block_tiled``) while K4 runs a cluster plan, so
    ``full`` is held against K4 within the tolerance there."""
    T, A, K = _inputs(N, P, C, Cout, seed=5, device=cuda, dtype=dtype)
    got = risi18_bank_variant(T, A, K, mode)
    ref = risi18_bank_variant_reference(T, A, K, mode)
    if mode == "dma":
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    else:
        _assert_close(got, ref)
        if mode == "full":
            bank = risi18_bank(T, A, K)
            if bank_plan(N, P, C, Cout, dtype)["cluster"]:
                _assert_close(got, bank)
            else:
                assert torch.equal(got, bank)


@pytest.mark.parametrize("mode", MODES)
def test_variants_at_the_edge_of_their_reach(cuda, dtype, mode):
    """P = 216, the last field whose tiles of one row fit K4's block at
    Cout = 32: every variant runs there and matches its plain version."""
    T, A, K = _inputs(1, 216, 1, 32, seed=216, device=cuda, dtype=dtype)
    got = risi18_bank_variant(T, A, K, mode)
    ref = risi18_bank_variant_reference(T, A, K, mode)
    if mode == "dma":
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    else:
        _assert_close(got, ref)


def test_tool_reports_five_times_and_the_attribution(cuda):
    lines = []
    ms, parts, spread = ablate_bank.report(8, 8, 8, torch.float32,
                                           out=lines.append)
    assert set(ms) == set(MODES) | {"bank"}
    assert all(t > 0 for t in ms.values())
    assert parts == ablate_bank.attribution(ms)
    assert set(spread) == set(ms) | set(parts) | {"full-bank"}
    assert all(spread[m][0] <= ms[m] <= spread[m][1] for m in ms)
    assert len(lines) == 1 + len(MODES) + 1 + 2
    assert lines[-2].startswith("attribution of full: stream ")
    assert lines[-1].startswith("full - bank, the same code: ")
