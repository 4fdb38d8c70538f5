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
    _backward_reduce_kernel, bank_backward_plan, bank_plan, risi18_bank,
    risi18_bank_backward, risi18_bank_backward_reference,
    risi18_bank_backward_sums, risi18_bank_backward_sums_reference,
    risi18_bank_reference)
from graphflow_tpu_torch.ops.risi_level import risi18_level
from graphflow_tpu_torch.utils.datasets import random_level_case
from test_torch_kernels_cuda import (TILED_FIELDS, check_cluster_plan,
                                     cluster_sizes, sums_bytes)

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
    # In float64 2^25 elements at a time: a dT of 8.6 GB in float32 would
    # take 17 GB a copy.
    got, ref = got.reshape(-1), ref.reshape(-1)
    err = scale = 0.0
    for i in range(0, got.numel(), 1 << 25):
        x, r = got[i:i + (1 << 25)].double(), ref[i:i + (1 << 25)].double()
        assert torch.isfinite(x).all()
        err = max(err, float((x - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
    assert err <= rtol * max(1.0, scale)


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
    does); the backward, like K2's, takes the row-tiled block there (one
    tile of 33 rows, or several)."""
    T, A, K, g = _inputs(2, 33, 4, 8, seed=4, device=cuda, dtype=dtype)
    _assert_close(risi18_bank(T, A, K), risi18_bank_reference(T, A, K))
    for x, r in zip(risi18_bank_backward(T, A, K, g),
                    risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)
    assert bank_backward_plan(2, 33, 4, 8, dtype)["tiled"] == 1


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
    """The maps and Z of a tile of rows live in shared memory beside the
    adjacency [P, P]: P=64 at Cout=32, which one block's maps and Z could
    not hold, runs in row tiles; the first fields that even tiles of one
    row leave no room for (K4 at P=217, K5 at P=179 with Cout=32 in one
    panel) are refused with an error, not run."""
    T, A, K, g = _inputs(2, 64, 2, 32, seed=8, device=cuda,
                         dtype=torch.float32)
    _assert_close(risi18_bank(T, A, K), risi18_bank_reference(T, A, K))
    for x, r in zip(risi18_bank_backward(T, A, K, g),
                    risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)
    for P, call, need in ((217, risi18_bank, 234288),
                          (179, risi18_bank_backward, 232880)):
        T = torch.zeros((1, P, P, P, 1), device=cuda)
        A = torch.zeros((1, P, P), device=cuda)
        K = torch.zeros((18, 32), device=cuda)
        args = (T, A, K) if call is risi18_bank else (
            T, A, K, torch.zeros((1, P, P, 32), device=cuda))
        before = (risi18_bank.launches, risi18_bank_backward.launches)
        with pytest.raises(RuntimeError, match=f"P={P} at Cout=32 needs "
                                               f"{need} bytes .* shared "
                                               f"memory"):
            call(*args)
        assert (risi18_bank.launches,
                risi18_bank_backward.launches) == before


# Fields that one block's maps do not hold: the row-tiled block (K5 from 33
# rows, K4 from 36), at the widths of SMP_beta's levels (Cout = 32) and a
# narrow one; two vertices, one of them empty.
LARGE = [(2, P, C, Cout) for P in (33, 36, 48, 64)
         for C, Cout in ((4, 4), (8, 32))]


@pytest.mark.parametrize("N,P,C,Cout", LARGE)
def test_bank_kernels_on_fields_beyond_one_block(cuda, dtype, N, P, C, Cout):
    T, A, K, g = _inputs(N, P, C, Cout, seed=N + P, device=cuda, dtype=dtype)
    got = risi18_bank(T, A, K)
    _assert_close(got, risi18_bank_reference(T, A, K))
    assert not got[N // 2].any()
    for x, r in zip(risi18_bank_backward(T, A, K, g),
                    risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)
    second = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
    first = (got, *risi18_bank_backward(T, A, K, g))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("P", [33, 36])
def test_bank_kernels_walk_several_vertices_of_a_tiled_field(cuda, dtype, P):
    """140 vertices, more than K5 kernel 1's 132 vertex groups: blocks of
    its row-tiled plan walk two vertices each, write each one's dT and
    carry dK from one to the next (K4 tiles from 36 rows)."""
    N, C, Cout = 140, 4, 4
    assert bank_backward_plan(N, P, C, Cout, dtype)["tiled"] == 1
    T, A, K, g = _inputs(N, P, C, Cout, seed=P, device=cuda, dtype=dtype)
    _assert_close(risi18_bank(T, A, K), risi18_bank_reference(T, A, K))
    for x, r in zip(risi18_bank_backward(T, A, K, g),
                    risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)


def test_bank_kernels_run_at_the_edge_of_their_reach(cuda, dtype):
    """The last fields whose tiles of one row fit a block at Cout = 32:
    K4 at P = 216 and K5 kernel 1 at P = 178 run and match, on cluster
    plans of 8 blocks (one vertex leaves the card idle)."""
    assert bank_plan(1, 216, 1, 32, dtype)["cluster"] == 8
    assert bank_backward_plan(1, 178, 1, 32, dtype)["cluster"] == 8
    T, A, K, _ = _inputs(1, 216, 1, 32, seed=216, device=cuda, dtype=dtype)
    _assert_close(risi18_bank(T, A, K), risi18_bank_reference(T, A, K))
    T, A, K, g = _inputs(1, 178, 1, 32, seed=178, device=cuda, dtype=dtype)
    for x, r in zip(risi18_bank_backward(T, A, K, g),
                    risi18_bank_backward_reference(T, A, K, g)):
        _assert_close(x, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_bank_plans_report_their_clusters(cuda, dtype):
    """Every row-tiled plan of K4 and K5 kernel 1 is a cluster plan sized
    for N by the rule K1 and K2 kernel 1 follow
    (``test_torch_kernels_cuda.py:check_cluster_plan``; K5's one-block
    clusters on the CUDA cores take the row-tiled block one a vertex group),
    with the tensor cores where a tile's rows allow them; an untiled plan
    has none.  At
    SMP_beta's field (C = Cout = 32) one vertex spreads over 8 blocks of 2
    tiles, 64 vertices over 2 blocks of 8 tiles forward and one block
    backward (64 groups x 4 chunks), 256 over one block."""
    for C, Cout in ((4, 4), (32, 32), (16, 8)):
        for P in list(range(20, 65)) + [100, 178]:
            for N in (1, 64, 140, 160, 256):
                fwd = bank_plan(N, P, C, Cout, dtype)
                if fwd is not None:
                    check_cluster_plan(fwd, P, N * -(-Cout // fwd["panel"]))
                bwd = bank_backward_plan(N, P, C, Cout, dtype)
                check_cluster_plan(bwd, P, min(N, 132) * -(-C // bwd["chunk"])
                                   * -(-Cout // bwd["panel"]), backward=True)
    for N, fwd, bwd in ((1, (8, 2), (8, 2)), (64, (2, 8), (1, 16)),
                        (256, (1, 16), (1, 16))):
        for plan, want in ((bank_plan(N, 64, 32, 32, dtype), fwd),
                           (bank_backward_plan(N, 64, 32, 32, dtype), bwd)):
            assert (plan["rows"], plan["cluster"], plan["tiles_per_block"],
                    plan["mma"]) == (4, *want, 1), (N, plan)


def _cluster_sizes(P, C, Cout, dtype, most_bytes):
    """{(K4's cluster, K5 kernel 1's cluster): the least N whose plans take
    them}, over the N whose T holds at most ``most_bytes``."""
    sizes = {}
    per_vertex = P ** 4 * C * torch.finfo(dtype).bits // 8
    for N in range(1, most_bytes // per_vertex + 1):
        key = (bank_plan(N, P, C, Cout, dtype)["cluster"],
               bank_backward_plan(N, P, C, Cout, dtype)["cluster"])
        sizes.setdefault(key, N)
    return sizes


@pytest.mark.parametrize("C,Cout", [(1, 4), (8, 8)])
def test_bank_kernels_at_every_cluster_size(cuda, dtype, C, Cout):
    """K4 and K5 kernel 1 at every cluster size the rule picks as N grows
    (P = 40: three tiles a vertex, clusters of 3, 2 and 1 blocks; K5's
    cluster of one is the row-tiled block one a vertex group, 0, where its
    dK would run on the CUDA cores: 4 channels a chunk, as at C = 1, and at
    C = 8 in float32; in bfloat16 the chunk of 8 takes the tensor cores),
    against the plain bank and bit for bit from run to run."""
    P = 40
    sizes = _cluster_sizes(P, C, Cout, dtype, 8 << 30)
    one = 1 if (C, dtype) == (8, torch.bfloat16) else 0
    assert {f for f, _ in sizes} >= {1, 2, 3}, sizes
    assert {b for _, b in sizes} >= {one, 2, 3}, sizes
    for N in sorted(sizes.values()):
        T, A, K, g = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                             dtype=dtype)
        got = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
        _assert_close(got[0], risi18_bank_reference(T, A, K))
        for x, r in zip(got[1:], risi18_bank_backward_reference(T, A, K, g)):
            _assert_close(x, r)
        again = (risi18_bank(T, A, K), *risi18_bank_backward(T, A, K, g))
        torch.cuda.synchronize()
        for x, y in zip(got, again):
            assert torch.equal(x, y)


def test_bank_plans_stay_untiled_where_a_block_holds_the_field(cuda):
    """The planners try the plans that keep every row first, exactly as
    before the row tiles, and tile only where none fits: K4 from 36 rows
    (38 in bfloat16), K5 from 33 (from 22 at Cout = 32, which it holds in
    one panel: 23 in bfloat16).  The production shape keeps its plan
    (rows, panel, chunk, ring depth, bytes)."""
    for dtype, f4, f32, b32 in ((torch.float32, 36, 36, 22),
                                (torch.bfloat16, 38, 38, 23)):
        for C, Cout, first_fwd, first_bwd in ((4, 4, f4, 33),
                                              (32, 32, f32, b32)):
            for P in range(1, 65):
                fwd = bank_plan(64, P, C, Cout, dtype)
                bwd = bank_backward_plan(64, P, C, Cout, dtype)
                assert fwd["tiled"] == (P >= first_fwd), (P, C, Cout)
                assert bwd["tiled"] == (P >= first_bwd), (P, C, Cout)
                assert fwd["rows"] < P if fwd["tiled"] else fwd["rows"] == P
    assert bank_plan(256, 16, 32, 32) == dict(
        rows=16, panel=32, chunk=16, depth=3, smem_bytes=210928, tiled=0,
        pieces=1, cluster=0, tiles_per_block=1, mma=1, stream="cp_async")
    assert bank_backward_plan(256, 16, 32, 32) == dict(
        rows=16, panel=32, chunk=8, depth=4, smem_bytes=226960, tiled=0,
        pieces=1, cluster=0, tiles_per_block=1, mma=1, scratch_bytes=0,
        sums_smem_bytes=0, stream="cp_async", scatter="store")


def _bank_backward_in_chunks(T, A, K, g, chunk=32):
    """The plain backward of a bank over many vertices, 32 at a time (T is
    8.6 GB at N = 256, P = 64, C = 32 in float32): dT's chunks side by
    side, dK's added in float64, from the inputs cast up to float32 and
    rounded to their dtype once."""
    dTs, dK = [], None
    for v0 in range(0, T.shape[0], chunk):
        dT, part = risi18_bank_backward_reference(
            T[v0:v0 + chunk].float(), A[v0:v0 + chunk], K.float(),
            g[v0:v0 + chunk].float())
        dTs.append(dT.to(T.dtype))
        dK = part.double() if dK is None else dK + part.double()
    return torch.cat(dTs), dK.to(K.dtype)


@pytest.mark.parametrize("P,C,Cout", TILED_FIELDS)
def test_bank_backward_on_row_tiled_plans_at_every_cluster_size(
        cuda, dtype, P, C, Cout):
    """K5 kernel 1 on the row-tiled plans (on a cluster plan kernel 0's
    sums once a vertex and dT one pass a row tile) at every cluster size
    the rule picks, and at 140 and 256 vertices: against the plain
    backward, dT and dK the same bits from run to run, kernel 0 launched
    once a backward on a cluster plan and not otherwise, and the plan's
    scratch as kernel 0 lays it out."""
    for N in cluster_sizes(bank_backward_plan, P, C, Cout, dtype):
        plan = bank_backward_plan(N, P, C, Cout, dtype)
        assert plan["tiled"] == 1, plan
        # Kernel 0 and its scratch on a cluster plan; the one-block
        # row-tiled block forms its sums itself.
        clustered = plan["cluster"] > 0
        assert (plan["scratch_bytes"], plan["sums_smem_bytes"]) == (
            sums_bytes(N, P, Cout) if clustered else (0, 0)), plan
        T, A, K, g = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                             dtype=dtype)
        counts = (risi18_bank_backward.sums_launches,
                  risi18_bank_backward.launches)
        got = risi18_bank_backward(T, A, K, g)
        assert (risi18_bank_backward.sums_launches,
                risi18_bank_backward.launches) == (counts[0] + clustered,
                                                   counts[1] + 1)
        for x, r in zip(got, _bank_backward_in_chunks(T, A, K, g)):
            _assert_close(x, r)
        again = risi18_bank_backward(T, A, K, g)
        torch.cuda.synchronize()
        for x, y in zip(got, again):              # dT and dK, bit for bit
            assert torch.equal(x, y), (N, plan)
        del T, got, again
        torch.cuda.empty_cache()


@pytest.mark.parametrize("N,P,Cout", [(3, 33, 32), (2, 64, 3), (2, 64, 40),
                                      (1, 178, 32), (140, 37, 8)])
def test_bank_backward_sums_kernel_matches_plain(cuda, dtype, N, P, Cout):
    """Kernel 0 of K5 (GAp and the row sums GR, GAx, GSx of g) against its
    plain version: Cout of one partial pass (3), of one and two passes of
    32 (32, 40), the largest field K5 kernel 1 reaches (178), and more
    vertices than kernel 1 has vertex groups."""
    _, A, _, g = _inputs(N, P, 1, Cout, seed=P + Cout, device=cuda,
                         dtype=dtype)
    before = risi18_bank_backward.sums_launches
    got = risi18_bank_backward_sums(A, g)
    assert risi18_bank_backward.sums_launches == before + 1
    for x, r in zip(got, risi18_bank_backward_sums_reference(A, g)):
        assert x.shape == r.shape and x.dtype == torch.float32
        _assert_close(x, r)


def test_bank_reduce_matches_torch_and_repeats(cuda):
    """K5's kernel 2 sums 132 partial rows of 18C*Cout columns into dK:
    ``partial.sum(0)`` to float32 rounding, and the same bits every run."""
    for rows, C, Cout in ((132, 32, 32), (132, 5, 3), (7, 4, 4), (0, 2, 2)):
        partial = torch.randn((rows, 18 * C * Cout), device=cuda)
        dK = _backward_reduce_kernel(partial, C, Cout)
        again = _backward_reduce_kernel(partial, C, Cout)
        torch.cuda.synchronize()
        assert torch.equal(dK, again)
        ref = partial.double().sum(0).reshape(18 * C, Cout)
        assert float((dK.double() - ref).abs().max()) <= 1e-5 * max(
            1.0, float(ref.abs().max()))


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
