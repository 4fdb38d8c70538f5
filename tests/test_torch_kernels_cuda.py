"""The CUDA level kernels, forward (K1) and backward (K2), against their
plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a machine with
an NVIDIA GPU (sm_90a) and nvcc, run

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because the suite's conftest configures JAX, which the
port does not need).  The cases are those of ``chip_smoke.py`` phase 3:
inputs from a NumPy seed with mixed-sign adjacency, absent neighbours and
positions, and one vertex whose slots are all absent, in float32 and in
bfloat16 (state, K, b and the cotangent rounded to bfloat16; the adjacency
stays float32).
"""

import numpy as np
import pytest
import torch

from graphflow_tpu_torch.ops.risi_level import (
    _backward_reduce_kernel, alignment_of, level_backward_plan, level_plan,
    risi18_level, risi18_level_backward, risi18_level_backward_reference,
    risi18_level_backward_sums, risi18_level_backward_sums_reference,
    risi18_level_reference)
from graphflow_tpu_torch.tools.measure import same_signs
from graphflow_tpu_torch.utils.datasets import random_level_case

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# Summation order on the card differs from the plain version's; the bound
# is that of tests/test_fused_kernel.py:49-50.
RTOL = 1e-4
# bfloat16: kernel and plain version sum the same values in float32, in
# another order, and round once; they differ by a bfloat16 step or two
# (2^-8 relative each) where a sum lands near a rounding boundary.
RTOL_BF16 = 1e-2
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, P, C, Cout, seed, device, empty_vertex=None,
            dtype=torch.float32, repeated=False):
    """Seeded level inputs (random_level_case); ``repeated``: in three
    slots of each vertex one position repeats another's, so that two
    columns read one cell of the neighbour's row."""
    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=empty_vertex)
    if repeated:
        rng = np.random.default_rng(seed)
        for v in range(N):
            for a in rng.choice(P, size=3, replace=False):
                c, c2 = rng.choice(P, size=2, replace=False)
                d["pos"][v, a, c2] = d["pos"][v, a, c]
    f = {k: torch.as_tensor(d[k], dtype=torch.float32, device=device)
         for k in ("state", "radj", "K", "b")}
    i = {k: torch.as_tensor(d[k], dtype=torch.int32, device=device)
         for k in ("nbr", "pos")}
    return (f["state"].to(dtype), i["nbr"], i["pos"], f["radj"],
            f["K"].to(dtype), f["b"].to(dtype))


def _assert_close(got, ref):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype
    rtol = RTOL_BF16 if got.dtype == torch.bfloat16 else RTOL
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


# (12, 12, 40, 16) walks the channels in several chunks; the next four are the
# levels of a halving channel schedule, down to one channel.  The next two
# have more vertices than the backward has vertex groups (132), so that every
# block walks several vertices and carries its sums of dK and db along.  The
# next two have fields of 17 to 32 rows: a warp takes two rows of a staged
# slot, the chunk has four channels and the output goes in panels.  The last
# four are the product paths that the bank's kernels share with these
# (tests/test_torch_bank_cuda.py): the tensor cores at P = 12, the CUDA
# cores where P*P is no multiple of 16 (P = 7) or Cout no multiple of 8,
# two and twenty channels.
SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8), (5, 8, 8, 16),
          (12, 12, 40, 16), (256, 16, 32, 16), (256, 16, 16, 8),
          (64, 10, 2, 1), (32, 4, 1, 1), (600, 16, 32, 32), (600, 4, 8, 4),
          (6, 24, 8, 32), (4, 20, 12, 16), (24, 12, 20, 24), (24, 7, 8, 8),
          (16, 16, 2, 20), (8, 4, 20, 3)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,C,Cout", SHAPES)
def test_level_kernel_matches_plain(cuda, N, P, C, Cout, dtype):
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2, dtype=dtype)
    before = risi18_level.launches
    got = risi18_level(*args)
    assert risi18_level.launches == before + 1
    assert got.shape == (N, P * P, Cout) and got.dtype == dtype
    _assert_close(got, risi18_level_reference(*args))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,C,Cout", [(3, 33, 4, 32), (2, 34, 8, 4),
                                        (2, 35, 5, 3)])
def test_level_kernel_streams_fields_of_more_than_32_rows(cuda, N, P, C,
                                                          Cout, dtype):
    """Beyond 32 rows a thread's cells of a staged slot no longer fit its
    registers, and the forward sums them in shared memory
    (``stream_reductions_wide``), in chunks of four channels; P=35 is the
    last field whose maps fit one block."""
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2, dtype=dtype)
    _assert_close(risi18_level(*args), risi18_level_reference(*args))


@pytest.mark.parametrize("N,P,C,Cout", [(64, 10, 20, 20), (32, 4, 8, 8),
                                        (256, 16, 32, 16)])
def test_level_kernel_bfloat16_tracks_the_float32_kernel(cuda, N, P, C, Cout):
    """The float32 kernel on the rounded inputs, rounded once, is what the
    bfloat16 kernel computes up to the order of its float32 sums."""
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2, dtype=torch.bfloat16)
    up = [t.float() if t.is_floating_point() else t for t in args]
    _assert_close(risi18_level(*args), risi18_level(*up).bfloat16())


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_level_kernel_negative_adjacency(cuda, dtype):
    """All-negative adjacency zeroes every adjacency-weighted case."""
    state, nbr, pos, radj, K, b = _inputs(16, 8, 8, 8, seed=3, device=cuda,
                                          dtype=dtype)
    radj = -radj.abs() - 0.1
    got = risi18_level(state, nbr, pos, radj, K, b)
    _assert_close(got, risi18_level_reference(state, nbr, pos, radj, K, b))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_level_kernel_all_absent_vertex_is_bias_only(cuda, dtype):
    state, nbr, pos, radj, K, b = _inputs(8, 4, 8, 8, seed=5, device=cuda,
                                          empty_vertex=2, dtype=dtype)
    got = risi18_level(state, nbr, pos, radj, K, b)
    torch.cuda.synchronize()
    # LeakyReLU in float32, rounded once to the output's dtype.
    bias = torch.where(b.float() > 0, b.float(), 0.01 * b.float()).to(dtype)
    np.testing.assert_array_equal(got[2].float().cpu().numpy(),
                                  bias.expand(16, 8).float().cpu().numpy())


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


def test_level_kernel_takes_float32_and_bfloat16_only(cuda):
    """One type for state, K and b; the adjacency in float32; anything else
    raises and nothing launches."""
    state, nbr, pos, radj, K, b = _inputs(4, 4, 8, 8, seed=7, device=cuda)
    s16, K16, b16 = state.bfloat16(), K.bfloat16(), b.bfloat16()
    before = risi18_level.launches
    for bad in ((state.half(), nbr, pos, radj, K.half(), b.half()),
                (s16, nbr, pos, radj, K, b16),          # mixed state and K
                (state, nbr, pos, radj, K16, b),
                (s16, nbr, pos, radj, K16, b),          # mixed K and b
                (s16, nbr, pos, radj.bfloat16(), K16, b16),
                (s16, nbr, pos, radj.double(), K16, b16)):
        with pytest.raises(TypeError):
            risi18_level(*bad)
    with pytest.raises(ValueError):                     # not contiguous
        risi18_level(s16.transpose(1, 2), nbr, pos, radj, K16, b16)
    assert risi18_level.launches == before
    # A contiguous bfloat16 view that starts at an odd element (2-byte
    # aligned only) is read element by element and still agrees.
    flat = torch.empty(s16.numel() + 1, dtype=torch.bfloat16, device=cuda)
    view = flat[1:].view(s16.shape)
    view.copy_(s16)
    assert view.is_contiguous() and view.data_ptr() % 4 != 0
    got = risi18_level(view, nbr, pos, radj, K16, b16)
    torch.cuda.synchronize()
    assert torch.equal(got, risi18_level(s16, nbr, pos, radj, K16, b16))


def test_level_kernel_rejects_shapes_beyond_shared_memory(cuda):
    """The maps and Z of a tile of rows live in shared memory beside the
    vertex's adjacency and positions [P, P]: P=64 at Cout=32, whose maps
    and Z one block could not hold, runs in row tiles; P=157 leaves no room
    even for tiles of one row, and the launch is refused with an error,
    not run."""
    args = _inputs(2, 64, 4, 32, seed=8, device=cuda)
    _assert_close(risi18_level(*args), risi18_level_reference(*args))
    args = _inputs(1, 157, 1, 32, seed=8, device=cuda)
    before = risi18_level.launches
    with pytest.raises(RuntimeError, match="P=157 at Cout=32 needs 233376 "
                                           "bytes .* shared memory"):
        risi18_level(*args)
    assert risi18_level.launches == before


def test_backward_kernel_rejects_shapes_beyond_shared_memory(cuda):
    """G and G.Ap of a tile of rows live in shared memory beside the maps:
    P=33 at Cout=32, the first field whose rows one block's maps and G do
    not hold, runs in row tiles, and so does P=64; P=154 leaves no room even
    for tiles of one row and is refused with its bytes."""
    for P in (33, 64):
        args = _inputs(2, P, 4, 32, seed=8, device=cuda)
        _check_backward(args, _cotangent(2, P, 32, seed=8, device=cuda))
    args = _inputs(1, 154, 1, 32, seed=8, device=cuda)
    out = torch.ones((1, 154 * 154, 32), device=cuda)
    before = (risi18_level.launches, risi18_level_backward.launches)
    with pytest.raises(RuntimeError, match="P=154 at Cout=32 needs 233840 "
                                           "bytes .* shared memory"):
        risi18_level_backward(*args, out, torch.ones_like(out))
    assert (risi18_level.launches, risi18_level_backward.launches) == before


# Fields that one block's maps do not hold: the cluster plans (K2 from 33
# rows, K1 from 36; at P = 40 and Cout = 32 K1 on the CUDA cores, at 64 on
# the tensor cores), at SMP_beta's width (C = Cout = 32) and a narrow one,
# with chunks that do not divide C; three vertices, one of them empty.
LARGE = [(3, P, C, Cout) for P in (33, 36, 40, 48, 64)
         for C, Cout in ((5, 4), (32, 32))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,C,Cout", LARGE)
def test_level_kernels_on_fields_beyond_one_block(cuda, N, P, C, Cout,
                                                  dtype):
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2, dtype=dtype)
    before = risi18_level.launches
    out = risi18_level(*args)
    assert risi18_level.launches == before + 1
    _assert_close(out, risi18_level_reference(*args))
    got = _check_backward(args, _cotangent(N, P, Cout, seed=N, device=cuda,
                                           dtype=dtype))
    again = risi18_level_backward(*args, same_signs(
        risi18_level(*args), risi18_level_reference(*args)),
        _cotangent(N, P, Cout, seed=N, device=cuda, dtype=dtype))
    torch.cuda.synchronize()
    assert torch.equal(out, risi18_level(*args))
    for x, y in zip(got[1:], again[1:]):      # dK and db, bit for bit
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("C,Cout", [(4, 4), (8, 8)])
@pytest.mark.parametrize("P", [33, 36, 64])
def test_level_kernels_walk_several_vertices_of_a_tiled_field(cuda, P, C,
                                                             Cout, dtype):
    """140 vertices, more than the backward's 132 vertex groups: the blocks
    of kernel 1 walk two vertices each and carry dK, db and their buffers
    from one to the next (K1 tiles from 36 rows).  132 groups already fill
    the card, so kernel 1 takes a cluster of one block where dK runs on the
    tensor cores (8 channels a chunk: P = 36 in both dtypes), else the
    row-tiled block one a vertex group (4 channels a chunk)."""
    N = 140
    plan = level_backward_plan(N, P, C, Cout, dtype)
    assert plan["tiled"] == 1 and plan["cluster"] in (0, 1), plan
    assert plan["cluster"] == plan["mma"], plan
    if (P, C) == (36, 8):
        assert plan["cluster"] == 1, plan
    args = _inputs(N, P, C, Cout, seed=P, device=cuda, empty_vertex=N // 2,
                   dtype=dtype)
    _assert_close(risi18_level(*args), risi18_level_reference(*args))
    _check_backward(args, _cotangent(N, P, Cout, seed=P, device=cuda,
                                     dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_level_kernels_run_at_the_edge_of_their_reach(cuda, dtype):
    """The last fields whose tiles of one row fit a block at Cout = 32:
    K1 at P = 156 and K2 kernel 1 at P = 153 run and match."""
    args = _inputs(1, 156, 1, 32, seed=156, device=cuda, dtype=dtype)
    assert level_plan(1, 156, 1, 32, dtype)["rows"] >= 1
    assert level_plan(1, 156, 1, 32, dtype)["cluster"] == 8
    _assert_close(risi18_level(*args), risi18_level_reference(*args))
    assert level_backward_plan(1, 153, 1, 32, dtype)["cluster"] == 8
    # (check_smem refuses by the float32 plan's bytes: P = 157 and 154.)
    assert level_plan(1, 157, 1, 32) is None
    assert level_backward_plan(1, 154, 1, 32) is None
    args = _inputs(1, 153, 1, 32, seed=153, device=cuda, dtype=dtype)
    _check_backward(args, _cotangent(1, 153, 32, seed=153, device=cuda,
                                     dtype=dtype))


def test_level_plans_stay_untiled_where_a_block_holds_the_field(cuda):
    """The planners try the plans that keep every row first, exactly as
    before the row tiles, and tile only where none fits: K1 from 36 rows
    (37 in bfloat16), K2 from 33.  The production shape keeps its plan
    (rows, panel, chunk, ring depth, bytes)."""
    for dtype, first_fwd in ((torch.float32, 36), (torch.bfloat16, 37)):
        for C, Cout in ((4, 4), (32, 32), (16, 8)):
            for P in range(1, 65):
                fwd = level_plan(64, P, C, Cout, dtype)
                bwd = level_backward_plan(64, P, C, Cout, dtype)
                assert fwd["tiled"] == (P >= first_fwd), (P, C, Cout)
                assert bwd["tiled"] == (P >= 33), (P, C, Cout)
                assert fwd["rows"] < P if fwd["tiled"] else fwd["rows"] == P
    assert level_plan(256, 16, 32, 32) == dict(rows=16, panel=32, chunk=16,
                                          depth=3, smem_bytes=212096,
                                          tiled=0, pieces=1, cluster=0,
                                          tiles_per_block=1, mma=1,
                                          stream="cp_async")
    assert level_backward_plan(256, 16, 32, 32) == dict(
        rows=16, panel=32, chunk=8, depth=4, smem_bytes=230848, tiled=0,
        pieces=1, cluster=0, tiles_per_block=1, mma=1, scratch_bytes=0,
        sums_smem_bytes=0, stream="cp_async", scatter="atomic")


def cluster_rounds(tiles, blocks, per, grid, sms=132):
    """The rounds of clusters one SM a block runs one after another, times
    the tiles a block takes: what ``csrc/risi18_level_common.cuh:
    cluster_shape`` makes least (of equal counts, the fewest blocks)."""
    return -(-grid // (sms // blocks)) * per


def check_cluster_plan(plan, P, grid, backward=False):
    """A row-tiled plan is a cluster plan of at most 8 blocks, each with its
    share of the tiles and as few blocks as that share needs, and no other
    shape of at most 8 blocks runs fewer rounds of tiles for ``grid``
    clusters, nor as few with fewer blocks; an untiled plan has none.  A
    backward plan whose cluster would be one block with dK on the CUDA
    cores is the row-tiled block of one block a vertex group instead
    (``cluster`` 0, ``mma`` 0)."""
    if not plan["tiled"] or (backward and plan["cluster"] == 0):
        assert plan["cluster"] == 0 and not (plan["tiled"] and plan["mma"]), \
            plan
        return
    tiles = -(-P // plan["rows"])
    per, blocks = plan["tiles_per_block"], plan["cluster"]
    assert 1 <= blocks <= 8 and per >= -(-tiles // 8), plan
    assert blocks == -(-tiles // per), plan
    best = cluster_rounds(tiles, blocks, per, grid)
    for cap in range(1, 9):
        p = -(-tiles // cap)
        b = -(-tiles // p)
        cost = cluster_rounds(tiles, b, p, grid)
        assert cost > best or (cost == best and b >= blocks), (plan, cap)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_level_plans_report_their_clusters(cuda, dtype):
    """Every row-tiled plan of K1 and K2 kernel 1 is a cluster plan sized
    for N: the fewest rounds of tiles on the card's 132 SMs, where a
    cluster's blocks split a vertex's tiles (the grid: vertices x panels
    forward, vertex groups x chunks x panels backward), but a backward one
    that would be one block on the CUDA cores; an untiled plan has none.
    SMP_beta's field at C = Cout = 32 spreads one vertex over 8 blocks of
    2 tiles, a batch of 64 vertices over 2 blocks of 8 tiles forward and
    one block backward (64 groups x 4 chunks already fill the
    card twice), and a batch of 256 over one block in both directions."""
    for C, Cout in ((4, 4), (32, 32), (16, 8)):
        for P in list(range(30, 65)) + [100, 153]:
            for N in (1, 64, 140, 160, 256):
                fwd = level_plan(N, P, C, Cout, dtype)
                check_cluster_plan(fwd, P, N * -(-Cout // fwd["panel"]))
                bwd = level_backward_plan(N, P, C, Cout, dtype)
                check_cluster_plan(bwd, P, min(N, 132) * -(-C // bwd["chunk"])
                                   * -(-Cout // bwd["panel"]), backward=True)
    for N, fwd, bwd in ((1, (8, 2), (8, 2)), (64, (2, 8), (1, 16)),
                        (256, (1, 16), (1, 16))):
        for plan, want in ((level_plan(N, 64, 32, 32, dtype), fwd),
                           (level_backward_plan(N, 64, 32, 32, dtype), bwd)):
            assert (plan["rows"], plan["cluster"], plan["tiles_per_block"],
                    plan["mma"]) == (4, *want, 1), (N, plan)


def sums_bytes(N, P, Cout):
    """Kernel 0's float32 scratch for N vertices (GAp and the three row
    sums) and its shared memory a block (the adjacency, R, and up to eight
    rows of G, 32 outputs a pass, as many as 227 KB hold), by its layout in
    ``csrc/risi18_backward_block.cuh``."""
    up4 = lambda x: -(-x // 4) * 4
    fixed = up4(P * (P + 1)) + up4(P)
    rows = min(8, (232448 // 4 - fixed) // (P * 32))
    return (4 * N * (P * P + 3 * P) * Cout, 4 * (fixed + rows * P * 32))


def cluster_sizes(plan_fn, P, C, Cout, dtype, most=300):
    """{cluster of the plan (0: the row-tiled block one a vertex group):
    the least N <= most whose plan takes it}, with N = 140 and 256 added
    under their own keys: the N that put the size rule on every cluster
    size it picks."""
    sizes = {}
    for N in range(1, most + 1):
        sizes.setdefault(plan_fn(N, P, C, Cout, dtype)["cluster"], N)
    return sorted(set(sizes.values()) | {140, 256})


# The row-tiled plans' fields (K2 kernel 1 and K5 kernel 1): P = 33 and 50
# are the row-tiled block one a vertex group at N >= 12 and 14, 37 and 40
# clusters of up to 5 blocks, 64 SMP_beta's field (clusters of 1, 2, 3,
# 4, 6 and 8); Cout = 3 takes kernel 0's and the dT maps' partial rows.
TILED_FIELDS = [(P, 32, 32) for P in (33, 37, 40, 50, 64)] + [(33, 5, 3),
                                                               (64, 5, 3)]


def _level_in_chunks(args, chunk=32):
    """The plain level's output, 32 vertices at a time (its gathered T at
    N = 256, P = 64, C = 32 is 8.6 GB in float32)."""
    state, nbr, pos, radj, K, b = args
    return torch.cat([risi18_level_reference(
        state, nbr[v0:v0 + chunk], pos[v0:v0 + chunk], radj[v0:v0 + chunk],
        K, b) for v0 in range(0, state.shape[0], chunk)])


def _level_backward_in_chunks(args, g, chunk=32):
    """The plain backward of a level with many vertices, 32 at a time:
    every chunk's dstate, dK and db added in float64, computed from the
    inputs cast up to float32 and rounded to the inputs' dtype once."""
    state, nbr, pos, radj, K, b = args
    up = lambda t: t.float() if t.is_floating_point() else t
    total = None
    for v0 in range(0, state.shape[0], chunk):
        part = risi18_level_backward_reference(
            up(state), nbr[v0:v0 + chunk], pos[v0:v0 + chunk],
            radj[v0:v0 + chunk], up(K), up(b), up(g[v0:v0 + chunk]))
        part = [x.double() for x in part]
        total = part if total is None else [t + x for t, x in zip(total,
                                                                  part)]
    return [t.to(p.dtype) for t, p in zip(total, (state, K, b))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("P,C,Cout", TILED_FIELDS)
def test_backward_kernel_on_row_tiled_plans_at_every_cluster_size(
        cuda, P, C, Cout, dtype):
    """K2 kernel 1 on the row-tiled plans (on a cluster plan kernel 0's
    sums once a vertex and dT one pass a row tile) at every cluster size
    the rule picks, and at 140 and 256 vertices: against the plain backward
    (dstate, dK, db), dK and db the same bits from run to run, kernel 0
    launched once a backward on a cluster plan and not otherwise, and the
    plan's scratch as kernel 0 lays it out."""
    for N in cluster_sizes(level_backward_plan, P, C, Cout, dtype):
        plan = level_backward_plan(N, P, C, Cout, dtype)
        assert plan["tiled"] == 1, plan
        # Kernel 0 and its scratch on a cluster plan; the one-block
        # row-tiled block forms its sums itself.
        clustered = plan["cluster"] > 0
        assert (plan["scratch_bytes"], plan["sums_smem_bytes"]) == (
            sums_bytes(N, P, Cout) if clustered else (0, 0)), plan
        args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                       empty_vertex=N // 2, dtype=dtype)
        g = _cotangent(N, P, Cout, seed=N, device=cuda, dtype=dtype)
        # LeakyReLU' reads the sign of ``out``: both sides get one.
        out = same_signs(risi18_level(*args), _level_in_chunks(args))
        counts = (risi18_level_backward.sums_launches,
                  risi18_level_backward.launches)
        assert plan["stream"] == expected_stream(plan, P, C, dtype), plan
        got = risi18_level_backward(*args, out, g)
        assert (risi18_level_backward.sums_launches,
                risi18_level_backward.launches) == (counts[0] + clustered,
                                                    counts[1] + 1)
        for x, r in zip(got, _level_backward_in_chunks(args, g)):
            _assert_close(x, r)
        again = risi18_level_backward(*args, out, g)
        torch.cuda.synchronize()
        for x, y in zip(got[1:], again[1:]):      # dK and db, bit for bit
            assert torch.equal(x, y), (N, plan)


def tile_regs(P, rows, ncp):
    """``csrc/risi18_level_common.cuh:tile_regs``: a warp reduces one row
    of each stage, its lanes' cells of the row in registers."""
    return rows <= 16 and -(-P // (32 // (ncp // 4))) <= 4


def expected_stream(plan, P, C, dtype, aligned=16):
    """The route a K1 or K2 plan must name: ``"tma_producer"`` (a producer
    warp issues one tensor copy a gathered row, 15 warps at most reduce) on
    a cluster plan whose warps reduce a row each, whose row tile has at most
    15 rows, whose box of ncp channels and state rows of C channels are
    multiples of 16 bytes, over a 16-byte aligned state; else
    ``"cp_async"``.  A stage of the producer route holds a row for each of
    its reducing warps (15 // rows pieces), the cp.async route's for each
    of the 16 warps."""
    es = 2 if dtype == torch.bfloat16 else 4
    ncp = 4 if plan["chunk"] <= 4 else 8 if plan["chunk"] <= 8 else 16
    tma = (plan["cluster"] > 0 and tile_regs(P, plan["rows"], ncp)
           and plan["rows"] < 16 and ncp * es % 16 == 0 and C * es % 16 == 0
           and aligned % 16 == 0)
    if tma:
        assert plan["pieces"] <= 15 // plan["rows"], plan
    return "tma_producer" if tma else "cp_async"


def expected_scatter(plan, C):
    """The scatter a K2 kernel 1 plan must name: ``"tma_reduce"`` (each
    gathered row's dT staged in the neighbour's storage order, one tensor
    reduce a row into the float32 dstate) on a cluster plan whose rows of C
    float32 channels are multiples of 16 bytes, whose chunk has more than 4
    channels (whole 32-byte sectors a cell) and whose row tile has at most
    8 rows (two warps or more a row b; the warps' staging buffers fit at
    every field tested here); else ``"atomic"`` (the untiled plans and the
    row-tiled block of one block a vertex group too)."""
    return ("tma_reduce" if plan["cluster"] > 0 and C % 4 == 0
            and plan["chunk"] > 4 and plan["rows"] <= 8 else "atomic")


# K1 and K2 kernel 1 on both routes of the stream: C = 32 and 8 (and 4 in
# float32) take the tensor copies on a cluster plan, C = 3 and 1 and C = 4
# in bfloat16 (a box of 8 bytes) take cp.async; and K2 kernel 1 on both
# routes of its scatter: C = 32 and 8 (in both dtypes: dstate is float32)
# stage rows for tensor reduces on a cluster plan in tiles of at most 8
# rows, tiles of more rows (P = 37, 40, 50 at C = 8), C = 4 (cells of 16
# bytes) and C = 3 and 1 take the atomics.  Three slots of every vertex
# repeat a position, so that the producer route's consumers read a cell
# that two columns share (a whole slot's weight 2) and a staged row adds
# two columns into one cell.
ROUTE_FIELDS = [(P, C, Cout) for P in (33, 37, 40, 50, 64)
                for C, Cout in ((32, 32), (8, 8), (4, 4), (3, 4), (1, 4))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("P,C,Cout", ROUTE_FIELDS)
def test_level_kernels_on_both_stream_routes_at_every_cluster_size(
        cuda, P, C, Cout, dtype):
    """K1 at every cluster size its size rule picks for this field, and
    at 140 and 256 vertices (absent neighbours and positions, repeated
    positions, an empty vertex), against the plain level, its output the
    same bits from run to run, its plan naming the route the rule gives and
    the route's launch counted as the plan names it; K2 kernel 1 the same
    at its own cluster sizes (dstate, dK, db; dK and db bit for bit), its
    plan naming the scatter the rule gives and the launch counted on it."""
    for N in cluster_sizes(level_plan, P, C, Cout, dtype):
        plan = level_plan(N, P, C, Cout, dtype)
        assert plan["stream"] == expected_stream(plan, P, C, dtype), plan
        args = _inputs(N, P, C, Cout, seed=N + P + C, device=cuda,
                       empty_vertex=N // 2, dtype=dtype, repeated=True)
        before = risi18_level.tma_launches
        out = risi18_level(*args)
        assert risi18_level.tma_launches - before == (
            plan["stream"] == "tma_producer"), plan
        _assert_close(out, _level_in_chunks(args))
        assert torch.equal(out, risi18_level(*args)), (N, plan)
    for N in cluster_sizes(level_backward_plan, P, C, Cout, dtype):
        plan = level_backward_plan(N, P, C, Cout, dtype)
        assert plan["stream"] == expected_stream(plan, P, C, dtype), plan
        assert plan["scatter"] == expected_scatter(plan, C), plan
        args = _inputs(N, P, C, Cout, seed=N + P + C, device=cuda,
                       empty_vertex=N // 2, dtype=dtype, repeated=True)
        g = _cotangent(N, P, Cout, seed=N, device=cuda, dtype=dtype)
        out = same_signs(risi18_level(*args), _level_in_chunks(args))
        before = (risi18_level_backward.tma_launches,
                  risi18_level_backward.scatter_tma_launches)
        got = risi18_level_backward(*args, out, g)
        assert (risi18_level_backward.tma_launches - before[0],
                risi18_level_backward.scatter_tma_launches - before[1]) == (
            plan["stream"] == "tma_producer",
            plan["scatter"] == "tma_reduce"), plan
        for x, r in zip(got, _level_backward_in_chunks(args, g)):
            _assert_close(x, r)
        again = risi18_level_backward(*args, out, g)
        torch.cuda.synchronize()
        for x, y in zip(got[1:], again[1:]):
            assert torch.equal(x, y), (N, plan)


# K2 kernel 1 untiled (fields one block holds): its plans keep the
# atomics (staged over the stream's ring, rows of P = 16 cells measured
# slower on an H100), repeated positions and all.
UNTILED_SCATTER = [(256, 16, 32, 32), (64, 16, 8, 8), (64, 10, 4, 4),
                   (64, 16, 3, 4), (32, 4, 8, 8)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,C,Cout", UNTILED_SCATTER)
def test_backward_kernel_untiled_scatters_repeated_positions(cuda, N, P, C,
                                                            Cout, dtype):
    """K2 kernel 1 on its untiled plans, with absent neighbours and
    positions, three repeated positions a vertex and an empty vertex,
    against the plain backward (dstate, dK, db), dK and db the same bits
    from run to run, its plan naming the atomics and no launch counted on
    the staged scatter."""
    plan = level_backward_plan(N, P, C, Cout, dtype)
    assert plan["tiled"] == 0 and plan["cluster"] == 0, plan
    assert plan["scatter"] == expected_scatter(plan, C), plan
    args = _inputs(N, P, C, Cout, seed=N + P + C, device=cuda,
                   empty_vertex=N // 2, dtype=dtype, repeated=True)
    g = _cotangent(N, P, Cout, seed=N, device=cuda, dtype=dtype)
    out = same_signs(risi18_level(*args), risi18_level_reference(*args))
    before = risi18_level_backward.scatter_tma_launches
    got = risi18_level_backward(*args, out, g)
    assert risi18_level_backward.scatter_tma_launches - before == (
        plan["scatter"] == "tma_reduce"), plan
    for x, r in zip(got, risi18_level_backward_reference(*args, g)):
        _assert_close(x, r)
    again = risi18_level_backward(*args, out, g)
    torch.cuda.synchronize()
    for x, y in zip(got[1:], again[1:]):
        assert torch.equal(x, y), plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_level_kernels_on_an_unaligned_state_take_the_route_named(cuda,
                                                                  dtype):
    """A contiguous state view that starts 4 bytes (2 in bfloat16) past a
    16-byte boundary takes the cp.async route that the plan query names for
    its alignment, one 16 bytes past takes the tensor copies, and both give
    the aligned state's output, dK and db bit for bit where the plans agree
    in every field, the route included (the same sums in the same order),
    else within the kernels' bounds: the tensor-copy route sums a whole
    slot's rows outside its tile in storage order, and its stage holds a
    row for each of 15 warps, the cp.async route's for each of 16."""
    N, P, C, Cout = 6, 64, 32, 32
    args = _inputs(N, P, C, Cout, seed=11, device=cuda, empty_vertex=2,
                   dtype=dtype)
    g = _cotangent(N, P, Cout, seed=11, device=cuda, dtype=dtype)
    state = args[0]
    ref_out = risi18_level(*args)
    out = same_signs(ref_out, _level_in_chunks(args))
    ref = risi18_level_backward(*args, out, g)
    base = level_plan(N, P, C, Cout, dtype)
    assert base["stream"] == "tma_producer", base
    step = 16 // state.element_size()
    for shift, want in ((1, "cp_async"), (step, "tma_producer")):
        flat = torch.empty(state.numel() + shift, dtype=dtype, device=cuda)
        view = flat[shift:].view(state.shape)
        view.copy_(state)
        aligned = alignment_of(view)
        assert view.is_contiguous() and aligned == (16 if shift == step
                                                    else 16 // step)
        for query in (level_plan, level_backward_plan):
            plan = query(N, P, C, Cout, dtype, aligned)
            assert plan["stream"] == want == expected_stream(
                plan, P, C, dtype, aligned), plan
        got_out = risi18_level(view, *args[1:])
        got = risi18_level_backward(view, *args[1:], out, g)
        torch.cuda.synchronize()
        same = level_plan(N, P, C, Cout, dtype, aligned) == base
        assert same == (want == "tma_producer")
        if same:
            assert torch.equal(got_out, ref_out)
            for x, y in zip(got[1:], ref[1:]):
                assert torch.equal(x, y)
        _assert_close(got_out, _level_in_chunks(args))
        for x, r in zip(got, _level_backward_in_chunks(args, g)):
            _assert_close(x, r)


# The shared memory of K1's and K2 kernel 1's cluster plans at P = 64,
# C = Cout = 32 (tiles of 4 rows, chunks of 8, 3 pieces a stage for the 12
# reducing warps), with the ring's full and empty mbarriers, the piece list
# and the whole slots' weights, and the ring aligned to 128 bytes for the
# tensor copies; the same at every N.  The cp.async plan of a state 4
# bytes past a 16-byte boundary has the same tiles and chunk, and 4 pieces
# a stage, one row for each of the 16 warps.
TMA_BYTES = {torch.float32: {"forward": 217312, "backward": 225312},
             torch.bfloat16: {"forward": 168160, "backward": 225312}}


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_level_plans_name_their_route_and_bytes(cuda, dtype):
    """SMP_beta's field (P = 64, C = Cout = 32) on K1's and K2 kernel 1's
    cluster plans takes the tensor copies from a producer warp at every N,
    a row of a stage for each of 15 // rows reducing warps' pieces, with
    the mbarriers, the piece list, the weights and the ring's 128-byte
    alignment counted in its bytes; the untiled plans, the bank's (K4, K5:
    stored slots) and narrow chunks in bfloat16 take cp.async.  K2 kernel
    1's cluster plans there stage dT's rows for tensor reduces over G, in
    the same bytes; C = 3 (rows of 12 bytes) and the untiled plans keep the
    atomics, and K5 writes dT."""
    from graphflow_tpu_torch.ops.risi_bank import bank_backward_plan, bank_plan

    for N in (1, 64, 140, 256):
        for query in (level_plan, level_backward_plan):
            plan = query(N, 64, 32, 32, dtype)
            assert plan["cluster"] >= 1, plan
            assert plan["stream"] == "tma_producer", plan
            assert plan["smem_bytes"] == TMA_BYTES[dtype][
                "backward" if "scratch_bytes" in plan else "forward"], plan
            assert plan["pieces"] == 15 // plan["rows"] == 3, plan
            other = query(N, 64, 32, 32, dtype, 4)
            assert other["stream"] == "cp_async", other
            assert (other["rows"], other["chunk"], other["pieces"]) == (
                plan["rows"], plan["chunk"], 16 // plan["rows"]), other
            if query is level_backward_plan:
                assert plan["scatter"] == other["scatter"] == "tma_reduce"
                assert level_backward_plan(N, 64, 3, 4, dtype)[
                    "scatter"] == "atomic"
        for plan in (bank_plan(N, 64, 32, 32, dtype),
                     bank_backward_plan(N, 64, 32, 32, dtype)):
            assert plan["stream"] == "cp_async", plan
        assert bank_backward_plan(N, 64, 32, 32, dtype)["scatter"] == "store"
    assert level_backward_plan(256, 16, 32, 32, dtype)["scatter"] == "atomic"
    assert level_plan(256, 16, 32, 32, dtype)["stream"] == "cp_async"
    assert level_backward_plan(64, 64, 4, 4, dtype)["stream"] == (
        "tma_producer" if dtype == torch.float32 else "cp_async")
    # K1's plan there passes over row tiles of 16 rows, which leave no warp
    # for the producer, for tiles of 4 on the tensor copies in float32; in
    # bfloat16 (a box of 8 bytes) it keeps 16 rows on cp.async.
    plan = level_plan(64, 64, 4, 4, dtype)
    assert (plan["rows"], plan["stream"]) == (
        (4, "tma_producer") if dtype == torch.float32 else (16, "cp_async")
    ), plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,Cout", [(3, 33, 32), (2, 64, 3), (2, 64, 40),
                                      (1, 153, 32), (140, 37, 8)])
def test_backward_sums_kernel_matches_plain(cuda, N, P, Cout, dtype):
    """Kernel 0 of K2 (GAp and the row sums GR, GAx, GSx of geff) against
    its plain version: Cout of one partial pass (3), of one and two passes
    of 32 (32, 40), the largest field K2 kernel 1 reaches (153), and more
    vertices than kernel 1 has vertex groups."""
    args = _inputs(N, P, 4, Cout, seed=P + Cout, device=cuda,
                   empty_vertex=N // 2, dtype=dtype)
    g = _cotangent(N, P, Cout, seed=P, device=cuda, dtype=dtype)
    out = same_signs(risi18_level(*args), risi18_level_reference(*args))
    before = risi18_level_backward.sums_launches
    got = risi18_level_backward_sums(args[3], g, out)
    assert risi18_level_backward.sums_launches == before + 1
    ref = risi18_level_backward_sums_reference(args[3], g, out)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.float32
        # Both sides sum float32 values from the same inputs.
        _assert_close(x, r)


@pytest.mark.parametrize("C,Cout", [(32, 32), (5, 3), (1, 1)])
def test_backward_reduce_matches_torch_and_repeats(cuda, C, Cout):
    """Kernel 2 sums the partial rows (132 at N >= 132) into dK and db:
    ``partial.sum(0)`` to float32 rounding, the same bits every run, and
    zeros without rows."""
    for rows in (132, 7, 0):
        partial = torch.randn((rows, 18 * C * Cout + Cout), device=cuda)
        dK, db = _backward_reduce_kernel(partial, C, Cout)
        dK2, db2 = _backward_reduce_kernel(partial, C, Cout)
        torch.cuda.synchronize()
        assert torch.equal(dK, dK2) and torch.equal(db, db2)
        ref = partial.double().sum(0)
        got = torch.cat([dK.flatten(), db]).double()
        assert float((got - ref).abs().max()) <= 1e-5 * max(
            1.0, float(ref.abs().max()))


# -- K2, the level backward -------------------------------------------------

def _cotangent(N, P, Cout, seed, device, dtype=torch.float32):
    g = np.random.default_rng(seed).normal(size=(N, P * P, Cout))
    return torch.as_tensor(g, dtype=torch.float32, device=device).to(dtype)


def _check_backward(args, g):
    counts = (risi18_level_backward.launches,
              risi18_level_backward.reduce_launches)
    # LeakyReLU' reads the sign of ``out``: both sides get one.
    out = same_signs(risi18_level(*args), risi18_level_reference(*args))
    got = risi18_level_backward(*args, out, g)
    assert (risi18_level_backward.launches,
            risi18_level_backward.reduce_launches) == (counts[0] + 1,
                                                       counts[1] + 1)
    ref = risi18_level_backward_reference(*args, g)
    for x, r, param in zip(got, ref, (args[0], args[4], args[5])):
        assert x.shape == r.shape and x.dtype == param.dtype
        _assert_close(x, r)
    return got


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,C,Cout", SHAPES)
def test_backward_kernel_matches_plain(cuda, N, P, C, Cout, dtype):
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2, dtype=dtype)
    _check_backward(args, _cotangent(N, P, Cout, seed=N, device=cuda,
                                     dtype=dtype))


@pytest.mark.parametrize("N,P,C,Cout", [(64, 10, 20, 20), (32, 4, 8, 8),
                                        (256, 16, 32, 16)])
def test_backward_kernel_bfloat16_tracks_the_float32_kernels(cuda, N, P, C,
                                                             Cout):
    """The float32 kernels on the rounded inputs and the float32 view of
    the bfloat16 output: the same geff, the same float32 sums."""
    bf16 = torch.bfloat16
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2, dtype=bf16)
    g = _cotangent(N, P, Cout, seed=N, device=cuda, dtype=bf16)
    out = risi18_level(*args)
    got = risi18_level_backward(*args, out, g)
    up = [t.float() if t.is_floating_point() else t for t in args]
    ref = risi18_level_backward(*up, out.float(), g.float())
    for x, r in zip(got, ref):
        _assert_close(x, r.to(bf16))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_backward_kernel_negative_adjacency(cuda, dtype):
    state, nbr, pos, radj, K, b = _inputs(16, 8, 8, 8, seed=3, device=cuda,
                                          dtype=dtype)
    radj = -radj.abs() - 0.1
    _check_backward((state, nbr, pos, radj, K, b),
                    _cotangent(16, 8, 8, seed=3, device=cuda, dtype=dtype))


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


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("N,P,C,Cout", [(256, 16, 32, 32), (600, 4, 8, 4),
                                        (24, 7, 8, 8), (8, 64, 32, 32),
                                        (6, 40, 32, 32)])
def test_level_kernels_repeat_bit_for_bit(cuda, N, P, C, Cout, dtype):
    """K1's output and K2's dK and db come out the same from run to run
    (the partial rows are summed in a fixed order, and on a cluster plan
    the blocks' parts in rank order); dstate is summed by atomics and
    agrees to rounding only."""
    args = _inputs(N, P, C, Cout, seed=N + P, device=cuda,
                   empty_vertex=N // 2, dtype=dtype)
    g = _cotangent(N, P, Cout, seed=N, device=cuda, dtype=dtype)
    out = risi18_level(*args)
    first = risi18_level_backward(*args, out, g)
    second = risi18_level_backward(*args, out, g)
    torch.cuda.synchronize()
    assert torch.equal(out, risi18_level(*args))
    for x, y in zip(first[1:], second[1:]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_level_autograd_on_cuda_runs_k1_and_k2(cuda, dtype):
    state, nbr, pos, radj, K, b = _inputs(32, 8, 8, 8, seed=6, device=cuda,
                                          empty_vertex=4, dtype=dtype)
    g = _cotangent(32, 8, 8, seed=6, device=cuda, dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in (state, K, b)]
    counts = (risi18_level.launches, risi18_level_backward.launches)
    out = risi18_level(leaves[0], nbr, pos, radj, leaves[1], leaves[2])
    got = torch.autograd.grad(out, leaves, g)
    assert (risi18_level.launches, risi18_level_backward.launches) == (
        counts[0] + 1, counts[1] + 1)
    ref = risi18_level_backward_reference(state, nbr, pos, radj, K, b, g)
    for x, r, leaf in zip(got, ref, leaves):
        assert x.dtype == leaf.dtype
        _assert_close(x, r)


def test_backward_kernel_takes_float32_and_bfloat16_only(cuda):
    args = _inputs(4, 4, 8, 8, seed=7, device=cuda, dtype=torch.bfloat16)
    g = _cotangent(4, 4, 8, seed=7, device=cuda, dtype=torch.bfloat16)
    out = risi18_level(*args)
    before = risi18_level_backward.launches
    with pytest.raises(TypeError):                      # float32 cotangent
        risi18_level_backward(*args, out, g.float())
    with pytest.raises(TypeError):                      # float32 output
        risi18_level_backward(*args, out.float(), g)
    with pytest.raises(TypeError):
        risi18_level_backward(*(t.half() if t.dtype == torch.bfloat16 else t
                                for t in args), out.half(), g.half())
    with pytest.raises(ValueError):
        risi18_level_backward(*args, out.transpose(1, 2), g)
    assert risi18_level_backward.launches == before


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
