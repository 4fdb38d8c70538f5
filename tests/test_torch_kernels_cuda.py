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
    risi18_level, risi18_level_backward, risi18_level_backward_reference,
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
            dtype=torch.float32):
    d = random_level_case(N, P, C, Cout, seed=seed, empty_vertex=empty_vertex)
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
    got, ref = got.double(), ref.double()
    assert torch.isfinite(got).all()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= rtol * scale


# (12, 12, 40, 16) walks the channels in several chunks; the next four are the
# levels of a halving channel schedule, down to one channel.  The next two
# have more vertices than the backward has vertex groups (132), so that every
# block walks several vertices and carries its sums of dK and db along.  The
# last two have fields of 17 to 32 rows: a warp takes two rows of a staged
# slot, the chunk has four channels and the output goes in panels.
SHAPES = [(256, 16, 32, 32), (64, 10, 20, 20), (32, 4, 8, 8), (5, 8, 8, 16),
          (12, 12, 40, 16), (256, 16, 32, 16), (256, 16, 16, 8),
          (64, 10, 2, 1), (32, 4, 1, 1), (600, 16, 32, 32), (600, 4, 8, 4),
          (6, 24, 8, 32), (4, 20, 12, 16)]


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
    """The maps and Z [P*P, Cout] live in shared memory: at P=64, Cout=32
    they do not fit, and the launch is refused with an error, not run."""
    args = _inputs(2, 64, 4, 32, seed=8, device=cuda)
    before = risi18_level.launches
    with pytest.raises(RuntimeError, match="P=64 at Cout=32 needs 761296 "
                                           "bytes .* shared memory"):
        risi18_level(*args)
    assert risi18_level.launches == before


def test_backward_kernel_rejects_shapes_beyond_shared_memory(cuda):
    """G and G.Ap [P*P, a panel of Cout] live in shared memory beside the
    maps: P=32 at Cout=32 is the last field that fits both kernels (in
    panels of four output channels); at P=33 the backward is refused with
    its bytes, and the forward still runs."""
    args = _inputs(2, 32, 4, 32, seed=8, device=cuda)
    out = risi18_level(*args)
    _assert_close(out, risi18_level_reference(*args))
    _check_backward(args, _cotangent(2, 32, 32, seed=8, device=cuda))
    args = _inputs(2, 33, 4, 32, seed=8, device=cuda)
    out = torch.ones((2, 33 * 33, 32), device=cuda)
    before = (risi18_level.launches, risi18_level_backward.launches)
    with pytest.raises(RuntimeError, match="P=33 at Cout=32 needs 246592 "
                                           "bytes .* shared memory"):
        risi18_level_backward(*args, out, torch.ones_like(out))
    assert (risi18_level.launches, risi18_level_backward.launches) == before
    _assert_close(risi18_level(*args), risi18_level_reference(*args))


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
