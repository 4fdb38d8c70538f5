"""The fused second-order SMP level (counterpart of
``graphflow_tpu/ops/risi_fused_pallas.py:risi18_level``).

One level maps a state [N, P, P, C] to [N, P*P, Cout]:

    T_i = X_i f_{nbr(v,i)} X_i^T          (alignment, SMP_omega.h:641-648)
    Y   = RisiContraction_18(T, radj_v)   (RisiContraction_18.h:73-331)
    Z   = LeakyReLU(reshape(Y) @ K + b)   (SMP_omega.h:653-669)

``risi18_level_reference`` is the plain PyTorch version.  ``risi18_level``
is the wrapper: on CPU tensors it runs the plain version, which torch
autograd differentiates; on CUDA tensors it runs ``_Risi18LevelFn``, whose
forward launches the hand-written kernel ``csrc/risi18_level.cu`` (K1) and
whose backward launches ``csrc/risi18_level_bwd.cu`` (K2), or raises.
``risi18_level_backward`` is the backward's wrapper and
``risi18_level_backward_reference`` its plain version.

Index conventions: ``nbr`` values lie in [0, N], where N marks an absent
neighbour; ``pos`` values lie in [0, P], where P marks an absent position.
Both read zeros.  (Prepared graphs mark padding slots by ``pos = P`` with
``nbr = 0``.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import risi_contraction_18


def risi18_level_reference(state, nbr, pos, radj, K, b, negslope=0.01):
    """Plain version (``_reference_level``, risi_fused_pallas.py:1043-1056):
    gather and align, the 18-case bank, the product with K, b, LeakyReLU."""
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2_reference)

    N, P, _, C = state.shape
    T = risi18_aligned_t2_reference(state, nbr, pos)
    Y = risi_contraction_18(T, radj)
    Z = Y.reshape(N, P * P, 18 * C) @ K + b
    return leaky_relu(Z, negslope)


def risi18_level_backward_reference(state, nbr, pos, radj, K, b, g,
                                    negslope=0.01):
    """Plain backward: ``torch.autograd.grad`` of
    :func:`risi18_level_reference` with respect to (state, K, b) for the
    cotangent g [N, P*P, Cout] -> (dstate, dK, db)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (state, K, b)]
        out = risi18_level_reference(leaves[0], nbr, pos, radj, leaves[1],
                                     leaves[2], negslope)
        return torch.autograd.grad(out, leaves, g)


def _bind_min_smem(fn):
    """A library's ``*_min_smem_bytes(P, Cout)``: the least shared memory
    one block of its kernel needs, by the kernel's own layout."""
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_level")
    ptr = ctypes.c_void_p
    lib.risi18_level_forward_f32.argtypes = (
        [ptr] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ptr])
    lib.risi18_level_forward_f32.restype = ctypes.c_int
    _bind_min_smem(lib.risi18_level_min_smem_bytes)
    lib.risi18_level_error_string.argtypes = [ctypes.c_int]
    lib.risi18_level_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _backward_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_level_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.risi18_level_backward_blocks.argtypes = [i32]
    lib.risi18_level_backward_blocks.restype = i32
    lib.risi18_level_backward_f32.argtypes = (
        [ptr] * 9 + [i32] * 4 + [ctypes.c_float, i32, ptr])
    lib.risi18_level_backward_f32.restype = i32
    lib.risi18_level_backward_reduce_f32.argtypes = (
        [ptr] * 3 + [i32] * 3 + [ptr])
    lib.risi18_level_backward_reduce_f32.restype = i32
    _bind_min_smem(lib.risi18_level_backward_min_smem_bytes)
    lib.risi18_level_bwd_error_string.argtypes = [i32]
    lib.risi18_level_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, state on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_level(state, nbr, pos, radj, K):
    """Checks the inputs both kernels share; returns (N, P, C, Cout)."""
    N, P, _, C = state.shape
    Cout = K.shape[1]
    dev = state.device
    f32, i32 = torch.float32, torch.int32
    _check("state", state, f32, (N, P, P, C), dev)
    _check("nbr", nbr, i32, (N, P), dev)
    _check("pos", pos, i32, (N, P, P), dev)
    _check("radj", radj, f32, (N, P, P), dev)
    _check("K", K, f32, (18 * C, Cout), dev)
    return N, P, C, Cout


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# Shared memory one block may take on sm_90 (227 KB), as kMaxSmemBytes of
# ``csrc/risi18_common.cuh``.
SMEM_LIMIT_BYTES = 232448


def check_smem(what, min_smem_bytes, P, Cout):
    """Raises when a block of kernel ``what`` cannot fit its shared memory:
    the kernels keep a vertex's whole [P*P, Cout] output (or cotangent) in
    one block, so a large receptive field is refused, never rerouted.
    ``min_smem_bytes(P, Cout)`` is the library's own count of the bytes a
    block needs at a channel chunk of one (``make_forward_layout`` and
    ``make_backward_layout`` of ``csrc/risi18_common.cuh``)."""
    need = min_smem_bytes(P, Cout)
    if need > SMEM_LIMIT_BYTES:
        raise RuntimeError(
            f"{what}: a receptive field of P={P} at Cout={Cout} needs "
            f"{need} bytes ({need / 1024:.0f} KB) of shared memory in one "
            f"block, and an H100 block has {SMEM_LIMIT_BYTES} bytes "
            f"(227 KB); the kernels do not tile a vertex's [P*P, Cout] "
            f"maps yet")


def _raise_on(err, what, lib_error_string, where):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed at {where}: "
                           f"{lib_error_string(err).decode()}")


def _forward_kernel(state, nbr, pos, radj, K, b, negslope):
    """K1: one launch of ``risi18_level_forward_f32``."""
    N, P, C, Cout = _check_level(state, nbr, pos, radj, K)
    dev = state.device
    _check("b", b, torch.float32, (Cout,), dev)
    lib = _kernel_lib()
    check_smem("risi18_level", lib.risi18_level_min_smem_bytes, P, Cout)
    out = torch.empty((N, P * P, Cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.risi18_level_forward_f32(
            state.data_ptr(), nbr.data_ptr(), pos.data_ptr(), radj.data_ptr(),
            K.data_ptr(), b.data_ptr(), out.data_ptr(), N, P, C, Cout,
            float(negslope), _stream(dev))
    _raise_on(err, "risi18_level", lib.risi18_level_error_string,
              f"N={N} P={P} C={C} Cout={Cout}")
    risi18_level.launches += 1
    return out


def _backward_main_kernel(state, nbr, pos, radj, K, g, out, negslope):
    """K2, kernel 1: dstate (atomics into zeros) and per-block partial rows
    of [dK | db]; returns (dstate, partial)."""
    N, P, C, Cout = _check_level(state, nbr, pos, radj, K)
    dev = state.device
    _check("g", g, torch.float32, (N, P * P, Cout), dev)
    _check("out", out, torch.float32, (N, P * P, Cout), dev)
    lib = _backward_lib()
    check_smem("risi18_level_backward",
               lib.risi18_level_backward_min_smem_bytes, P, Cout)
    nblocks = lib.risi18_level_backward_blocks(N)
    dstate = torch.zeros_like(state)
    partial = torch.empty((nblocks, 18 * C * Cout + Cout),
                          dtype=torch.float32, device=dev)
    if N == 0:
        return dstate, partial
    with torch.cuda.device(dev):
        err = lib.risi18_level_backward_f32(
            state.data_ptr(), nbr.data_ptr(), pos.data_ptr(), radj.data_ptr(),
            K.data_ptr(), g.data_ptr(), out.data_ptr(), dstate.data_ptr(),
            partial.data_ptr(), N, P, C, Cout, float(negslope), nblocks,
            _stream(dev))
    _raise_on(err, "risi18_level_backward", lib.risi18_level_bwd_error_string,
              f"N={N} P={P} C={C} Cout={Cout}")
    risi18_level_backward.launches += 1
    return dstate, partial


def _backward_reduce_kernel(partial, C, Cout):
    """K2, kernel 2: the partial rows summed into (dK [18C, Cout], db)."""
    dev = partial.device
    _check("partial", partial, torch.float32,
           (partial.shape[0], 18 * C * Cout + Cout), dev)
    lib = _backward_lib()
    dK = torch.empty((18 * C, Cout), dtype=torch.float32, device=dev)
    db = torch.empty((Cout,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.risi18_level_backward_reduce_f32(
            partial.data_ptr(), dK.data_ptr(), db.data_ptr(),
            partial.shape[0], C, Cout, _stream(dev))
    _raise_on(err, "risi18_level_backward reduce",
              lib.risi18_level_bwd_error_string,
              f"{partial.shape[0]} partial rows, C={C} Cout={Cout}")
    risi18_level_backward.reduce_launches += 1
    return dK, db


def risi18_level_backward(state, nbr, pos, radj, K, b, out, g,
                          negslope=0.01):
    """Gradients of the level for the cotangent g [N, P*P, Cout] ->
    (dstate [N,P,P,C], dK [18C, Cout], db [Cout]); nbr, pos and radj get
    none.  ``out`` is the level's output for these inputs.

    CPU tensors run :func:`risi18_level_backward_reference`, which
    recomputes the output.  CUDA tensors launch K2's two kernels
    (``csrc/risi18_level_bwd.cu``) on float32 inputs, or raise.
    """
    if state.device.type == "cpu":
        return risi18_level_backward_reference(state, nbr, pos, radj, K, b, g,
                                               negslope)
    if state.device.type != "cuda":
        raise ValueError(f"no level kernel for device {state.device}")
    dstate, partial = _backward_main_kernel(state, nbr, pos, radj, K, g, out,
                                            negslope)
    dK, db = _backward_reduce_kernel(partial, state.shape[3], K.shape[1])
    return dstate, dK, db


risi18_level_backward.launches = 0          # kernel 1 (dstate, partials)
risi18_level_backward.reduce_launches = 0   # kernel 2 (dK, db)


class _Risi18LevelFn(torch.autograd.Function):
    """The level on CUDA: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, state, nbr, pos, radj, K, b, negslope):
        out = _forward_kernel(state, nbr, pos, radj, K, b, negslope)
        ctx.save_for_backward(state, nbr, pos, radj, K, b, out)
        ctx.negslope = negslope
        return out

    @staticmethod
    def backward(ctx, g):
        state, nbr, pos, radj, K, b, out = ctx.saved_tensors
        dstate, dK, db = risi18_level_backward(
            state, nbr, pos, radj, K, b, out, g.contiguous(), ctx.negslope)
        return dstate, None, None, None, dK, db, None


def risi18_level(state, nbr, pos, radj, K, b, negslope=0.01):
    """Fused level: state [N,P,P,C], nbr [N,P], pos [N,P,P], radj [N,P,P],
    K [18C, Cout], b [Cout] -> [N, P*P, Cout], rows (p1 p2).

    CPU tensors run :func:`risi18_level_reference`, differentiated by torch
    autograd.  CUDA tensors run ``_Risi18LevelFn``: the forward launches K1
    and, when a gradient is taken, the backward launches K2, with or
    without grad enabled.  The kernels take float32 state/radj/K/b, int32
    nbr/pos, all contiguous, and raise on anything else.
    """
    if state.device.type == "cpu":
        return risi18_level_reference(state, nbr, pos, radj, K, b, negslope)
    if state.device.type != "cuda":
        raise ValueError(f"no level kernel for device {state.device}")
    return _Risi18LevelFn.apply(state, nbr, pos, radj, K, b, float(negslope))


risi18_level.launches = 0
