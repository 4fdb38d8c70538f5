"""The fused second-order SMP level (counterpart of
``graphflow_tpu/ops/risi_fused_pallas.py:risi18_level``).

One level maps a state [N, P, P, C] to [N, P*P, Cout]:

    T_i = X_i f_{nbr(v,i)} X_i^T          (alignment, SMP_omega.h:641-648)
    Y   = RisiContraction_18(T, radj_v)   (RisiContraction_18.h:73-331)
    Z   = LeakyReLU(reshape(Y) @ K + b)   (SMP_omega.h:653-669)

``risi18_level_reference`` is the plain PyTorch version.  ``risi18_level``
is the wrapper: on CPU tensors it runs the plain version; on CUDA tensors
it launches the hand-written kernel ``csrc/risi18_level.cu`` or raises.

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
    from graphflow_tpu_torch.models.smp2d import _gather_neighbor_tensors_take

    N, P, _, C = state.shape
    state_pad = torch.nn.functional.pad(state, (0, 0, 0, 1, 0, 1))
    T = _gather_neighbor_tensors_take(state_pad, nbr, pos)
    Y = risi_contraction_18(T, radj)
    Z = Y.reshape(N, P * P, 18 * C) @ K + b
    return leaky_relu(Z, negslope)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_level")
    ptr = ctypes.c_void_p
    lib.risi18_level_forward_f32.argtypes = (
        [ptr] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ptr])
    lib.risi18_level_forward_f32.restype = ctypes.c_int
    lib.risi18_level_error_string.argtypes = [ctypes.c_int]
    lib.risi18_level_error_string.restype = ctypes.c_char_p
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


def risi18_level(state, nbr, pos, radj, K, b, negslope=0.01):
    """Fused level: state [N,P,P,C], nbr [N,P], pos [N,P,P], radj [N,P,P],
    K [18C, Cout], b [Cout] -> [N, P*P, Cout], rows (p1 p2).

    CPU tensors run :func:`risi18_level_reference`.  CUDA tensors launch
    the kernel, which takes float32 state/radj/K/b, int32 nbr/pos, all
    contiguous, and raises on anything else.  The kernel has no backward
    yet: on CUDA, inputs that require grad raise.
    """
    if state.device.type == "cpu":
        return risi18_level_reference(state, nbr, pos, radj, K, b, negslope)
    if state.device.type != "cuda":
        raise ValueError(f"no level kernel for device {state.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (state, radj, K, b)):
        raise NotImplementedError(
            "the level backward (kernel K2) is ROADMAP slice 2; run "
            "inference under torch.no_grad()")
    N, P, _, C = state.shape
    Cout = K.shape[1]
    dev = state.device
    f32, i32 = torch.float32, torch.int32
    _check("state", state, f32, (N, P, P, C), dev)
    _check("nbr", nbr, i32, (N, P), dev)
    _check("pos", pos, i32, (N, P, P), dev)
    _check("radj", radj, f32, (N, P, P), dev)
    _check("K", K, f32, (18 * C, Cout), dev)
    _check("b", b, f32, (Cout,), dev)
    lib = _kernel_lib()
    out = torch.empty((N, P * P, Cout), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.risi18_level_forward_f32(
            state.data_ptr(), nbr.data_ptr(), pos.data_ptr(), radj.data_ptr(),
            K.data_ptr(), b.data_ptr(), out.data_ptr(), N, P, C, Cout,
            float(negslope), stream)
    if err != 0:
        raise RuntimeError(
            f"risi18_level kernel launch failed at N={N} P={P} C={C} "
            f"Cout={Cout}: {lib.risi18_level_error_string(err).decode()} "
            f"(a block keeps Z [P*P, Cout] in shared memory, at most "
            f"227 KB)")
    risi18_level.launches += 1
    return out


risi18_level.launches = 0
