"""The aligned neighbour tensor of a second-order level (counterpart of
``graphflow_tpu/ops/risi_fused_pallas.py:risi18_aligned_t2``).

    T[v, i, p1, p2, :] = state[nbr[v,i], pos[v,i,p1], pos[v,i,p2], :]
    state [N, P, P, C], nbr [N, P], pos [N, P, P] -> T [N, P, P, P, C]

in the state's dtype, zero where the neighbour id lies outside [0, N) or a
position outside [0, P).  Prepared graphs mark an absent neighbour by N
and an absent position by P (ROADMAP "Padding and sentinels").  This is
the alignment X_i f X_i^T of ``SMP_omega.h:641-648`` for every slot, the
input of the 10- and 50-case banks of SMP_2D_ver6 and ver7.

``risi18_aligned_t2_reference`` is the plain version, the take-gather.
``risi18_aligned_t2`` is the wrapper: on CPU tensors it runs the plain
version; on CUDA tensors it launches the hand-written kernel
``csrc/risi_aligned_t2.cu`` (K7) on a float32 or bfloat16 state, or
raises.  Like the JAX function it has no backward: it raises when the
state requires a gradient, and training builds T with the reference, which
torch autograd differentiates (``graphflow_tpu/models/smp2d.py:287-299``).

Where the TPU function emits T2all [N, P*P, P*C] in float32 and views it as
T through a transpose, the kernel writes [N, P, P, P, C] directly in the
state's dtype; every element is one copied value, so that is exact.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphflow_tpu_torch.ops.risi_level import (_check, _check_element_type,
                                                _entry, _raise_on, _stream)


def _gather_neighbor_tensors_take(state_pad, nbr, pos):
    """The flat-take gather and alignment X f X^T (counterpart of
    ``smp2d.py:_gather_neighbor_tensors_take``).

    state_pad [R, P+1, P+1, C] (the state zero-padded by one position on
    both spatial axes), nbr [N, P] in [0, R], pos [N, P, P] in [0, P]
    -> T [N, P, P, P, C], T[v,i,p1,p2] = state_pad[nbr[v,i], pos[v,i,p1],
    pos[v,i,p2]].  The source may hold more rows than there are vertices
    to gather for (R >= N): a partitioned level gathers from its state
    with the halo appended (``parallel/partition.py``).  Neighbour id and
    row position fold into one row index over the [(R+1)(P+1), (P+1)C]
    view; the appended zero vertex row makes the sentinel R read zeros,
    where ``jnp.take`` would clamp and torch would raise (CPU) or read out
    of range (CUDA).  The rows are taken with ``index_select``, whose
    adjoint is ``index_add_``, a scatter-add like ``jnp.take``'s; the
    adjoint of indexing ``src[rows]`` sorts the indices first, and took
    twice as long per bfloat16 step on an H100.
    """
    R, Q, _, C = state_pad.shape
    N, P = nbr.shape
    src = torch.cat([state_pad.reshape(R * Q, Q * C),
                     state_pad.new_zeros((Q, Q * C))], dim=0)
    rows = nbr.long()[:, :, None] * Q + pos.long()                # [N, P, P]
    Ar = src.index_select(0, rows.reshape(-1)).reshape(N, P, P, Q, C)
    col = pos.long()[:, :, None, :, None].expand(N, P, P, P, C)
    return torch.gather(Ar, 3, col)


def risi18_aligned_t2_reference(state, nbr, pos):
    """Plain version: ids outside [0, N) become N and positions outside
    [0, P) become P, then the take-gather of the padded state (N the
    state's vertices: nbr may list fewer, for a check that runs the plain
    level a few vertices at a time).  Any dtype; differentiable by torch
    autograd."""
    N, P = state.shape[0], nbr.shape[1]
    nbr = torch.where((nbr >= 0) & (nbr < N), nbr, torch.full_like(nbr, N))
    pos = torch.where((pos >= 0) & (pos < P), pos, torch.full_like(pos, P))
    state_pad = torch.nn.functional.pad(state, (0, 0, 0, 1, 0, 1))
    return _gather_neighbor_tensors_take(state_pad, nbr, pos)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi_aligned_t2")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.risi_aligned_t2_f32, lib.risi_aligned_t2_bf16):
        fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        fn.restype = i32
    lib.risi_aligned_t2_error_string.argtypes = [i32]
    lib.risi_aligned_t2_error_string.restype = ctypes.c_char_p
    return lib


def _kernel(state, nbr, pos):
    """K7: one launch of ``risi_aligned_t2_{f32,bf16}``."""
    if state.dim() != 4 or state.shape[1] != state.shape[2]:
        raise ValueError(f"state has shape {tuple(state.shape)}, expected "
                         f"[N, P, P, C]")
    N, P, _, C = state.shape
    dev, dt = state.device, state.dtype
    _check_element_type("state", state)
    _check("state", state, dt, (N, P, P, C), dev)
    _check("nbr", nbr, torch.int32, (N, P), dev)
    _check("pos", pos, torch.int32, (N, P, P), dev)
    lib = _kernel_lib()
    T = torch.empty((N, P, P, P, C), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        err = _entry(lib, "risi_aligned_t2", dt)(
            state.data_ptr(), nbr.data_ptr(), pos.data_ptr(), T.data_ptr(),
            N, P, C, _stream(dev))
    _raise_on(err, "risi_aligned_t2", lib.risi_aligned_t2_error_string,
              f"N={N} P={P} C={C} {dt}")
    risi18_aligned_t2.launches += 1
    return T


def risi18_aligned_t2(state, nbr, pos):
    """The aligned neighbour tensor T [N, P, P, P, C] of state [N, P, P, C],
    nbr [N, P] and pos [N, P, P], for inference.

    Raises when ``state`` requires a gradient under grad mode: there is no
    backward, and training takes :func:`risi18_aligned_t2_reference`.  CPU
    tensors run the plain version.  CUDA tensors launch K7, which takes a
    float32 or bfloat16 state and int32 nbr and pos, all contiguous, and
    raises on anything else; T has the state's dtype.
    """
    if torch.is_grad_enabled() and state.requires_grad:
        raise RuntimeError(
            "risi18_aligned_t2 has no backward (as in the JAX package); "
            "differentiate risi18_aligned_t2_reference, the take-gather")
    if state.device.type == "cpu":
        return risi18_aligned_t2_reference(state, nbr, pos)
    if state.device.type != "cuda":
        raise ValueError(f"no aligned-tensor kernel for device {state.device}")
    return _kernel(state, nbr, pos)


risi18_aligned_t2.launches = 0
