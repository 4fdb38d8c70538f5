"""The 18-case bank and its product with K over materialised slots
(counterpart of ``graphflow_tpu/ops/risi_pallas.py``).

    Z = reshape(RisiContraction_18(T, A)) @ K
    T [N, P, P, P, C], A [N, P, P], K [18C, Cout] -> Z [N, P, P, Cout]

Where the level (``ops/risi_level.py``) gathers its slots inside the
kernel, the bank reads them from T, which the take-gather has already
materialised.  SMP_omega in bfloat16 runs its levels through the bank
(``models/smp2d.py``), as the JAX package does on the TPU.

``risi18_bank_reference`` is the plain PyTorch version.  ``risi18_bank``
is the wrapper: on CPU tensors it runs the plain version, which torch
autograd differentiates; on CUDA tensors it runs ``_Risi18BankFn``, whose
forward launches the hand-written kernel ``csrc/risi18_bank.cu`` (K4) and
whose backward launches ``csrc/risi18_bank_bwd.cu`` (K5), or raises.
``risi18_bank_backward`` is the backward's wrapper and
``risi18_bank_backward_reference`` its plain version.

Dtypes: the kernels take T and K in float32 or bfloat16 (one type), A in
float32, and compute in float32, as the Pallas kernels do
(``risi_pallas.py:166-174``, ``:284-285``); Z and dT have T's dtype and dK
K's.  The plain versions also take float64, for parity tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphflow_tpu_torch.ops.fused import risi18_matmul_fused
from graphflow_tpu_torch.ops.risi_level import (_bind_min_smem, _check,
                                                _raise_on, _stream,
                                                check_smem)

# Storage dtype -> the dtype the bank computes in.
_COMPUTE = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
            torch.float64: torch.float64}


def _compute_dtype(T: torch.Tensor) -> torch.dtype:
    if T.dtype not in _COMPUTE:
        raise TypeError(f"T has dtype {T.dtype}; the bank takes "
                        f"{sorted(str(d) for d in _COMPUTE)}")
    return _COMPUTE[T.dtype]


def risi18_bank_reference(T, A, K):
    """Plain version: T, A and K upcast to float32 (float64 stays
    float64), ``risi18_matmul_fused``, and Z cast to T's dtype, which is
    what the Pallas kernel computes (``risi_pallas.py:166-174``, ``:315``)."""
    ct = _compute_dtype(T)
    return risi18_matmul_fused(T.to(ct), A.to(ct), K.to(ct)).to(T.dtype)


def risi18_bank_backward_reference(T, A, K, g):
    """Plain backward: ``torch.autograd.grad`` of the float32 (or float64)
    bank for the cotangent g [N, P, P, Cout] -> (dT in T's dtype, dK in K's
    dtype), as ``risi18_matmul_pallas_bwd`` returns them
    (``risi_pallas.py:491-542``).  A gets no gradient."""
    ct = _compute_dtype(T)
    with torch.enable_grad():
        t, k = (x.detach().to(ct).requires_grad_() for x in (T, K))
        Z = risi18_matmul_fused(t, A.to(ct), k)
        dT, dK = torch.autograd.grad(Z, (t, k), g.to(ct))
    return dT.to(T.dtype), dK.to(K.dtype)


# Kernel element type -> the suffix of its C entry points.
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def _forward_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_bank")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.risi18_bank_forward_f32, lib.risi18_bank_forward_bf16):
        fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        fn.restype = i32
    _bind_min_smem(lib.risi18_bank_min_smem_bytes)
    lib.risi18_bank_error_string.argtypes = [i32]
    lib.risi18_bank_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _backward_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_bank_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.risi18_bank_backward_blocks.argtypes = [i32]
    lib.risi18_bank_backward_blocks.restype = i32
    for fn in (lib.risi18_bank_backward_f32, lib.risi18_bank_backward_bf16):
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.risi18_bank_backward_reduce.argtypes = [ptr] * 2 + [i32] * 3 + [ptr]
    lib.risi18_bank_backward_reduce.restype = i32
    _bind_min_smem(lib.risi18_bank_backward_min_smem_bytes)
    lib.risi18_bank_bwd_error_string.argtypes = [i32]
    lib.risi18_bank_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_bank(T, A, K):
    """Checks the inputs both kernels share; returns (N, P, C, Cout)."""
    if T.dim() != 5:
        raise ValueError(f"T has shape {tuple(T.shape)}, expected "
                         f"[N, P, P, P, C]")
    N, P, _, _, C = T.shape
    Cout = K.shape[1] if K.dim() == 2 else -1
    if T.dtype not in _SUFFIX:
        raise TypeError(f"T has dtype {T.dtype}, the kernels take "
                        f"torch.float32 or torch.bfloat16")
    dev = T.device
    _check("T", T, T.dtype, (N, P, P, P, C), dev)
    _check("A", A, torch.float32, (N, P, P), dev)
    _check("K", K, T.dtype, (18 * C, Cout), dev)
    return N, P, C, Cout


def _where(N, P, C, Cout, dtype):
    return f"N={N} P={P} C={C} Cout={Cout} {dtype}"


def _forward_kernel(T, A, K):
    """K4: one launch of ``risi18_bank_forward_{f32,bf16}``."""
    N, P, C, Cout = _check_bank(T, A, K)
    lib = _forward_lib()
    check_smem("risi18_bank", lib.risi18_bank_min_smem_bytes, P, Cout)
    Z = torch.empty((N, P, P, Cout), dtype=T.dtype, device=T.device)
    with torch.cuda.device(T.device):
        err = getattr(lib, f"risi18_bank_forward_{_SUFFIX[T.dtype]}")(
            T.data_ptr(), A.data_ptr(), K.data_ptr(), Z.data_ptr(), N, P, C,
            Cout, _stream(T.device))
    _raise_on(err, "risi18_bank", lib.risi18_bank_error_string,
              _where(N, P, C, Cout, T.dtype))
    risi18_bank.launches += 1
    return Z


def _backward_main_kernel(T, A, K, g):
    """K5, kernel 1: dT (every element written) and per-block partial rows
    of dK; returns (dT, partial)."""
    N, P, C, Cout = _check_bank(T, A, K)
    _check("g", g, T.dtype, (N, P, P, Cout), T.device)
    lib = _backward_lib()
    check_smem("risi18_bank_backward",
               lib.risi18_bank_backward_min_smem_bytes, P, Cout)
    nblocks = lib.risi18_bank_backward_blocks(N)
    dT = torch.empty_like(T)
    partial = torch.empty((nblocks, 18 * C * Cout), dtype=torch.float32,
                          device=T.device)
    if N == 0:
        return dT, partial
    with torch.cuda.device(T.device):
        err = getattr(lib, f"risi18_bank_backward_{_SUFFIX[T.dtype]}")(
            T.data_ptr(), A.data_ptr(), K.data_ptr(), g.data_ptr(),
            dT.data_ptr(), partial.data_ptr(), N, P, C, Cout, nblocks,
            _stream(T.device))
    _raise_on(err, "risi18_bank_backward", lib.risi18_bank_bwd_error_string,
              _where(N, P, C, Cout, T.dtype))
    risi18_bank_backward.launches += 1
    return dT, partial


def _backward_reduce_kernel(partial, C, Cout):
    """K5, kernel 2: the partial rows summed into dK [18C, Cout], float32."""
    dev = partial.device
    _check("partial", partial, torch.float32,
           (partial.shape[0], 18 * C * Cout), dev)
    lib = _backward_lib()
    dK = torch.empty((18 * C, Cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.risi18_bank_backward_reduce(
            partial.data_ptr(), dK.data_ptr(), partial.shape[0], C, Cout,
            _stream(dev))
    _raise_on(err, "risi18_bank_backward reduce",
              lib.risi18_bank_bwd_error_string,
              f"{partial.shape[0]} partial rows, C={C} Cout={Cout}")
    risi18_bank_backward.reduce_launches += 1
    return dK


def risi18_bank_backward(T, A, K, g):
    """Gradients of the bank for the cotangent g [N, P, P, Cout] -> (dT in
    T's dtype, dK in K's dtype); A gets none.

    CPU tensors run :func:`risi18_bank_backward_reference`.  CUDA tensors
    launch K5's two kernels (``csrc/risi18_bank_bwd.cu``), or raise; dK is
    summed in float32 and then cast to K's dtype.
    """
    if T.device.type == "cpu":
        return risi18_bank_backward_reference(T, A, K, g)
    if T.device.type != "cuda":
        raise ValueError(f"no bank kernel for device {T.device}")
    dT, partial = _backward_main_kernel(T, A, K, g)
    dK = _backward_reduce_kernel(partial, T.shape[4], K.shape[1])
    return dT, dK.to(K.dtype)


risi18_bank_backward.launches = 0          # kernel 1 (dT, partials)
risi18_bank_backward.reduce_launches = 0   # kernel 2 (dK)


class _Risi18BankFn(torch.autograd.Function):
    """The bank on CUDA (counterpart of the ``risi18_bank_train``
    custom_vjp, ``risi_pallas.py:545-568``): K4 forward, K5 backward."""

    @staticmethod
    def forward(ctx, T, A, K):
        Z = _forward_kernel(T, A, K)
        ctx.save_for_backward(T, A, K)
        return Z

    @staticmethod
    def backward(ctx, g):
        T, A, K = ctx.saved_tensors
        dT, dK = risi18_bank_backward(T, A, K, g.contiguous())
        return dT, None, dK


def risi18_bank(T, A, K):
    """The bank: T [N,P,P,P,C], A [N,P,P], K [18C, Cout] -> Z [N,P,P,Cout]
    in T's dtype.

    CPU tensors run :func:`risi18_bank_reference`, differentiated by torch
    autograd.  CUDA tensors run ``_Risi18BankFn``: the forward launches K4
    and, when a gradient is taken, the backward launches K5.  The kernels
    take T and K in float32 or bfloat16, A in float32, all contiguous, and
    raise on anything else.
    """
    if T.device.type == "cpu":
        return risi18_bank_reference(T, A, K)
    if T.device.type != "cuda":
        raise ValueError(f"no bank kernel for device {T.device}")
    return _Risi18BankFn.apply(T, A, K)


risi18_bank.launches = 0
