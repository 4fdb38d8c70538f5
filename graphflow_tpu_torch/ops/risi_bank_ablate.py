"""Ablation variants of the 18-case bank (counterpart of
``tools/ablate_bank.py:variant``).

The JAX package times stripped-down copies of its Pallas bank kernel to
attribute the kernel's cost to its stages.  The port does the same with
the bank kernel of ``ops/risi_bank.py`` (K4): each variant is a function

    T [B, P, P, P, C], A [B, P, P], K [18C, Cout] -> Z [B, P, P, Cout]

defined by what ``variant(T, A, K, mode)`` returns there:

``full``      the bank, ``risi18_bank(T, A, K)``;
``dma``       ``T.reshape(B, P*P, P*C)[:, :, :Cout]``: every element of T
              streamed and the output written, with no arithmetic (needs
              Cout <= P*C);
``reduce``    ``(T_ab + T_bc + W17) @ K[0:C] + (D_bc + D_ac) @ K[C:2C]``:
              the stream and the shared reductions, two products instead
              of eighteen;
``nogroupd``  ``full`` without the adjacency-weighted cases 6, 9, 10, 12,
              13, 16 and 17 (K's blocks 5, 8, 9, 11, 12, 15, 16);
``novpu``     ``full`` with every diagonal extraction replaced by the full
              sum, which is wrong as a contraction by design: it prices the
              selection.

``risi18_bank_variant_reference`` is the plain PyTorch version, written on
T with sums and einsums.  ``risi18_bank_variant`` is the wrapper: on CPU
tensors it runs the plain version; on CUDA tensors it launches the
hand-written kernel ``csrc/risi18_bank_ablate.cu`` (K6), which is K4's
device code with the mode as a template parameter, or raises.  Dtypes are
the bank's: T and K float32 or bfloat16, A float32, sums in float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphflow_tpu_torch.ops.risi_bank import (_SUFFIX, _check_bank,
                                               _compute_dtype, _where)
from graphflow_tpu_torch.ops.risi_level import (_bind_min_smem, _raise_on,
                                                _stream, check_smem)

# Mode -> its number in the C interface.
MODES = {"full": 0, "dma": 1, "reduce": 2, "nogroupd": 3, "novpu": 4}
# 0-based cases whose K blocks ``nogroupd`` drops (tools/ablate_bank.py:121).
_GROUP_D = (5, 8, 9, 11, 12, 15, 16)


def _check_mode(mode, P, C, Cout):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: the variants are {sorted(MODES)}")
    if mode == "dma" and Cout > P * C:
        raise ValueError(f"mode 'dma' copies the first Cout columns of T as "
                         f"[P*P, P*C]: Cout={Cout} > P*C={P * C}")


def _reductions(T, R, select):
    """The bank's reductions of T [..., a, b, c, f] (``ops/fused.py``).
    With ``select`` False every diagonal extraction is the full sum instead
    (``novpu``: ``mask_cb = mask_ca = dmask_row = 1``)."""
    ein = torch.einsum
    T_ab = T.sum(dim=-2)                                      # [..., a,b,f]
    T_a = T_ab.sum(dim=-2)
    T_b = T_ab.sum(dim=-3)
    T_full = T_a.sum(dim=-2)
    red = {"T_ab": T_ab, "T_a": T_a, "T_b": T_b, "T_full": T_full,
           "M6": ein("...abdf,...d->...abf", T, R)}
    if select:
        D_bc = ein("...abbf->...abf", T)
        red.update(
            T_bc=T.sum(dim=-4), D_bc=D_bc, D_ac=ein("...abaf->...abf", T),
            M10=ein("...dbcf,...d->...bcf", T, R),
            s14=ein("...aacf->...f", T), s15=D_bc.sum(dim=(-3, -2)),
            t18=ein("...aaaf->...f", T))
    else:
        P = T.shape[-2]
        rows = ein("...abcf,...a->...bf", T, R)       # sum_{a,c} R[a] T[a,b,c]
        red.update(
            T_bc=T_b[..., :, None, :].expand(*T_b.shape[:-1], P, -1),
            D_bc=T_ab, D_ac=T_ab,
            M10=rows[..., :, None, :].expand(*rows.shape[:-1], P, -1),
            s14=T_full, s15=T_full, t18=T_full)
    return red


def _assemble(red, Ap, R, Kc, drop=()):
    """Z from the reductions: the 18 cases in the order of
    ``risi_contraction_18``, each times its block of K, skipping ``drop``."""
    ein = torch.einsum
    S = Ap.sum(dim=(-2, -1))[..., None, None, None]
    trA = torch.diagonal(Ap, dim1=-2, dim2=-1).sum(-1)[..., None, None, None]
    T_ab, T_bc, D_bc, D_ac = (red[k] for k in ("T_ab", "T_bc", "D_bc", "D_ac"))
    W17 = D_ac.transpose(-3, -2)                              # T[e,b,e,f]

    def rows(u):                                      # u[x] R[y]
        return u[..., :, None, :] * R[..., None, :, None]

    def adj(t):                                       # Ap[x,y] t
        return Ap[..., None] * t[..., None, None, :]

    cases = [
        T_ab * S,                                             # 1
        rows(red["T_a"]),                                     # 2
        T_bc * S,                                             # 3
        rows(red["T_b"]),                                     # 4
        adj(red["T_full"]),                                   # 5
        red["M6"],                                            # 6
        T_ab * trA,                                           # 7
        rows(D_bc.sum(dim=-2)),                               # 8
        ein("...aef,...de->...adf", T_ab, Ap),                # 9
        red["M10"],                                           # 10
        rows(D_ac.sum(dim=-3)),                               # 11
        ein("...ebf,...de->...bdf", T_ab, Ap),                # 12
        ein("...bef,...de->...bdf", T_bc, Ap),                # 13
        adj(red["s14"]),                                      # 14
        adj(red["s15"]),                                      # 15
        ein("...aef,...de->...adf", D_bc, Ap),                # 16
        ein("...bef,...de->...bdf", W17, Ap),                 # 17
        adj(red["t18"]),                                      # 18
    ]
    return sum(y @ Kc[k] for k, y in enumerate(cases) if k not in drop)


def risi18_bank_variant_reference(T, A, K, mode):
    """Plain version of variant ``mode``: T, A and K upcast to float32
    (float64 stays float64), the variant's function, Z cast to T's dtype."""
    B, P, _, _, C = T.shape
    Cout = K.shape[1]
    _check_mode(mode, P, C, Cout)
    if mode == "dma":
        return T.reshape(B, P * P, P * C)[:, :, :Cout].reshape(B, P, P, Cout)
    ct = _compute_dtype(T)
    t, a = T.to(ct), A.to(ct)
    Kc = K.to(ct).reshape(18, C, Cout)
    Ap = torch.where(a > 0, a, torch.zeros_like(a))
    R = Ap.sum(dim=-1)
    red = _reductions(t, R, select=mode != "novpu")
    if mode == "reduce":
        W17 = red["D_ac"].transpose(-3, -2)
        Z = ((red["T_ab"] + red["T_bc"] + W17) @ Kc[0]
             + (red["D_bc"] + red["D_ac"]) @ Kc[1])
    else:
        Z = _assemble(red, Ap, R, Kc,
                      drop=_GROUP_D if mode == "nogroupd" else ())
    return Z.to(T.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_bank_ablate")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.risi18_bank_ablate_f32, lib.risi18_bank_ablate_bf16):
        fn.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        fn.restype = i32
    _bind_min_smem(lib.risi18_bank_ablate_min_smem_bytes)
    lib.risi18_bank_ablate_error_string.argtypes = [i32]
    lib.risi18_bank_ablate_error_string.restype = ctypes.c_char_p
    return lib


def risi18_bank_variant(T, A, K, mode):
    """Variant ``mode`` of the bank: T [B,P,P,P,C], A [B,P,P], K [18C, Cout]
    -> Z [B,P,P,Cout] in T's dtype.  No gradient is defined.

    CPU tensors run :func:`risi18_bank_variant_reference`.  CUDA tensors
    launch ``risi18_bank_ablate_{f32,bf16}`` once, counted in
    ``risi18_bank_variant.launches[mode]``, or raise; the kernel
    takes what the bank kernel takes (T and K float32 or bfloat16, A
    float32, all contiguous).
    """
    if T.device.type == "cpu":
        return risi18_bank_variant_reference(T, A, K, mode)
    if T.device.type != "cuda":
        raise ValueError(f"no bank kernel for device {T.device}")
    N, P, C, Cout = _check_bank(T, A, K)
    _check_mode(mode, P, C, Cout)
    lib = _kernel_lib()
    check_smem("risi18_bank_variant",
               lib.risi18_bank_ablate_min_smem_bytes, P, Cout)
    Z = torch.empty((N, P, P, Cout), dtype=T.dtype, device=T.device)
    # Mode dma folds its loads of T into one float per vertex.
    sink = (torch.empty((N,), dtype=torch.float32, device=T.device)
            if mode == "dma" else None)
    with torch.cuda.device(T.device):
        err = getattr(lib, f"risi18_bank_ablate_{_SUFFIX[T.dtype]}")(
            T.data_ptr(), A.data_ptr(), K.data_ptr(), Z.data_ptr(),
            sink.data_ptr() if sink is not None else None, N, P, C, Cout,
            MODES[mode], _stream(T.device))
    _raise_on(err, f"risi18_bank_variant[{mode}]",
              lib.risi18_bank_ablate_error_string,
              _where(N, P, C, Cout, T.dtype))
    risi18_bank_variant.launches[mode] += 1
    return Z


# Kernel launches by mode.
risi18_bank_variant.launches = dict.fromkeys(MODES, 0)
