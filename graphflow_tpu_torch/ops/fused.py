"""Low-rank fused RisiContraction_18 + channel product (counterpart of
``graphflow_tpu/ops/fused.py:risi18_matmul_fused``).

Z = reshape(Risi18(T, A)) @ K without materialising the [P, P, 18C] bank:

  spatial-broadcast cases (1,3,7):  slab * scalar
  row-broadcast cases (2,4,8,11):   u[x] K * R[y]
  adj-broadcast cases (5,14,15,18): Ap[x,y] * (t K)
  full-map cases (6,9,10,12,13,16,17): [P, P, C] maps, one product

This is the decomposition the CUDA level kernel follows
(``ops/csrc/risi18_level.cu``); it is exact algebra, so it equals
``risi_contraction_18`` followed by the product with K.
:func:`risi18_matmul_reference` is that unfused product on the case-table
engine, the yardstick of the fused forms and of the bank kernel.
"""

from __future__ import annotations

import torch

from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import risi_contraction_18_spec


def risi18_matmul_reference(T: torch.Tensor, A: torch.Tensor,
                            K: torch.Tensor) -> torch.Tensor:
    """The unfused Z = reshape(Risi18(T, A)) @ K, the bank from the
    case-table engine (``risi_contraction_18_spec``).  T: [..., P, P, P,
    C], A: [..., P, P], K: [18*C, Cout] -> [..., P, P, Cout]."""
    return risi_contraction_18_spec(T, A) @ K


def risi18_matmul_fused(T: torch.Tensor, A: torch.Tensor,
                        K: torch.Tensor) -> torch.Tensor:
    """T: [..., P, P, P, C], A: [..., P, P], K: [18*C, Cout]
    -> [..., P, P, Cout]; leading dimensions are batch dimensions."""
    C = T.shape[-1]
    Kc = K.reshape(18, C, K.shape[1])
    ein = torch.einsum

    Ap = torch.where(A > 0, A, torch.zeros_like(A))
    S = Ap.sum(dim=(-2, -1))[..., None, None, None]
    R = Ap.sum(dim=-1)                                        # [..., P]
    trA = torch.diagonal(Ap, dim1=-2, dim2=-1).sum(-1)[..., None, None, None]

    T_ab = T.sum(dim=-2)                                      # [..., a,b,f]
    T_bc = T.sum(dim=-4)                                      # [..., b,c,f]
    T_a = T_ab.sum(dim=-2)                                    # [..., a,f]
    T_b = T_bc.sum(dim=-2)                                    # [..., b,f]
    T_full = T_a.sum(dim=-2)                                  # [..., f]
    D_bc = ein("...abbf->...abf", T)
    D_aab = ein("...aacf->...acf", T)
    Tdiag_bc_a = D_bc.sum(dim=-2)                             # case 8
    Tdiag_ac_b = ein("...abaf->...bf", T)                     # case 11
    s14 = D_aab.sum(dim=(-3, -2))
    s15 = D_bc.sum(dim=(-3, -2))
    t18 = ein("...aaaf->...f", T)
    W16 = D_bc                                                # T[a,e,e,f]
    W17 = ein("...ebef->...bef", T)                           # T[e,b,e,f]

    # Spatial-broadcast cases 1, 3, 7 (scalars fold into K).
    Z = (T_ab @ Kc[0]) * S + (T_ab @ Kc[6]) * trA + (T_bc @ Kc[2]) * S

    # Row-broadcast cases 2, 4, 8, 11: u[x] K * R[y].
    U = torch.cat([T_a, T_b, Tdiag_bc_a, Tdiag_ac_b], dim=-1)     # [..., P, 4C]
    K_B = torch.cat([Kc[1], Kc[3], Kc[7], Kc[10]], dim=0)          # [4C, Co]
    Z = Z + (U @ K_B)[..., :, None, :] * R[..., None, :, None]

    # Adj-broadcast cases 5, 14, 15, 18: Ap[x,y] * (t K).
    t_cat = torch.cat([T_full, s14, s15, t18], dim=-1)             # [..., 4C]
    K_C = torch.cat([Kc[4], Kc[13], Kc[14], Kc[17]], dim=0)
    Z = Z + Ap[..., None] * (t_cat @ K_C)[..., None, None, :]

    # Full-map cases 6, 9, 10, 12, 13, 16, 17: one [P^2, 7C] product.
    M = torch.cat([
        ein("...abdf,...d->...abf", T, R),                    # 6
        ein("...aef,...de->...adf", T_ab, Ap),                # 9
        ein("...dbcf,...d->...bcf", T, R),                    # 10
        ein("...ebf,...de->...bdf", T_ab, Ap),                # 12
        ein("...bef,...de->...bdf", T_bc, Ap),                # 13
        ein("...aef,...de->...adf", W16, Ap),                 # 16
        ein("...bef,...de->...bdf", W17, Ap),                 # 17
    ], dim=-1)
    K_D = torch.cat([Kc[i] for i in (5, 8, 9, 11, 12, 15, 16)], dim=0)
    return Z + M @ K_D


def smp2d_layer_fused(T: torch.Tensor, A: torch.Tensor, K: torch.Tensor,
                      b: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """One SMP second-order layer: the fused bank with K, plus the bias b
    [Cout], then LeakyReLU with slope ``alpha``."""
    return leaky_relu(risi18_matmul_fused(T, A, K) + b, alpha)
