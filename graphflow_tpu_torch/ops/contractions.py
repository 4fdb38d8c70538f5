"""The 18-case RisiContraction bank (counterpart of
``graphflow_tpu/ops/contractions.py:risi_contraction_18``).

Given stacked neighbour tensors T[a, b, c, f] and a reduced adjacency
A[d, e], each case fixes two of the five indices and contracts or ties the
rest (``RisiContraction_18.h:73-331``).  Every case is a scalar times a
slab, an outer product with R, or one small product with Ap, over shared
reductions of T: O(N^3 C) work.

The 4/10/50-case banks and the per-case dropout mask are ROADMAP
queue 1, item 3b.
"""

from __future__ import annotations

import torch


def risi_contraction_18(T: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """T: [..., N, N, N, C] (axis -4 is the stacking axis a), A: [..., N, N]
    -> [..., N, N, 18*C] with depth layout case*C + f.

    With Ap = A * (A > 0) (the reference's ``adj_value > 0`` guard,
    ``RisiContraction_18.h:90``): S = sum Ap, R[d] = sum_e Ap[d,e],
    trA = tr Ap.  Leading dimensions are batch dimensions.
    """
    Ap = torch.where(A > 0, A, torch.zeros_like(A))
    S = Ap.sum(dim=(-2, -1))[..., None, None, None]
    R = Ap.sum(dim=-1)                                        # [..., N]
    trA = torch.diagonal(Ap, dim1=-2, dim2=-1).sum(-1)[..., None, None, None]
    ein = torch.einsum

    T_ab = T.sum(dim=-2)                                      # [..., a,b,f]
    T_bc = T.sum(dim=-4)                                      # [..., b,c,f]
    T_a = T_ab.sum(dim=-2)                                    # [..., a,f]
    T_b = T_bc.sum(dim=-2)                                    # [..., b,f]
    T_full = T_a.sum(dim=-2)                                  # [..., f]
    D_bc = ein("...abbf->...abf", T)                          # T[a,b,b,f]
    D_ac = ein("...abaf->...abf", T)                          # T[a,b,a,f]
    D_aab = ein("...aacf->...acf", T)                         # T[a,a,c,f]
    s14 = D_aab.sum(dim=(-3, -2))                             # [..., f]
    s15 = D_bc.sum(dim=(-3, -2))
    t18 = ein("...aaaf->...af", T).sum(dim=-2)
    W16 = D_bc                                                # T[a,e,e,f]
    W17 = ein("...ebef->...bef", T)                           # T[e,b,e,f]
    Tdiag_ac_b = D_ac.sum(dim=-3)                             # [..., b,f]
    Tdiag_bc_a = D_bc.sum(dim=-2)                             # [..., a,f]

    def outer_vR(u):                                          # u[x,f]*R[y]
        return u[..., :, None, :] * R[..., None, :, None]

    AoT = Ap[..., None]

    ys = [
        T_ab * S,                                        # 1  (a,b) c,d,e
        outer_vR(T_a),                                   # 2  (a,d) b,c,e
        T_bc * S,                                        # 3  (b,c) a,d,e
        outer_vR(T_b),                                   # 4  (b,d) a,c,e
        AoT * T_full[..., None, None, :],                # 5  (d,e) a,b,c
        ein("...abdf,...d->...abf", T, R),               # 6  (a,b) c==d | e
        T_ab * trA,                                      # 7  (a,b) d==e | c
        outer_vR(Tdiag_bc_a),                            # 8  (a,d) b==c | e
        ein("...aef,...de->...adf", T_ab, Ap),           # 9  (a,d) b==e | c
        ein("...dbcf,...d->...bcf", T, R),               # 10 (b,c) a==d | e
        outer_vR(Tdiag_ac_b),                            # 11 (b,d) a==c | e
        ein("...ebf,...de->...bdf", T_ab, Ap),           # 12 (b,d) a==e | c
        ein("...bef,...de->...bdf", T_bc, Ap),           # 13 (b,d) c==e | a
        AoT * s14[..., None, None, :],                   # 14 (d,e) a==b | c
        AoT * s15[..., None, None, :],                   # 15 (d,e) b==c | a
        ein("...aef,...de->...adf", W16, Ap),            # 16 (a,d) b==c==e
        ein("...bef,...de->...bdf", W17, Ap),            # 17 (b,d) a==c==e
        AoT * t18[..., None, None, :],                   # 18 (d,e) a==b==c
    ]
    return torch.cat(ys, dim=-1)
