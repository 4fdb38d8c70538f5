"""The RisiContraction banks with 4, 10, 18 and 50 cases (counterpart of
``graphflow_tpu/ops/contractions.py``).

Given stacked neighbour tensors T[a, b, c, f] and a reduced adjacency
A[d, e], each case fixes two of the five indices and contracts or ties the
rest (``RisiContraction_18.h:73-331``, ``RisiContraction_50.h:94-431``).
Every case is a scalar times a slab, an outer product with a row or column
sum of A, or one small product with A, over shared reductions of T:
O(N^3 C) work.

Only the 18-case bank applies the reference's ``adj_value > 0`` guard; the
10- and 50-case banks multiply by A as it is, and the 4-case bank takes no
adjacency.  The ``_matmul`` forms return ``reshape(bank) @ K`` without
materialising the bank: K acts on the channel axis only, so each case's
block of K is applied to that case's shared reduction.

Every function takes leading batch dimensions.  They compute in T's dtype
(float32 on the card, float64 for the parity tests).
"""

from __future__ import annotations

import torch

ein = torch.einsum

nContractions_18 = 18


def risi_contraction_4(T: torch.Tensor) -> torch.Tensor:
    """``RisiContraction_4.h:79-124``: T [..., N, N, N, C] -> [..., N, N,
    4C]: (a,b) summed over c; (b,c) summed over a; a==b; b==c.  No
    adjacency."""
    return torch.cat([T.sum(dim=-2), T.sum(dim=-4),
                      ein("...aacf->...acf", T), ein("...abbf->...abf", T)],
                     dim=-1)


def _shared_reductions(T, A):
    """The T and A reductions the 10- and 50-case banks are assembled from
    (``contractions.py:119-154``), with leading batch dimensions."""
    q = dict(S=A.sum(dim=(-2, -1)), R=A.sum(dim=-1), Rc=A.sum(dim=-2),
             diagA=torch.diagonal(A, dim1=-2, dim2=-1))
    q["trA"] = q["diagA"].sum(dim=-1)
    q["T_ab"] = T.sum(dim=-2)                                 # [..., a,b,f]
    q["T_ac"] = T.sum(dim=-3)                                 # [..., a,c,f]
    q["T_bc"] = T.sum(dim=-4)                                 # [..., b,c,f]
    q["T_a"] = q["T_ab"].sum(dim=-2)
    q["T_b"] = q["T_ab"].sum(dim=-3)
    q["T_c"] = q["T_bc"].sum(dim=-3)
    q["T_full"] = q["T_a"].sum(dim=-2)
    q["D_bc"] = ein("...abbf->...abf", T)                     # T[a,b,b,f]
    q["D_ac"] = ein("...abaf->...abf", T)                     # T[a,b,a,f]
    q["D_aab"] = ein("...aacf->...acf", T)                    # T[a,a,c,f]
    q["Dg_bc_a"] = q["D_bc"].sum(dim=-2)                      # [..., a,f]
    q["Dg_ac_b"] = q["D_ac"].sum(dim=-3)                      # [..., b,f]
    q["Dg_aab_c"] = q["D_aab"].sum(dim=-3)                    # [..., c,f]
    q["s_aab"] = q["Dg_aab_c"].sum(dim=-2)
    q["s_aba"] = q["Dg_ac_b"].sum(dim=-2)
    q["s_abb"] = q["Dg_bc_a"].sum(dim=-2)
    q["t_diag3"] = ein("...aaaf->...af", T).sum(dim=-2)
    return q


def _outer(u, v):
    """u[..., x, f] * v[..., y] -> [..., x, y, f]."""
    return u[..., :, None, :] * v[..., None, :, None]


def _scalar(s):
    return s[..., None, None, None]


def _cases_1_to_10(q, A):
    S = _scalar(q["S"])
    return [
        q["T_ab"] * S,                                        # 1 (a,b)
        q["T_ac"] * S,                                        # 2 (a,c)
        _outer(q["T_a"], q["R"]),                             # 3 (a,d)
        _outer(q["T_a"], q["Rc"]),                            # 4 (a,e)
        q["T_bc"] * S,                                        # 5 (b,c)
        _outer(q["T_b"], q["R"]),                             # 6 (b,d)
        _outer(q["T_b"], q["Rc"]),                            # 7 (b,e)
        _outer(q["T_c"], q["R"]),                             # 8 (c,d)
        _outer(q["T_c"], q["Rc"]),                            # 9 (c,e)
        A[..., None] * q["T_full"][..., None, None, :],       # 10 (d,e)
    ]


def risi_contraction_10(T: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``RisiContraction_10.h:94-228``: the 10 "fix 2, contract 3" cases.
    T [..., N, N, N, C], A [..., N, N] -> [..., N, N, 10C], depth layout
    case*C + f.  No positivity guard."""
    return torch.cat(_cases_1_to_10(_shared_reductions(T, A), A), dim=-1)


def risi_contraction_50(T: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``RisiContraction_50.h:94-431``: all 50 cases in the reference's
    order (1-10 fix two and contract three; 11-40 tie one pair of the rest;
    41-50 tie all three).  T [..., N, N, N, C], A [..., N, N] -> [..., N,
    N, 50C].  No positivity guard."""
    q = _shared_reductions(T, A)
    A3 = A[..., None]
    T_ab, T_ac, T_bc = q["T_ab"], q["T_ac"], q["T_bc"]
    R, Rc, diagA, trA = q["R"], q["Rc"], q["diagA"], _scalar(q["trA"])
    ys = _cases_1_to_10(q, A) + [
        ein("...abcf,...c->...abf", T, R),                    # 11 (a,b) c=d
        ein("...abcf,...c->...abf", T, Rc),                   # 12 (a,b) c=e
        T_ab * trA,                                           # 13 (a,b) d=e
        ein("...abcf,...b->...acf", T, R),                    # 14 (a,c) b=d
        ein("...abcf,...b->...acf", T, Rc),                   # 15 (a,c) b=e
        T_ac * trA,                                           # 16 (a,c) d=e
        _outer(q["Dg_bc_a"], R),                              # 17 (a,d) b=c
        ein("...abf,...db->...adf", T_ab, A),                 # 18 (a,d) b=e
        ein("...acf,...dc->...adf", T_ac, A),                 # 19 (a,d) c=e
        _outer(q["Dg_bc_a"], Rc),                             # 20 (a,e) b=c
        ein("...abf,...be->...aef", T_ab, A),                 # 21 (a,e) b=d
        ein("...acf,...ce->...aef", T_ac, A),                 # 22 (a,e) c=d
        ein("...abcf,...a->...bcf", T, R),                    # 23 (b,c) a=d
        ein("...abcf,...a->...bcf", T, Rc),                   # 24 (b,c) a=e
        T_bc * trA,                                           # 25 (b,c) d=e
        _outer(q["Dg_ac_b"], R),                              # 26 (b,d) a=c
        ein("...abf,...da->...bdf", T_ab, A),                 # 27 (b,d) a=e
        ein("...bcf,...dc->...bdf", T_bc, A),                 # 28 (b,d) c=e
        _outer(q["Dg_ac_b"], Rc),                             # 29 (b,e) a=c
        ein("...abf,...ae->...bef", T_ab, A),                 # 30 (b,e) a=d
        ein("...bcf,...ce->...bef", T_bc, A),                 # 31 (b,e) c=d
        _outer(q["Dg_aab_c"], R),                             # 32 (c,d) a=b
        ein("...acf,...da->...cdf", T_ac, A),                 # 33 (c,d) a=e
        ein("...bcf,...db->...cdf", T_bc, A),                 # 34 (c,d) b=e
        _outer(q["Dg_aab_c"], Rc),                            # 35 (c,e) a=b
        ein("...acf,...ae->...cef", T_ac, A),                 # 36 (c,e) a=d
        ein("...bcf,...be->...cef", T_bc, A),                 # 37 (c,e) b=d
        A3 * q["s_aab"][..., None, None, :],                  # 38 (d,e) a=b
        A3 * q["s_aba"][..., None, None, :],                  # 39 (d,e) a=c
        A3 * q["s_abb"][..., None, None, :],                  # 40 (d,e) b=c
        ein("...abcf,...c->...abf", T, diagA),                # 41 (a,b) c=d=e
        ein("...abcf,...b->...acf", T, diagA),                # 42 (a,c) b=d=e
        ein("...abf,...db->...adf", q["D_bc"], A),            # 43 (a,d) b=c=e
        ein("...abf,...be->...aef", q["D_bc"], A),            # 44 (a,e) b=c=d
        ein("...abcf,...a->...bcf", T, diagA),                # 45 (b,c) a=d=e
        ein("...abf,...da->...bdf", q["D_ac"], A),            # 46 (b,d) a=c=e
        ein("...abf,...ae->...bef", q["D_ac"], A),            # 47 (b,e) a=c=d
        ein("...acf,...da->...cdf", q["D_aab"], A),           # 48 (c,d) a=b=e
        ein("...acf,...ae->...cef", q["D_aab"], A),           # 49 (c,e) a=b=d
        A3 * q["t_diag3"][..., None, None, :],                # 50 (d,e) a=b=c
    ]
    return torch.cat(ys, dim=-1)


def _k_blocks(K, C):
    """K [nCases*C, Cout] -> {1-based case: its [C, Cout] block}."""
    return {i + 1: blk for i, blk in enumerate(K.split(C, dim=0))}


def _project_outer(q, Kb, us, cases_R, cases_Rc):
    """The outer-product cases u[x] (x) R[y] and u[x] (x) Rc[y], each u's
    block of K applied before the broadcast."""
    U = torch.cat([q[u] for u in us], dim=-1)                 # [..., N, kC]
    KR = torch.cat([Kb[k] for k in cases_R], dim=0)
    KRc = torch.cat([Kb[k] for k in cases_Rc], dim=0)
    return _outer(U @ KR, q["R"]) + _outer(U @ KRc, q["Rc"])


def risi_contraction_10_matmul(T: torch.Tensor, A: torch.Tensor,
                               K: torch.Tensor) -> torch.Tensor:
    """``reshape(risi_contraction_10(T, A)) @ K`` without the [..., N, N,
    10C] bank (``contractions.py:343-374``).  T [..., N, N, N, C], A [...,
    N, N], K [10C, Cout] -> [..., N, N, Cout]."""
    q = _shared_reductions(T, A)
    Kb = _k_blocks(K, T.shape[-1])
    S = _scalar(q["S"])
    Z = (q["T_ab"] @ Kb[1] + q["T_ac"] @ Kb[2] + q["T_bc"] @ Kb[5]) * S
    Z = Z + _project_outer(q, Kb, ("T_a", "T_b", "T_c"), (3, 6, 8),
                           (4, 7, 9))
    return Z + A[..., None] * (q["T_full"] @ Kb[10])[..., None, None, :]


def risi_contraction_50_matmul(T: torch.Tensor, A: torch.Tensor,
                               K: torch.Tensor) -> torch.Tensor:
    """``reshape(risi_contraction_50(T, A)) @ K`` without the [..., N, N,
    50C] bank (``contractions.py:377-487``).  T [..., N, N, N, C], A [...,
    N, N], K [50C, Cout] -> [..., N, N, Cout].  The cases group into five
    shapes: a slab times a scalar (S, trA fold into K); weighted index
    sums of T (weights R, Rc, diag A); outer products u[x] (x) R[y] or
    Rc[y]; one-axis products with A (four orientations); A[x,y] times a
    projected vector."""
    C, Cout = T.shape[-1], K.shape[1]
    q = _shared_reductions(T, A)
    Kb = _k_blocks(K, C)

    def scal(slab, *terms):
        # terms: (scalar [...], K block); K mixed per batch element.
        Kmix = sum(s[..., None, None] * kb for s, kb in terms)
        return slab @ Kmix[..., None, :, :]

    S, trA = q["S"], q["trA"]
    Z = (scal(q["T_ab"], (S, Kb[1]), (trA, Kb[13]))
         + scal(q["T_ac"], (S, Kb[2]), (trA, Kb[16]))
         + scal(q["T_bc"], (S, Kb[5]), (trA, Kb[25])))

    # Weighted index sums of T: weights R, Rc, diag A, three per family.
    W3 = torch.stack([q["R"], q["Rc"], q["diagA"]], dim=-2)   # [..., 3, N]
    for sub, ks in (("...abcf,...wc->...wabf", (11, 12, 41)),
                    ("...abcf,...wb->...wacf", (14, 15, 42)),
                    ("...abcf,...wa->...wbcf", (23, 24, 45))):
        E = ein(sub, T, W3)                                   # [..., 3,N,N,C]
        K3 = torch.stack([Kb[k] for k in ks])                 # [3, C, Cout]
        Z = Z + ein("...wxyf,wfo->...xyo", E, K3)

    Z = Z + _project_outer(
        q, Kb, ("T_a", "T_b", "T_c", "Dg_bc_a", "Dg_ac_b", "Dg_aab_c"),
        (3, 6, 8, 17, 26, 32), (4, 7, 9, 20, 29, 35))

    # One-axis products with A, four orientation groups over six slabs.
    slabs = torch.cat([q["T_ab"], q["T_ac"], q["T_bc"], q["D_bc"],
                       q["D_ac"], q["D_aab"]], dim=-1)        # [..., N,N,6C]

    def kcat(pairs):
        # (slab index, case) -> [6C, Cout], zero outside the named slabs.
        out = K.new_zeros((6 * C, Cout))
        for si, case in pairs:
            out[si * C:(si + 1) * C] = Kb[case]
        return out

    M = slabs @ kcat(((0, 18), (1, 19), (2, 28), (3, 43)))
    Z = Z + ein("...xmo,...ym->...xyo", M, A)                 # M[x,m] A[y,m]
    M = slabs @ kcat(((0, 27), (1, 33), (2, 34), (4, 46), (5, 48)))
    Z = Z + ein("...mxo,...ym->...xyo", M, A)                 # M[m,x] A[y,m]
    M = slabs @ kcat(((0, 21), (1, 22), (2, 31), (3, 44)))
    Z = Z + ein("...xmo,...my->...xyo", M, A)                 # M[x,m] A[m,y]
    M = slabs @ kcat(((0, 30), (1, 36), (2, 37), (4, 47), (5, 49)))
    Z = Z + ein("...mxo,...my->...xyo", M, A)                 # M[m,x] A[m,y]

    vecs = torch.cat([q["T_full"], q["s_aab"], q["s_aba"], q["s_abb"],
                      q["t_diag3"]], dim=-1)                  # [..., 5C]
    Kv = torch.cat([Kb[k] for k in (10, 38, 39, 40, 50)], dim=0)
    return Z + A[..., None] * (vecs @ Kv)[..., None, None, :]


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


def risi_contraction_18_dropout(T: torch.Tensor, A: torch.Tensor,
                                case_mask: torch.Tensor) -> torch.Tensor:
    """``RisiContraction_18_dropout.h``: case-level dropout.  ``case_mask``
    is an [18] multiplier, one per case: at train time a 0/1 mask keeping
    ``nKept`` cases (:func:`dropout_case_mask`), at eval the constant
    nKept/18."""
    y = risi_contraction_18(T, A)
    return y * torch.repeat_interleave(case_mask.to(y.dtype), T.shape[-1])


def dropout_case_mask(generator: torch.Generator, nKept: int, train: bool,
                      n_cases: int = nContractions_18,
                      device=None) -> torch.Tensor:
    """The per-case mask of :func:`risi_contraction_18_dropout`, float32:
    ``nKept`` ones at places drawn from ``generator`` when ``train``, else
    nKept / n_cases everywhere.  (torch's draw is not JAX's: both keep
    ``nKept`` cases, at other places for the same seed.)"""
    if not train:
        return torch.full((n_cases,), nKept / n_cases, device=device)
    idx = torch.randperm(n_cases, generator=generator)[:nKept]
    mask = torch.zeros(n_cases)
    mask[idx] = 1.0
    return mask.to(device)
