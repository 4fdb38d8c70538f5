"""The 18-case bank and its product with K over materialised slots
(counterpart of ``graphflow_tpu/ops/risi_pallas.py``).

    Z = reshape(RisiContraction_18(T, A)) @ K
    T [N, P, P, P, C], A [N, P, P], K [18C, Cout] -> Z [N, P, P, Cout]

Where the level (``ops/risi_level.py``) gathers its slots inside the
kernel, the bank reads them from T, which the take-gather has already
materialised.  ``models/smp2d.py:risi18_bank_level`` is the level through
the bank, a ``level_fn=`` choice; the JAX package takes this route where
its fused level does not apply.

``risi18_bank_reference`` is the plain PyTorch version.  ``risi18_bank``
is the wrapper: on CPU tensors it runs the plain version, which torch
autograd differentiates; on CUDA tensors it runs ``_Risi18BankFn``, whose
forward launches the hand-written kernel ``csrc/risi18_bank.cu`` (K4) and
whose backward launches ``csrc/risi18_bank_bwd.cu`` (K5), or raises.
``risi18_bank_backward`` is the backward's wrapper and
``risi18_bank_backward_reference`` its plain version.
``risi18_bank_factored_reference`` and
``risi18_bank_backward_factored_reference`` are the same two functions in
the algebra the kernels use (nine map products and the adjacency applied
once; dK and the cotangents as products with G, G.Ap, G.R and GA); the
level's factored versions (``ops/risi_level.py``) call them.

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
from graphflow_tpu_torch.ops.risi_level import (_bind_min_smem, _bind_plan,
                                                _check, _check_element_type,
                                                _entry, _raise_on, _stream,
                                                _where, check_smem,
                                                query_plan)

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


def _bank_reductions(T, A):
    """The shared reductions of slots T [N,P,P,P,C] (a, b, c, channel) that
    the kernels form per vertex and chunk (``csrc/risi18_level_common.cuh``),
    and the adjacency's: the maps are [N,P,P,C], the vectors [N,P,C], the
    scalars [N,C]; ``Ap`` is the guarded adjacency, ``R`` its row sums,
    ``S`` and ``trA`` its sum and trace."""
    Ap = A.clamp(min=0)
    R = Ap.sum(-1)
    tab = T.sum(3)                                       # T_ab[a,b]
    dbc = T.diagonal(dim1=2, dim2=3).movedim(-1, 2)      # T[a,b,b]
    dac = T.diagonal(dim1=1, dim2=3).movedim(-1, 1)      # T[a,b,a]
    return dict(
        Ap=Ap, R=R, S=R.sum(-1), trA=Ap.diagonal(dim1=1, dim2=2).sum(-1),
        tab=tab, tabT=tab.transpose(1, 2), tbc=T.sum(1), dbc=dbc,
        dacT=dac.transpose(1, 2),
        m6=torch.einsum("nabcf,nc->nabf", T, R),
        m10=torch.einsum("nabcf,na->nbcf", T, R),
        ta=tab.sum(2), tb=tab.sum(1), tdbc=dbc.sum(2), tdac=dac.sum(1),
        tfull=tab.sum((1, 2)),
        s14=tab.diagonal(dim1=1, dim2=2).sum(-1),
        s15=dbc.sum((1, 2)),
        t18=dbc.diagonal(dim1=1, dim2=2).sum(-1))


def _bank_factored(T, A, K):
    """Z [N,P,P,Cout] of the bank in the factored algebra, in T's dtype
    with no cast (:func:`risi18_bank_factored_reference`)."""
    C = T.shape[-1]
    m = _bank_reductions(T, A)
    Kc = K.reshape(18, C, -1)
    S, trA = m["S"][:, None, None, None], m["trA"][:, None, None, None]
    Z = ((m["tab"] * S) @ Kc[0] + (m["tab"] * trA) @ Kc[6]
         + (m["tbc"] * S) @ Kc[2] + m["m6"] @ Kc[5] + m["m10"] @ Kc[9])
    W = (m["tab"] @ Kc[8] + m["tabT"] @ Kc[11] + m["tbc"] @ Kc[12]
         + m["dbc"] @ Kc[15] + m["dacT"] @ Kc[16])
    U = (m["ta"] @ Kc[1] + m["tb"] @ Kc[3] + m["tdbc"] @ Kc[7]
         + m["tdac"] @ Kc[10])
    s = (m["tfull"] @ Kc[4] + m["s14"] @ Kc[13] + m["s15"] @ Kc[14]
         + m["t18"] @ Kc[17])
    return (Z + torch.einsum("nye,nxeo->nxyo", m["Ap"], W)
            + m["R"][:, None, :, None] * U[:, :, None, :]
            + m["Ap"][..., None] * s[:, None, None, :])


def risi18_bank_factored_reference(T, A, K):
    """The bank as K4 (``csrc/risi18_bank.cu``) factors it, in plain
    PyTorch: the 18 cases never stand side by side.  With K_k the k-th
    [C, Cout] slab of K (k = 1..18), per vertex

        Z[x,y] = T_ab[x,y] (S K1 + trA K7) + T_bc[x,y] S K3
                 + M6[x,y] K6 + M10[x,y] K10
                 + sum_e Ap[y,e] W[x,e] + R[y] U[x] + Ap[x,y] s,
        W[x,e] = T_ab[x,e] K9 + T_ab[e,x] K12 + T_bc[x,e] K13
                 + D_bc[x,e] K16 + D_ac[e,x] K17,
        U[x]   = T_a[x] K2 + T_b[x] K4 + Tdbc[x] K8 + Tdac[x] K11,
        s      = Tfull K5 + s14 K14 + s15 K15 + t18 K18:

    nine products of a [P*P, C] map instead of eighteen, and the adjacency
    applied once, to W.  Computed as :func:`risi18_bank_reference` computes
    (float32 for float32 or bfloat16 inputs, float64 for float64) and cast
    to T's dtype once: the same function in another order of sums."""
    ct = _compute_dtype(T)
    return _bank_factored(T.to(ct), A.to(ct), K.to(ct)).to(T.dtype)


def _bank_backward_factored(T, A, K, G):
    """(dT, dK) of the bank for the cotangent G [N,P,P,Cout], in the
    factored algebra, in T's dtype with no cast
    (:func:`risi18_bank_backward_factored_reference`)."""
    N, P, _, _, C = T.shape
    Cout = K.shape[1]
    m = _bank_reductions(T, A)
    Ap, R = m["Ap"], m["R"]
    S, trA = m["S"][:, None, None, None], m["trA"][:, None, None, None]
    GAp = torch.einsum("nxyo,nye->nxeo", G, Ap)
    GR = torch.einsum("nxyo,ny->nxo", G, R)
    GA = torch.einsum("nxy,nxyo->no", Ap, G)

    def maps(a, x):       # sum over vertices and rows: [C, Cout]
        return torch.einsum("nxyf,nxyo->fo", a, x)

    def vecs(a, x):
        return torch.einsum("nxf,nxo->fo", a, x)

    def scal(a):
        return torch.einsum("nf,no->fo", a, GA)

    dK = torch.stack([
        maps(m["tab"] * S, G), vecs(m["ta"], GR), maps(m["tbc"] * S, G),
        vecs(m["tb"], GR), scal(m["tfull"]), maps(m["m6"], G),
        maps(m["tab"] * trA, G), vecs(m["tdbc"], GR), maps(m["tab"], GAp),
        maps(m["m10"], G), vecs(m["tdac"], GR), maps(m["tabT"], GAp),
        maps(m["tbc"], GAp), scal(m["s14"]), scal(m["s15"]),
        maps(m["dbc"], GAp), maps(m["dacT"], GAp), scal(m["t18"]),
    ]).reshape(18 * C, Cout)

    Kc = K.reshape(18, C, Cout)

    def back(x, k):       # x [..., Cout] against slab k: [..., C]
        return x @ Kc[k].T

    eye = torch.eye(P, dtype=T.dtype, device=T.device)[None, :, :, None]
    d_ta, d_tb = back(GR, 1), back(GR, 3)
    d_tdbc, d_tdac = back(GR, 7), back(GR, 10)
    d_tfull, d_s14 = back(GA, 4), back(GA, 13)
    d_s15, d_t18 = back(GA, 14), back(GA, 17)
    d_tab = (S * back(G, 0) + trA * back(G, 6) + back(GAp, 8)
             + back(GAp, 11).transpose(1, 2) + d_ta[:, :, None]
             + d_tfull[:, None, None] + eye * d_s14[:, None, None])
    d_tbc = S * back(G, 2) + back(GAp, 12) + d_tb[:, :, None]
    d_m6, d_m10 = back(G, 5), back(G, 9)
    d_dbc = (back(GAp, 15) + d_tdbc[:, :, None] + d_s15[:, None, None]
             + eye * d_t18[:, None, None])
    d_dac = back(GAp, 16).transpose(1, 2) + d_tdac[:, None, :]
    dT = (d_tab[:, :, :, None] + d_tbc[:, None]
          + d_m6[:, :, :, None] * R[:, None, None, :, None]
          + R[:, :, None, None, None] * d_m10[:, None]
          + eye[:, None] * d_dbc[:, :, :, None]
          + eye[:, :, None] * d_dac[:, :, :, None])
    return dT, dK


def risi18_bank_backward_factored_reference(T, A, K, g):
    """The bank's gradients as K5 (``csrc/risi18_bank_bwd.cu``) forms them,
    in plain PyTorch, without differentiating the 18 cases: with G the
    cotangent g [N,P,P,Cout], GAp[x,e] = sum_y G[x,y] Ap[y,e], GR[x] =
    sum_y G[x,y] R[y] and GA = sum_{x,y} Ap[x,y] G[x,y], dK's cases are
    products of the forward's reductions with G, GAp, GR or GA (ten map
    slabs, four vectors, four scalars); the reductions' cotangents are
    products of those with K's slabs; and

        dT[a,b,c] = dTab[a,b] + dTbc[b,c] + dM6[a,b] R[c] + R[a] dM10[b,c]
                    + d(b,c) dDbc[a,b] + d(a,c) dDac[a,b].

    -> (dT in T's dtype, dK in K's dtype), each computed as
    :func:`risi18_bank_backward_reference` computes and rounded once."""
    ct = _compute_dtype(T)
    dT, dK = _bank_backward_factored(T.to(ct), A.to(ct), K.to(ct), g.to(ct))
    return dT.to(T.dtype), dK.to(K.dtype)


# -- the row-tiled decomposition ---------------------------------------------
# Where a field's maps do not fit one block (P >= 36 forward, >= 33 backward
# at Cout = 32), the kernels walk the rows x of Z in tiles X: spread over a
# cluster of blocks (K1 and K4: ``csrc/risi18_forward_block.cuh:
# forward_block_cluster``; K2 kernel 1 and K5 kernel 1:
# ``csrc/risi18_backward_block.cuh:backward_block_cluster``), or one block a
# vertex (K6's variants: ``forward_block_tiled``; K4 where a field fits
# no cluster plan).  The functions below are those
# decompositions in plain PyTorch, for the CPU tests: each tile is computed
# from the slot data the kernels stream for it and nothing else.  Nothing
# on the main path calls them.

def _tile_maps(T, R, x0, x1, slot_sums=None):
    """The maps of the rows [x0, x1) (``_bank_reductions``' names, map row
    x - x0), from the whole slots a in [x0, x1) and the rows b in [x0, x1)
    of every slot only, as ``csrc/risi18_level_common.cuh:
    tile_reductions`` forms them.  ``slot_sums``: (T_ab, M6) [N, P, P, C]
    of every slot formed another way (the tensor-copy route's, from rows
    in storage order: ``ops/risi_level.py:risi18_slot_row_sums_reference``),
    which give the whole slots' rows b outside [x0, x1)."""
    Tw = T[:, x0:x1]                 # whole slots   [N, nx, P(b), P(c), C]
    Tr = T[:, :, x0:x1]              # rows of slots [N, P(a), nx, P(c), C]
    tab = Tw.sum(3)                                     # T_ab[x, y]
    m6 = torch.einsum("nxbcf,nc->nxbf", Tw, R)
    if slot_sums is not None:
        outside = torch.ones(T.shape[2], dtype=torch.bool, device=T.device)
        outside[x0:x1] = False
        outside = outside[None, None, :, None]
        tab = torch.where(outside, slot_sums[0][:, x0:x1], tab)
        m6 = torch.where(outside, slot_sums[1][:, x0:x1], m6)
    tabT = Tr.sum(3).transpose(1, 2)                    # T_ab[y, x]
    dbc = Tw.diagonal(dim1=2, dim2=3).movedim(-1, 2)    # T[x, y, y]
    dacT = Tr.diagonal(dim1=1, dim2=3).movedim(-1, 2)   # T[y, x, y]
    return dict(
        tab=tab, tabT=tabT, tbc=Tr.sum(1), dbc=dbc, dacT=dacT, m6=m6,
        m10=torch.einsum("naxcf,na->nxcf", Tr, R),
        ta=tab.sum(2), tb=tabT.sum(2), tdbc=dbc.sum(2), tdac=dacT.sum(2))


def _tiles(P, rows):
    return [(x0, min(P, x0 + rows)) for x0 in range(0, P, rows)]


def _adjacency(A):
    Ap = A.clamp(min=0)
    R = Ap.sum(-1)
    return (Ap, R, R.sum(-1)[:, None, None, None],
            Ap.diagonal(dim1=1, dim2=2).sum(-1)[:, None, None, None])


def risi18_bank_tiled_reference(T, A, K, rows):
    """Z of the bank (:func:`risi18_bank_factored_reference`) in row tiles
    of ``rows`` rows, as ``forward_block_tiled`` forms it: the four scalars
    (Tfull, s14, s15, t18) in a pass of their own over every slot, then per
    tile X the maps of its rows (:func:`_tile_maps`), its rows of Z, W and
    U, and Z's rows X = the direct products + W against the adjacency +
    R U + Ap s.  Computed in float32 (float64 for float64) and cast to T's
    dtype once."""
    ct, dtype = _compute_dtype(T), T.dtype
    T, A, K = T.to(ct), A.to(ct), K.to(ct)
    N, P, _, _, C = T.shape
    Kc = K.reshape(18, C, -1)
    Ap, R, S, trA = _adjacency(A)
    # The scalars' own pass: sum T, sum T[a,a,c], sum T[a,b,b], T[a,a,a].
    d_aa = T.diagonal(dim1=1, dim2=2)                   # [N, P(c), C, P(a)]
    s = (T.sum((1, 2, 3)) @ Kc[4] + d_aa.sum((1, 3)) @ Kc[13]
         + T.diagonal(dim1=2, dim2=3).sum((1, 3)) @ Kc[14]
         + d_aa.diagonal(dim1=1, dim2=3).sum(-1) @ Kc[17])
    Z = []
    for x0, x1 in _tiles(P, rows):
        m = _tile_maps(T, R, x0, x1)
        z = ((m["tab"] * S) @ Kc[0] + (m["tab"] * trA) @ Kc[6]
             + (m["tbc"] * S) @ Kc[2] + m["m6"] @ Kc[5] + m["m10"] @ Kc[9])
        W = (m["tab"] @ Kc[8] + m["tabT"] @ Kc[11] + m["tbc"] @ Kc[12]
             + m["dbc"] @ Kc[15] + m["dacT"] @ Kc[16])
        U = (m["ta"] @ Kc[1] + m["tb"] @ Kc[3] + m["tdbc"] @ Kc[7]
             + m["tdac"] @ Kc[10])
        Z.append(z + torch.einsum("nye,nxeo->nxyo", Ap, W)
                 + R[:, None, :, None] * U[:, :, None, :]
                 + Ap[:, x0:x1, :, None] * s[:, None, None, :])
    return torch.cat(Z, 1).to(dtype)


def risi18_bank_cluster_reference(T, A, K, rows, cluster, slot_sums=None):
    """Z of the bank (:func:`risi18_bank_factored_reference`) as
    ``csrc/risi18_forward_block.cuh:forward_block_cluster`` forms it: the
    row tiles of ``rows`` rows spread over a cluster of ``cluster`` blocks,
    block ``rank`` taking the tiles rank, rank + cluster, ...  Per own tile
    X: its maps (:func:`_tile_maps`), its rows of the pre-activation
    (the direct products + W against the adjacency + R U) and the block's
    part of s from the tile's whole slots (Tfull K5 + s14 K14 + s15 K15 +
    t18 K18 over the slots a in X); s = the blocks' parts added in rank
    order; then Z's rows X = pre + Ap s.  No pass over the slots for the
    scalars alone.  ``slot_sums`` as :func:`_tile_maps` takes it.  Computed
    in float32 (float64 for float64) and cast to T's dtype once."""
    ct, dtype = _compute_dtype(T), T.dtype
    T, A, K = T.to(ct), A.to(ct), K.to(ct)
    N, P, _, _, C = T.shape
    Kc = K.reshape(18, C, -1)
    Ap, R, S, trA = _adjacency(A)
    tiles = _tiles(P, rows)
    pre, parts = [None] * len(tiles), []
    for rank in range(cluster):
        part = torch.zeros(N, Kc.shape[2], dtype=ct, device=T.device)
        for t in range(rank, len(tiles), cluster):
            x0, x1 = tiles[t]
            m = _tile_maps(T, R, x0, x1, slot_sums)
            z = ((m["tab"] * S) @ Kc[0] + (m["tab"] * trA) @ Kc[6]
                 + (m["tbc"] * S) @ Kc[2] + m["m6"] @ Kc[5]
                 + m["m10"] @ Kc[9])
            W = (m["tab"] @ Kc[8] + m["tabT"] @ Kc[11] + m["tbc"] @ Kc[12]
                 + m["dbc"] @ Kc[15] + m["dacT"] @ Kc[16])
            U = (m["ta"] @ Kc[1] + m["tb"] @ Kc[3] + m["tdbc"] @ Kc[7]
                 + m["tdac"] @ Kc[10])
            pre[t] = (z + torch.einsum("nye,nxeo->nxyo", Ap, W)
                      + R[:, None, :, None] * U[:, :, None, :])
            own = torch.arange(x1 - x0, device=T.device)
            part = part + (m["ta"].sum(1) @ Kc[4]
                           + m["tab"][:, own, x0 + own].sum(1) @ Kc[13]
                           + m["tdbc"].sum(1) @ Kc[14]
                           + m["dbc"][:, own, x0 + own].sum(1) @ Kc[17])
        parts.append(part)
    s = parts[0]
    for part in parts[1:]:
        s = s + part
    Z = [pre[t] + Ap[:, x0:x1, :, None] * s[:, None, None, :]
         for t, (x0, x1) in enumerate(tiles)]
    return torch.cat(Z, 1).to(dtype)


def backward_sums_reference(G, A):
    """Kernel 0 of K2's and K5's cluster plans
    (``csrc/risi18_backward_block.cuh:backward_sums_kernel``) in plain
    PyTorch, in G's dtype: for G [N,P,P,Cout] and the guarded adjacency
    Ap of A, GAp[x,e] = sum_y G[x,y] Ap[y,e] and the row sums GR[x] =
    sum_y R[y] G[x,y], GAx[x] = sum_y Ap[x,y] G[x,y] and GSx[x] =
    sum_y G[x,y] -> (gap [N,P,P,Cout], sums [N,3,P,Cout]: GR, GAx, GSx)."""
    Ap = A.clamp(min=0)
    R = Ap.sum(-1)
    GAp = torch.einsum("nxyo,nye->nxeo", G, Ap)
    sums = torch.stack([torch.einsum("nxyo,ny->nxo", G, R),
                        torch.einsum("nxy,nxyo->nxo", Ap, G), G.sum(2)], 1)
    return GAp, sums


def _bank_backward_cluster(T, A, K, G, rows, cluster, slot_sums=None):
    """(dT, dK, [db's part of each block]) of the bank for the cotangent G
    [N, P, P, Cout] in row tiles of ``rows`` rows over a cluster of
    ``cluster`` blocks, block ``rank`` taking the tiles rank, rank +
    cluster, ..., in T's dtype (no rounding): see
    :func:`risi18_bank_backward_cluster_reference` (``slot_sums`` as
    :func:`_tile_maps` takes it)."""
    N, P, _, _, C = T.shape
    Cout, dev, ct = K.shape[1], T.device, T.dtype
    Kc = K.reshape(18, C, Cout)
    Ap, R, S, trA = _adjacency(A)
    tiles = _tiles(P, rows)
    # Kernel 0, once a vertex: GAp, and per row GR, GA's and db's sums.
    GAp, sums = backward_sums_reference(G, A)
    GR, GAx, GSx = sums.unbind(1)

    def own_tiles(rank):
        return [tiles[t] for t in range(rank, len(tiles), cluster)]

    def back(x, k):        # x [..., Cout] against slab k: [..., C]
        return x @ Kc[k].T

    def maps(a, x):
        return torch.einsum("nxyf,nxyo->fo", a, x)

    def vecs(a, x):
        return torch.einsum("nxf,nxo->fo", a, x)

    # 0. GA from every row's sum; db's part of each block from its rows.
    GA = GAx.sum(1)
    db_parts = [sum(GSx[:, x0:x1].sum((0, 1)) for x0, x1 in own_tiles(rank))
                for rank in range(cluster)]

    # 1. dK, block by block: the own tiles' map and vector cases (G of the
    #    tile's rows, GAp and GR of them from kernel 0), then the block's
    #    part of the four scalars times GA; added in rank order.
    dK = torch.zeros(18, C, Cout, dtype=ct)
    for rank in range(cluster):
        dKr = torch.zeros(18, C, Cout, dtype=ct)
        sc = torch.zeros(4, N, C, dtype=ct)       # Tfull, s14, s15, t18
        for x0, x1 in own_tiles(rank):
            m = _tile_maps(T, R, x0, x1, slot_sums)
            Gx, GApx, GRx = G[:, x0:x1], GAp[:, x0:x1], GR[:, x0:x1]
            for k, a, x in ((0, m["tab"] * S, Gx), (2, m["tbc"] * S, Gx),
                            (5, m["m6"], Gx), (6, m["tab"] * trA, Gx),
                            (8, m["tab"], GApx), (9, m["m10"], Gx),
                            (11, m["tabT"], GApx), (12, m["tbc"], GApx),
                            (15, m["dbc"], GApx), (16, m["dacT"], GApx)):
                dKr[k] += maps(a, x)
            for k, a in ((1, m["ta"]), (3, m["tb"]), (7, m["tdbc"]),
                         (10, m["tdac"])):
                dKr[k] += vecs(a, GRx)
            own = torch.arange(x1 - x0, device=dev)
            sc += torch.stack([m["ta"].sum(1),
                               m["tab"][:, own, x0 + own].sum(1),
                               m["tdbc"].sum(1),
                               m["dbc"][:, own, x0 + own].sum(1)])
        for k, j in ((4, 0), (13, 1), (14, 2), (17, 3)):
            dKr[k] = torch.einsum("nf,no->fo", sc[j], GA)
        dK = dK + dKr

    # 2. dT, which needs G and not T, one pass a row tile Xb: the B maps of
    #    the rows b in Xb (at (b, y)) and the A maps of every row a at the
    #    columns Xb (at (a, b)), each a sum of products of G, GAp and GR's
    #    rows with K's slabs, S and trA folded into the slabs of G; then
    #    dT[:, Xb] = A + A6 R[c] + d(b,c) A15 + B11[b,a] + Bbc[b,c]
    #    + R[a] B9[b,c] + d(a,c) B16[b,a] for every a and c.
    s = S[:, 0, 0, 0, None, None]
    KA = s * Kc[0] + trA[:, 0, 0, 0, None, None] * Kc[6]     # [N, C, Cout]
    KB = s * Kc[2]

    def back_v(x, k):      # x [N, ..., Cout] against a vertex's slab k
        return torch.einsum("n...o,nfo->n...f", x, k)

    d_tfull, d_s14 = back(GA, 4)[:, None, None], back(GA, 13)[:, None, None]
    d_s15, d_t18 = back(GA, 14)[:, None, None], back(GA, 17)[:, None, None]
    cols = torch.arange(P, device=dev)
    dT = torch.empty_like(T)
    for xb0, xb1 in tiles:
        # The B maps, rows (b, y).
        Gb, GApb, GRb = G[:, xb0:xb1], GAp[:, xb0:xb1], GR[:, xb0:xb1, None]
        tabT = back(GApb, 11)
        tbc = back_v(Gb, KB) + back(GApb, 12) + back(GRb, 3)
        m10 = back(Gb, 9)
        dacT = back(GApb, 16) + back(GRb, 10)
        # The A maps, rows (a, b).
        Ga, GApa, GRa = G[:, :, xb0:xb1], GAp[:, :, xb0:xb1], GR[:, :, None]
        rb = torch.arange(xb0, xb1, device=dev)
        diag = (cols[:, None] == rb[None])[None, :, :, None]
        tab = (back_v(Ga, KA) + back(GApa, 8) + back(GRa, 1) + d_tfull
               + diag * d_s14)
        m6 = back(Ga, 5)
        dbc = back(GApa, 15) + back(GRa, 7) + d_s15 + diag * d_t18
        # The assembly, dT[a, b, c] for b in Xb.
        d_bc = (rb[:, None] == cols[None])[None, None, :, :, None]
        d_ac = (cols[:, None] == cols[None])[None, :, None, :, None]
        dT[:, :, xb0:xb1] = (
            tab[:, :, :, None] + m6[:, :, :, None] * R[:, None, None, :, None]
            + d_bc * dbc[:, :, :, None]
            + tabT.transpose(1, 2)[:, :, :, None] + tbc[:, None]
            + R[:, :, None, None, None] * m10[:, None]
            + d_ac * dacT.transpose(1, 2)[:, :, :, None])
    return dT, dK.reshape(18 * C, Cout), db_parts


def risi18_bank_backward_cluster_reference(T, A, K, g, rows, cluster):
    """(dT, dK) of the bank (:func:`risi18_bank_backward_factored_reference`)
    as ``csrc/risi18_backward_block.cuh:backward_block_cluster`` forms
    them: the row tiles of ``rows`` rows spread over a cluster of
    ``cluster`` blocks, block ``rank`` taking the tiles rank, rank +
    cluster, ...  Kernel 0 (:func:`backward_sums_reference`) forms GAp and
    the row sums of G once a vertex; GA = the sum of every row's.  dK: per
    block, its tiles' maps (:func:`_tile_maps`) against G and GAp of their
    rows, its vectors against GR, and its part of the four scalars times
    GA; the blocks' dK added in rank order.  dT, which needs G and not T,
    one pass a row tile Xb: the B maps of the rows b in Xb and the A maps
    of every row a at the columns Xb, products of G, GAp and GR with K's
    slabs (S K1 + trA K7 and S K3 per vertex), then dT[:, Xb, :] = A + A6
    R[c] + d(b,c) A15 + B11[b,a] + Bbc[b,c] + R[a] B9[b,c] + d(a,c)
    B16[b,a].  -> (dT in T's dtype, dK in K's), computed in float32
    (float64) and rounded once."""
    ct = _compute_dtype(T)
    dT, dK, _ = _bank_backward_cluster(T.to(ct), A.to(ct), K.to(ct),
                                       g.to(ct), rows, cluster)
    return dT.to(T.dtype), dK.to(K.dtype)


def risi18_bank_backward_tiled_reference(T, A, K, g, rows):
    """(dT, dK) of the bank (:func:`risi18_bank_backward_factored_reference`)
    in row tiles of ``rows`` rows: :func:`risi18_bank_backward_cluster_reference`
    with one block, which walks every tile (dK: per tile X its maps against
    G and GAp of its rows and its vectors against GR of its rows, the four
    scalars summed tile by tile, times GA; dT one pass a tile), as K5's
    cluster plan of one block (``backward_block_cluster``) forms them.
    -> (dT in T's dtype, dK in K's), computed in float32 (float64) and
    rounded once."""
    return risi18_bank_backward_cluster_reference(T, A, K, g, rows, 1)


@functools.lru_cache(maxsize=None)
def _forward_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_bank")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.risi18_bank_forward_f32, lib.risi18_bank_forward_bf16):
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        fn.restype = i32
    _bind_min_smem(lib.risi18_bank_min_smem_bytes)
    _bind_plan(lib.risi18_bank_plan)
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
        fn.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        fn.restype = i32
    for fn in (lib.risi18_bank_backward_sums_f32,
               lib.risi18_bank_backward_sums_bf16):
        fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        fn.restype = i32
    lib.risi18_bank_backward_reduce.argtypes = [ptr] * 2 + [i32] * 3 + [ptr]
    lib.risi18_bank_backward_reduce.restype = i32
    _bind_min_smem(lib.risi18_bank_backward_min_smem_bytes)
    _bind_plan(lib.risi18_bank_backward_plan)
    lib.risi18_bank_bwd_error_string.argtypes = [i32]
    lib.risi18_bank_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def bank_plan(N, P, C, Cout, dtype=torch.float32):
    """K4's plan for N vertices (``ops/risi_level.py:query_plan``)."""
    return query_plan(_forward_lib().risi18_bank_plan, N, P, C, Cout, dtype)


@functools.lru_cache(maxsize=None)
def bank_backward_plan(N, P, C, Cout, dtype=torch.float32):
    """K5 kernel 1's plan for N vertices (``ops/risi_level.py:
    query_plan``, with kernel 0's scratch)."""
    return query_plan(_backward_lib().risi18_bank_backward_plan, N, P, C,
                      Cout, dtype, backward=True)


def _check_bank(T, A, K):
    """Checks the inputs both kernels share; returns (N, P, C, Cout)."""
    if T.dim() != 5:
        raise ValueError(f"T has shape {tuple(T.shape)}, expected "
                         f"[N, P, P, P, C]")
    N, P, _, _, C = T.shape
    Cout = K.shape[1] if K.dim() == 2 else -1
    _check_element_type("T", T)
    dev = T.device
    _check("T", T, T.dtype, (N, P, P, P, C), dev)
    _check("A", A, torch.float32, (N, P, P), dev)
    _check("K", K, T.dtype, (18 * C, Cout), dev)
    return N, P, C, Cout


def _forward_kernel(T, A, K):
    """K4: one launch of ``risi18_bank_forward_{f32,bf16}``.  A cluster
    plan keeps its pre-activations in float32 until the cluster has summed
    the scalar cases: in Z itself in float32, in a float32 scratch [N, P*P,
    Cout] in bfloat16."""
    N, P, C, Cout = _check_bank(T, A, K)
    dev, dt = T.device, T.dtype
    lib = _forward_lib()
    check_smem("risi18_bank", lib.risi18_bank_min_smem_bytes, P, Cout)
    Z = torch.empty((N, P, P, Cout), dtype=dt, device=dev)
    plan = bank_plan(N, P, C, Cout, dt)
    pre = Z
    if dt != torch.float32 and plan is not None and plan["cluster"]:
        pre = torch.empty((N, P * P, Cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry(lib, "risi18_bank_forward", dt)(
            T.data_ptr(), A.data_ptr(), K.data_ptr(), Z.data_ptr(),
            pre.data_ptr(), N, P, C, Cout, _stream(dev))
    _raise_on(err, "risi18_bank", lib.risi18_bank_error_string,
              _where(N, P, C, Cout, dt) + (f", plan {plan}" if err else ""))
    risi18_bank.launches += 1
    return Z


def _backward_sums_kernel(A, g):
    """K5, kernel 0 (``risi18_bank_backward_sums_{f32,bf16}``): once a
    vertex, GAp and the row sums of g, the float32 scratch kernel 1 reads on
    a cluster plan; returns (gap [N,P,P,Cout], sums [N,3,P,Cout]: GR,
    GAx, GSx), float32."""
    _check_element_type("g", g)
    if g.dim() != 4:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"[N, P, P, Cout]")
    N, P, _, Cout = g.shape
    dev, dt = g.device, g.dtype
    _check("A", A, torch.float32, (N, P, P), dev)
    _check("g", g, dt, (N, P, P, Cout), dev)
    lib = _backward_lib()
    gap = torch.empty((N, P, P, Cout), dtype=torch.float32, device=dev)
    sums = torch.empty((N, 3, P, Cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry(lib, "risi18_bank_backward_sums", dt)(
            A.data_ptr(), g.data_ptr(), gap.data_ptr(), sums.data_ptr(), N,
            P, Cout, _stream(dev))
    _raise_on(err, "risi18_bank_backward sums",
              lib.risi18_bank_bwd_error_string,
              f"N={N} P={P} Cout={Cout} {dt}")
    risi18_bank_backward.sums_launches += 1
    return gap, sums


def risi18_bank_backward_sums_reference(A, g):
    """Plain kernel 0 of the bank's backward: :func:`backward_sums_reference`
    of g [N,P,P,Cout] computed in float32 (float64 stays float64) -> (gap
    [N,P,P,Cout], sums [N,3,P,Cout])."""
    ct = _compute_dtype(g)
    return backward_sums_reference(g.to(ct), A.to(ct))


def risi18_bank_backward_sums(A, g):
    """Kernel 0 of the bank's backward on a cluster plan: A [N,P,P], g
    [N,P,P,Cout] -> (gap [N,P,P,Cout], sums [N,3,P,Cout]: GR, GAx, GSx),
    float32 (float64 for float64 on the CPU).  CPU tensors run
    :func:`risi18_bank_backward_sums_reference`; CUDA tensors launch kernel
    0 (``csrc/risi18_bank_bwd.cu``), or raise."""
    if g.device.type == "cpu":
        return risi18_bank_backward_sums_reference(A, g)
    if g.device.type != "cuda":
        raise ValueError(f"no bank kernel for device {g.device}")
    return _backward_sums_kernel(A, g)


def _backward_main_kernel(T, A, K, g, sums=None):
    """K5, kernel 1: dT (every element written) and per-block partial rows
    of dK; returns (dT, partial).  On a cluster plan kernel 0
    (:func:`_backward_sums_kernel`) runs first, and kernel 1 reads its
    scratch (the plan's ``scratch_bytes``), or the (gap, sums) that
    ``sums`` gives (a timing of kernel 1 alone)."""
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
    plan = bank_backward_plan(N, P, C, Cout, T.dtype)
    gap = None
    if plan is not None and plan["cluster"]:
        gap, sums = _backward_sums_kernel(A, g) if sums is None else sums
    else:
        sums = None
    with torch.cuda.device(T.device):
        err = _entry(lib, "risi18_bank_backward", T.dtype)(
            T.data_ptr(), A.data_ptr(), K.data_ptr(), g.data_ptr(),
            None if gap is None else gap.data_ptr(),
            None if sums is None else sums.data_ptr(), dT.data_ptr(),
            partial.data_ptr(), N, P, C, Cout, nblocks, _stream(T.device))
    _raise_on(err, "risi18_bank_backward", lib.risi18_bank_bwd_error_string,
              _where(N, P, C, Cout, T.dtype) + (f", plan {plan}" if err
                                                else ""))
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


risi18_bank_backward.sums_launches = 0     # kernel 0 (cluster plans)
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
