"""Host-side graph preparation (counterpart of ``graphflow_tpu/core/prep.py``).

The reference rebuilds a computation graph per example
(``SMP_omega.h:584-693``).  All of that data-dependent work is data
preparation: Floyd-Warshall shortest paths (``:358-380``), depth-bucketed
Weisfeiler-Lehman features (``:382-404``), the exchange-sort vertex ranking
(``:418-434``) and the capped receptive fields (``:476-582``).  It runs on
the host in NumPy and emits static-shaped index arrays: the dense
permutation matrices X[v][w] become gather indices ``pos`` with the
sentinel P for "absent", which the level kernel reads as zeros.

This is the NumPy path of the JAX package, array for array, but for one
case: a vertex is at distance 0 from itself even when the graph has a self
loop (:func:`floyd_warshall`), as in the JAX package's native backend, the
one its models use by default.  The native C++ backend
(``graphflow_tpu/runtime/native.py``) is ROADMAP queue 1, item 2; the
first-order ``fo_degree`` indices come with smp1d (item 5).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from graphflow_tpu_torch.core.graph import DenseGraph

INF = 10**9  # reference GCN_1D.h:26 `const int INF = 1e9`


def floyd_warshall(adj: np.ndarray) -> np.ndarray:
    """All-pairs hop counts (``SMP_omega.h:358-380``) by min-plus squaring;
    unreachable pairs keep INF.

    A vertex is 0 hops from itself whatever ``adj[v, v]`` is.  The JAX
    package's two backends differ on a self loop: its NumPy path writes
    ``sp[adj > 0] = 1`` after the zero diagonal
    (``graphflow_tpu/core/prep.py:46-48``), so ``sp[v, v] = 1`` and the
    vertex's own feature lands in the depth-1 WL histogram; its native
    backend keeps ``sp[i, i] = 0`` (``graph_prep.cpp:66``).  The port
    follows the native one: ``backend="auto"`` picks it, so it is what the
    JAX models compute as users build them, and a shortest path from a
    vertex to itself has no edge."""
    n = adj.shape[0]
    sp = np.full((n, n), INF, dtype=np.int64)
    sp[adj > 0] = 1
    np.fill_diagonal(sp, 0)
    sp = np.minimum(sp, sp.T)
    hops = 1
    while hops < n:
        sp = np.minimum(sp, (sp[:, :, None] + sp[None, :, :]).min(axis=1))
        hops *= 2
    return np.minimum(sp, INF)


def wl_features(sp: np.ndarray, feature: np.ndarray, nDepth: int) -> np.ndarray:
    """``hist[v, d*F + f] = sum_{u : sp[u,v] == d} feature[u, f]`` for
    d in [0, nDepth] (``SMP_omega.h:382-404``)."""
    n, F = feature.shape
    hist = np.zeros((n, (nDepth + 1) * F), dtype=feature.dtype)
    for d in range(nDepth + 1):
        sel = (sp == d).astype(feature.dtype)
        hist[:, d * F:(d + 1) * F] = sel.T @ feature
    return hist


def rank_vertices(hist: np.ndarray):
    """Descending lexicographic rank by the reference's NON-stable exchange
    sort (``SMP_omega.h:418-434``): ``for i: for j>i: if key[order[i]] <
    key[order[j]]: swap``.  Returns (order, rank)."""
    n = hist.shape[0]
    keys = [tuple(hist[v]) for v in range(n)]
    order = list(range(n))
    for i in range(n):
        for j in range(i + 1, n):
            if keys[order[i]] < keys[order[j]]:
                order[i], order[j] = order[j], order[i]
    rank = np.empty(n, dtype=np.int64)
    for i, v in enumerate(order):
        rank[v] = i
    return np.asarray(order, dtype=np.int64), rank


def _limit_receptive_field(v: int, A: List[int], sp: np.ndarray,
                           rank: Optional[np.ndarray], cap: int) -> List[int]:
    """Cap a receptive field (``SMP_omega.h:476-507``): sort by (distance,
    rank), then drop whole trailing distance groups until it fits.  With
    ``rank=None`` the reference's non-stable distance-only exchange sort is
    replicated swap for swap."""
    if rank is None:
        A = list(A)
        for i in range(len(A)):
            for j in range(i + 1, len(A)):
                if sp[v, A[i]] > sp[v, A[j]]:
                    A[i], A[j] = A[j], A[i]
    else:
        A = sorted(A, key=lambda u: (sp[v, u], rank[u]))
    while len(A) > cap:
        d = sp[v, A[-1]]
        while A and sp[v, A[-1]] == d:
            A.pop()
    assert 0 < len(A) <= cap and A[0] == v
    return A


def receptive_fields(sp: np.ndarray, rank: np.ndarray, nLevels: int,
                     max_receptive_field: Optional[int],
                     has_WL_ordering: bool = True) -> List[List[List[int]]]:
    """phi[l][v] (``SMP_omega.h:509-538``): phi[0][v] = [v]; phi[l][v] is the
    first-seen union of phi[l-1][u] over the closed neighbourhood of v,
    capped, then sorted by WL rank."""
    n = sp.shape[0]
    phi: List[List[List[int]]] = [[[v] for v in range(n)]]
    for l in range(1, nLevels + 1):
        phi_l = []
        for v in range(n):
            acc: List[int] = []
            seen = set()
            for u in range(n):
                if sp[u, v] <= 1:
                    for w in phi[l - 1][u]:
                        if w not in seen:
                            seen.add(w)
                            acc.append(w)
            if max_receptive_field is not None and len(acc) > max_receptive_field:
                acc = _limit_receptive_field(
                    v, acc, sp, rank if has_WL_ordering else None,
                    max_receptive_field)
            if has_WL_ordering:
                acc = sorted(acc, key=lambda u: rank[u])
            phi_l.append(acc)
        phi.append(phi_l)
    return phi


@dataclasses.dataclass
class PreparedGraph:
    """Static-shaped arrays describing one prepared graph.

    Shapes (V = max_nVertices, P = max_receptive_field, L = nLevels):
      wl_feat   [V, F*(nDepth+1)]  WL features (raw features when
                                   ``use_wl_features=False``)
      vmask     [V]                1.0 for real vertices
      sizes     [L+1, V]           |phi_l(v)| (0 for padding vertices)
      nbr       [L, V, P]          phi_l(v)[i]; padding slots point at vertex 0
      pos       [L, V, P, P]       index of phi_l(v)[p] in phi_{l-1}(nbr[i]),
                                   or the sentinel P when absent
      radj      [L, V, P, P]       reduced adjacency (or Coulomb) per (l, v)
      smask     [L+1, V, P, P]     (p1 < s) & (p2 < s)
      norm_adj, adj, sp, dist [V, V] and raw_feat [V, F]: zero-padded raw
                                   payloads (sp padded with INF)
    """
    wl_feat: np.ndarray
    vmask: np.ndarray
    sizes: np.ndarray
    nbr: np.ndarray
    pos: np.ndarray
    radj: np.ndarray
    smask: np.ndarray
    nVertices: int
    norm_adj: np.ndarray
    adj: np.ndarray
    sp: np.ndarray
    raw_feat: np.ndarray
    dist: np.ndarray


def prepare_graph(graph: DenseGraph, nLevels: int, max_nVertices: int,
                  max_receptive_field: Optional[int], nDepth: int,
                  has_WL_ordering: bool = True, use_coulomb: bool = False,
                  use_wl_features: bool = True,
                  dtype=np.float32) -> PreparedGraph:
    """The full host pipeline for one graph (``SMP_omega.h:584-604``).

    ``use_wl_features=False`` feeds raw features; ``use_coulomb=True`` swaps
    the 0/1 reduced adjacency for the Coulomb matrix (``:567-577``).
    """
    n = graph.nVertices
    V = max_nVertices
    if n > V:
        raise ValueError(f"graph has {n} vertices > max_nVertices={V}")
    P = max_receptive_field if max_receptive_field is not None else V
    L = nLevels
    F = graph.nFeatures

    sp = floyd_warshall(graph.adj)
    hist = wl_features(sp, graph.feature, nDepth)
    _, rank = rank_vertices(hist)
    phi = receptive_fields(sp, rank, L, max_receptive_field, has_WL_ordering)

    feat_dim = F * (nDepth + 1) if use_wl_features else F
    wl_feat = np.zeros((V, feat_dim), dtype=dtype)
    wl_feat[:n] = (hist if use_wl_features else graph.feature).astype(dtype)

    vmask = np.zeros((V,), dtype=dtype)
    vmask[:n] = 1.0

    sizes = np.zeros((L + 1, V), dtype=np.int32)
    nbr = np.zeros((L, V, P), dtype=np.int32)
    pos = np.full((L, V, P, P), P, dtype=np.int32)
    radj = np.zeros((L, V, P, P), dtype=dtype)
    smask = np.zeros((L + 1, V, P, P), dtype=dtype)

    for l in range(L + 1):
        for v in range(n):
            s = len(phi[l][v])
            sizes[l, v] = s
            smask[l, v, :s, :s] = 1.0

    for l in range(1, L + 1):
        for v in range(n):
            phiv = phi[l][v]
            for i, w in enumerate(phiv):
                nbr[l - 1, v, i] = w
                lookup = {u: q for q, u in enumerate(phi[l - 1][w])}
                for p, u in enumerate(phiv):
                    pos[l - 1, v, i, p] = lookup.get(u, P)
            # Reduced adjacency (SMP_omega.h:555-581)
            for i, v1 in enumerate(phiv):
                for j, v2 in enumerate(phiv):
                    if use_coulomb:
                        radj[l - 1, v, i, j] = graph.coulomb[v1, v2]
                    elif v1 == v2:
                        radj[l - 1, v, i, j] = 1.0
                    else:
                        radj[l - 1, v, i, j] = graph.adj[v1, v2]

    na = np.zeros((V, V), dtype=dtype)
    na[:n, :n] = graph.norm_adj().astype(dtype)
    adj_pad = np.zeros((V, V), dtype=dtype)
    adj_pad[:n, :n] = (graph.adj[:n, :n] > 0).astype(dtype)
    sp_pad = np.full((V, V), INF, dtype=np.int64)
    sp_pad[:n, :n] = sp
    raw = np.zeros((V, F), dtype=dtype)
    raw[:n] = graph.feature.astype(dtype)
    dist_pad = np.zeros((V, V), dtype=dtype)
    dist_pad[:n, :n] = graph.distance.astype(dtype)

    return PreparedGraph(
        wl_feat=wl_feat, vmask=vmask, sizes=sizes, nbr=nbr, pos=pos,
        radj=radj, smask=smask, nVertices=n,
        norm_adj=na, adj=adj_pad, sp=sp_pad, raw_feat=raw, dist=dist_pad)
