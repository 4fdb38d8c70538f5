"""Host-side graph preparation (counterpart of ``graphflow_tpu/core/prep.py``).

The reference rebuilds a computation graph per example
(``SMP_omega.h:584-693``).  All of that data-dependent work is data
preparation: Floyd-Warshall shortest paths (``:358-380``), depth-bucketed
Weisfeiler-Lehman features (``:382-404``), the exchange-sort vertex ranking
(``:418-434``) and the capped receptive fields (``:476-582``).  It runs on
the host in NumPy and emits static-shaped index arrays: the dense
permutation matrices X[v][w] become gather indices ``pos`` with the
sentinel P for "absent", which the level kernel reads as zeros.

Two backends compute the same arrays bit for bit.  ``backend="auto"``
(every model's) takes the native C++ library (``runtime/native.py``, the
port's copy of ``graph_prep.cpp``, built with g++ at first use) whenever
it is available and no ``fo_degree`` is asked for, as the JAX package does
(``graphflow_tpu/core/prep.py:243-253``); ``backend="python"`` is the
NumPy path of the JAX package, array for array, but for one case: a vertex
is at distance 0 from itself even when the graph has a self loop
(:func:`floyd_warshall`), as in both packages' native backends.  The
first-order sparse indices ``fo_idx`` (``fo_degree=``) are built in NumPy
only, in both packages.  ``ROUTES`` counts the graphs each route
prepared: ``native``, ``numpy`` (asked for), ``numpy_fo_degree``,
``numpy_fallback`` (``"auto"`` on a machine without g++) and ``sparse``
(:func:`prepare_graph_sparse`, the ELLPACK-only prep of the 1-hop GCNs).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np

from graphflow_tpu_torch.core.graph import DenseGraph

INF = 10**9  # reference GCN_1D.h:26 `const int INF = 1e9`
ROUTES = collections.Counter()


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
      ell_nbr, ell_w, ell_nbr_a, ell_w_a [V, D]  ELLPACK 1-hop structures
                                   (``ops/sparse.py``; sentinel V), built
                                   only by :func:`prepare_graph_sparse`,
                                   which fills wl_feat, vmask and raw_feat
                                   beside them and leaves the rest None
      fo_idx    [L, V, P, D]       first-order sparse aggregation: per
                                   level, the flat (w*P + q) rows of the
                                   previous level's [V, P, C] state that sum
                                   into sum_v[p] ({(w, q) : sp(v, w) <= 1 and
                                   phi_{l-1}(w)[q] == phi_l(v)[p]}), sentinel
                                   V*P; only with ``fo_degree=``
    """
    wl_feat: np.ndarray
    vmask: np.ndarray
    sizes: Optional[np.ndarray] = None
    nbr: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    radj: Optional[np.ndarray] = None
    smask: Optional[np.ndarray] = None
    nVertices: int = 0
    norm_adj: Optional[np.ndarray] = None
    adj: Optional[np.ndarray] = None
    sp: Optional[np.ndarray] = None
    raw_feat: Optional[np.ndarray] = None
    dist: Optional[np.ndarray] = None
    ell_nbr: Optional[np.ndarray] = None
    ell_w: Optional[np.ndarray] = None
    ell_nbr_a: Optional[np.ndarray] = None
    ell_w_a: Optional[np.ndarray] = None
    fo_idx: Optional[np.ndarray] = None


def prepare_graph(graph: DenseGraph, nLevels: int, max_nVertices: int,
                  max_receptive_field: Optional[int], nDepth: int,
                  has_WL_ordering: bool = True, use_coulomb: bool = False,
                  use_wl_features: bool = True, dtype=np.float32,
                  backend: str = "auto",
                  fo_degree: Optional[int] = None) -> PreparedGraph:
    """The full host pipeline for one graph (``SMP_omega.h:584-604``).

    ``use_wl_features=False`` feeds raw features; ``use_coulomb=True`` swaps
    the 0/1 reduced adjacency for the Coulomb matrix (``:567-577``).
    ``backend`` is ``"auto"`` (the native library when it is available and
    ``fo_degree`` is None) or ``"python"`` (NumPy); ``fo_degree`` (at least
    the largest closed degree) also builds ``fo_idx``.
    """
    if backend not in ("auto", "python"):
        raise ValueError(f"backend {backend!r}: 'auto' or 'python'")
    if backend == "auto" and fo_degree is None:
        from graphflow_tpu_torch.runtime import native
        if native.available():
            ROUTES["native"] += 1
            return native.prepare_graph_native(
                graph, nLevels, max_nVertices, max_receptive_field, nDepth,
                has_WL_ordering=has_WL_ordering, use_coulomb=use_coulomb,
                use_wl_features=use_wl_features, dtype=dtype)
        ROUTES["numpy_fallback"] += 1
    else:
        ROUTES["numpy" if backend == "python" else "numpy_fo_degree"] += 1
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

    sp_pad = np.full((V, V), INF, dtype=np.int64)
    sp_pad[:n, :n] = sp

    return PreparedGraph(
        wl_feat=wl_feat, sizes=sizes, nbr=nbr, pos=pos, radj=radj,
        smask=smask, nVertices=n, sp=sp_pad,
        fo_idx=(None if fo_degree is None
                else first_order_indices(graph.adj, phi, V, P, fo_degree)),
        **payload(graph, V, dtype))


def payload(graph: DenseGraph, V: int, dtype) -> dict:
    """The ``PreparedGraph`` fields that both backends fill alike, padded
    to V vertices: ``vmask``, ``norm_adj``, ``adj``, ``raw_feat`` and
    ``dist``."""
    n, F = graph.nVertices, graph.nFeatures
    vmask = np.zeros((V,), dtype=dtype)
    vmask[:n] = 1.0
    na = np.zeros((V, V), dtype=dtype)
    na[:n, :n] = graph.norm_adj().astype(dtype)
    adj_pad = np.zeros((V, V), dtype=dtype)
    adj_pad[:n, :n] = (graph.adj[:n, :n] > 0).astype(dtype)
    raw = np.zeros((V, F), dtype=dtype)
    raw[:n] = graph.feature.astype(dtype)
    dist_pad = np.zeros((V, V), dtype=dtype)
    dist_pad[:n, :n] = graph.distance.astype(dtype)
    return dict(vmask=vmask, norm_adj=na, adj=adj_pad, raw_feat=raw,
                dist=dist_pad)


def first_order_indices(adj: np.ndarray, phi, V: int, P: int,
                        fo_degree: int) -> np.ndarray:
    """``PreparedGraph.fo_idx`` [L, V, P, fo_degree] from the receptive
    fields ``phi`` (``graphflow_tpu/core/prep.py:317-341``): for each
    (l, v, p) the flat (w * P + q) rows of the previous level's [V, P, C]
    state that sum into sum_v[p], in the order of w, then the sentinel
    V * P."""
    n, L = adj.shape[0], len(phi) - 1
    fo_idx = np.full((L, V, P, fo_degree), V * P, dtype=np.int32)
    closed = (adj[:n, :n] > 0) | np.eye(n, dtype=bool)
    for l in range(1, L + 1):
        # POS[w, u] = position of vertex u inside phi_{l-1}(w), else -1.
        POS = np.full((n, n), -1, dtype=np.int64)
        for w in range(n):
            POS[w, np.asarray(phi[l - 1][w], dtype=np.int64)] = (
                np.arange(len(phi[l - 1][w])))
        for v in range(n):
            u_list = np.asarray(phi[l][v], dtype=np.int64)        # [s]
            Wn = np.nonzero(closed[v])[0]                         # [deg]
            Q = POS[np.ix_(Wn, u_list)]                           # [deg, s]
            valid = Q >= 0
            counts = valid.sum(axis=0)
            if counts.max(initial=0) > fo_degree:
                raise ValueError(
                    f"fo_degree={fo_degree} < closed degree "
                    f"{int(counts.max())} at level {l} vertex {v}")
            ii, jj = np.nonzero(valid)
            ranks = valid.cumsum(axis=0)[ii, jj] - 1
            fo_idx[l - 1, v, jj, ranks] = Wn[ii] * P + Q[ii, jj]
    return fo_idx


def prepare_graph_sparse(graph, max_nVertices: int,
                         max_degree: Optional[int] = None,
                         dtype=np.float32) -> PreparedGraph:
    """The light host prep of the 1-hop sparse models (GCN_MW and
    NeuralFingerprint with ``aggregation="ell"``;
    ``graphflow_tpu/core/prep.py:351-390``): no Floyd-Warshall and no
    [V, V] array, only ``wl_feat`` (the raw features, also ``raw_feat``),
    ``vmask`` and the ELLPACK lists built from the edges, ``ell_nbr`` /
    ``ell_w`` of the normalised adjacency and ``ell_nbr_a`` / ``ell_w_a``
    of the 0/1 one (``ops/sparse.py``), so it costs O(E).

    ``graph`` is a DenseGraph or a ``(nVertices, edges, features)`` tuple;
    with the tuple no dense adjacency is ever built."""
    from graphflow_tpu_torch.ops import sparse

    if isinstance(graph, DenseGraph):
        n = graph.nVertices
        edges = [(int(u), int(v))
                 for (u, v) in np.argwhere(np.triu(graph.adj, 1) > 0)]
        features = graph.feature
    else:
        n, edges, features = graph
    V = max_nVertices
    if n > V:
        raise ValueError(f"graph has {n} vertices > max_nVertices={V}")
    ROUTES["sparse"] += 1
    features = np.asarray(features)
    wl_feat = np.zeros((V, features.shape[1]), dtype=dtype)
    wl_feat[:n] = features.astype(dtype)
    vmask = np.zeros((V,), dtype=dtype)
    vmask[:n] = 1.0
    nbr_n, w_n = sparse.norm_adj_ell(n, edges, pad_rows=V,
                                     max_degree=max_degree)
    nbr_a, w_a = sparse.ell_from_edges(n, edges, pad_rows=V,
                                       max_degree=max_degree)
    return PreparedGraph(
        wl_feat=wl_feat, vmask=vmask, nVertices=n, raw_feat=wl_feat,
        ell_nbr=nbr_n, ell_w=w_n.astype(dtype),
        ell_nbr_a=nbr_a, ell_w_a=w_a.astype(dtype))
