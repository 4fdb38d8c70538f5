"""Sparse neighbour aggregation (counterpart of
``graphflow_tpu/ops/sparse.py``).

The reference aggregates neighbours with per-vertex scalar loops
(``NeuralFingerprint.h:58-82``, ``GCN_MW.h:209-221``).  Here, as in the
JAX package, the format is ELLPACK: every vertex's neighbour list padded to
a common degree D, ``agg[v] = sum_d w[v, d] * h[nbr[v, d]]``, one flat row
gather and one batched weighted sum, O(V D H) where the dense product is
O(V^2 H).  The host-side constructors (``ell_from_adj``, ``ell_from_edges``,
``norm_adj_ell``, ``edges_count``) are NumPy; the products are torch ops on
any device.  A COO scatter-add is kept for parity checks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def ell_from_adj(adj: np.ndarray, weights: Optional[np.ndarray] = None,
                 max_degree: Optional[int] = None,
                 pad_rows: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (possibly weighted) adjacency -> ELLPACK ``nbr [Vp, D]`` int32
    (sentinel Vp in padding slots) and ``w [Vp, D]`` (0 there).  ``weights``
    defaults to ``adj`` itself; ``pad_rows`` pads to Vp >= V rows."""
    V = adj.shape[0]
    Vp = pad_rows or V
    w_src = adj if weights is None else weights
    rows = [np.nonzero(adj[v])[0] for v in range(V)]
    D = max_degree or max((len(r) for r in rows), default=1) or 1
    nbr = np.full((Vp, D), Vp, np.int32)
    w = np.zeros((Vp, D), w_src.dtype)
    for v, r in enumerate(rows):
        if len(r) > D:
            raise ValueError(f"vertex {v} degree {len(r)} > D={D}")
        nbr[v, :len(r)] = r
        w[v, :len(r)] = w_src[v, r]
    return nbr, w


def ell_from_edges(n: int, edges, weights=None,
                   max_degree: Optional[int] = None,
                   pad_rows: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected edge list -> ELLPACK without a [V, V] array.  ``weights``
    maps an edge's index to its weight (1.0 by default), used in both
    directions; a self loop appears once."""
    Vp = pad_rows or n
    adj_lists = [[] for _ in range(n)]
    wts = [[] for _ in range(n)]
    for e, (u, v) in enumerate(edges):
        wv = 1.0 if weights is None else float(weights[e])
        adj_lists[u].append(v)
        wts[u].append(wv)
        if u != v:
            adj_lists[v].append(u)
            wts[v].append(wv)
    D = max_degree or max((len(r) for r in adj_lists), default=1) or 1
    nbr = np.full((Vp, D), Vp, np.int32)
    w = np.zeros((Vp, D), np.float32)
    for v in range(n):
        r = adj_lists[v]
        if len(r) > D:
            raise ValueError(f"vertex {v} degree {len(r)} > D={D}")
        nbr[v, :len(r)] = r
        w[v, :len(r)] = wts[v]
    return nbr, w


def norm_adj_ell(n: int, edges, pad_rows: Optional[int] = None,
                 max_degree: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Kipf-Welling normalised adjacency D^-1/2 (A+I) D^-1/2
    (``DenseGraph.h:69-111``) in ELLPACK form: weight 1/sqrt((deg_u + 1)
    (deg_v + 1)) per entry, the self loop included."""
    deg = np.zeros(n, np.int64)
    for (u, v) in edges:
        if u != v:
            deg[u] += 1
            deg[v] += 1
    inv = 1.0 / np.sqrt(deg + 1.0)
    ed = list(edges) + [(v, v) for v in range(n)]
    wts = [inv[u] * inv[v] for (u, v) in ed]
    return ell_from_edges(n, ed, wts, max_degree=max_degree,
                          pad_rows=pad_rows)


def ell_spmm(nbr: torch.Tensor, w: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """ELLPACK SpMM: ``out[v] = sum_d w[v, d] * h[nbr[v, d]]`` for nbr
    [V, D] (sentinel V, where w is 0), w [V, D], h [V, H] -> [V, H] in h's
    dtype, summed in float32 or wider.

    As in the JAX package (``graphflow_tpu/ops/sparse.py:139-155``), one
    flat row gather with the sentinels clamped to the last real row, whose
    value w = 0 annihilates.  So a non-finite value in that row of ``h``
    leaks NaN into padded slots' outputs (0 * inf = NaN): finite inputs
    are the contract."""
    V, H = h.shape
    D = nbr.shape[1]
    acc = torch.promote_types(h.dtype, torch.float32)
    ids = torch.clamp(nbr.reshape(-1).long(), max=V - 1)
    gathered = h[ids].reshape(V, D, H).to(acc)
    return torch.einsum("vd,vdh->vh", w.to(acc), gathered).to(h.dtype)


def coo_spmm(src_idx: torch.Tensor, dst_idx: torch.Tensor, w: torch.Tensor,
             h: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """COO SpMM: scatter-adds ``w_e * h[src_e]`` into row ``dst_e``."""
    contrib = h[src_idx.long()] * w[:, None].to(h.dtype)
    out = h.new_zeros((num_vertices, h.shape[1]))
    return out.index_add_(0, dst_idx.long(), contrib)


def edges_count(nbr) -> int:
    """Real (directed) entries of an ELLPACK structure."""
    nbr = np.asarray(nbr)
    return int((nbr < nbr.shape[0]).sum())
