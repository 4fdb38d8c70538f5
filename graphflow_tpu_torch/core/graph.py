"""Host-side graph container (counterpart of ``graphflow_tpu/core/graph.py``).

A plain NumPy container with the reference's ``DenseGraph.h:113-119``
members: ``nVertices, nFeatures, adj, feature, coulomb, distance``.
Tensors appear only after preparation and batching.

Instances hash by identity (no ``__eq__``/``__hash__`` override), because
the model's preparation cache is a ``WeakKeyDictionary`` keyed by graph.
"""

from __future__ import annotations

import numpy as np


class DenseGraph:
    """A dense graph: adjacency + per-vertex features (+ coulomb/distance)."""

    def __init__(self, nVertices: int, nFeatures: int):
        self.nVertices = int(nVertices)
        self.nFeatures = int(nFeatures)
        self.adj = np.zeros((nVertices, nVertices), dtype=np.int32)
        self.feature = np.zeros((nVertices, nFeatures), dtype=np.float64)
        self.coulomb = np.zeros((nVertices, nVertices), dtype=np.float64)
        self.distance = np.zeros((nVertices, nVertices), dtype=np.float64)

    @classmethod
    def from_edges(cls, nVertices, nFeatures, edges, features=None) -> "DenseGraph":
        """Build an undirected graph from (u, v) pairs and optional
        [nVertices, nFeatures] features."""
        g = cls(nVertices, nFeatures)
        for (u, v) in edges:
            g.add_edge(u, v)
        if features is not None:
            feats = np.asarray(features, dtype=np.float64)
            if feats.shape != (nVertices, nFeatures):
                raise ValueError(f"features have shape {feats.shape}, "
                                 f"expected {(nVertices, nFeatures)}")
            g.feature[:] = feats
        return g

    def add_edge(self, u: int, v: int) -> None:
        self.adj[u, v] = 1
        self.adj[v, u] = 1

    def permuted(self, perm) -> "DenseGraph":
        """A copy with vertices relabeled by ``perm`` (new = perm[old])."""
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (self.nVertices,):
            raise ValueError(f"perm has shape {perm.shape}, "
                             f"expected {(self.nVertices,)}")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.nVertices)
        g = DenseGraph(self.nVertices, self.nFeatures)
        g.adj = self.adj[np.ix_(inv, inv)].copy()
        g.feature = self.feature[inv].copy()
        g.coulomb = self.coulomb[np.ix_(inv, inv)].copy()
        g.distance = self.distance[np.ix_(inv, inv)].copy()
        return g

    def norm_adj(self) -> np.ndarray:
        """D^{-1/2} (A + I) D^{-1/2} (reference ``DenseGraph.h:69-111``)."""
        a_tilde = self.adj.astype(np.float64) + np.eye(self.nVertices)
        deg = a_tilde.sum(axis=1)
        d_inv_sqrt = 1.0 / np.sqrt(deg)
        return a_tilde * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]

    def __repr__(self) -> str:
        nEdges = int(np.triu(self.adj, 1).sum())
        return (f"DenseGraph(nVertices={self.nVertices}, "
                f"nFeatures={self.nFeatures}, nEdges={nEdges})")
