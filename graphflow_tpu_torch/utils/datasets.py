"""Fixtures (counterpart of the molecule and random-graph parts of
``graphflow_tpu/utils/datasets.py``), plus seeded inputs for one level.

The four toy molecules every reference demo trains on come from
``tests/test_SMP_omega.cpp:39-146``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from graphflow_tpu_torch.core.graph import DenseGraph

N_MOLECULE_FEATURES = 4

_MOLS = {
    "CH4": (5, [(0, 1), (0, 2), (0, 3), (0, 4)], "CHHHH"),
    "NH3": (4, [(0, 1), (0, 2), (0, 3)], "NHHH"),
    "H2O": (3, [(0, 1), (0, 2)], "OHH"),
    "C2H4": (6, [(0, 1), (0, 2), (0, 3), (3, 4), (3, 5)], "CHHCHH"),
}
_LABEL = {"C": 0, "H": 1, "N": 2, "O": 3}


def toy_molecule(name: str) -> DenseGraph:
    n, edges, labels = _MOLS[name]
    feats = np.zeros((n, N_MOLECULE_FEATURES))
    for v, lab in enumerate(labels):
        feats[v, _LABEL[lab]] = 1.0
    return DenseGraph.from_edges(n, N_MOLECULE_FEATURES, edges, feats)


def toy_molecules() -> Tuple[List[DenseGraph], List[float]]:
    """The reference demo set; regression target = vertex count."""
    graphs = [toy_molecule(n) for n in ("CH4", "NH3", "H2O", "C2H4")]
    return graphs, [float(g.nVertices) for g in graphs]


def random_graph(n: int, p: float, nFeatures: int = 4,
                 seed: int = 0) -> DenseGraph:
    """Erdos-Renyi graph with random one-hot features (same draws as the
    JAX package's ``random_graph`` for the same seed)."""
    rng = np.random.default_rng(seed)
    adj = np.triu((rng.random((n, n)) < p).astype(int), 1)
    feats = np.eye(nFeatures)[rng.integers(0, nFeatures, size=n)]
    return DenseGraph.from_edges(n, nFeatures, np.argwhere(adj), feats)


def random_level_case(N: int, P: int, C: int, Cout: int, seed: int = 0,
                      empty_vertex: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """Seeded inputs for one fused level, float64 and int32 NumPy arrays.

    The draws are those of the JAX package's kernel tests
    (``tests/test_fused_kernel.py:22-37``): neighbour ids in [0, N], where
    N is the absent-vertex sentinel; random partial position maps with the
    sentinel P; mixed-sign ``radj`` so the adj>0 guard matters.
    ``empty_vertex`` makes one vertex's slots all absent (bias-only rows).
    """
    rng = np.random.RandomState(seed)
    state = rng.randn(N, P, P, C)
    nbr = rng.randint(0, N + 1, size=(N, P)).astype(np.int32)
    pos = np.full((N, P, P), P, np.int32)
    for v in range(N):
        for i in range(P):
            if nbr[v, i] == N:
                continue
            n_valid = rng.randint(1, P + 1)
            pos[v, i, :n_valid] = rng.permutation(P + 1)[:n_valid]
    radj = rng.randn(N, P, P)
    K = rng.randn(18 * C, Cout) * 0.1
    b = rng.randn(Cout) * 0.1
    if empty_vertex is not None:
        nbr[empty_vertex, :] = N
        pos[empty_vertex] = P
    return dict(state=state, nbr=nbr, pos=pos, radj=radj, K=K, b=b)
