"""Dataset loaders and fixtures (counterpart of
``graphflow_tpu/utils/datasets.py``), plus seeded inputs for one level.

The reference's dataset programs hand-parse MNIST idx files
(``tests/test_mlp.cpp:154-172``) and CIFAR-10 binary batches
(``tests/CIFAR-10/``); these loaders read the same formats.  The four toy
molecules every reference demo trains on come from
``tests/test_SMP_omega.cpp:39-146``.  The synthetic sets draw from NumPy's
``default_rng`` in the JAX package's order, so the same seed gives the same
arrays and graphs in both packages.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from graphflow_tpu_torch.core.graph import DenseGraph


# MNIST idx files and CIFAR-10 binary batches.

def load_mnist_images(path: str) -> np.ndarray:
    """Parse an idx3-ubyte image file -> [N, 28, 28] float32 in [0, 1]."""
    with open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: idx3 magic {magic}, expected 2051")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols).astype(np.float32) / 255.0


def load_mnist_labels(path: str) -> np.ndarray:
    """Parse an idx1-ubyte label file -> [N] int32."""
    with open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: idx1 magic {magic}, expected 2049")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.astype(np.int32)


def load_cifar10_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one CIFAR-10 binary batch -> ([N, 32, 32, 3] float32 in
    [0, 1], [N] int32 labels)."""
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    images = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images.astype(np.float32) / 255.0, labels


def synthetic_mnist(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Class-separable 28x28 synthetic digits (the stand-in when the MNIST
    image files are absent): class k lights up block k."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = rng.random((n, 28, 28)).astype(np.float32) * 0.1
    for i, k in enumerate(labels):
        r, c = divmod(int(k), 5)
        images[i, r * 14:(r + 1) * 14, c * 5:(c + 1) * 5] += 0.8
    return images, labels

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


def synthetic_molecules(n_molecules: int, seed: int = 0, min_atoms: int = 3,
                        max_atoms: int = 9, n_types: int = 4,
                        extra_bond_p: float = 0.15
                        ) -> Tuple[List[DenseGraph], List[float]]:
    """QM9/HCEP-shaped synthetic regression set: random connected
    molecule-like graphs (a random spanning tree and a few extra bonds)
    over ``n_types`` atom species, with the additive "atomization energy"

        E = sum_v e[type(v)] + sum_{(u,v) in bonds} b[type(u), type(v)]

    (fixed per-atom terms, symmetric per-bond terms).  E is determined by
    the graph, so held-out error measures what the message passing
    learned."""
    rng = np.random.default_rng(seed)
    e_atom = np.array([-1.0, 0.5, 1.5, -0.7, 0.9, -1.3][:n_types])
    b_raw = np.array([[0.8, -0.4, 0.2, -0.9, 0.3, 0.1][:n_types]]) \
        * np.arange(1, n_types + 1)[:, None] * 0.5
    b_bond = (b_raw + b_raw.T) / 2.0
    graphs, targets = [], []
    for _ in range(n_molecules):
        n = int(rng.integers(min_atoms, max_atoms + 1))
        types = rng.integers(0, n_types, size=n)
        edges = [(int(rng.integers(0, v)), v) for v in range(1, n)]
        for u in range(n):
            for v in range(u + 2, n):
                if rng.random() < extra_bond_p / n:
                    edges.append((u, v))
        edges = sorted(set(edges))
        energy = float(e_atom[types].sum()
                       + sum(b_bond[types[u], types[v]] for u, v in edges))
        feats = np.eye(n_types)[types]
        graphs.append(DenseGraph.from_edges(n, n_types, edges, feats))
        targets.append(energy)
    return graphs, targets


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
