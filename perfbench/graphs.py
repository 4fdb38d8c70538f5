"""The benchmark's inputs, made from ``--seed``: pools of molecule-shaped
graphs with one-hot atom types, their regression targets, and the epochs
that draw batches from a pool.

The shape is the ZINC regression benchmark's (Dwivedi et al.,
"Benchmarking Graph Neural Networks", arXiv:2003.00982: 9-37 heavy atoms,
23.16 atoms and 24.92 bonds a molecule on average, 28 atom types), which
the traffic files state: atom counts uniform over the range (mean 23), at
most 4 bonds an atom, and a spanning tree closed into 0.12 rings an atom
(2.76 at the mean: 24.92 - 23.16 + 1), each a ring of 5 or 6 atoms where
one fits.

Graph ``i`` of a pool depends on (seed, i) alone, so any graph can be made
again on its own (the reference makes the graphs of the steps it follows).
Every seed gets the same multiset of atom counts, in another order, so
that the work of a run does not change much with its seed.
"""

from __future__ import annotations

import numpy as np


# Adapted from graphflow_tpu_torch/utils/datasets.py:synthetic_molecules
# (a random spanning tree and extra bonds over one-hot atom types): one
# molecule of a given size, each atom bonded at most ``valence`` times and
# each extra bond closing a ring of 5 or 6 atoms where one fits.
def molecule(n: int, n_types: int, rings: int, valence: int, seed):
    """A random connected molecule-like graph of ``n`` atoms and ``n - 1 +
    rings`` bonds -> (adj [n, n] int32, symmetric, zero diagonal; feature
    [n, n_types] float64 one-hot; types [n]; bonds [m, 2])."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, n_types, size=n)
    adj = np.zeros((n, n), bool)
    deg = np.zeros(n, np.int64)

    def bond(u, v):
        adj[u, v] = adj[v, u] = True
        deg[u] += 1
        deg[v] += 1

    for v in range(1, n):
        free = np.flatnonzero(deg[:v] < valence)
        bond(int(free[rng.integers(free.size)]), v)
    for _ in range(rings):
        hops = _hops(adj, 5)
        ok = np.triu((deg < valence)[:, None] & (deg < valence)[None, :], 1)
        pick = ok & ((hops == 4) | (hops == 5))
        if not pick.any():
            pick = ok & (hops != 1)
        u, v = np.nonzero(pick)
        if u.size == 0:
            break
        k = rng.integers(u.size)
        bond(int(u[k]), int(v[k]))
    bonds = np.argwhere(np.triu(adj, 1))
    return adj.astype(np.int32), np.eye(n_types)[types], types, bonds


def _hops(adj: np.ndarray, most: int) -> np.ndarray:
    """Bond distances up to ``most`` (0 on the diagonal, most + 1 beyond)."""
    n = adj.shape[0]
    hops = np.full((n, n), most + 1)
    reach = np.eye(n, dtype=bool)
    hops[reach] = 0
    step = adj.astype(np.int64)
    for k in range(1, most + 1):
        nxt = (reach.astype(np.int64) @ step) > 0
        hops[nxt & ~reach] = k
        reach = reach | nxt
    return hops


def atom_counts(seed: int, traffic: dict) -> np.ndarray:
    """The atom count of every graph of the pool: n_min..n_max in turn,
    permuted by the seed."""
    lo, hi = traffic["atoms"]
    size = traffic["pool"]
    counts = lo + np.arange(size) % (hi - lo + 1)
    return counts[np.random.default_rng([seed, 1]).permutation(size)]


def energy_terms(seed: int, n_types: int):
    """The seed's additive energy: a term per atom type and a symmetric
    term per pair of bonded types (``synthetic_molecules``' form)."""
    rng = np.random.default_rng([seed, 3])
    e_atom = rng.standard_normal(n_types)
    b = 0.5 * rng.standard_normal((n_types, n_types))
    return e_atom, (b + b.T) / 2.0


def make_pool(seed: int, traffic: dict, indices=None):
    """(graphs, targets) of the pool, or of its ``indices``: each graph an
    (adj, feature) pair, each target ``target_scale`` times the molecule's
    additive energy."""
    counts = atom_counts(seed, traffic)
    n_types = traffic["atom_types"]
    e_atom, b_bond = energy_terms(seed, n_types)
    if indices is None:
        indices = range(traffic["pool"])
    graphs, targets = [], []
    for i in indices:
        n = int(counts[i])
        adj, feats, types, bonds = molecule(
            n, n_types, int(round(traffic["rings_per_atom"] * n)),
            traffic["valence"], seed=[seed, 2, int(i)])
        graphs.append((adj, feats))
        targets.append(e_atom[types].sum()
                       + b_bond[types[bonds[:, 0]], types[bonds[:, 1]]].sum())
    return graphs, traffic["target_scale"] * np.asarray(targets)


def batches(seed: int, size: int, batch: int):
    """Index batches drawn without replacement from a pool of ``size``,
    the pool reshuffled every epoch."""
    if size % batch:
        raise ValueError(f"a pool of {size} does not split into batches "
                         f"of {batch}")
    epoch = 0
    while True:
        order = np.random.default_rng([seed, 4, epoch]).permutation(size)
        for k in range(0, size, batch):
            yield order[k:k + batch]
        epoch += 1
