"""Permutation invariance of the graph feature (counterpart of
``examples/permutation_invariance.py``; the reference's
``tests/test_graph_permutation_invariant.cpp``): ``Feature()`` must not
change under a relabelling of the vertices, the defining property of the
Covariant Compositional Network construction.

Run:  python -m graphflow_tpu_torch.examples.permutation_invariance [trials]
"""

from __future__ import annotations

import sys

import numpy as np

from graphflow_tpu_torch.models import SMP_omega
from graphflow_tpu_torch.utils.datasets import random_graph


def main(trials: int = 5, device=None) -> list:
    """Compare the feature of a random graph with that of ``trials``
    random relabellings; returns the L1 gaps."""
    rng = np.random.default_rng(7)
    n = 10
    g = random_graph(n, 0.4, seed=7)
    model = SMP_omega(max_nVertices=n, max_receptive_field=5, nLevels=2,
                      nChanels=8, nFeatures=4, nDepth=3, device=device)

    f0 = model.Feature(g)
    print("graph feature:", np.round(f0, 4))
    gaps = []
    for trial in range(trials):
        perm = rng.permutation(n)
        gaps.append(float(np.abs(f0 - model.Feature(g.permuted(perm))).sum()))
        print(f"permutation {trial}: L1 gap = {gaps[-1]:.2e}")
    return gaps


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
