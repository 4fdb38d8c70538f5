"""SMP_omega toy-molecule training (counterpart of
``examples/train_smp_omega.py``; the reference's flagship demo,
``tests/test_SMP_omega.cpp:149-210``): second-order steerable message
passing on CH4/NH3/H2O/C2H4 with the vertex count as the target, then a
save/load round trip of the text checkpoint and the predictions.

Run:  python -m graphflow_tpu_torch.examples.train_smp_omega [epochs]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

from graphflow_tpu_torch.models import SMP_omega
from graphflow_tpu_torch.utils.datasets import toy_molecules


def main(epochs: int = 256, device=None, lr: float = 1e-3) -> list:
    """Train ``epochs`` BatchLearn steps; returns the per-epoch
    (loss_before, loss_after)."""
    graphs, targets = toy_molecules()
    model = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                      nChanels=10, nFeatures=4, nDepth=5, device=device)
    losses = []
    t0 = time.time()
    for epoch in range(epochs):
        losses.append(model.BatchLearn(graphs, targets, lr))
        if epoch % 32 == 0:
            print(f"epoch {epoch:4d}: loss {losses[-1][0]:.4f} -> "
                  f"{losses[-1][1]:.4f}")
    print(f"trained {epochs} epochs in {time.time() - t0:.1f}s")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "SMP_omega-model.dat")
        model.save_model(path)
        model.load_model(path)

    for g, t in zip(graphs, targets):
        print(f"target {t:.0f}  predict {model.Predict(g):.3f}")
    return losses


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256)
