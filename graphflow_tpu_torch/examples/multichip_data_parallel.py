"""Data-parallel SMP_omega training over ranks (counterpart of
``examples/multichip_data_parallel.py``; the reference's thread-replica
data parallelism, ``tests/test_SMP_omega_multithreads.cpp``): the molecule
batch is split over the ranks of a "data" mesh axis, the gradients are
all-reduced, and every rank takes the same optimizer step.

Run:  python -m graphflow_tpu_torch.examples.multichip_data_parallel [epochs]
(two ranks: a card each where there are two, else both on the first card)
"""

from __future__ import annotations

import sys

from graphflow_tpu_torch import parallel
from graphflow_tpu_torch.models import SMP_omega
from graphflow_tpu_torch.ops import launch_counts
from graphflow_tpu_torch.utils.datasets import toy_molecules


def _rank(rank, device, n, epochs):
    model = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                      nChanels=10, nFeatures=4, nDepth=5, device=device)
    graphs, targets = toy_molecules()
    reps = max(1, (2 * n) // len(graphs))
    graphs, targets = graphs * reps, targets * reps
    keep = len(graphs) - len(graphs) % n
    graphs, targets = graphs[:keep], targets[:keep]

    mesh = parallel.make_mesh({"data": n})
    step = parallel.make_dp_train_step(model._loss, model.opt, mesh)
    batch = parallel.shard_batch(model._stack(graphs, targets), mesh)
    params = parallel.replicate(model.param_dict(), mesh)
    state = model.opt_state
    losses = []
    for epoch in range(epochs):
        params, state, loss = step(params, state, batch, 1e-3)
        losses.append(float(loss))
        if rank == 0 and epoch % 8 == 0:
            print(f"epoch {epoch:3d}: loss {losses[-1]:.4f}", flush=True)
    model.opt_state = state
    predictions = [model.Predict(g) for g in graphs[:4]]
    if rank == 0:
        print("predictions:", [round(p, 2) for p in predictions], flush=True)
    return {"losses": losses, "predictions": predictions,
            "launches": launch_counts()}


def main(epochs: int = 64, n_ranks: int = 2, device=None) -> list:
    """Train ``epochs`` data-parallel steps on ``n_ranks`` ranks; returns
    each rank's losses, predictions and kernel launches."""
    return parallel.run_ranks(_rank, n_ranks, (n_ranks, epochs),
                              device=device, verbose=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
