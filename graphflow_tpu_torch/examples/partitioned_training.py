"""Partitioned-graph training: vertices sharded over ranks, the batch over
a second mesh axis (counterpart of ``examples/partitioned_training.py``).

The scale-out mode the reference lacks (its only "large graph" control is
capping receptive fields): each graph's padded vertex axis is sharded over
the "graph" axis, every message-passing level exchanges only the per-pair
boundary rows, and the batch is sharded over "data"; per-shard partial
losses and gradients are all-reduced over both axes.  On the card each
level's bank runs K4 forward and K5 backward.

Run:  python -m graphflow_tpu_torch.examples.partitioned_training [epochs]
(four ranks, data 2 x graph 2: a card each where there are four, else all
on the first card)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from graphflow_tpu_torch import parallel
from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.models.smp2d import SMP2DConfig, init_smp2d_params
from graphflow_tpu_torch.ops import launch_counts
from graphflow_tpu_torch.optim import make_optimizer
from graphflow_tpu_torch.utils.convert import flatten
from graphflow_tpu_torch.utils.datasets import random_graph


def _rank(rank, device, n_data, n_graph, epochs):
    V = 8 * n_graph
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=8, nLevels=2,
                      nChanels=8, nFeatures=4, nDepth=3)
    params = flatten(init_smp2d_params(torch.Generator().manual_seed(0), cfg,
                                       device))
    for p in params.values():
        p.requires_grad_()

    graphs = [random_graph(V, 0.2, seed=s) for s in range(2 * n_data)]
    targets = np.array([float(g.nVertices) for g in graphs])
    pgs = [prep.prepare_graph(g, cfg.nLevels, V, cfg.max_receptive_field,
                              cfg.nDepth) for g in graphs]
    plan = parallel.plan_partition_batch(pgs, n_graph)
    if rank == 0:
        print(f"halo rows/shard/level: {plan.rows_targeted} targeted vs "
              f"{plan.rows_allgather} all_gather "
              f"({plan.rows_allgather / max(plan.rows_targeted, 1):.1f}x "
              f"less)", flush=True)

    mesh = parallel.make_mesh({"data": n_data, "graph": n_graph})
    opt = make_optimizer("adam")
    step = parallel.make_partitioned_train_step(cfg, plan, opt, mesh,
                                                device=device)
    inputs = parallel.shard_inputs(plan, mesh, device=device)
    state = opt.init(params)
    losses = []
    for epoch in range(epochs):
        params, state, loss = step(params, state, inputs, targets, 0.02)
        losses.append(float(loss))
        if rank == 0 and epoch % 8 == 0:
            print(f"epoch {epoch:3d}: loss {losses[-1]:.4f}", flush=True)
    if rank == 0:
        print(f"loss {losses[0]:.2f} -> {losses[-1]:.2f}", flush=True)
    # Adam's first steps (uncorrected, nBatch) overshoot at this rate, in
    # the JAX package too; the loss comes down below its start after about
    # a dozen epochs.
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    return {"losses": losses, "rows": (plan.rows_targeted,
                                       plan.rows_allgather),
            "launches": launch_counts()}


def main(epochs: int = 64, n_ranks: int = 4, device=None) -> list:
    """Train ``epochs`` partitioned steps on ``n_ranks`` ranks (graph axis 4
    from 8 ranks, else half of them); returns each rank's losses, halo rows
    (targeted, all_gather) and kernel launches."""
    n_graph = 4 if n_ranks >= 8 else max(1, n_ranks // 2)
    n_data = max(1, n_ranks // n_graph)
    print(f"mesh: data={n_data} x graph={n_graph}", flush=True)
    return parallel.run_ranks(_rank, n_data * n_graph,
                              (n_data, n_graph, epochs), device=device,
                              verbose=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
