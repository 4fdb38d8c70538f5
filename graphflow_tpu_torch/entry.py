"""The port's entry points (counterpart of ``__graft_entry__.py``): a
forward of the flagship model, and a dry run of every parallel mode.

``entry()`` returns the forward of SMP_omega (second-order steerable
message passing with the 18-case contraction bank) on the four toy
molecules, with its arguments.  P = 4 is off the TPU's sublane tile, where
the JAX package runs its K3 kernel; here every P runs the level kernel K1.

``dryrun_multichip(n)`` starts n ranks and runs ONE step of each parallel
mode, asserting that it computes the single-process numbers:

  1. data parallelism over "data": the loss of a step equals the batch
     loss of one process, and the replicas stay bit-identical;
  2. a vertex-partitioned forward over "graph" with the targeted per-pair
     halo exchange equals the unsharded forward;
  3. a partitioned train step on a data x graph mesh equals the
     single-process step in loss and post-step parameters.

Ranks run on the card, one card each over NCCL where there are enough,
else all on the first card over gloo (``parallel/mesh.py:placement``);
they never fall back to the CPU, which only ``device="cpu"`` picks.

Run:  python -m graphflow_tpu_torch.entry [n_ranks]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _toy_batch(model, batch_size):
    """CH4/NH3/H2O/C2H4-style toy molecules, cycled to batch_size."""
    from graphflow_tpu_torch.core.graph import DenseGraph

    mols = [
        (5, [(0, 1), (0, 2), (0, 3), (0, 4)], [0, 1, 1, 1, 1]),
        (4, [(0, 1), (0, 2), (0, 3)], [2, 1, 1, 1]),
        (3, [(0, 1), (0, 2)], [3, 1, 1]),
        (6, [(0, 1), (0, 2), (0, 3), (3, 4), (3, 5)], [0, 1, 1, 0, 1, 1]),
    ]
    graphs, targets = [], []
    for i in range(batch_size):
        n, edges, labels = mols[i % len(mols)]
        feats = np.eye(4)[labels]
        graphs.append(DenseGraph.from_edges(n, 4, edges, feats))
        targets.append(float(n))
    return model._stack(graphs, targets)


def entry(device=None):
    """(fn, example_args): ``fn(params, batch) -> predictions [4]``, the
    forward of SMP_omega(10, 4, 2, 16, 4, 5) on the four toy molecules,
    on the card unless ``device`` names another."""
    from graphflow_tpu_torch.models import SMP_omega
    from graphflow_tpu_torch.models.smp2d import smp2d_forward

    model = SMP_omega(max_nVertices=10, max_receptive_field=4, nLevels=2,
                      nChanels=16, nFeatures=4, nDepth=5, seed=0,
                      device=device)
    batch = _toy_batch(model, 4)

    def forward(params, batch):
        pred, _ = smp2d_forward(params, batch, model.cfg)
        return pred

    return forward, (model.params, batch)


def _close(what, got, ref, rtol, atol=0.0):
    got = torch.as_tensor(got).detach().cpu().double().numpy()
    ref = torch.as_tensor(ref).detach().cpu().double().numpy()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _identical_across(tensors, group=None) -> None:
    """Raise unless every rank holds the same bits in ``tensors``."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    if not all(torch.equal(p, parts[0]) for p in parts):
        raise AssertionError("the replicas' parameters differ after a step")


def _dryrun_rank(rank, device, n):
    """One rank of :func:`dryrun_multichip`: the three modes, each checked
    against the single-process computation; returns the numbers and this
    rank's kernel launches."""
    from graphflow_tpu_torch import parallel
    from graphflow_tpu_torch.core import batching, prep
    from graphflow_tpu_torch.models import SMP_omega
    from graphflow_tpu_torch.models.smp2d import (SMP2DConfig,
                                                  init_smp2d_params,
                                                  smp2d_forward)
    from graphflow_tpu_torch.ops import launch_counts
    from graphflow_tpu_torch.ops.losses import squared_loss
    from graphflow_tpu_torch.optim import make_optimizer
    from graphflow_tpu_torch.utils.convert import flatten, unflatten
    from graphflow_tpu_torch.utils.datasets import random_graph

    out = {}
    # --- 1. data-parallel training step over mesh axis "data" ---
    model = SMP_omega(max_nVertices=8, max_receptive_field=3, nLevels=1,
                      nChanels=4, nFeatures=4, nDepth=2, seed=0,
                      device=device)
    mesh = parallel.make_mesh({"data": n})
    step = parallel.make_dp_train_step(model._loss, model.opt, mesh)
    batch = _toy_batch(model, n)          # one graph per rank
    with torch.no_grad():
        loss_single = float(model._loss(model.params, batch))
    params = parallel.replicate(model.param_dict(), mesh)
    params, _, loss = step(params, model.opt_state,
                           parallel.shard_batch(batch, mesh), 0.001)
    if not np.isfinite(float(loss)):
        raise AssertionError("DP step produced a non-finite loss")
    _close("DP loss != single-process batch loss", float(loss),
           loss_single, 1e-5)
    _identical_across(list(params.values()))
    out["dp"] = (float(loss), loss_single)

    # --- 2. vertex-partitioned forward over mesh axis "graph" ---
    V = 3 * n
    cfg = SMP2DConfig(max_nVertices=V, max_receptive_field=3, nLevels=1,
                      nChanels=4, nFeatures=4, nDepth=2)
    p_params = init_smp2d_params(torch.Generator().manual_seed(0), cfg,
                                 device)
    pg = prep.prepare_graph(random_graph(V, 0.3, seed=1), cfg.nLevels, V, 3,
                            cfg.nDepth)
    plan = parallel.plan_partition(pg, n)
    gmesh = parallel.make_mesh({"graph": n})
    fwd = parallel.make_partitioned_forward(cfg, plan, gmesh, device=device)
    with torch.no_grad():
        pred, feat = fwd(p_params, parallel.shard_inputs(plan, gmesh,
                                                          device=device))
        pred_s, feat_s = smp2d_forward(
            p_params, batching.stack_graphs([pg], device=device), cfg)
    _close("partitioned forward != unsharded", pred, pred_s[0], 1e-4)
    _close("partitioned feature != unsharded", feat, feat_s[0], 1e-4, 1e-5)
    out["forward"] = (float(pred), float(pred_s[0]))

    # --- 3. partitioned TRAIN step on a data x graph mesh ---
    n_graph = max(d for d in (1, 2, 4, 8) if d <= n and V % d == 0)
    n_data = n // n_graph
    graphs = [random_graph(V, 0.3, seed=s) for s in range(2 * n_data)]
    targets = np.array([float(g.nVertices) for g in graphs], np.float32)
    pgs = [prep.prepare_graph(g, cfg.nLevels, V, 3, cfg.nDepth)
           for g in graphs]
    bplan = parallel.plan_partition_batch(pgs, n_graph)
    mesh2 = parallel.make_mesh({"data": n_data, "graph": n_graph})
    opt = make_optimizer("adam")
    tstep = parallel.make_partitioned_train_step(cfg, bplan, opt, mesh2,
                                                 device=device)
    flat = {k: v.clone().requires_grad_()
            for k, v in flatten(p_params).items()}
    new_params, _, loss_p = tstep(
        flat, opt.init(flat),
        parallel.shard_inputs(bplan, mesh2, device=device), targets, 0.01)

    ref = {k: v.clone().requires_grad_() for k, v in flatten(p_params).items()}
    sbatch = batching.stack_graphs(pgs, targets, device=device)
    pred_ref, _ = smp2d_forward(unflatten(ref), sbatch, cfg, training=True)
    loss_ref = squared_loss(pred_ref, sbatch["target"])
    grads = torch.autograd.grad(loss_ref, list(ref.values()))
    ref, _ = opt.update(ref, opt.init(ref), dict(zip(ref, grads)), 0.01,
                        nBatch=len(graphs))
    _close("partitioned train loss diverged", float(loss_p),
           float(loss_ref.detach()), 1e-4)
    # The nBatch Adam is uncorrected without a schedule, so first-step
    # updates are ~3.16x larger and near-zero gradients amplify reduction-
    # order noise: the JAX package's tolerance.  The sharp gates are the
    # loss and the forward above.
    for k in new_params:
        _close(f"post-step {k}", new_params[k], ref[k], 2e-2, 2e-4)
    _identical_across(list(new_params.values()))
    out["train"] = (float(loss_p), float(loss_ref.detach()))
    out["launches"] = launch_counts()
    return out


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run the three parallel modes on ``n_devices`` ranks (module
    docstring) and return each rank's report: the numbers compared and the
    kernel launches.  Raises if a rank fails a check."""
    from graphflow_tpu_torch.parallel import run_ranks

    return run_ranks(_dryrun_rank, n_devices, (n_devices,), device=device,
                     verbose=True)


if __name__ == "__main__":
    fn, args = entry()
    print("entry() forward:", fn(*args).detach().cpu().numpy())
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) OK")
