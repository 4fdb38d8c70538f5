"""Data-parallel training across ranks (counterpart of
``graphflow_tpu/parallel/data_parallel.py``).

The reference's ``Threaded_BatchLearn`` copies the parameters to thread
replicas, takes one molecule per thread, sums the gradients serially and
applies one optimizer step (``SMP_omega.h:750-792``).  Here each rank holds
a replica and a contiguous share of the batch:

  replica broadcast   -> ``replicate``: every rank takes the first rank's
                         parameters
  one share per rank  -> ``shard_batch`` over the "data" axis
  serial gradient sum -> one all-reduce (SUM) of the loss and of every
                         gradient over the axis group
  one optimizer step  -> ``opt.update(..., nBatch=global batch)`` on every
                         rank, on the same summed gradients

Every rank applies the same update to the same parameters with the same
summed gradients, so the replicas stay bit-identical.  On CUDA the loss is
the model's own, so the level kernels (K1, K2) run inside each rank.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from graphflow_tpu_torch.core.batching import GraphBatch, batch_size
from graphflow_tpu_torch.parallel.mesh import (Axes, Mesh, data_sharding,
                                               replicated)
from graphflow_tpu_torch.utils.convert import unflatten


def all_reduce_sum(tensors, group) -> None:
    """Sum each tensor in place over ``group`` (nothing without one)."""
    if group is None:
        return
    works = [dist.all_reduce(t, group=group, async_op=True) for t in tensors]
    for w in works:
        w.wait()


def make_dp_train_step(loss_fn: Callable, opt, mesh: Mesh,
                       axis: Axes = "data"):
    """A data-parallel train step.

    ``loss_fn(params, batch)`` is the loss of a stacked batch summed over
    its graphs, with ``params`` the parameter tree (a model's ``_loss``).
    The returned ``step(params, opt_state, batch, lr)`` takes ``params`` as
    {path: leaf tensor that requires grad} (a model's ``param_dict()``) and
    this rank's share of the batch (``shard_batch``); it sums the shard's
    loss, all-reduces the loss and every gradient over ``axis`` (a name, or
    a tuple such as ``("host", "data")`` on a hybrid mesh), and applies
    one ``opt.update`` in place with nBatch = the global batch.  Returns
    (params, opt_state, the global loss as a 0-d tensor)."""
    group = mesh.group(axis)
    n_ranks = mesh.size(axis)

    def step(params: Dict[str, torch.Tensor], opt_state, batch: GraphBatch,
             lr):
        loss = loss_fn(unflatten(params), batch)
        grads = list(torch.autograd.grad(loss, list(params.values())))
        loss = loss.detach().clone()
        all_reduce_sum([loss] + grads, group)
        params, opt_state = opt.update(
            params, opt_state, dict(zip(params, grads)), lr,
            nBatch=batch_size(batch) * n_ranks)
        return params, opt_state, loss

    return step


def shard_batch(batch: GraphBatch, mesh: Mesh,
                axis: Axes = "data") -> GraphBatch:
    """This rank's share of a stacked batch (``mesh.data_sharding``)."""
    share = data_sharding(mesh, batch_size(batch), axis)
    return {k: x[share] for k, x in batch.items()}


def replicate(params: Dict[str, torch.Tensor], mesh: Mesh):
    """Overwrite ``params`` ({path: tensor}) in place with the first
    rank's values on every rank of the mesh; returns them."""
    replicated(mesh, list(params.values()))
    return params
