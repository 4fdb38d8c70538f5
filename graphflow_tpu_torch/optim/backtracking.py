"""Backtracking learning-rate loop (counterpart of
``graphflow_tpu/optim/backtracking.py``).

Reference pattern (``GCN_1D.h:361-434``, ``SMP_omega.h:843-871``): take a
step; if the batch loss rose, restore the cached parameters and optimizer
state and halve the learning rate (down to ``min_lr``), else keep going.
The optimizer updates the parameters in place, so the cache is a copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def backtracking_learn(
    params: Dict[str, torch.Tensor],
    opt_state,
    loss_and_grads: Callable[[Dict[str, torch.Tensor]], Tuple[float, Any]],
    opt_update: Callable[..., Tuple[Any, Any]],
    learning_rate: float,
    nIterations: int,
    epsilon: float = 1e-8,
    decay_lr: float = 0.5,
    min_lr: float = 1e-6,
    nBatch=None,
):
    """Run up to nIterations steps with halve-on-increase backtracking.

    ``loss_and_grads(params) -> (loss, grads)`` evaluates the batch;
    ``opt_update(params, state, grads, lr, nBatch) -> (params, state)``
    updates ``params`` in place.  Returns (params, opt_state, initial_loss,
    final_loss), ``params`` being the same dict, updated.
    """
    loss0, grads = loss_and_grads(params)
    loss0 = float(loss0)
    best_loss = loss0
    lr = learning_rate

    for _ in range(nIterations):
        if best_loss < epsilon:
            break
        with torch.no_grad():
            cached = {k: p.detach().clone() for k, p in params.items()}
        cached_state = opt_state
        _, new_state = opt_update(params, opt_state, grads, lr, nBatch)
        new_loss, new_grads = loss_and_grads(params)
        new_loss = float(new_loss)
        if new_loss > best_loss:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(cached[k])
            opt_state = cached_state
            lr = max(lr * decay_lr, min_lr)
            if lr <= min_lr:
                break
        else:
            opt_state = new_state
            best_loss, grads = new_loss, new_grads

    return params, opt_state, loss0, best_loss
