"""Losses and regularizers (counterpart of ``graphflow_tpu/ops/losses.py``).

Each loss returns the scalar to be minimised, and torch autograd seeds the
reverse sweep.  That folds the reference's sign conventions into the
returned value: its ``LogLoss`` ``getLoss`` returns +log p and seeds the
gradient with -1, the JAX package and the port return -log p.
"""

from __future__ import annotations

import torch

LOG_ZERO = -1e9  # the reference's LOG_ZERO guard (``LogLoss.h``)


def squared_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``SquaredLoss.h:41-66``: 0.5 * ||predict - target||^2."""
    d = predict - target
    return 0.5 * torch.sum(d * d)


def log_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``LogLoss.h:38-76`` over a batch: sum_b -log softmax(scores_b)[label_b]
    for scores [B, nClasses] and labels [B].  Labels may arrive as the
    batch's float targets; they are cast to int64, truncating as the JAX
    package's ``astype(int32)`` does."""
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).sum()


def _leaves(params):
    """The tensors of a dict ({path: tensor} or a nested tree), a list or
    one tensor."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        params = params.values()
    return [x for p in params for x in _leaves(p)]


def l1_regularization(params, lam: float) -> torch.Tensor:
    """``L1Regularization.h``: lam * sum |w| over the parameters."""
    return lam * sum(torch.sum(torch.abs(p)) for p in _leaves(params))


def l2_regularization(params, lam: float) -> torch.Tensor:
    """``L2Regularization.h``: lam / 2 * sum w^2 over the parameters."""
    return 0.5 * lam * sum(torch.sum(p * p) for p in _leaves(params))
