"""Losses (counterpart of ``graphflow_tpu/ops/losses.py``).

Each loss returns the scalar to be minimised, and torch autograd seeds the
reverse sweep.  ``log_loss`` belongs to the classification heads, ROADMAP
queue 1, item 3 (slice 3).
"""

from __future__ import annotations

import torch


def squared_loss(predict: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``SquaredLoss.h:41-66``: 0.5 * ||predict - target||^2."""
    d = predict - target
    return 0.5 * torch.sum(d * d)
