"""Activations (counterpart of ``graphflow_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """``LeakyReLU.h``: x where x > 0, else alpha * x (reference default
    alpha = 0.01, ``LeakyReLU.h:31``)."""
    return torch.where(x > 0, x, alpha * x)
