"""Optimizers, the backtracking loop and parameter initialisation."""

from graphflow_tpu_torch.optim.backtracking import backtracking_learn
from graphflow_tpu_torch.optim.optimizers import (Optimizer, adam,
                                                  make_optimizer, momentum)

__all__ = ["Optimizer", "adam", "backtracking_learn", "make_optimizer",
           "momentum"]
