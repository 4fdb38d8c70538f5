"""Optimizers, the backtracking loop, parameter initialisation and the
training utilities."""

from graphflow_tpu_torch.optim.backtracking import backtracking_learn
from graphflow_tpu_torch.optim.optimizers import (Optimizer, adadelta, adam,
                                                  adamax, make_optimizer,
                                                  momentum, sgd)
from graphflow_tpu_torch.optim.utils import (cache_parameters, init_like,
                                             restore_parameters,
                                             sum_gradients_add,
                                             sum_gradients_init,
                                             uniform_init, xavier_init)

__all__ = ["Optimizer", "adadelta", "adam", "adamax", "backtracking_learn",
           "cache_parameters", "init_like", "make_optimizer", "momentum",
           "restore_parameters", "sgd", "sum_gradients_add",
           "sum_gradients_init", "uniform_init", "xavier_init"]
