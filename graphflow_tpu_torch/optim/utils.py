"""Training utilities (counterpart of ``graphflow_tpu/optim/utils.py``):
weight initialisation, gradient accumulation (``SumGradients.h``) and
parameter snapshots (``CacheParameters.h``).

A parameter tree here is a dict ({path: tensor}, as the port's models and
optimizers keep them, or nested), a list or a tuple of tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _tree_map(fn, *trees):
    """fn over the leaves of trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def uniform_init(shape, generator: torch.Generator, dtype=torch.float32,
                 device=None, fan=None) -> torch.Tensor:
    """``GraphFlow.h:1280-1307`` uniform_init at the JAX package's scale:
    U(-0.9, 0.9) / rows, where ``rows`` defaults to shape[0].

    The draw is made on the CPU from ``generator`` and then moved, so one
    seed gives the same weights on every device.  (JAX's PRNG draws other
    numbers for the same seed; weights cross packages through
    ``utils/convert.py``.)
    """
    if fan is None:
        fan = shape[0] if len(shape) > 0 else 1
    r = 0.9 / fan
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * r).to(dtype=dtype, device=device)


def xavier_init(shape, generator: torch.Generator, dtype=torch.float32,
                device=None, fan=None) -> torch.Tensor:
    """``GraphFlow.h:1322-1328`` Xavier_init: U(-sqrt(3 / fan),
    +sqrt(3 / fan)), where ``fan`` defaults to the tensor's size; drawn as
    :func:`uniform_init` draws."""
    if fan is None:
        fan = int(np.prod(shape)) if len(shape) > 0 else 1
    r = float(np.sqrt(3.0 / fan))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * r).to(dtype=dtype, device=device)


def init_like(generator: torch.Generator, tree_shapes,
              initializer=uniform_init, dtype=torch.float32, device=None):
    """A tree of shapes (each leaf a tuple) -> a tree of tensors drawn by
    ``initializer`` from ``generator``, leaf after leaf in the JAX
    package's flattening order (a dict's keys sorted)."""
    if isinstance(tree_shapes, dict):
        drawn = {k: init_like(generator, tree_shapes[k], initializer, dtype,
                              device) for k in sorted(tree_shapes)}
        return {k: drawn[k] for k in tree_shapes}
    if isinstance(tree_shapes, list):
        return [init_like(generator, s, initializer, dtype, device)
                for s in tree_shapes]
    return initializer(tuple(tree_shapes), generator, dtype, device)


def sum_gradients_init(params):
    """``SumGradients.h`` reset_sum_gradients: zeros shaped like params."""
    return _tree_map(torch.zeros_like, params)


def sum_gradients_add(acc, grads):
    """``SumGradients.h`` cache_gradients: acc + grads."""
    return _tree_map(lambda a, g: a + g, acc, grads)


@torch.no_grad()
def cache_parameters(params):
    """``CacheParameters.h``: a snapshot.  The port's optimizers update the
    parameters in place, so the snapshot is a copy (the JAX package's
    arrays are immutable, and its snapshot is the tree itself)."""
    return _tree_map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def restore_parameters(snapshot, params=None):
    """The snapshot back: copied into ``params`` in place and ``params``
    returned when given, else the snapshot itself, as in the JAX
    package."""
    if params is None:
        return snapshot
    _tree_map(lambda p, s: p.copy_(s), params, snapshot)
    return params
