"""Weight initialisation (counterpart of ``graphflow_tpu/optim/utils.py``)."""

from __future__ import annotations

import torch


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
