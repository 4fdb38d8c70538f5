"""Reference-format text checkpoints (counterpart of ``save_text`` and
``load_text`` in ``graphflow_tpu/utils/checkpoint.py``).

The reference saves every registered parameter as whitespace-separated
plain text in registration order (``SMP_omega.h:1033-1055``).  The values
are written as the JAX package writes them, so a file saved by either
package loads into the other unchanged.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def save_text(filename: str, params: Dict[str, torch.Tensor],
              order: Sequence[str]) -> None:
    """Write ``params[path]`` for each path of ``order``, flattened
    row-major, each value followed by one space."""
    with open(filename, "w") as f:
        for path in order:
            for v in params[path].detach().cpu().numpy().reshape(-1):
                f.write(f"{float(v)} ")


def load_text(filename: str, template: Dict[str, torch.Tensor],
              order: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Read a text checkpoint into new tensors shaped, typed and placed like
    ``template[path]``, in the order of ``order``."""
    with open(filename) as f:
        vals = np.asarray([float(x) for x in f.read().split()])
    expected = sum(template[p].numel() for p in order)
    if vals.size != expected:
        raise ValueError(f"{filename} has {vals.size} values, "
                         f"the model has {expected}")
    out, at = {}, 0
    for path in order:
        t = template[path]
        n = t.numel()
        out[path] = torch.as_tensor(vals[at:at + n].reshape(t.shape)).to(
            dtype=t.dtype, device=t.device)
        at += n
    return out
