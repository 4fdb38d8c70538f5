"""Weights across packages.

The JAX package keeps parameters as a tree of dicts and lists
(``{"H", "levels": [{"K", "b"}, ...], "W"}``); the port keys them by the
same '/'-joined paths (``"H"``, ``"levels/0/K"``, ...).  Layouts are the
same in both, so crossing over is a copy, never a transpose.  Tests and
``chip_smoke.py`` use these to feed both packages one set of weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Any, dtype=None, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Flatten a tree of NumPy-convertible arrays into {path: tensor}, dicts
    in insertion order and lists by index."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            flat[prefix] = torch.as_tensor(np.array(node)).to(
                dtype=dtype, device=device)
            return
        for k, child in items:
            walk(child, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return flat


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: {path: tensor} -> a tree of
    NumPy arrays, a numeric path component indexing a list."""
    tree: Dict[str, Any] = {}
    for path, t in params.items():
        keys = path.split("/")
        node: Any = tree
        for k, nxt in zip(keys[:-1], keys[1:]):
            if isinstance(node, list):
                while len(node) <= int(k):
                    node.append([] if nxt.isdigit() else {})
                node = node[int(k)]
            else:
                node = node.setdefault(k, [] if nxt.isdigit() else {})
        value = t.detach().cpu().numpy()
        if isinstance(node, list):
            node.append(value)
        else:
            node[keys[-1]] = value
    return tree
