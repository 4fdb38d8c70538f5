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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a NumPy array on the host.  NumPy has no bfloat16, so a
    bfloat16 tensor comes back as float32, which holds it exactly."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A NumPy array as a tensor.  JAX's bfloat16 arrays (an ``ml_dtypes``
    dtype, which torch does not take) cross as float32, which is exact, and
    come out as bfloat16."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a)


def flatten(tree: Any, leaf=lambda x: x) -> Dict[str, Any]:
    """A tree of dicts and lists -> {path: leaf(x)}, dicts in insertion
    order and lists by index, paths '/'-joined."""
    flat: Dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            flat[prefix] = leaf(node)
            return
        for k, child in items:
            walk(child, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return flat


def params_from_jax(tree: Any, dtype=None, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Flatten a tree of NumPy-convertible arrays into {path: tensor}
    (:func:`flatten`); bfloat16 stays bfloat16 unless ``dtype`` says
    otherwise."""
    return flatten(tree, lambda a: _from_numpy(np.array(a)).to(
        dtype=dtype, device=device))


def unflatten(params: Dict[str, Any], leaf=lambda t: t) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: {path: x} -> the tree of
    ``leaf(x)``, a numeric path component indexing a list."""
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
        value = leaf(t)
        if isinstance(node, list):
            node.append(value)
        else:
            node[keys[-1]] = value
    return tree


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{path: tensor} -> the tree of NumPy arrays (bfloat16 as float32)."""
    return unflatten(params, to_numpy)
