"""Checkpoints (counterpart of ``graphflow_tpu/utils/checkpoint.py``):
reference-format text dumps, npz snapshots and ``torch.save`` files.

The reference saves every registered parameter as whitespace-separated
plain text in registration order (``SMP_omega.h:1033-1055``).  The values
are written as the JAX package writes them, so a file saved by either
package loads into the other unchanged, bfloat16 included: a value is
written as the Python float it holds, and read back as float64 and then
rounded to the parameter's dtype, as the JAX package's NumPy cast does.

``save_npz``/``load_npz`` keep the leaves as ``arr_0``, ``arr_1``, ... in
the JAX package's ``tree_flatten`` order (dict keys sorted, list entries by
index), so that an npz written by either package loads into the other.
``save_torch``/``load_torch`` are the counterparts of ``save_orbax`` and
``load_orbax``: one ``torch.save`` of the leaves in that order, keyed by
path.  Parameters are {path: tensor} (a model's ``param_dict()``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from graphflow_tpu_torch.utils.convert import to_numpy, unflatten


def save_text(filename: str, params: Dict[str, torch.Tensor],
              order: Sequence[str]) -> None:
    """Write ``params[path]`` for each path of ``order``, flattened
    row-major, each value followed by one space."""
    with open(filename, "w") as f:
        for path in order:
            for v in to_numpy(params[path]).reshape(-1):
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


def leaf_order(params: Dict[str, torch.Tensor]) -> List[str]:
    """The paths of ``params`` in the JAX package's ``tree_flatten`` order
    of the same tree: dict keys sorted, list entries by index."""
    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k])
        elif isinstance(node, list):
            for x in node:
                yield from walk(x)
        else:
            yield node

    return list(walk(unflatten({p: p for p in params})))


def _like(a, t: torch.Tensor, what: str) -> torch.Tensor:
    """Array or tensor ``a`` as a new tensor of ``t``'s dtype and device,
    after checking its shape."""
    if tuple(a.shape) != tuple(t.shape):
        raise ValueError(f"{what} has shape {tuple(a.shape)}, the model "
                         f"has {tuple(t.shape)}")
    return torch.as_tensor(a).to(dtype=t.dtype, device=t.device)


def save_npz(filename: str, params: Dict[str, torch.Tensor]) -> None:
    """The leaves as ``arr_i`` in :func:`leaf_order` (bfloat16 as float32,
    which holds it exactly), and their paths as ``treedef``."""
    order = leaf_order(params)
    np.savez(filename, *[to_numpy(params[p]) for p in order],
             treedef=" ".join(order))


def load_npz(filename: str, template: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """Read an npz of either package into new tensors shaped, typed and
    placed like ``template[path]``."""
    order = leaf_order(template)
    with np.load(filename, allow_pickle=False) as data:
        n = sum(1 for k in data.files if k.startswith("arr_"))
        if n != len(order):
            raise ValueError(f"{filename} has {n} arrays, the model has "
                             f"{len(order)} parameters")
        return {p: _like(data[f"arr_{i}"], template[p], p)
                for i, p in enumerate(order)}


def save_torch(filename: str, params: Dict[str, torch.Tensor]) -> None:
    """One ``torch.save`` of {path: tensor on the CPU} in
    :func:`leaf_order`."""
    torch.save({p: params[p].detach().cpu() for p in leaf_order(params)},
               filename)


def load_torch(filename: str, template: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Read a :func:`save_torch` file (tensors only) into new tensors
    shaped, typed and placed like ``template[path]``."""
    saved = torch.load(filename, map_location="cpu", weights_only=True)
    if list(saved) != leaf_order(template):
        raise ValueError(f"{filename} holds {list(saved)}, the model has "
                         f"{leaf_order(template)}")
    return {p: _like(saved[p], template[p], p) for p in saved}
