"""The numbers that decide ``correct``, each a gap between the program's
outputs and the plain reference's, relative to the reference's scale."""

from __future__ import annotations

import numpy as np
import torch


def loss_gap(prog: float, ref: float) -> float:
    """The relative gap of one step's loss."""
    return abs(prog - ref) / abs(ref)


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Leaf by leaf: the gap between the program's norm of a leaf and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf (``keep``: the leaves that count)."""
    pn, rn = _norms(prog), _norms(ref)
    keys = [k for k in rn if keep is None or k in keep]
    median = float(np.median([rn[k] for k in keys]))
    return [abs(pn[k] - rn[k]) / max(rn[k], median) for k in keys]


def moving_leaves(first_grad: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding: a
    norm of at least a thousandth of the median leaf's."""
    n = _norms(first_grad)
    median = float(np.median(list(n.values())))
    return {k for k, v in n.items() if v >= 1e-3 * median}


def training_numbers(prog: dict, ref: dict) -> tuple:
    """``prog`` and ``ref`` each hold ``losses`` (before each followed
    step), ``grad`` (the first step's gradient as the optimizer takes it,
    over the batch size) and ``change`` (the parameters after the last
    followed step, minus before).

    -> (the numbers compared, the numbers only logged).  Compared: the
    first step's loss, the widest gap of the later steps' losses, the
    first gradient by the median leaf and the change by the worst leaf.
    Logged: the gradient by the worst leaf and the change by the median
    leaf.  Each measure is the one whose readings the control's stand
    farther from (PERF.md, section 2): the gradient's worst leaf swings
    where the batch's gradient cancels to a small sum, and its median leaf
    does less."""
    keep = moving_leaves(ref["grad"])
    losses = [loss_gap(p, r) for p, r in zip(prog["losses"],
                                              ref["losses"])]
    grad = leaf_gaps(prog["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], keep)
    return ({"loss_1": losses[0], "loss_later": max(losses[1:]),
             "grad": float(np.median(grad)), "change": max(change)},
            {"grad_worst": max(grad),
             "change_median": float(np.median(change))})


def prediction_numbers(prog, ref) -> dict:
    """The widest gap of a prediction over the reference's root mean
    square prediction."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    scale = float(np.sqrt(np.mean(ref ** 2)))
    return {"pred": float(np.max(np.abs(prog - ref)) / scale)}
