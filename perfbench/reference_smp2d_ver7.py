"""The plain reference of SMP_2D_ver7 (GraphFlow's ``SMP_2D_ver7.h:134-141``
with ``RisiContraction_50.h:94-431``; Kondor et al., "Covariant
Compositional Networks for Learning Graphs", arXiv:1801.02144): level 0,
the 50-case contraction levels, the head, the squared loss, the gradients
and Momentum (``Momentum.h:46-68``), in plain PyTorch and NumPy.

It imports nothing of the program and takes nothing the program made.  Of
``reference_smp2d`` (benchmark code too) it takes the host prep and the
batch's level arrays (``prepare``, ``Batch``: receptive fields as boolean
rows over the graph's vertices, capped by whole distance groups, fields in
ascending vertex order) and the products in the reference's precision
(``Products``: float64, or ``"tf32"``, the control that ``correct`` has to
reject).

A level is the definition, not the program's factoring: the aligned
neighbour tensor T[v, a, b, c] = state[nbr[v,a], pos[v,a,b], pos[v,a,c]]
is materialised a block of vertices at a time; each of the 50 cases is one
einsum of T and the reduced adjacency A from the case table, in the order
of ``RisiContraction_50.h:94-431``; the whole bank [n, P, P, 50C] is built
and ``reshape(bank) @ K`` is taken, as ``SMP_2D_ver7.h:134-141`` does; then
+ b, LeakyReLU and the field mask.

Departures from the reference program, each leaving every output as it is
up to rounding: a field's members stand in ascending vertex order (the
program orders them by WL rank, which permutes the rows and columns of a
vertex's tensor alike); each level is padded to the batch's largest field
(absent slots and positions are zeros, and A is zero outside the field);
A carries a unit diagonal (the field's adjacency with its self loops, as
the program's prep builds it); the 50 cases take A as it is, with no
positivity guard (A is 0/1 here); products run in float64 (or TF32) where
the reference program runs float64 loops; the gradients are torch
autograd's, each block's T and bank recomputed in the backward rather than
kept.  Momentum takes the nBatch overload: the gradients divided by the
batch's size, then v = gamma v + lr g and p -= v.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference_smp2d import Batch, Products, leaky, param_order
# The host prep of one graph, as the family interface's ``prepare``.
from perfbench.reference_smp2d import prepare  # noqa: F401

PAIRS = ("ab", "ac", "ad", "ae", "bc", "bd", "be", "cd", "ce", "de")


def case_table():
    """The 50 cases of ``RisiContraction_50.h:94-431`` in its order, each
    (the fixed pair, the tied indices or ""), over T's indices a, b, c and
    A's d, e: cases 1-10 fix each pair and sum the other three apart,
    11-40 fix each pair and tie one pair of the rest (in lexicographic
    order), 41-50 fix each pair and tie all three of the rest."""
    rest = {p: [i for i in "abcde" if i not in p] for p in PAIRS}
    table = [(p, "") for p in PAIRS]
    for p in PAIRS:
        r = rest[p]
        table += [(p, r[0] + r[1]), (p, r[0] + r[2]), (p, r[1] + r[2])]
    table += [(p, "".join(rest[p])) for p in PAIRS]
    return tuple(table)


CASES = case_table()


def equation(fixed: str, tie: str) -> str:
    """The einsum of one case: T "vabcf" and A "vde" with each tied index
    written as the first of its tie -> the fixed pair and the channel."""
    sym = {i: (tie[0] if i in tie else i) for i in "abcde"}
    t = "v" + "".join(sym[i] for i in "abc") + "f"
    a = "v" + sym["d"] + sym["e"]
    return f"{t},{a}->v{sym[fixed[0]]}{sym[fixed[1]]}f"


def bank_50(T, A, mm):
    """T [n, P, P, P, C], A [n, P, P] -> the bank [n, P, P, 50C], case k
    in channels k*C .. (k+1)*C - 1."""
    n, P, C = T.shape[0], T.shape[1], T.shape[-1]
    Y = T.new_empty((n, P, P, len(CASES) * C))
    for k, (fixed, tie) in enumerate(CASES):
        Y[..., k * C:(k + 1) * C] = mm(equation(fixed, tie), T, A)
    return Y


def aligned(state, nbr, pos):
    """T[v, a, b, c] = state[nbr[v,a], pos[v,a,b], pos[v,a,c]], zero where
    the slot (nbr < 0) or a position (pos < 0) is absent."""
    nb, P = nbr.shape
    Q, C = state.shape[1], state.shape[-1]
    n = nbr.clamp(min=0).long()
    p = pos.clamp(min=0).long()
    rows = (n[:, :, None, None] * Q + p[:, :, :, None]) * Q + p[:, :, None, :]
    T = state.reshape(-1, C).index_select(0, rows.reshape(-1))
    ok = (nbr >= 0)[:, :, None] & (pos >= 0)
    return T.reshape(nb, P, P, P, C) * (
        ok[:, :, :, None] & ok[:, :, None, :])[..., None].to(T.dtype)


def _level_block(state, nbr, pos, radj, mask, K, b, mm):
    """One level for a block of vertices: T, the whole bank, reshape @ K,
    + b, LeakyReLU, the field mask -> [n, P, P, Cout]."""
    nb, P = nbr.shape
    Y = bank_50(aligned(state, nbr, pos), radj, mm)
    Z = mm("npk,ko->npo", Y.reshape(nb, P * P, -1), K) + b
    both = mask[:, :, None] & mask[:, None, :]
    return leaky(Z).reshape(nb, P, P, -1) * both[..., None].to(Z.dtype)


def forward(batch: Batch, params: dict, mm: Products, block_elements: int,
            grad: bool = False):
    """Predictions [G] of a batch.  ``params``: H, levels/l/K, levels/l/b,
    W.  Each level runs a block of vertices at a time (T of at most
    ``block_elements`` elements); where gradients are taken, a block is
    recomputed in the backward rather than kept."""
    F0 = leaky(mm("vf,cf->vc", batch.hist, params["H"]))
    state = F0[:, None, None, :]
    for l, (nbr, pos, radj, mask) in enumerate(batch.levels):
        K, b = params[f"levels/{l}/K"], params[f"levels/{l}/b"]
        P, C = nbr.shape[1], state.shape[-1]
        step = max(1, block_elements // (P ** 3 * C))
        blocks = []
        for v0 in range(0, nbr.shape[0], step):
            args = (state, nbr[v0:v0 + step], pos[v0:v0 + step],
                    radj[v0:v0 + step], mask[v0:v0 + step], K, b)
            if grad:
                blocks.append(checkpoint(_level_block, *args, mm,
                                         use_reentrant=False))
            else:
                blocks.append(_level_block(*args, mm))
        state = torch.cat(blocks)
    vertex = leaky(state.sum(dim=(1, 2)))
    graph = torch.zeros((batch.G, vertex.shape[1]), dtype=vertex.dtype,
                        device=vertex.device).index_add(0, batch.graph_of,
                                                        vertex)
    return mm("gc,c->g", graph, params["W"])


def predict(preps, params, cfg: dict, precision="float64",
            block_elements=1 << 27, device="cpu"):
    """Predictions of graphs prepared by :func:`prepare`, as float64
    NumPy."""
    mm = Products(precision)
    p = {k: v.to(device=device, dtype=mm.dtype) for k, v in params.items()}
    with torch.no_grad():
        out = forward(Batch(preps, cfg, device, mm.dtype), p, mm,
                      block_elements)
    return out.double().cpu().numpy()


def train(steps, params, cfg: dict, lr: float, precision="float64",
          block_elements=1 << 27, device="cpu"):
    """Follow training steps: ``steps`` is a list of (preps, targets), one
    batch a step.  Each step: the summed squared loss, its gradients, one
    Momentum step (``cfg["momentum"]["gamma"]``) with the gradients divided
    by the batch's size.  Returns (losses before each step, the first
    step's gradients over the batch size {path: float64}, the parameters
    after the last step)."""
    gamma = cfg["momentum"]["gamma"]
    mm = Products(precision)
    order = param_order(cfg["nLevels"])
    p = {k: params[k].detach().to(device=device, dtype=mm.dtype).clone()
         for k in order}
    vel = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, first = [], None
    for preps, targets in steps:
        batch = Batch(preps, cfg, device, mm.dtype)
        leaves = {k: x.detach().requires_grad_() for k, x in p.items()}
        pred = forward(batch, leaves, mm, block_elements, grad=True)
        tgt = torch.as_tensor(np.asarray(targets), dtype=mm.dtype,
                              device=device)
        loss = 0.5 * ((pred - tgt) ** 2).sum()
        grads = torch.autograd.grad(loss, [leaves[k] for k in order])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gr / len(preps) for k, gr in zip(order, grads)}
            if first is None:
                first = {k: x.double().cpu() for k, x in g.items()}
            for k in order:
                vel[k] = gamma * vel[k] + lr * g[k]
                p[k] = p[k] - vel[k]
        p = {k: x.detach() for k, x in p.items()}
    return losses, first, {k: x.double().cpu() for k, x in p.items()}
