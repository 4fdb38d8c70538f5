"""The plain reference of SMP_omega and SMP_beta (GraphFlow's
``SMP_omega.h:31-113`` and ``SMP_beta.h``; Kondor et al., "Covariant
Compositional Networks for Learning Graphs", arXiv:1801.02144): host prep,
batching, level 0, the contraction levels, the head, the squared loss, the
gradients and Adam, in plain PyTorch and NumPy.

It imports nothing of the program and takes nothing the program made: it
starts from the benchmark's (adjacency, features) pairs and weights.  Its
prep works in vertex ids, not in the program's index arrays: a receptive
field is a boolean row over the graph's vertices, capped by dropping whole
distance groups; a field's members stand in ascending vertex order (the
program orders them by WL rank, which permutes the rows and columns of a
vertex's tensor alike and leaves every output unchanged).  Each level is
padded only to the batch's largest field.  The gathered slots T are
materialised, a block of vertices at a time, and the 18 cases are the
definition (a copy of ``graphflow_tpu_torch/ops/contractions.py:
risi_contraction_18``).

``precision`` is ``"float64"`` (the reference), or ``"tf32"``: float32 with
every product's operands rounded to TF32 (10 mantissa bits) and summed in
float32, in the forward and the backward alike, which is what one pass of
the tensor cores computes: the control that ``correct`` has to reject.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

INF = 10**9
NEGSLOPE = 0.01


# -- host prep -----------------------------------------------------------

def distances(adj: np.ndarray) -> np.ndarray:
    """All-pairs hop counts by breadth-first frontiers; INF unreachable."""
    n = adj.shape[0]
    A = (adj > 0).astype(np.int64)
    sp = np.full((n, n), INF, dtype=np.int64)
    reach = np.eye(n, dtype=bool)
    sp[reach] = 0
    frontier, d = reach.copy(), 0
    while frontier.any():
        d += 1
        frontier = ((frontier.astype(np.int64) @ A) > 0) & ~reach
        sp[frontier] = d
        reach |= frontier
    return sp


def wl_histogram(sp: np.ndarray, feature: np.ndarray, nDepth: int):
    """hist[v, d*F + f] = sum of feature[u, f] over u at distance d of v,
    d = 0..nDepth (``SMP_omega.h:382-404``)."""
    return np.concatenate([(sp == d).astype(np.float64).T @ feature
                           for d in range(nDepth + 1)], axis=1)


def receptive_fields(adj, sp, nLevels: int, cap: Optional[int]):
    """Boolean [n, n] fields of levels 0..nLevels: phi_0(v) = {v};
    phi_l(v) is the union of phi_{l-1}(u) over v's closed neighbourhood,
    and where it holds more than ``cap`` vertices the farthest distance
    groups leave it, whole, until it fits (``SMP_omega.h:476-538``)."""
    n = adj.shape[0]
    closed = ((adj > 0) | np.eye(n, dtype=bool)).astype(np.int64)
    fields = [np.eye(n, dtype=bool)]
    for _ in range(nLevels):
        U = (closed @ fields[-1].astype(np.int64)) > 0
        if cap is not None:
            for v in np.nonzero(U.sum(1) > cap)[0]:
                d = sp[v, U[v]]
                keep = max(x for x in np.unique(d)
                           if (d <= x).sum() <= cap)
                U[v] &= sp[v] <= keep
        fields.append(U)
    return fields


def prepare(adj, feature, cfg: dict) -> dict:
    """Everything the reference needs of one graph."""
    sp = distances(adj)
    return {"n": adj.shape[0], "adj": adj,
            "hist": wl_histogram(sp, feature, cfg["nDepth"]),
            "fields": receptive_fields(adj, sp, cfg["nLevels"],
                                       cfg["max_receptive_field"])}


def _level_arrays(preps: Sequence[dict], l: int, P: int):
    """The batch's level-l gather: nbr [N, P] (global vertex ids, -1
    absent), pos [N, P, P] (place in the neighbour's level-(l-1) field, -1
    absent), radj [N, P, P] (the field's adjacency with a unit diagonal)
    and the field mask [N, P], fields in ascending vertex order."""
    nbr, pos, radj, mask = [], [], [], []
    offset = 0
    for g in preps:
        n, F, Fp = g["n"], g["fields"][l], g["fields"][l - 1]
        order = np.zeros((n, P), dtype=np.int64)                  # [n, P]
        order[:, :min(n, P)] = np.argsort(~F, axis=1, kind="stable")[:, :P]
        valid = np.arange(P)[None, :] < F.sum(1)[:, None]
        place = np.where(Fp, np.cumsum(Fp, axis=1) - 1, -1)       # [w, u]
        pab = place[order[:, :, None], order[:, None, :]]
        both = valid[:, :, None] & valid[:, None, :]
        a = g["adj"] > 0
        adj1 = (a | np.eye(n, dtype=bool)).astype(np.float64)
        nbr.append(np.where(valid, order + offset, -1))
        pos.append(np.where(both, pab, -1))
        radj.append(np.where(both, adj1[order[:, :, None],
                                        order[:, None, :]], 0.0))
        mask.append(valid)
        offset += n
    return (np.concatenate(nbr), np.concatenate(pos), np.concatenate(radj),
            np.concatenate(mask))


# -- products in the reference's precision -------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Einsum(torch.autograd.Function):
    """einsum of two operands rounded to TF32, summed in float32; the
    backward's products round their operands too."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            ra = round_tf32(a).requires_grad_()
            rb = round_tf32(b).requires_grad_()
            out = torch.einsum(ctx.eq, ra, rb)
            ga, gb = torch.autograd.grad(out, (ra, rb), round_tf32(g))
        return None, ga, gb


class Products:
    """The products of the reference: exact in its dtype, or TF32."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def __call__(self, eq, a, b):
        if self.tf32:
            return _TF32Einsum.apply(eq, a, b)
        return torch.einsum(eq, a, b)


def leaky(x):
    return torch.where(x > 0, x, NEGSLOPE * x)


# Copied from graphflow_tpu_torch/ops/contractions.py:risi_contraction_18,
# with its products taken by ``mm``.
def contraction_18(T, A, mm):
    """T [N, P, P, P, C] (axis 1 the slot a), A [N, P, P] -> [N, P, P, 18C]:
    the 18 cases of ``RisiContraction_18.h:73-331`` with Ap = A * (A > 0)."""
    ein = torch.einsum
    Ap = torch.where(A > 0, A, torch.zeros_like(A))
    S = Ap.sum(dim=(-2, -1))[..., None, None, None]
    R = Ap.sum(dim=-1)
    trA = torch.diagonal(Ap, dim1=-2, dim2=-1).sum(-1)[..., None, None, None]
    T_ab = T.sum(dim=-2)
    T_bc = T.sum(dim=-4)
    T_a = T_ab.sum(dim=-2)
    T_b = T_bc.sum(dim=-2)
    T_full = T_a.sum(dim=-2)
    D_bc = ein("...abbf->...abf", T)
    D_ac = ein("...abaf->...abf", T)
    D_aab = ein("...aacf->...acf", T)
    s14 = D_aab.sum(dim=(-3, -2))
    s15 = D_bc.sum(dim=(-3, -2))
    t18 = ein("...aaaf->...af", T).sum(dim=-2)
    W16 = D_bc
    W17 = ein("...ebef->...bef", T)
    Tdiag_ac_b = D_ac.sum(dim=-3)
    Tdiag_bc_a = D_bc.sum(dim=-2)

    def outer_vR(u):
        return u[..., :, None, :] * R[..., None, :, None]

    AoT = Ap[..., None]
    ys = [
        T_ab * S,
        outer_vR(T_a),
        T_bc * S,
        outer_vR(T_b),
        AoT * T_full[..., None, None, :],
        mm("...abdf,...d->...abf", T, R),
        T_ab * trA,
        outer_vR(Tdiag_bc_a),
        mm("...aef,...de->...adf", T_ab, Ap),
        mm("...dbcf,...d->...bcf", T, R),
        outer_vR(Tdiag_ac_b),
        mm("...ebf,...de->...bdf", T_ab, Ap),
        mm("...bef,...de->...bdf", T_bc, Ap),
        AoT * s14[..., None, None, :],
        AoT * s15[..., None, None, :],
        mm("...aef,...de->...adf", W16, Ap),
        mm("...bef,...de->...bdf", W17, Ap),
        AoT * t18[..., None, None, :],
    ]
    return torch.cat(ys, dim=-1)


def _level_block(state, nbr, pos, radj, mask, K, b, mm):
    """One level for a block of vertices: gather and align the slots
    T[v, a, b, c] = state[nbr[v,a], pos[v,a,b], pos[v,a,c]] (zero where
    absent), the 18 cases, K, b, LeakyReLU, the field mask."""
    nb, P = nbr.shape
    Q, C = state.shape[1], state.shape[-1]
    n = nbr.clamp(min=0).long()
    p = pos.clamp(min=0).long()
    rows = (n[:, :, None, None] * Q + p[:, :, :, None]) * Q + p[:, :, None, :]
    T = state.reshape(-1, C).index_select(0, rows.reshape(-1))
    ok = (nbr >= 0)[:, :, None] & (pos >= 0)
    T = T.reshape(nb, P, P, P, C) * (
        ok[:, :, :, None] & ok[:, :, None, :])[..., None].to(T.dtype)
    Y = contraction_18(T, radj, mm)
    Z = mm("npk,ko->npo", Y.reshape(nb, P * P, -1), K) + b
    both = mask[:, :, None] & mask[:, None, :]
    return leaky(Z).reshape(nb, P, P, -1) * both[..., None].to(Z.dtype)


class Batch:
    """A batch of prepared graphs on ``device``, its level gathers built
    once."""

    def __init__(self, preps: Sequence[dict], cfg: dict, device, dtype):
        self.G = len(preps)
        self.graph_of = torch.as_tensor(np.repeat(
            np.arange(self.G), [g["n"] for g in preps]), device=device)
        self.hist = torch.as_tensor(np.concatenate(
            [g["hist"] for g in preps]), dtype=dtype, device=device)
        self.levels = []
        for l in range(1, cfg["nLevels"] + 1):
            P = max(int(g["fields"][l].sum(1).max()) for g in preps)
            nbr, pos, radj, mask = _level_arrays(preps, l, P)
            self.levels.append(tuple(
                torch.as_tensor(x, device=device) for x in (nbr, pos))
                + (torch.as_tensor(radj, dtype=dtype, device=device),
                   torch.as_tensor(mask, device=device)))


def forward(batch: Batch, params: dict, mm: Products, block_elements: int,
            grad: bool = False):
    """Predictions [G] of a batch.  ``params``: H, levels/l/K, levels/l/b,
    W.  Each level runs a block of vertices at a time, and, where
    gradients are taken, a block's gather is recomputed in the backward
    rather than kept."""
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


def param_order(nLevels: int) -> List[str]:
    """The registration order of ``SMP_omega.h:289-295``."""
    return (["H"] + [f"levels/{l}/{k}" for l in range(nLevels)
                     for k in ("K", "b")] + ["W"])


def predict(preps, params, cfg: dict, precision="float64",
            block_elements=1 << 28, device="cpu"):
    """Predictions of graphs prepared by :func:`prepare`, as float64
    NumPy."""
    mm = Products(precision)
    p = {k: v.to(device=device, dtype=mm.dtype) for k, v in params.items()}
    with torch.no_grad():
        out = forward(Batch(preps, cfg, device, mm.dtype), p, mm,
                      block_elements)
    return out.double().cpu().numpy()


def adam_corrections(order, shapes, t, beta1, beta2):
    """The per-element bias corrections of the reference's Adam nBatch
    overload (``Adam.h:108-136``): element e of the N registered scalars,
    at step t, is corrected by 1 - beta^(e + 1 + (t-1) N), the exponent
    and the power in float32."""
    total = sum(int(np.prod(shapes[k])) for k in order)
    out, at = {}, 0
    for k in order:
        n = int(np.prod(shapes[k]))
        expo = (torch.arange(at, at + n, dtype=torch.float32)
                + 1.0 + (float(t) - 1.0) * total).reshape(shapes[k])
        out[k] = (1.0 - beta1 ** expo, 1.0 - beta2 ** expo)
        at += n
    return out


def train(steps, params, cfg: dict, lr: float, precision="float64",
          block_elements=1 << 28, device="cpu"):
    """Follow training steps: ``steps`` is a list of (preps, targets), one
    batch a step.  Each step: the summed squared loss, its gradients, one
    Adam step (``cfg["adam"]``'s beta1, beta2 and epsilon) with the
    gradients divided by the batch's size.  Returns (losses before each
    step, the first step's gradients over the batch size {path: float64},
    the parameters after the last step)."""
    adam = cfg["adam"]
    mm = Products(precision)
    order = param_order(cfg["nLevels"])
    p = {k: params[k].detach().to(device=device, dtype=mm.dtype).clone()
         for k in order}
    m = {k: torch.zeros_like(x) for k, x in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    shapes = {k: tuple(x.shape) for k, x in p.items()}
    losses, first = [], None
    for t, (preps, targets) in enumerate(steps, start=1):
        batch = Batch(preps, cfg, device, mm.dtype)
        leaves = {k: x.detach().requires_grad_() for k, x in p.items()}
        pred = forward(batch, leaves, mm, block_elements, grad=True)
        tgt = torch.as_tensor(np.asarray(targets), dtype=mm.dtype,
                              device=device)
        loss = 0.5 * ((pred - tgt) ** 2).sum()
        grads = torch.autograd.grad(loss, [leaves[k] for k in order])
        losses.append(float(loss.detach()))
        nB = len(preps)
        corr = adam_corrections(order, shapes, t, adam["beta1"],
                                adam["beta2"])
        with torch.no_grad():
            g = {k: gr / nB for k, gr in zip(order, grads)}
            if first is None:
                first = {k: x.double().cpu() for k, x in g.items()}
            for k in order:
                m[k] = adam["beta1"] * m[k] + (1 - adam["beta1"]) * g[k]
                v[k] = adam["beta2"] * v[k] + (1 - adam["beta2"]) * g[k] ** 2
                c1, c2 = (c.to(device=device, dtype=mm.dtype)
                          for c in corr[k])
                p[k] = (p[k] - lr * (m[k] / c1)
                        / (torch.sqrt(v[k] / c2) + adam["epsilon"]))
        p = {k: x.detach() for k, x in p.items()}
    return losses, first, {k: x.double().cpu() for k, x in p.items()}
