"""The graph convolution autoencoder GCA_1D and the covariant GCNs CGCN_1D
and CGCN_2D (counterpart of ``graphflow_tpu/models/gca.py``).

GCA_1D (``GCA_1D.h``): a GCN_1D-like encoder whose head is the Gram matrix
of the top level's vertex embeddings, trained to reconstruct the adjacency
with the squared loss (``GCA_1D.h:242-255``).  Momentum.

CGCN_1D/2D (``CGCN_1D.h``, ``CGCN_2D.h``): vertex states live in
R^{max_nVertices}:
  level 0:  rep_v = e_v * <wl_feat_v, H>      (VertexRepresentation)
  level l:  n_v = RisiLayer{1,2}D({rep_{l-1,u} : adj(u,v) > 0})  (open 1-hop)
            rep_v = LeakyReLU(mask_{<=l}(F_l @ n_v))   (CGCN_1D.h:220-234)
  head:     predict = the sum of every component of sum_v rep_v; squared
            loss

The batch runs at once; torch ops, no kernel (the JAX package runs no
Pallas kernel here either).  Every Softmax trains with the reference's
diagonal-only backward.
"""

from __future__ import annotations

import numpy as np
import torch

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.ops.activations import leaky_relu, softmax
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.optim.utils import uniform_init
from graphflow_tpu_torch.utils.convert import to_numpy


class _OneHopModel(GraphModel):
    """Momentum, a 1-hop preparation, the squared loss of the
    prediction."""

    def __init__(self, nLevels, max_nVertices, nDepth, momentum_param):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.nLevels, self.max_nVertices = nLevels, max_nVertices
        self.nDepth = nDepth

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        return prep.prepare_graph(graph, self.nLevels, self.max_nVertices, 1,
                                  self.nDepth)

    def _loss(self, params, batch):
        pred, _ = self._forward(params, batch)
        return squared_loss(pred, batch["target"])


class GCA_1D(_OneHopModel):
    """The graph autoencoder: Gram(hiddens) ~ adjacency.  Parameters per
    level W1 [H, feat] (and W2 [H, H] from level 1), in that order."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                 max_Radius, momentum_param=0.9, seed=0, device=None):
        super().__init__(nLevels, max_nVertices, nDepth, momentum_param)
        self.nFeatures, self.nHiddens = nFeatures, nHiddens
        self.max_Radius = max_Radius
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)

        def draw(shape):
            return uniform_init(shape, generator, torch.float32, device)

        feat_dim = nFeatures * (nDepth + 1)
        levels = [dict({"W1": draw((nHiddens, feat_dim))},
                       **({"W2": draw((nHiddens, nHiddens))} if l else {}))
                  for l in range(nLevels + 1)]
        self._register({"levels": levels},
                       [f"levels/{l}/{k}" for l, lev in enumerate(levels)
                        for k in lev])

    def _encode(self, params, g):
        vmask, feat = g["vmask"], g["wl_feat"]
        mask = vmask[..., None]
        outer = vmask[:, :, None] * vmask[:, None, :]
        levels = params["levels"]
        hidden = softmax(feat @ levels[0]["W1"].T) * mask
        for l in range(1, self.nLevels + 1):
            M = (g["sp"] <= min(l, self.max_Radius)).to(vmask.dtype) * outer
            part2 = (M @ hidden) @ levels[l]["W2"].T
            hidden = softmax(feat @ levels[l]["W1"].T + part2) * mask
        return hidden

    def _forward(self, params, batch):
        """-> (the Gram matrices [B, V, V], the vertex embeddings)."""
        hidden = self._encode(params, batch)
        return hidden @ hidden.transpose(1, 2), hidden

    def _loss(self, params, batch):
        """The squared loss of the Gram matrix against the adjacency, both
        restricted to real vertices; the targets are not read."""
        gram, _ = self._forward(params, batch)
        vmask = batch["vmask"]
        vm2 = vmask[:, :, None] * vmask[:, None, :]
        return squared_loss(gram * vm2, batch["adj"] * vm2)

    # The autoencoder's API: no regression target (gca.py:85-93).
    def getLoss(self, graphs, targets=None) -> float:
        return super().getLoss(graphs, [0.0] * len(graphs))

    def BatchLearn(self, graphs, targets=None, learning_rate=1e-3, **kw):
        """``BatchLearn(graphs, lr)`` or ``BatchLearn(graphs,
        learning_rate=lr)``: a float in place of the targets is the
        learning rate."""
        if targets is None or isinstance(targets, float):
            if isinstance(targets, float):
                learning_rate = targets
            targets = [0.0] * len(graphs)
        return super().BatchLearn(graphs, targets, learning_rate, **kw)

    def Reconstruct(self, graph: DenseGraph) -> np.ndarray:
        """The predicted adjacency (the Gram matrix of the vertex
        embeddings) of the graph's n real vertices, [n, n]."""
        n = graph.nVertices
        return self._run([graph], lambda out: to_numpy(out[0][0, :n, :n]))


class CGCN(_OneHopModel):
    """CGCN_1D / CGCN_2D: H [feat], then per level F [V, V]."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nDepth, order=1,
                 momentum_param=0.9, seed=0, device=None):
        super().__init__(nLevels, max_nVertices, nDepth, momentum_param)
        self.nFeatures, self.order = nFeatures, order
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)

        def draw(shape):
            return uniform_init(shape, generator, torch.float32, device)

        tree = {"H": draw((nFeatures * (nDepth + 1),)),
                "levels": [{"F": draw((max_nVertices, max_nVertices))}
                           for _ in range(nLevels)]}
        self._register(tree, ["H"] + [f"levels/{l}/F"
                                      for l in range(nLevels)])

    def _forward(self, params, batch):
        """-> (predictions [B], the summed representation [B, V])."""
        vmask, sp = batch["vmask"], batch["sp"]
        outer = vmask[:, :, None] * vmask[:, None, :]
        # Level 0: rep_v = e_v * <feat_v, H> (VertexRepresentation.h).
        scalar = batch["wl_feat"] @ params["H"]               # [B, V]
        rep = torch.diag_embed(scalar) * vmask[..., None]
        A = batch["adj"] * outer                             # the open 1-hop
        for l in range(1, self.nLevels + 1):
            if self.order == 1:
                n = A @ rep                                  # RisiLayer1D
            else:
                s = rep.sum(dim=-1, keepdim=True)
                n = (A @ s) * (A @ rep) - A @ (s * rep)
            lin = n @ params["levels"][l - 1]["F"].T         # F @ n_v
            # mask[v, u]: sp(u, v) <= l between real vertices.
            mask_l = (sp.transpose(1, 2) <= l).to(vmask.dtype) * outer
            rep = leaky_relu(torch.where(mask_l > 0, lin,
                                         torch.zeros_like(lin)))
        summed = rep.sum(dim=1)
        return summed.sum(dim=-1), summed


def CGCN_1D(nLevels, max_nVertices, nFeatures, nDepth, momentum_param=0.9,
            seed=0, device=None) -> CGCN:
    """``CGCN_1D.h``."""
    return CGCN(nLevels, max_nVertices, nFeatures, nDepth, 1, momentum_param,
                seed, device)


def CGCN_2D(nLevels, max_nVertices, nFeatures, nDepth, momentum_param=0.9,
            seed=0, device=None) -> CGCN:
    """``CGCN_2D.h``: RisiLayer2D aggregation."""
    return CGCN(nLevels, max_nVertices, nFeatures, nDepth, 2, momentum_param,
                seed, device)
