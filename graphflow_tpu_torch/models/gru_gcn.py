"""Gated graph sequence networks (counterpart of
``graphflow_tpu/models/gru_gcn.py``): a GRU cell over message-passing
levels, the neighbour aggregate as its input.

  level 0:  h_v = Softmax(W @ wl_feat_v)
  level l:  a_v = RisiLayer{1,2,3}D({h_{l-1,u} : sp(v,u) <= min(l, R)})
            (the third order then keeps the nHiddens largest, KMax,
            GRU_GCN_3D.h:123-124)
            z = sigmoid(W_z a + U_z h);  r = sigmoid(W_r a + U_r h)
            htilde = tanh(W_h a + U_h (r o h))
            h = (1 - z) o h + z o htilde            (GRU_GCN_1D.h:143-147)
  head:     vertex = sigmoid(W_g h_L) o tanh(U_g h_L)   (the output gate)
            graph = tanh(sum_v vertex);  predict = <U, graph>; squared loss

The parameters are shared by every level; Momentum.  Every Softmax trains
with the reference's diagonal-only backward (``ops/activations.py:
softmax``).  The batch runs at once, [B, V, H]; torch ops, no kernel (the
JAX package runs no Pallas kernel here either).
"""

from __future__ import annotations

import torch

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.models.gcn import _aggregate
from graphflow_tpu_torch.ops.activations import softmax
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.optim.utils import uniform_init


def gru_gcn_states(params, g, nLevels, max_Radius, order, nHiddens):
    """(per-level hidden states, each [B, V, H]; the output-gated vertex
    features [B, V, H]; the graph feature [B, H]) of a stacked batch
    (``graphflow_tpu/models/gru_gcn.py:32-53``)."""
    vmask, sp = g["vmask"], g["sp"]
    mask = vmask[..., None]
    outer = vmask[:, :, None] * vmask[:, None, :]
    h = softmax(g["wl_feat"] @ params["W"].T) * mask
    states = [h]
    for l in range(1, nLevels + 1):
        M = (sp <= min(l, max_Radius)).to(vmask.dtype) * outer
        a = _aggregate(M, h, order, nHiddens)
        z = torch.sigmoid(a @ params["W_z"].T + h @ params["U_z"].T)
        r = torch.sigmoid(a @ params["W_r"].T + h @ params["U_r"].T)
        ht = torch.tanh(a @ params["W_h"].T + (r * h) @ params["U_h"].T)
        h = ((1.0 - z) * h + z * ht) * mask
        states.append(h)
    vertex = (torch.sigmoid(h @ params["W_g"].T)
              * torch.tanh(h @ params["U_g"].T)) * mask
    return states, vertex, torch.tanh(vertex.sum(dim=1))


class GRU_GCN(GraphModel):
    """GRU_GCN_{1,2,3}D with the reference API; parameters in the
    reference's registration order (``GRU_GCN_1D.h:180-189``)."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                 max_Radius, order=1, momentum_param=0.9, seed=0,
                 device=None):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.nLevels, self.max_nVertices = nLevels, max_nVertices
        self.nFeatures, self.nHiddens = nFeatures, nHiddens
        self.nDepth, self.max_Radius, self.order = nDepth, max_Radius, order
        H = nHiddens
        shapes = {"W": (H, nFeatures * (nDepth + 1)), "W_z": (H, H),
                  "U_z": (H, H), "W_r": (H, H), "U_r": (H, H), "W_h": (H, H),
                  "U_h": (H, H), "W_g": (H, H), "U_g": (H, H), "U": (H,)}
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self._register({n: uniform_init(s, generator, torch.float32, device)
                        for n, s in shapes.items()}, list(shapes))

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        return prep.prepare_graph(graph, self.nLevels, self.max_nVertices, 1,
                                  self.nDepth)

    def _forward(self, params, batch):
        _, _, graph_feat = gru_gcn_states(params, batch, self.nLevels,
                                          self.max_Radius, self.order,
                                          self.nHiddens)
        return graph_feat @ params["U"], graph_feat

    def _loss(self, params, batch):
        pred, _ = self._forward(params, batch)
        return squared_loss(pred, batch["target"])


def GRU_GCN_1D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
               max_Radius, momentum_param=0.9, seed=0, device=None):
    """``GRU_GCN_1D.h``."""
    return GRU_GCN(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                   max_Radius, 1, momentum_param, seed, device)


def GRU_GCN_2D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
               max_Radius, momentum_param=0.9, seed=0, device=None):
    """``GRU_GCN_2D.h``: RisiLayer2D aggregation."""
    return GRU_GCN(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                   max_Radius, 2, momentum_param, seed, device)


def GRU_GCN_3D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
               max_Radius, momentum_param=0.9, seed=0, device=None):
    """``GRU_GCN_3D.h``: RisiLayer3D and KMax aggregation."""
    return GRU_GCN(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                   max_Radius, 3, momentum_param, seed, device)
