"""LCNN, a PATCHY-SAN-like graph CNN (counterpart of
``graphflow_tpu/models/lcnn.py``).

Reference ``LCNN.h``: WL-rank the padded graph, build a sequence of the
nNeighbors nearest vertices per rank position (by hop distance, then rank,
``LCNN.h:294-320``), gather WL-feature rows by the sequence, two
stride-nNeighbors Conv1D layers with LeakyReLU, a dense layer and a linear
regression head.  Momentum.

Two quirks of the reference stay as they are: the second gather reads the
first convolution's rows by VERTEX id, while those rows are in RANK order
(``LCNN.h:69-70``), and the dense layer reads the second convolution's raw
output, not its LeakyReLU (``LCNN.h:78``).  Torch ops, no kernel (the JAX
package runs none here either).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.conv import conv1d
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.optim.utils import uniform_init


def find_sequence(sp, order, n_real, nNeighbors, nVertices) -> np.ndarray:
    """``LCNN.h:294-320``: for each rank position i, up to nNeighbors real
    vertices by (hop distance from order[i], rank), padded with the
    sentinel ``n_real``; [nVertices * nNeighbors] int64."""
    seq = np.full((nVertices * nNeighbors,), n_real, dtype=np.int64)
    for i in range(nVertices):
        j = 0
        for d in range(nVertices):
            for v in range(nVertices):
                if sp[order[i], order[v]] == d and order[v] < n_real:
                    seq[nNeighbors * i + j] = order[v]
                    j += 1
                    if j == nNeighbors:
                        break
            if j == nNeighbors:
                break
    return seq


class LCNN(GraphModel):
    """Parameters firstFilter [K, feat, C1], firstBias [C1], secondFilter
    [K, C1, C2], secondBias [C2], denseWeight [nDense, V C2], W [nDense],
    registered in that order."""

    def __init__(self, nVertices, nFeatures, nNeighbors, nDepth, nChanels1,
                 nChanels2, nDense, momentum_param=0.9, seed=0, device=None):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.nVertices, self.nFeatures = nVertices, nFeatures
        self.nNeighbors, self.nDepth = nNeighbors, nDepth
        feat_dim = nFeatures * (nDepth + 1)
        shapes = {"firstFilter": (nNeighbors, feat_dim, nChanels1),
                  "firstBias": (nChanels1,),
                  "secondFilter": (nNeighbors, nChanels1, nChanels2),
                  "secondBias": (nChanels2,),
                  "denseWeight": (nDense, nVertices * nChanels2),
                  "W": (nDense,)}
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        self._register({n: uniform_init(s, generator, torch.float32, device)
                        for n, s in shapes.items()}, list(shapes))

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        """The 1-level preparation, and the vertex sequence as ``seq``.  The
        WL rank is taken on the padded graph, its zero-feature dummy
        vertices included, as the reference does (``LCNN.h``'s
        floyd_warshall over nVertices)."""
        pg = prep.prepare_graph(graph, 1, self.nVertices, 1, self.nDepth)
        order, _ = prep.rank_vertices(np.asarray(pg.wl_feat, np.float64))
        pg.seq = find_sequence(np.asarray(pg.sp), order, graph.nVertices,
                               self.nNeighbors, self.nVertices)
        return pg

    def _stack(self, graphs, targets=None):
        batch = super()._stack(graphs, targets)
        batch["seq"] = torch.from_numpy(
            np.stack([self.prepare(g).seq for g in graphs])).to(self.device)
        return batch

    def _forward(self, params, batch):
        """-> (predictions [B], the dense layer [B, nDense])."""
        seq, K = batch["seq"], self.nNeighbors

        def gather(rows):
            # Row n_real (or V, the appended one) reads zeros.
            padded = F.pad(rows, (0, 0, 0, 1))
            return torch.gather(padded, 1, seq[..., None].expand(
                -1, -1, rows.shape[-1]))

        c1 = conv1d(gather(batch["wl_feat"]), params["firstFilter"],
                    params["firstBias"], stride=K)               # [B, V, C1]
        # The quirk: the rows of conv 1 gathered by vertex id.
        c2 = conv1d(gather(leaky_relu(c1)), params["secondFilter"],
                    params["secondBias"], stride=K)              # [B, V, C2]
        # The dense layer reads the raw c2, not its LeakyReLU.
        dense = c2.reshape(c2.shape[0], -1) @ params["denseWeight"].T
        return dense @ params["W"], dense

    def _loss(self, params, batch):
        pred, _ = self._forward(params, batch)
        return squared_loss(pred, batch["target"])
