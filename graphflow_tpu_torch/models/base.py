"""The serving half of the reference's model API (counterpart of
``graphflow_tpu/models/base.py:GraphModel``).

Every reference model exposes ``Predict / Threaded_Predict / Feature /
save_model / load_model`` next to its training calls
(``SMP_omega.h:924-1045``).  Here a model is an ``nn.Module`` whose
parameters are registered in the reference's order; a concrete model
supplies ``_prepare`` (host preparation of one graph) and ``_forward``
(a pure function of a parameter tree and a stacked batch).  The per-graph
rebuild of the reference becomes a memoised host ``prepare`` plus one
batched forward.

Training (``getLoss``, ``Learn``, ``BatchLearn``) is ROADMAP queue 1,
item 2 (slice 2).
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.utils import checkpoint as ckpt

_TRAINING = ("training is ROADMAP queue 1, item 2 (slice 2): the level "
             "backward K2, the loss, Adam and BatchLearn")


class GraphModel(nn.Module):
    """Base class for graph-level models.

    Subclasses register their parameters in the reference's order under
    '/'-joined paths (``"levels/0/K"``), list them in ``param_order``, and
    implement ``_prepare(graph)`` and ``_forward(params, batch) ->
    (prediction [B], graph_feature [B, C])``.
    """

    param_order: List[str]

    def __init__(self):
        super().__init__()
        # Weak-keyed by graph identity: a collected DenseGraph can never
        # alias a new one, and the cache cannot grow without bound.
        self._prep_cache: "weakref.WeakKeyDictionary[DenseGraph, prep.PreparedGraph]" = (
            weakref.WeakKeyDictionary())

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        raise NotImplementedError

    def _forward(self, params, batch):
        raise NotImplementedError

    @property
    def params(self):
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        """Host preparation, memoised per DenseGraph instance."""
        pg = self._prep_cache.get(graph)
        if pg is None:
            pg = self._prepare(graph)
            self._prep_cache[graph] = pg
        return pg

    def _stack(self, graphs: Sequence[DenseGraph], targets=None):
        return batching.stack_graphs([self.prepare(g) for g in graphs],
                                     targets, device=self.device)

    @torch.no_grad()
    def _run(self, graphs: Sequence[DenseGraph]):
        return self._forward(self.params, self._stack(graphs))

    # -- reference API ---------------------------------------------------

    def Predict(self, graph: DenseGraph) -> float:
        """Reference ``Predict`` (SMP_omega.h:924-935)."""
        pred, _ = self._run([graph])
        return float(pred[0])

    def Threaded_Predict(self, graphs: Sequence[DenseGraph]) -> np.ndarray:
        """Batched prediction (``Threaded_Predict``, SMP_omega.h:938-1030):
        one forward over the stacked batch."""
        pred, _ = self._run(graphs)
        return pred.cpu().numpy()

    def Feature(self, graph: DenseGraph) -> np.ndarray:
        """Graph-level embedding (reference ``Feature``, SMP_2D.h:748)."""
        _, feat = self._run([graph])
        return feat[0].cpu().numpy()

    def getLoss(self, graphs, targets):
        raise NotImplementedError(_TRAINING)

    def Learn(self, graph, target, learning_rate, nIterations=1,
              epsilon=1e-8):
        raise NotImplementedError(_TRAINING)

    def BatchLearn(self, graphs, targets, learning_rate, nIterations=None,
                   epsilon=1e-8):
        raise NotImplementedError(_TRAINING)

    Threaded_BatchLearn = BatchLearn

    # -- parameters and checkpoints --------------------------------------

    def param_dict(self) -> Dict[str, nn.Parameter]:
        """{path: parameter} in registration order."""
        return {p: self.get_parameter(p) for p in self.param_order}

    @torch.no_grad()
    def load_params(self, flat: Dict[str, torch.Tensor]) -> None:
        """Copy {path: tensor} (e.g. from ``utils.convert.params_from_jax``)
        into the parameters; shapes must match."""
        for path, param in self.param_dict().items():
            src = flat[path]
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{path} has shape {tuple(src.shape)}, "
                                 f"the model has {tuple(param.shape)}")
            param.copy_(src)

    def save_model(self, filename: str) -> None:
        """Whitespace-separated text in registration order (reference
        ``save_model``, SMP_omega.h:1033-1043)."""
        ckpt.save_text(filename, self.param_dict(), self.param_order)

    def load_model(self, filename: str) -> None:
        self.load_params(ckpt.load_text(filename, self.param_dict(),
                                        self.param_order))
