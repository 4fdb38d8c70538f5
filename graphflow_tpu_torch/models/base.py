"""The reference's model API (counterpart of
``graphflow_tpu/models/base.py:GraphModel``).

Every reference model exposes ``getLoss / Learn / BatchLearn / Predict /
Threaded_Predict / Feature / save_model / load_model``
(``SMP_omega.h:695-1045``).  Here a model is an ``nn.Module`` whose
parameters are registered in the reference's order; a concrete model
supplies ``_prepare`` (host preparation of one graph), ``_forward`` (a
function of a parameter tree and a stacked batch) and ``_loss`` (the batch
loss, summed over graphs).  The per-graph rebuild of the reference becomes
a memoised host ``prepare`` plus one batched forward, and where JAX vmaps a
per-graph loss the port sums the batched one: the gradients are the same.

``Threaded_BatchLearn`` is an alias of ``BatchLearn``: the reference's
per-thread model replicas and summed gradients are one batched step here.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from graphflow_tpu_torch import optim as optim_lib
from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.utils import checkpoint as ckpt
from graphflow_tpu_torch.utils.convert import to_numpy


class GraphModel(nn.Module):
    """Base class for graph-level models.

    Subclasses register their parameters in the reference's order under
    '/'-joined paths (``"levels/0/K"``), list them in ``param_order``,
    implement ``_prepare(graph)``, ``_forward(params, batch) ->
    (prediction [B], graph_feature [B, C])`` and ``_loss(params, batch)
    -> scalar``, and call ``_finish_init()`` once the parameters exist.
    """

    param_order: List[str]

    def __init__(self):
        super().__init__()
        self.opt = optim_lib.make_optimizer("adam")
        self.opt_state = None
        # Weak-keyed by graph identity: a collected DenseGraph can never
        # alias a new one, and the cache cannot grow without bound.
        self._prep_cache: "weakref.WeakKeyDictionary[DenseGraph, prep.PreparedGraph]" = (
            weakref.WeakKeyDictionary())

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        raise NotImplementedError

    def _forward(self, params, batch):
        raise NotImplementedError

    def _loss(self, params, batch) -> torch.Tensor:
        raise NotImplementedError

    def _finish_init(self) -> None:
        """Install Adam's per-element schedule in registration order (the
        reference's nBatch overload, ``Adam.h:108-136``) and reset the
        optimizer state."""
        self.opt.set_element_schedule(self.param_dict(), self.param_order)
        self.opt_state = self.opt.init(self.param_dict())

    @property
    def params(self):
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        """Host preparation, memoised per DenseGraph instance."""
        pg = self._prep_cache.get(graph)
        if pg is None:
            pg = self._prepare(graph)
            self._prep_cache[graph] = pg
        return pg

    def _stack(self, graphs: Sequence[DenseGraph], targets=None):
        return batching.stack_graphs([self.prepare(g) for g in graphs],
                                     targets, device=self.device,
                                     dtype=self.dtype)

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
        one forward over the stacked batch.  A bfloat16 model returns its
        values as float32 (NumPy has no bfloat16; the JAX package returns
        an ``ml_dtypes`` bfloat16 array of the same values)."""
        pred, _ = self._run(graphs)
        return to_numpy(pred)

    def Feature(self, graph: DenseGraph) -> np.ndarray:
        """Graph-level embedding (reference ``Feature``, SMP_2D.h:748), as
        float32 for a bfloat16 model (see ``Threaded_Predict``)."""
        _, feat = self._run([graph])
        return to_numpy(feat[0])

    def _loss_and_grads(self, batch):
        """(batch loss as a float, {path: gradient})."""
        params = self.param_dict()
        loss = self._loss(self.params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    @torch.no_grad()
    def _loss_value(self, batch) -> float:
        return float(self._loss(self.params, batch))

    def getLoss(self, graphs: Sequence[DenseGraph], targets) -> float:
        """Total batch loss (reference ``getLoss``, SMP_omega.h:695-704)."""
        return self._loss_value(self._stack(graphs, targets))

    def Learn(self, graph: DenseGraph, target: float, learning_rate: float,
              nIterations: int = 1, epsilon: float = 1e-8):
        """Single-example training (reference per-model ``Learn``): the
        backtracking branch of :meth:`BatchLearn`."""
        return self.BatchLearn([graph], [target], learning_rate,
                               nIterations=nIterations, epsilon=epsilon)

    def BatchLearn(self, graphs: Sequence[DenseGraph], targets,
                   learning_rate: float, nIterations: Optional[int] = None,
                   epsilon: float = 1e-8) -> Tuple[float, float]:
        """One batched Adam step (reference ``BatchLearn``,
        ``SMP_omega.h:798-824``) with the nBatch overload: returns
        (loss_before, loss_after).

        With ``nIterations`` set, runs the reference's backtracking loop
        (``SMP_omega.h:843-871``): halve the learning rate and restore the
        parameters whenever the loss rises.
        """
        batch = self._stack(graphs, targets)
        n = len(graphs)
        params = self.param_dict()
        if nIterations is None:
            loss_before, grads = self._loss_and_grads(batch)
            _, self.opt_state = self.opt.update(
                params, self.opt_state, grads, learning_rate, nBatch=n)
            return loss_before, self._loss_value(batch)

        def loss_and_grads(_params):
            return self._loss_and_grads(batch)

        _, self.opt_state, loss0, loss1 = optim_lib.backtracking_learn(
            params, self.opt_state, loss_and_grads, self.opt.update,
            learning_rate, nIterations, epsilon=epsilon, nBatch=n)
        return loss0, loss1

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
        """Load a text checkpoint and reset the optimizer state."""
        self.load_params(ckpt.load_text(filename, self.param_dict(),
                                        self.param_order))
        self.opt_state = self.opt.init(self.param_dict())

    @torch.no_grad()
    def cache_parameters(self) -> None:
        self._cached = ({k: p.detach().clone()
                         for k, p in self.param_dict().items()},
                        self.opt_state)

    @torch.no_grad()
    def restore_parameters(self) -> None:
        values, self.opt_state = self._cached
        for k, p in self.param_dict().items():
            p.copy_(values[k])
