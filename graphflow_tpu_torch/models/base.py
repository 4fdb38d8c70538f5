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
:func:`fit_bucketed` is the bucketed training loop: each graph padded to
its size bucket rather than to max_nVertices.
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
from graphflow_tpu_torch.utils import profiling
from graphflow_tpu_torch.utils.convert import flatten, to_numpy, unflatten


def resolve_device(device=None) -> torch.device:
    """Where a model's parameters live: the device the caller names, else
    the CUDA device.  A model runs on the CPU only when asked to
    (``device="cpu"``); with no CUDA device and none named this raises
    rather than land there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: models run on the GPU unless the caller "
            "passes device=\"cpu\"")
    return torch.device("cuda")


class ParamModel(nn.Module):
    """Parameters under '/'-joined paths in the reference's registration
    order (``param_order``), an optimizer over them, the text checkpoint
    and parameter snapshots: what every model of the port shares, the
    graph models (:class:`GraphModel`), the pair models
    (``models/pairgraphs.py``) and the library models (``models/rnn.py``,
    ``models/mlp.py``).  ``optimizer`` names the optimizer
    (``optim.make_optimizer``), ``opt_kwargs`` its arguments."""

    param_order: List[str]

    def __init__(self, optimizer: str = "adam", **opt_kwargs):
        super().__init__()
        self.opt = optim_lib.make_optimizer(optimizer, **opt_kwargs)
        self.opt_state = None

    def _register(self, tree, order: Sequence[str]) -> None:
        """Register the tensors of ``tree`` (the JAX package's tree, or
        {path: tensor}) in the order of the paths ``order``, and reset the
        optimizer."""
        flat = flatten(tree)
        self.param_order = list(order)
        for path in self.param_order:
            self.register_parameter(path, nn.Parameter(flat[path]))
        self._finish_init()

    def _finish_init(self) -> None:
        """Install the optimizer's per-element schedule, where it has one,
        in registration order (Adam's nBatch overload, ``Adam.h:108-136``)
        and reset the optimizer state."""
        if self.opt.set_element_schedule is not None:
            self.opt.set_element_schedule(self.param_dict(), self.param_order)
        self.opt_state = self.opt.init(self.param_dict())

    @property
    def params(self):
        """The parameters as the JAX package's tree."""
        return unflatten(self.param_dict())

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def param_dict(self) -> Dict[str, nn.Parameter]:
        """{path: parameter} in registration order."""
        return {p: self.get_parameter(p) for p in self.param_order}

    def _step(self, loss_fn, learning_rate, nBatch=None) -> float:
        """One optimizer step on the gradients of ``loss_fn()`` -> the loss
        before it."""
        params = self.param_dict()
        with profiling.span("graphflow.forward"):
            loss = loss_fn()
        with profiling.span("graphflow.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
        with profiling.span("graphflow.optimizer"):
            _, self.opt_state = self.opt.update(
                params, self.opt_state, dict(zip(params, grads)),
                learning_rate, nBatch=nBatch)
        with profiling.span("graphflow.readback"):
            return float(loss.detach())

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


class GraphModel(ParamModel):
    """Base class for graph-level models.

    Subclasses register their parameters in the reference's order under
    '/'-joined paths (``"levels/0/K"``), list them in ``param_order``,
    implement ``_prepare(graph)``, ``_forward(params, batch) ->
    (prediction [B] or class scores [B, nClasses], graph_feature [B, C])``
    and ``_loss(params, batch) -> scalar``, and call ``_finish_init()``
    once the parameters exist.

    ``batch_fields`` names the prepared fields the forward and loss read
    (``batching.stack_graphs``'s ``fields``): ``_stack`` hands only those
    to the device, and builds ``smask`` there from ``sizes`` where it is
    named.  None, the default, stacks every field.  A subclass whose
    forward reads more overrides it.
    """

    batch_fields: Optional[Tuple[str, ...]] = None

    def __init__(self, optimizer: str = "adam", **opt_kwargs):
        super().__init__(optimizer, **opt_kwargs)
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
                                     dtype=self.dtype,
                                     fields=self.batch_fields)

    @torch.no_grad()
    def _run(self, graphs: Sequence[DenseGraph], read):
        """One request (span ``graphflow.predict``): the forward of the
        stacked graphs, and ``read`` of its (prediction, feature) on the
        host."""
        with profiling.span("graphflow.predict"):
            batch = self._stack(graphs)
            with profiling.span("graphflow.forward"):
                out = self._forward(self.params, batch)
            with profiling.span("graphflow.readback"):
                return read(out)

    # -- reference API ---------------------------------------------------

    def Predict(self, graph: DenseGraph) -> float:
        """Reference ``Predict`` (SMP_omega.h:924-935).  As in the JAX
        package, a classification model's [nClasses] scores do not convert
        to a float for nClasses > 1, and this raises."""
        return self._run([graph], lambda out: float(out[0][0]))

    def Threaded_Predict(self, graphs: Sequence[DenseGraph]) -> np.ndarray:
        """Batched prediction (``Threaded_Predict``, SMP_omega.h:938-1030):
        one forward over the stacked batch -> [B], or [B, nClasses] scores
        for a classification model.  A bfloat16 model returns its values
        as float32 (NumPy has no bfloat16; the JAX package returns
        an ``ml_dtypes`` bfloat16 array of the same values)."""
        return self._run(graphs, lambda out: to_numpy(out[0]))

    def Feature(self, graph: DenseGraph) -> np.ndarray:
        """Graph-level embedding (reference ``Feature``, SMP_2D.h:748), as
        float32 for a bfloat16 model (see ``Threaded_Predict``)."""
        return self._run([graph], lambda out: to_numpy(out[1][0]))

    def _loss_and_grads(self, batch):
        """(batch loss as a float, {path: gradient})."""
        params = self.param_dict()
        loss = self._loss(self.params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    @torch.no_grad()
    def _loss_value(self, batch) -> float:
        with profiling.span("graphflow.forward"):
            loss = self._loss(self.params, batch)
        with profiling.span("graphflow.readback"):
            return float(loss)

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
        """One batched optimizer step (reference ``BatchLearn``,
        ``SMP_omega.h:798-824``) with the nBatch overload: returns
        (loss_before, loss_after).

        With ``nIterations`` set, runs the reference's backtracking loop
        (``SMP_omega.h:843-871``): halve the learning rate and restore the
        parameters whenever the loss rises.

        The step is the root span ``graphflow.batch_learn``.
        """
        with profiling.span("graphflow.batch_learn"):
            batch = self._stack(graphs, targets)
            n = len(graphs)
            if nIterations is None:
                loss_before = self._step(
                    lambda: self._loss(self.params, batch), learning_rate,
                    nBatch=n)
                return loss_before, self._loss_value(batch)

            def loss_and_grads(_params):
                return self._loss_and_grads(batch)

            _, self.opt_state, loss0, loss1 = optim_lib.backtracking_learn(
                self.param_dict(), self.opt_state, loss_and_grads,
                self.opt.update, learning_rate, nIterations, epsilon=epsilon,
                nBatch=n)
            return loss0, loss1

    Threaded_BatchLearn = BatchLearn


def fit_bucketed(model: GraphModel, graphs, targets, learning_rate: float,
                 nEpochs: int, boundaries=(8, 16, 32, 64), seed: int = 0,
                 verbose: bool = False) -> float:
    """Bucketed training (``graphflow_tpu/models/base.py:192-227``): pad
    each graph to its size bucket (``batching.bucket_by_size``) instead of
    max_nVertices, then per epoch take one optimizer step per bucket, in
    an order shuffled by ``np.random.default_rng(seed)`` over the buckets
    in the order they were first met, as the JAX package does.

    The model's forward takes V from the batch; its receptive-field cap P
    stays fixed, so a bucket may hold fewer vertices than P.  A bucket's
    preparation bypasses the per-graph memo (its padding is not the
    model's).  Returns the last epoch's summed loss."""
    buckets = batching.bucket_by_size(graphs, targets, boundaries)
    prepared = {}
    for b, (gs, ts) in buckets.items():
        pgs = [model._prepare(g, pad_nVertices=b) for g in gs]
        prepared[b] = (batching.stack_graphs(pgs, ts, device=model.device,
                                             dtype=model.dtype), len(gs))

    rng = np.random.default_rng(seed)
    total = None
    order = list(prepared.items())
    for epoch in range(nEpochs):
        rng.shuffle(order)
        total = 0.0
        for _, (batch, n) in order:
            loss, grads = model._loss_and_grads(batch)
            _, model.opt_state = model.opt.update(
                model.param_dict(), model.opt_state, grads, learning_rate,
                nBatch=n)
            total += loss
        if verbose and epoch % max(1, nEpochs // 8) == 0:
            print(f"epoch {epoch}: loss {total:.4f}")
    return total
