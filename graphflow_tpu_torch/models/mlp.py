"""The MLP and CNN example models (counterpart of
``graphflow_tpu/models/mlp.py``): the reference's hand-built programs over
its op library.

  tests/test_mlp.cpp:75-107        a 784-128-10 sigmoid MLP, the squared
                                   loss on one-hot targets, Momentum
  tests/test_CNN_MNIST_MaxPool.cpp:109-146
                                   Conv2D(5x5, 8) -> LeakyReLU -> MaxPool2
                                   -> Conv2D(5x5, 16) -> LeakyReLU ->
                                   MaxPool2 -> dense + bias -> log loss,
                                   an L2 regularizer, SGD

``BatchLearn`` passes no nBatch to the optimizer, and the loss is summed
over the batch, as in the JAX package.  The text checkpoint lists the
parameters with their names sorted (the JAX package's flattened dict).
Torch ops (``ops/conv.py``), no kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from graphflow_tpu_torch.models.base import ParamModel, resolve_device
from graphflow_tpu_torch.ops import conv
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.losses import l2_regularization, log_loss
from graphflow_tpu_torch.optim.utils import uniform_init


class _ImageModel(ParamModel):
    """``BatchLearn``, ``Predict`` and ``accuracy`` over a batch of inputs
    and integer labels; a subclass gives ``_scores(params, xs)`` and
    ``_batch_loss(params, xs, ys)``."""

    def _inputs(self, xs) -> torch.Tensor:
        raise NotImplementedError

    def BatchLearn(self, xs, ys, learning_rate) -> float:
        """One optimizer step on the batch's summed loss -> that loss."""
        xs = self._inputs(xs)
        ys = torch.as_tensor(np.asarray(ys, np.int64), device=self.device)
        return self._step(lambda: self._batch_loss(self.params, xs, ys),
                          learning_rate)

    @torch.no_grad()
    def Predict(self, xs) -> np.ndarray:
        return self._scores(self.params, self._inputs(xs)).argmax(
            dim=-1).cpu().numpy()

    def accuracy(self, xs, ys) -> float:
        return float((self.Predict(xs) == np.asarray(ys)).mean())


class MLP(_ImageModel):
    """The sigmoid MLP with the squared loss on one-hot targets (reference
    test_mlp.cpp); W{i} [dims[i], dims[i-1]]."""

    def __init__(self, layer_dims: Sequence[int], optimizer="momentum",
                 seed=0, device=None, **opt_kwargs):
        super().__init__(optimizer, **opt_kwargs)
        self.dims = list(layer_dims)
        self.nOutputs = self.dims[-1]
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        tree = {f"W{i + 1}": uniform_init((self.dims[i + 1], self.dims[i]),
                                          generator, torch.float32, device)
                for i in range(len(self.dims) - 1)}
        self._register(tree, sorted(tree))

    def _inputs(self, xs):
        xs = torch.as_tensor(np.asarray(xs, np.float32))
        return xs.reshape(len(xs), -1).to(device=self.device,
                                          dtype=self.dtype)

    def _scores(self, params, xs):
        h = xs
        for i in range(len(self.dims) - 1):
            h = torch.sigmoid(h @ params[f"W{i + 1}"].T)
        return h

    def _batch_loss(self, params, xs, ys):
        onehot = torch.nn.functional.one_hot(ys, self.nOutputs).to(xs.dtype)
        return 0.5 * torch.sum((self._scores(params, xs) - onehot) ** 2)


class CNN(_ImageModel):
    """The reference MNIST CNN (test_CNN_MNIST_MaxPool.cpp:109-146):
    filter1 [k, k, Cin, c1] and filter2 [k, k, c1, c2] drawn at the scale
    1 / kernel, bias1 [Cin, c1] and bias2 [c1, c2] summed over their first
    axis (``ops/conv.py``), W [nOutputs, (H/4)(W/4) c2], bias [nOutputs]
    zeros.  ``lam > 0`` adds lam / 2 times the squares of filter1, filter2
    and W to the loss.  ``pool`` is "max" or "avg"."""

    def __init__(self, height=28, width=28, in_channels=1, nOutputs=10,
                 c1=8, c2=16, kernel=5, lam=0.0, pool="max",
                 optimizer="sgd", seed=0, device=None):
        super().__init__(optimizer)
        self.pool, self.lam, self.nOutputs = pool, lam, nOutputs
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)

        def draw(shape, fan=None):
            return uniform_init(shape, generator, torch.float32, device,
                                fan=fan)

        flat = (height // 4) * (width // 4) * c2       # two stride-2 pools
        tree = {"filter1": draw((kernel, kernel, in_channels, c1), kernel),
                "bias1": draw((in_channels, c1)),
                "filter2": draw((kernel, kernel, c1, c2), kernel),
                "bias2": draw((c1, c2)),
                "W": draw((nOutputs, flat)),
                "bias": torch.zeros(nOutputs).to(device=device)}
        self._register(tree, sorted(tree))

    def _inputs(self, xs):
        xs = torch.as_tensor(np.asarray(xs, np.float32))
        if xs.dim() == 3:
            xs = xs[..., None]
        return xs.to(device=self.device, dtype=self.dtype)

    def _scores(self, params, xs):
        """xs [N, H, W, Cin] -> class scores [N, nOutputs]."""
        pool = conv.max_pool2d if self.pool == "max" else conv.avg_pool2d
        h = conv.conv2d(xs, params["filter1"], params["bias1"], 1, 2)
        h = pool(leaky_relu(h), 2, 2)
        h = conv.conv2d(h, params["filter2"], params["bias2"], 1, 2)
        h = pool(leaky_relu(h), 2, 2)
        return h.reshape(h.shape[0], -1) @ params["W"].T + params["bias"]

    def _batch_loss(self, params, xs, ys):
        loss = log_loss(self._scores(params, xs), ys)
        if self.lam > 0:
            loss = loss + l2_regularization(
                [params[k] for k in ("filter1", "filter2", "W")], self.lam)
        return loss
