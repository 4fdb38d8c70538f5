"""Sequence models, LSTM and GRU, for per-step classification (counterpart
of ``graphflow_tpu/models/rnn.py``).

Reference ``LSTM.h`` / ``GRU.h``: cells unrolled over the steps, a head at
EVERY step over the cumulative mean of the hidden states
(``LSTM.h:337-345``: pool_l = mean(h_0..h_l), logits_l = theta @ pool_l,
a log loss per step), per-tensor L1 gradient clipping at 1.0
(``LSTM.h:72-78``), Momentum, and a keep-best Learn loop with a halving
rate (``LSTM.h:97-144``).  Where the JAX package scans the steps
(``lax.scan``), the port loops over them in Python; torch ops, no kernel.

Kept from the reference, as the JAX package keeps them:
  * the GRU's candidate is a SIGMOID, not a tanh (see :func:`_gru_cell`);
  * the loss is a double softmax: the log loss of the reference softmax
    of the logits, whose backward is the diagonal-only one
    (``ops/activations.py:softmax``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from graphflow_tpu_torch.models.base import ParamModel, resolve_device
from graphflow_tpu_torch.ops.activations import softmax
from graphflow_tpu_torch.optim.utils import uniform_init

GRADIENT_CLIPPING_THRESHOLD = 1.0  # LSTM.h:27


def clip_gradients_l1(grads, threshold=GRADIENT_CLIPPING_THRESHOLD):
    """Per-tensor L1 clipping (the reference's ``gradient_clipping``): a
    gradient whose L1 norm n exceeds ``threshold`` becomes threshold / n
    times itself; {path: tensor} -> {path: tensor}."""
    out = {}
    for k, g in grads.items():
        n = g.abs().sum()
        out[k] = torch.where(n > threshold, threshold / n * g, g)
    return out


def _lstm_cell(p, h, c, x):
    i = torch.sigmoid(p["Wi"] @ x + p["bi"] + p["Ui"] @ h)
    ct = torch.tanh(p["Wc"] @ x + p["bc"] + p["Uc"] @ h)
    f = torch.sigmoid(p["Wf"] @ x + p["bf"] + p["Uf"] @ h)
    c = i * ct + f * c
    o = torch.sigmoid(p["Wo"] @ x + p["bo"] + p["Vo"] @ c + p["Uo"] @ h)
    return o * torch.tanh(c), c


def _gru_cell(p, h, x):
    z = torch.sigmoid(p["W_z"] @ x + p["b_z"] + p["U_z"] @ h)
    r = torch.sigmoid(p["W_r"] @ x + p["b_r"] + p["U_r"] @ h)
    # The reference constructs the candidate as a Tanh (GRU.h:289) but
    # registers it under the Sigmoid opcode, and its dispatcher runs
    # Sigmoid::forward on it: the shipped candidate is a sigmoid
    # (graphflow_tpu/models/rnn.py:55-61).
    ht = torch.sigmoid(p["W_h"] @ x + p["b_h"] + p["U_h"] @ (r * h))
    return z * ht + (1.0 - z) * h         # GRU.h:292-300's convention


class _SequenceModel(ParamModel):
    """What LSTM and GRU share: the reference API ``getLoss``, ``Learn``,
    ``Predict``, ``save_model``, ``load_model``.  The text checkpoint lists
    the parameters with their names sorted, the order of the JAX
    package's flattened dict."""

    def __init__(self, nFeatures, nHiddens, nClasses, max_nLevels,
                 momentum_param=0.9, seed=0, device=None):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.nFeatures, self.nHiddens = nFeatures, nHiddens
        self.nClasses, self.max_nLevels = nClasses, max_nLevels
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        shapes = self._shapes(nFeatures, nHiddens, nClasses)
        self._register({n: uniform_init(s, generator, torch.float32, device)
                        for n, s in shapes.items()}, sorted(shapes))

    def _shapes(self, F, H, C):
        """{name: shape} from (nFeatures F, nHiddens H, nClasses C), in the
        reference's registration order."""
        raise NotImplementedError

    def _run(self, params, xs) -> torch.Tensor:
        """The hidden states [T, H] of a sequence xs [T, F]."""
        raise NotImplementedError

    def _logits(self, params, xs):
        """theta @ the cumulative mean of h_0..h_l, per step -> [T, C]."""
        hs = self._run(params, xs)
        steps = torch.arange(1, xs.shape[0] + 1, dtype=hs.dtype,
                             device=hs.device)
        return (torch.cumsum(hs, dim=0) / steps[:, None]) @ params["theta"].T

    def _seq_losses(self, params, xs, ts) -> torch.Tensor:
        """The negative log-likelihood of each step [T]: the log softmax of
        the reference softmax of the logits (LSTM.h: LogLoss on the Softmax
        node; LogLoss.h softmaxes its input again)."""
        logp = torch.log_softmax(softmax(self._logits(params, xs)), dim=-1)
        return -logp.gather(1, ts[:, None]).squeeze(1)

    def _inputs(self, x_sequence, target_sequence=None):
        xs = torch.as_tensor(np.asarray(x_sequence, np.float32)).to(
            device=self.device, dtype=self.dtype)
        if target_sequence is None:
            return xs
        return xs, torch.as_tensor(np.asarray(target_sequence, np.int64),
                                   device=self.device)

    def _loss(self, xs, ts) -> torch.Tensor:
        return self._seq_losses(self.params, xs, ts).sum()

    # -- reference API ---------------------------------------------------

    @torch.no_grad()
    def getLoss(self, x_sequence, target_sequence) -> float:
        """The sequence's total negative log-likelihood (the reference's
        ``getLoss`` returns +log p summed; the sign is folded here)."""
        return float(self._loss(*self._inputs(x_sequence, target_sequence)))

    def Learn(self, x_sequence, target_sequence, nIterations,
              learning_rate) -> Tuple[float, float]:
        """The keep-best loop (``LSTM.h:97-144``): each iteration takes a
        clipped Momentum step; when the loss does not fall, the parameters
        and the optimizer state go back to the best so far and the rate
        halves, down to 1e-20.  -> (the first loss, the best)."""
        xs, ts = self._inputs(x_sequence, target_sequence)
        params = self.param_dict()
        with torch.no_grad():
            best_nll = first = float(self._loss(xs, ts))
        lr, min_lr, decay = learning_rate, 1e-20, 0.5
        self.cache_parameters()
        for _ in range(nIterations):
            grads = torch.autograd.grad(self._loss(xs, ts),
                                        list(params.values()))
            grads = clip_gradients_l1(dict(zip(params, grads)))
            _, self.opt_state = self.opt.update(params, self.opt_state,
                                                grads, lr)
            with torch.no_grad():
                new_nll = float(self._loss(xs, ts))
            if new_nll >= best_nll:        # worse or equal: restore, decay
                self.restore_parameters()
                if lr <= min_lr:
                    break
                lr *= decay
            else:
                best_nll = new_nll
                self.cache_parameters()
        return first, best_nll

    @torch.no_grad()
    def Predict(self, x_sequence) -> np.ndarray:
        """The class of each step [T] (the argmax of its logits)."""
        xs = self._inputs(x_sequence)
        return self._logits(self.params, xs).argmax(dim=-1).cpu().numpy()


class LSTM(_SequenceModel):
    """``LSTM.h:30-41``."""

    def _shapes(self, F, H, C):
        return {"Wi": (H, F), "Ui": (H, H), "bi": (H,), "Wc": (H, F),
                "Uc": (H, H), "bc": (H,), "Wf": (H, F), "Uf": (H, H),
                "bf": (H,), "Wo": (H, F), "Uo": (H, H), "Vo": (H, H),
                "bo": (H,), "theta": (C, H)}

    def _run(self, params, xs):
        h = c = xs.new_zeros((self.nHiddens,))
        hs = []
        for x in xs:
            h, c = _lstm_cell(params, h, c, x)
            hs.append(h)
        return torch.stack(hs)


class GRU(_SequenceModel):
    """``GRU.h``: the same API with the GRU cell."""

    def _shapes(self, F, H, C):
        return {"W_z": (H, F), "U_z": (H, H), "b_z": (H,), "W_r": (H, F),
                "U_r": (H, H), "b_r": (H,), "W_h": (H, F), "U_h": (H, H),
                "b_h": (H,), "theta": (C, H)}

    def _run(self, params, xs):
        h = xs.new_zeros((self.nHiddens,))
        hs = []
        for x in xs:
            h = _gru_cell(params, h, x)
            hs.append(h)
        return torch.stack(hs)
