"""Adam and Momentum with the reference's semantics (counterpart of
``graphflow_tpu/optim/optimizers.py:adam`` and ``:momentum``).

An optimizer is a triple (init, update, set_element_schedule) over a dict
{path: tensor} of parameters in registration order.  ``update`` changes
the parameters in place under ``torch.no_grad()`` and returns a new state
(Adam: ``{"m": {path: tensor}, "v": {path: tensor}, "t": int}``; Momentum:
``{path: velocity}``); the old state's tensors are never written, so a
caller may keep it to restore.

The reference's ``Learn(lr, nBatch)`` overloads divide the gradients by
nBatch before the update; ``update(..., nBatch=k)`` does the same, and
Adam then applies the reference's per-element bias correction (see
:func:`adam`).  ``torch.optim.Adam`` has no such schedule.  The other
optimizers of the JAX package are ROADMAP queue 1, item 9.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Any]  # (params, state, grads, lr, nBatch=None)
    # Install the per-element beta_t schedule of the nBatch overload from
    # (params, param_order); GraphModel._finish_init calls it.  None for an
    # optimizer without one.
    set_element_schedule: Optional[Callable[..., None]]


def _scale(grads: Params, nBatch: Optional[int]) -> Params:
    if nBatch is None:
        return grads
    return {k: g / nBatch for k, g in grads.items()}


def adam(beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8) -> Optimizer:
    """``Adam.h``: both reference Learn overloads, selected by ``nBatch``.

    * ``nBatch=None`` (``Adam.h:77-106``): per-step bias correction
      1 - beta^t, with beta^t computed in float32.
    * ``nBatch=k`` (``Adam.h:108-136``, used by every reference
      BatchLearn): the gradients are divided by k.  The reference advances
      beta^t once per scalar element inside its update loop, so element e
      (0-based, in registration order) of a model with N registered
      scalars is corrected at step t by 1 - beta^(e + 1 + (t-1) N).  Once
      ``set_element_schedule`` is installed this is reproduced: the
      exponent and the pow are float32, as in the JAX package, and the
      correction is then cast to the parameter's dtype.  Without the
      schedule, or for a parameter outside it, no correction is applied
      (the schedule's limit).
    """
    holder: Dict[str, Any] = {"offsets": None, "total": None}

    def set_element_schedule(params: Params, order: Sequence[str]) -> None:
        offs, total = {}, 0
        for path in order:
            leaf = params[path]
            n = leaf.numel()
            offs[path] = torch.arange(total, total + n, dtype=torch.float32,
                                      device=leaf.device).reshape(leaf.shape)
            total += n
        holder["offsets"], holder["total"] = offs, total

    def init(params: Params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()},
                "t": 0}

    @torch.no_grad()
    def update(params: Params, state, grads: Params, lr, nBatch=None):
        grads = _scale(grads, nBatch)
        t = state["t"] + 1
        m = {k: beta1 * state["m"][k] + (1 - beta1) * g
             for k, g in grads.items()}
        v = {k: beta2 * state["v"][k] + (1 - beta2) * g * g
             for k, g in grads.items()}
        tt = torch.tensor(float(t), dtype=torch.float32)
        offsets = holder["offsets"] or {}
        for k, p in params.items():
            if nBatch is None:
                c1, c2 = 1 - beta1 ** tt, 1 - beta2 ** tt
            elif k in offsets:
                steps = (tt.to(p.device) - 1.0) * holder["total"]
                expo = offsets[k] + 1.0 + steps
                c1 = (1.0 - beta1 ** expo).to(p.dtype)
                c2 = (1.0 - beta2 ** expo).to(p.dtype)
            else:                        # outside the schedule: no correction
                p.sub_(lr * m[k] / (torch.sqrt(v[k]) + epsilon))
                continue
            p.sub_(lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + epsilon))
        return params, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, set_element_schedule)


def momentum(gamma: float = 0.9) -> Optimizer:
    """``Momentum.h:46-68``: v = gamma * v + lr * g, then p -= v, with g
    divided by nBatch first when it is given."""

    def init(params: Params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(params: Params, state, grads: Params, lr, nBatch=None):
        grads = _scale(grads, nBatch)
        v = {k: gamma * state[k] + lr * g for k, g in grads.items()}
        for k, p in params.items():
            p.sub_(v[k])
        return params, v

    return Optimizer(init, update, None)


_REGISTRY = {"adam": adam, "momentum": momentum}


def make_optimizer(name: str, **kwargs) -> Optimizer:
    """Build an optimizer by reference class name (case-insensitive)."""
    make = _REGISTRY.get(name.lower())
    if make is None:
        raise NotImplementedError(
            f"optimizer {name!r} is ROADMAP queue 1, item 9; the port has "
            f"{sorted(_REGISTRY)}")
    return make(**kwargs)
