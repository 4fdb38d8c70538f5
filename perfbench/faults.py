"""Faults planted underneath the timed path, each a hook
(``perfbench.faults:<name>``) that a run calls before its set-up in every
process: the check has to reject each one that the cell can have."""

from __future__ import annotations


def state_unchanged():
    """Every optimizer step returns the parameters and its state as they
    were."""
    from graphflow_tpu_torch.optim import optimizers

    make = optimizers._REGISTRY["adam"]

    def adam(**kw):
        opt = make(**kw)
        return opt._replace(update=lambda params, state, *a, **k:
                            (params, state))

    optimizers._REGISTRY["adam"] = adam


def half_batch():
    """A batch keeps its first half, twice: the mean over the rest, times
    the batch's size."""
    from graphflow_tpu_torch.core import batching

    stack = batching.stack_graphs

    def stack_half(graphs, targets=None, **kw):
        h = max(1, len(graphs) // 2)
        graphs = list(graphs[:h]) * 2 + list(graphs[2 * h:])
        if targets is not None:
            t = list(targets)
            targets = t[:h] * 2 + t[2 * h:]
        return stack(graphs, targets, **kw)

    batching.stack_graphs = stack_half


def step_reversed():
    """Every optimizer step moves the parameters the other way: its
    state as it should be, each parameter by minus its update."""
    import torch

    from graphflow_tpu_torch.optim import optimizers

    make = optimizers._REGISTRY["adam"]

    def adam(**kw):
        opt = make(**kw)

        @torch.no_grad()
        def update(params, state, *a, **k):
            before = {p: x.clone() for p, x in params.items()}
            params, state = opt.update(params, state, *a, **k)
            for p, x in params.items():          # the update is in place
                x.copy_(2 * before[p] - x)
            return params, state

        return opt._replace(update=update)

    optimizers._REGISTRY["adam"] = adam


def answer_altered():
    """Every request's first prediction comes back 1 % off."""
    from graphflow_tpu_torch.models.base import GraphModel

    predict = GraphModel.Threaded_Predict

    def altered(self, graphs):
        out = predict(self, graphs)
        out[0] *= 1.01
        return out

    GraphModel.Threaded_Predict = altered


def half_answered():
    """A request predicts its first half; the rest get that half's mean."""
    from graphflow_tpu_torch.models.base import GraphModel

    predict = GraphModel.Threaded_Predict

    def half(self, graphs):
        h = max(1, len(graphs) // 2)
        out = predict(self, list(graphs[:h]) * 2)[:len(graphs)].copy()
        out[h:] = out[:h].mean()
        return out

    GraphModel.Threaded_Predict = half


# The faults each kind of cell can have.
FAULTS = {"train": ("state_unchanged", "half_batch", "step_reversed"),
          "predict": ("answer_altered", "half_answered")}
