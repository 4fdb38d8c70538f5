"""What the measuring scripts share (``chip_smoke.py`` and the tools beside
this file) and the CUDA tests: the spin-timed CUDA-event timer, the
full-width model they drive (and the same model through the bank route),
the level output that a backward check gives both sides, and the
edge-list graphs of the ELL route."""

from __future__ import annotations

import statistics

import numpy as np
import torch

# V=64, P=16, C=32: the width of the reference configuration; two levels
# (only the depth is cut).
FULL_WIDTH = dict(max_nVertices=64, max_receptive_field=16, nLevels=2,
                  nChanels=32, nFeatures=4, nDepth=5)
# Graphs a request or step, and the edge probability of each Erdos-Renyi
# graph.
GRAPHS, ER_P = 4, 0.15
# Momentum has no per-element normalisation: at this width the gradients
# reach 1e3-1e5, and Adam's 1e-4 sends the loss to inf in three steps
# (probed on the CPU at V=32, P=8-12, C=16).
ADAM_LR, MOMENTUM_LR = 1e-4, 1e-10

# Edges drawn from each vertex of an edge-list graph (about twice as many
# neighbours a vertex).
ELL_LINKS = 4

# About half a millisecond of spinning on an H100.
SPIN_CYCLES = 1_000_000


def time_in_turns(fns, reps, warmup=3):
    """{name: [milliseconds of one call of fns[name], one per round]}, CUDA
    events on the current stream.  The functions are timed in turns, one
    call each per round, so that a drift of the card's clocks falls on all
    alike.  A spin kernel runs ahead of each first event: the host queues
    the launch while the card is busy, and the events bracket the device's
    work, not the wrapper's host time."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn(), timed as :func:`time_in_turns` does."""
    return statistics.median(time_in_turns({"fn": fn}, reps, warmup)["fn"])


def same_signs(out, plain_out):
    """The kernel's level output, with the plain version's value wherever
    the two differ in sign.  LeakyReLU' reads the sign of ``out``, so an
    output within rounding of zero (|plain| ~ 1e-7: 3 of 4.9 M at N=600)
    whose sign depends on the order of the sums would set the backward's
    cotangent 100 times apart on the two sides; both get one ``out``."""
    return torch.where((out > 0) == (plain_out > 0), out, plain_out)


def bank_route_model(seed=0, device="cuda", **config):
    """An SMP2D model of ``SMP2DConfig(**config)`` whose levels serve and
    train through ``level_fn=risi18_bank_level`` (the take-gather into a
    materialised T, then the bank: K4 forward, K5 backward on the card)
    instead of its default fused level; the same parameters as
    ``SMP2D(SMP2DConfig(**config), seed, device)``."""
    from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
    from graphflow_tpu_torch.models.smp2d import (risi18_bank_level,
                                                  smp2d_forward)
    from graphflow_tpu_torch.ops.losses import squared_loss

    class BankRoute(SMP2D):
        def _forward(self, params, batch):
            return smp2d_forward(params, batch, self.cfg,
                                 level_fn=risi18_bank_level)

        def _loss(self, params, batch):
            out, _ = smp2d_forward(params, batch, self.cfg,
                                   level_fn=risi18_bank_level, training=True)
            return squared_loss(out, batch["target"])

    return BankRoute(SMP2DConfig(**config), seed=seed, device=device)


class EdgeGraph:
    """A graph kept as an edge list: unpacks as the (nVertices, edges,
    features) tuple that ``core/prep.py:prepare_graph_sparse`` takes, and
    can key a model's preparation memo, so that GCN_MW and
    NeuralFingerprint on the ELL route serve and train it through the
    model API without a [V, V] array ever being made."""

    def __init__(self, n, edges, features):
        self.nVertices, self.edges, self.feature = n, edges, features

    def __iter__(self):
        return iter((self.nVertices, self.edges, self.feature))


def edge_graph(n: int, seed: int, nFeatures: int = 4) -> EdgeGraph:
    """n vertices, each linked to ELL_LINKS others drawn at random (no self
    loop, duplicates merged), one-hot features."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), ELL_LINKS)
    dst = rng.integers(0, n - 1, size=n * ELL_LINKS)
    dst = dst + (dst >= src)
    pairs = np.unique(np.sort(np.stack([src, dst], 1), axis=1), axis=0)
    feats = np.eye(nFeatures)[rng.integers(0, nFeatures, size=n)]
    return EdgeGraph(n, [tuple(map(int, e)) for e in pairs], feats)
