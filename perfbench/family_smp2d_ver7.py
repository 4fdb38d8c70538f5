"""The SMP_2D_ver7 family (the 50-case second-order CCN,
``SMP_2D_ver7.h:134-141``): how the benchmark builds the program's model,
makes its weights from the seed, hands it graphs, reads its first
gradient, checks it against the plain reference
(``reference_smp2d_ver7``), and counts the work of a batch
(``counts_ver7``), by the interface in ``harness.py``'s docstring.

The program's route (``graphflow_tpu_torch/models/smp2d.py``): the factory
``SMP_2D_ver7``, an ``SMP2D`` with ``contraction=50`` and Momentum; a
prediction's level is K7's aligned tensor T and the factored 50-case bank
with K (``contraction_level``); training takes the take-gather, which
autograd differentiates, in K7's place.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import counts_ver7, reference_smp2d_ver7
from perfbench.family_smp2d import P_of, feat_dim
# The graph container and the CPU tests' cut are SMP_omega's.
from perfbench.family_smp2d import program_graph, tiny_config  # noqa: F401

# The program's kernels, by the names the profiler gives them: K7 writes
# the aligned tensor T.  The bank's launches are torch's own.
KERNELS = {"k7": ("risi_aligned_t2_kernel",)}
# The libraries a driver of each kind loads: K7's (a training step takes
# the take-gather, so only a prediction launches it).
LIBRARIES = {"predict": ("risi_aligned_t2",), "train": ("risi_aligned_t2",)}
REFERENCE = reference_smp2d_ver7


def param_shapes(cfg):
    """{path: shape} in registration order (``SMP_2D_ver7.h:134-141``: K
    maps the 50 cases' 50C channels to C)."""
    C = cfg["nChanels"]
    shapes = {"H": (C, feat_dim(cfg))}
    for l in range(cfg["nLevels"]):
        shapes[f"levels/{l}/K"] = (counts_ver7.CASES * C, C)
        shapes[f"levels/{l}/b"] = (C,)
    shapes["W"] = (C,)
    return shapes


def make_weights(cfg, seed: int, device) -> dict:
    """The weights of ``seed``: one uniform draw on ``device`` from a
    generator there, cut into the leaves, each U(-0.9, 0.9) / its rows
    (``GraphFlow.h:1280-1307``), in the configuration's dtype."""
    shapes = param_shapes(cfg)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 5]).generate_state(
        1, np.uint64)[0]))
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=getattr(torch, cfg["dtype"]))
    return {path: (2.0 * part - 1.0).reshape(shape) * (0.9 / shape[0])
            for (path, shape), part in zip(shapes.items(),
                                           torch.split(u, sizes))}


def build_model(cfg, weights: dict, device):
    """The program's ``SMP_2D_ver7`` of ``cfg`` on ``device``, holding
    ``weights``, with a fresh Momentum state.  The factory fixes float32,
    the WL ordering and Momentum's gamma of 0.9 (``Momentum.h:46-68``); a
    configuration that states otherwise is refused."""
    from graphflow_tpu_torch.models.smp2d import SMP_2D_ver7

    fixed = {"dtype": "float32", "has_WL_ordering": True,
             "optimizer": "momentum", "momentum": {"gamma": 0.9}}
    wrong = {k: cfg[k] for k, v in fixed.items() if cfg[k] != v}
    if wrong:
        raise ValueError(f"SMP_2D_ver7 runs {fixed}; the configuration "
                         f"states {wrong}")
    model = SMP_2D_ver7(cfg["max_nVertices"], cfg["max_receptive_field"],
                        cfg["nLevels"], cfg["nChanels"], cfg["nFeatures"],
                        cfg["nDepth"], seed=0, device=device)
    model.load_params(weights)
    model.opt_state = model.opt.init(model.param_dict())
    return model


def first_gradient(model, cfg, learning_rate=None) -> dict:
    """The first step's gradient as Momentum took it, from its state after
    that step: the velocity (lr g from a zero state) over the learning
    rate, {path: float64 on the host}.  The interface hands over no
    learning rate, so a caller passes it."""
    if learning_rate is None:
        raise ValueError("Momentum's velocity is lr * g: the first "
                         "gradient needs the learning rate")
    return {p: (v / learning_rate).double().cpu()
            for p, v in model.opt_state.items()}


def graph_elements(cfg, adj) -> list:
    """Nothing of a graph counts: the level's work is a function of the
    shapes alone (the factoring runs every padded row and slot), so one 0
    a level."""
    return [0] * cfg["nLevels"]


def batch_work(cfg, B: int, elements) -> dict:
    """(bytes, operations) of each level of a batch of B graphs
    (``counts_ver7``): {"fwd": the level, "bwd": its backward}.  Each level
    runs over all B * V padded vertex rows."""
    N, P, C, dt = (B * cfg["max_nVertices"], P_of(cfg), cfg["nChanels"],
                   cfg["dtype"])
    fwd = (counts_ver7.level_bytes(N, P, C, C, dt),
           counts_ver7.level_ops(N, P, C, C))
    bwd = (counts_ver7.level_backward_bytes(N, P, C, C, dt),
           counts_ver7.level_backward_ops(N, P, C, C))
    return {"fwd": [fwd for _ in elements], "bwd": [bwd for _ in elements]}
