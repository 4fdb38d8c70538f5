"""The SMP_omega / SMP_beta family: how the benchmark builds the program's
model, makes its weights from the seed, hands it graphs, reads its first
gradient, checks it against the plain reference (``reference_smp2d``), and
counts the work of a batch for the rooflines and MFU (the interface in
``harness.py``'s docstring)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import counts, reference_smp2d

# The program's kernels, by the names the profiler gives them: K1 the
# fused level's forward, K2 its backward (kernel 0 the cluster plans' sums,
# kernel 1, kernel 2 the partial rows' sum or the bfloat16 finish).
K1_KERNELS = ("risi18_level_kernel", "risi18_level_cluster_kernel")
K2_MAIN_KERNELS = ("risi18_level_bwd_kernel",
                   "risi18_level_bwd_cluster_kernel")
K2_KERNELS = K2_MAIN_KERNELS + ("backward_sums_kernel", "sum_partial_rows",
                                "finish_bf16_kernel")
# The libraries a cell's traffic loads: a forward, or a forward and its
# backward.
LIBRARIES = {"predict": ("risi18_level",),
             "train": ("risi18_level", "risi18_level_bwd")}
REFERENCE = reference_smp2d


def P_of(cfg):
    return (cfg["max_receptive_field"] if cfg["max_receptive_field"]
            is not None else cfg["max_nVertices"])


def feat_dim(cfg):
    return cfg["nFeatures"] * (cfg["nDepth"] + 1)


def param_shapes(cfg):
    """{path: shape} in registration order (``SMP_omega.h:289-295``)."""
    C = cfg["nChanels"]
    shapes = {"H": (C, feat_dim(cfg))}
    for l in range(cfg["nLevels"]):
        shapes[f"levels/{l}/K"] = (18 * C, C)
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
    out = {}
    for (path, shape), part in zip(shapes.items(), torch.split(u, sizes)):
        out[path] = (2.0 * part - 1.0).reshape(shape) * (0.9 / shape[0])
    return out


def build_model(cfg, weights: dict, device):
    """The program's model of ``cfg`` on ``device``, holding ``weights``,
    with a fresh optimizer state."""
    from graphflow_tpu_torch.models.smp2d import SMP2D, SMP2DConfig

    model = SMP2D(SMP2DConfig(
        max_nVertices=cfg["max_nVertices"],
        max_receptive_field=cfg["max_receptive_field"],
        nLevels=cfg["nLevels"], nChanels=cfg["nChanels"],
        nFeatures=cfg["nFeatures"], nDepth=cfg["nDepth"],
        has_WL_ordering=cfg["has_WL_ordering"], contraction=18,
        optimizer=cfg["optimizer"], dtype=cfg["dtype"]), seed=0,
        device=device)
    model.load_params(weights)
    model.opt_state = model.opt.init(model.param_dict())
    return model


def first_gradient(model, cfg) -> dict:
    """The first step's gradient as Adam took it, from its state after that
    step: the first moment over (1 - beta1), {path: float64 on the host}."""
    beta1 = cfg["adam"]["beta1"]
    return {p: (m / (1 - beta1)).double().cpu()
            for p, m in model.opt_state["m"].items()}


def tiny_config(cfg) -> dict:
    """``cfg`` cut to a size that CPU tests run: 10 vertices, 8 channels,
    WL depth 2, a cap of 5 where there is a cap."""
    out = dict(cfg, max_nVertices=10, nChanels=8, nDepth=2)
    if out["max_receptive_field"] is not None:
        out["max_receptive_field"] = 5
    return out


def program_graph(adj, feature):
    """The program's graph container for an (adjacency, features) pair."""
    from graphflow_tpu_torch.core.graph import DenseGraph

    g = DenseGraph(adj.shape[0], feature.shape[1])
    g.adj[:] = adj
    g.feature[:] = feature
    return g


def graph_elements(cfg, adj) -> list:
    """Present elements of the gathered slots of each level of one graph
    (``counts.present_elements``), from the reference's own fields."""
    sp = reference_smp2d.distances(adj)
    fields = reference_smp2d.receptive_fields(adj, sp, cfg["nLevels"],
                                              cfg["max_receptive_field"])
    return [counts.present_elements(fields[l - 1], fields[l])
            for l in range(1, cfg["nLevels"] + 1)]


def batch_work(cfg, B: int, elements) -> dict:
    """(bytes, operations) of each level of a batch of B graphs, whose
    present elements sum to ``elements`` [levels]: {"fwd": the fused
    level (K1), "bwd": its backward (K2)}.  Each level runs over all B * V
    padded vertex rows."""
    N, P, C, dt = (B * cfg["max_nVertices"], P_of(cfg), cfg["nChanels"],
                   cfg["dtype"])
    return {"fwd": [(counts.level_bytes(N, P, C, C, dt),
                     counts.level_ops(N, P, C, C, int(e))) for e in elements],
            "bwd": [(counts.level_backward_bytes(N, P, C, C, dt),
                     counts.level_backward_ops(N, P, C, C, int(e)))
                    for e in elements]}
KERNELS = {"k1": K1_KERNELS, "k2": K2_KERNELS, "k2_launch": K2_MAIN_KERNELS}
