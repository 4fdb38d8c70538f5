"""Two-tower models over pairs of graphs (counterpart of
``graphflow_tpu/models/pairgraphs.py``): graph similarity and graph-kernel
regression.

  SMP_{omega,beta,gamma,sigma}_pairgraphs (``SMP_omega_pairgraphs.h``): two
      second-order towers with their own H, K, b (``:680-692``), each
      collecting its graph feature at every level (``:640-654``), merged
      level by level, tower 1's then tower 2's (``:705-709``), and a head
      h = LeakyReLU(W1 m), h = LeakyReLU(W2 h), <h, W3> with widths
      max(nTotal / 2, 10) and max(h1 / 2, 10) (``:332-333``).  The towers
      read raw features in insertion order (no WL histograms or ranking,
      ``:155``), and halve their channels every level, C_l = max(C_{l-1} /
      2, 1) (``:202-204``), so the levels run K1 and K2 at C != Cout.
      sigma adds the per-case dropout of the contraction
      (``SMP_sigma_pairgraphs.h:248-257``); gamma has the 4-case bank.
  SMP_theta_pairgraphs, CCN_1D: first-order towers (``models/smp1d.py``),
      the same head; CCN_1D with its own channel and head rule.
  GCN_{1,2,3}D_Kernel (``GCN_1D_Kernel.h:240-289``): ONE GCN tower shared
      by both graphs, the top level only, and <concat(top_1, top_2), W>.

Where the JAX package vmaps one pair, the port runs a batch of pairs: each
tower takes its graphs stacked, so a second-order tower's level is one
launch of K1 (K2 backward) on CUDA for the whole batch.  Every model is
float32, as the JAX constructors make it (there is no dtype argument).
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import ParamModel, resolve_device
from graphflow_tpu_torch.models.gcn import (GCNConfig, gcn_forward,
                                            init_gcn_params)
from graphflow_tpu_torch.models.physics import halving_schedule
from graphflow_tpu_torch.models.smp1d import (SMP1DConfig, init_smp1d_params,
                                              smp1d_level_features)
from graphflow_tpu_torch.models.smp2d import (SMP2DConfig, init_smp2d_params,
                                              smp2d_level_features)
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import dropout_case_mask
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.optim.utils import uniform_init


class PairGraphModel(ParamModel):
    """What the pair models share (``graphflow_tpu/models/pairgraphs.py:
    46-139``): the reference API over (graph_1, graph_2, target) and a
    per-tower preparation cache.

    A subclass registers its parameters (``ParamModel._register``) and
    implements ``_prepare_1(graph)``, ``_prepare_2(graph)`` and
    ``_forward(params, batch, case_mask=None, training=False) ->
    predictions [B]``; ``batch`` is {"g1": tower 1's stacked graphs, "g2":
    tower 2's, "target": [B]}."""

    # The sigma variant's number of kept contraction cases, else None.
    dropout_nKept: Optional[int] = None

    def __init__(self, optimizer="adam", **opt_kwargs):
        super().__init__(optimizer, **opt_kwargs)
        # graph -> {tower: PreparedGraph}, weak-keyed so that a collected
        # DenseGraph never aliases a new one.
        self._prep_cache = weakref.WeakKeyDictionary()

    def _prepare_1(self, graph: DenseGraph) -> prep.PreparedGraph:
        raise NotImplementedError

    def _prepare_2(self, graph: DenseGraph) -> prep.PreparedGraph:
        raise NotImplementedError

    def _forward(self, params, batch, case_mask=None, training=False):
        raise NotImplementedError

    def prepare(self, graph: DenseGraph, tower: int) -> prep.PreparedGraph:
        """Host preparation for ``tower`` (1 or 2), memoised per graph."""
        per = self._prep_cache.setdefault(graph, {})
        if tower not in per:
            per[tower] = (self._prepare_1 if tower == 1
                          else self._prepare_2)(graph)
        return per[tower]

    def _stack(self, graphs1: Sequence[DenseGraph],
               graphs2: Sequence[DenseGraph], targets=None):
        def stack(graphs, tower):
            return batching.stack_graphs(
                [self.prepare(g, tower) for g in graphs], device=self.device,
                dtype=self.dtype)

        batch = {"g1": stack(graphs1, 1), "g2": stack(graphs2, 2)}
        if targets is not None:
            batch["target"] = torch.as_tensor(
                np.asarray(targets, np.float32), device=self.device)
        return batch

    def _loss(self, params, batch, case_mask=None, level_fn=None):
        """The squared loss summed over the pairs, through the training
        route."""
        pred = self._forward(params, batch, case_mask=case_mask,
                             training=True, level_fn=level_fn)
        return squared_loss(pred, batch["target"])

    def _case_mask(self, train: bool):
        """The sigma variant's case mask: a fresh draw of nKept cases from
        the model's generator for a training step, nKept / 18 everywhere
        for the loss (``pairgraphs.py:108-120``); None for the others."""
        if not self.dropout_nKept:
            return None
        return dropout_case_mask(self._dropout_generator, self.dropout_nKept,
                                 train, device=self.device)

    # -- reference API ---------------------------------------------------

    @torch.no_grad()
    def getLoss(self, graphs1, graphs2, targets) -> float:
        """The batch's loss (``SMP_omega_pairgraphs.h`` getLoss); sigma
        applies its evaluation scaling."""
        return float(self._loss(self.params,
                                self._stack(graphs1, graphs2, targets),
                                case_mask=self._case_mask(False)))

    def BatchLearn(self, graphs1, graphs2, targets,
                   learning_rate) -> Tuple[float, float]:
        """One optimizer step with the nBatch overload -> (loss_before,
        loss_after); sigma draws a fresh case mask for the step and takes
        both losses with it."""
        batch = self._stack(graphs1, graphs2, targets)
        mask = self._case_mask(True)
        before = self._step(lambda: self._loss(self.params, batch, mask),
                            learning_rate, nBatch=len(graphs1))
        with torch.no_grad():
            return before, float(self._loss(self.params, batch, mask))

    Threaded_BatchLearn = BatchLearn

    @torch.no_grad()
    def Predict(self, graph1: DenseGraph, graph2: DenseGraph) -> float:
        """The model's output for one pair (no case mask, as in the JAX
        package)."""
        return float(self._forward(self.params,
                                   self._stack([graph1], [graph2]))[0])


def _mlp_head_dims(nTotal: int) -> Tuple[int, int]:
    """``SMP_omega_pairgraphs.h:332-333``."""
    h1 = max(nTotal // 2, 10)
    return h1, max(h1 // 2, 10)


class SMPPairGraphs(PairGraphModel):
    """Second- (``order=2``) or first-order (``order=1``) towers over graph
    pairs (``graphflow_tpu/models/pairgraphs.py:149-256``), Adam.

    Parameters are the JAX tree ``{"tower1": {"H", "levels"}, "tower2":
    ..., "W1", "W2", "W3"}`` flattened to paths, registered in the
    reference's order (``SMP_omega_pairgraphs.h:393-406``): both H, then
    per level tower 1's and tower 2's (K, b), or (lambda1, lambda2, b, K)
    for a first-order tower (the JAX package's whole-array approximation
    of the reference's per-size interleave), then W1, W2, W3.  The order
    fixes Adam's per-element schedule and the text checkpoint."""

    def __init__(self, order: int, max_nVertices_1: int,
                 max_nVertices_2: int, max_receptive_field: int,
                 nLevels: int, nChanels: int, nFeatures_1: int,
                 nFeatures_2: int, use_coulomb: bool = False,
                 contraction: int = 18, dropout_nKept: Optional[int] = None,
                 channel_schedule: Optional[tuple] = None,
                 head_dims: Optional[tuple] = None,
                 l1_normalize_features: bool = False, seed: int = 0,
                 device=None):
        super().__init__(optimizer="adam")
        if order not in (1, 2):
            raise ValueError(f"order {order}: the towers are first (1) or "
                             f"second (2) order")
        schedule = (halving_schedule(nChanels, nLevels)
                    if channel_schedule is None else tuple(channel_schedule))

        def config(V, F):
            common = dict(max_nVertices=V,
                          max_receptive_field=max_receptive_field,
                          nLevels=nLevels, nChanels=nChanels, nFeatures=F,
                          nDepth=0, has_WL_ordering=False,
                          use_wl_features=False, channel_schedule=schedule)
            if order == 2:
                return SMP2DConfig(use_coulomb=use_coulomb,
                                   contraction=contraction, **common)
            return SMP1DConfig(l1_normalize_features=l1_normalize_features,
                               **common)

        self.order = order
        self.cfg1 = config(max_nVertices_1, nFeatures_1)
        self.cfg2 = config(max_nVertices_2, nFeatures_2)
        self.dropout_nKept = dropout_nKept
        self._dropout_generator = torch.Generator().manual_seed(1234 + seed)

        # nTotal: both towers' channel counts summed over the levels
        # (SMP_omega_pairgraphs.h:323-328).
        nTotal = 2 * sum(schedule)
        h1, h2 = head_dims if head_dims is not None else _mlp_head_dims(
            nTotal)
        self.head_dims = (h1, h2)
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        init = init_smp2d_params if order == 2 else init_smp1d_params
        towers = [init(generator, cfg, device) for cfg in (self.cfg1,
                                                           self.cfg2)]
        for t in towers:
            t.pop("W")                 # the towers have no regression head

        def draw(shape):
            return uniform_init(shape, generator, torch.float32, device)

        tree = {"tower1": towers[0], "tower2": towers[1],
                "W1": draw((h1, nTotal)), "W2": draw((h2, h1)),
                "W3": draw((h2,))}
        per_level = (("K", "b") if order == 2
                     else ("lambda1", "lambda2", "b", "K"))
        self._register(tree, (
            ["tower1/H", "tower2/H"]
            + [f"tower{t}/levels/{l}/{k}" for l in range(nLevels)
               for t in (1, 2) for k in per_level]
            + ["W1", "W2", "W3"]))

    def _prepare(self, graph: DenseGraph, cfg) -> prep.PreparedGraph:
        """Raw features, insertion order, float32 host arrays (the JAX
        package passes no dtype)."""
        return prep.prepare_graph(
            graph, cfg.nLevels, cfg.max_nVertices, cfg.max_receptive_field,
            cfg.nDepth, has_WL_ordering=False, use_wl_features=False,
            use_coulomb=self.order == 2 and cfg.use_coulomb)

    def _prepare_1(self, graph):
        return self._prepare(graph, self.cfg1)

    def _prepare_2(self, graph):
        return self._prepare(graph, self.cfg2)

    def _forward(self, params, batch, case_mask=None, training=False,
                 level_fn=None):
        """-> predictions [B].  ``level_fn`` replaces a second-order
        tower's level step (a plain version, for comparison)."""
        feats = []
        for t, cfg in ((1, self.cfg1), (2, self.cfg2)):
            tower, g = params[f"tower{t}"], batch[f"g{t}"]
            if self.order == 2:
                feats.append(smp2d_level_features(
                    tower, g, cfg, case_mask=case_mask, level_fn=level_fn,
                    training=training))
            else:
                feats.append(smp1d_level_features(tower, g, cfg))
        # Level by level, tower 1's feature then tower 2's
        # (SMP_omega_pairgraphs.h:703-708); the widths shrink.
        merged = torch.cat([x for pair in zip(*feats) for x in pair], dim=-1)
        h = leaky_relu(merged @ params["W1"].T)
        h = leaky_relu(h @ params["W2"].T)
        return h @ params["W3"]


def SMP_omega_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, use_coulomb=False, seed=0,
                         device=None) -> SMPPairGraphs:
    """``SMP_omega_pairgraphs.h:81-128``."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, use_coulomb=use_coulomb, seed=seed,
                         device=device)


def SMP_beta_pairgraphs(max_nVertices_1, max_nVertices_2, nLevels, nChanels,
                        nFeatures_1, nFeatures_2, seed=0,
                        device=None) -> SMPPairGraphs:
    """``SMP_beta_pairgraphs.h``: no cap, and one receptive field P =
    max(V1, V2) for both towers, so the smaller graph's tower has P > V."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max(max_nVertices_1, max_nVertices_2), nLevels,
                         nChanels, nFeatures_1, nFeatures_2, seed=seed,
                         device=device)


def SMP_gamma_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, seed=0, device=None) -> SMPPairGraphs:
    """``SMP_gamma_pairgraphs.h``: 4-case towers (torch ops)."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, contraction=4, seed=seed, device=device)


def SMP_sigma_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, nKept=9, seed=0,
                         device=None) -> SMPPairGraphs:
    """``SMP_sigma_pairgraphs.h:248-257``: omega towers with per-case
    dropout of the contraction: each BatchLearn step keeps ``nKept`` of
    the 18 cases, drawn from a ``torch.Generator`` seeded with 1234 + seed
    (the JAX package draws from ``PRNGKey(1234 + seed)``, which torch
    cannot reproduce), and getLoss scales every case by nKept / 18.  The
    mask scales K's row blocks, so the levels keep K1 and K2."""
    return SMPPairGraphs(2, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, dropout_nKept=nKept, seed=seed,
                         device=device)


def SMP_theta_pairgraphs(max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, seed=0, device=None) -> SMPPairGraphs:
    """``SMP_theta_pairgraphs.h``: first-order theta towers."""
    return SMPPairGraphs(1, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, seed=seed, device=device)


# CCN_1D.h:30's minimum channel count.
CCN_1D_MIN_CHANNELS = 16


def CCN_1D(max_nVertices_1, max_nVertices_2, max_receptive_field, nLevels,
           nChanels, nFeatures_1, nFeatures_2, nChanels_decay=1.0, seed=0,
           device=None) -> SMPPairGraphs:
    """``CCN_1D.h:34-57``: the pair-of-graphs CCN, first-order theta towers
    with CCN's conventions (``graphflow_tpu/models/pairgraphs.py:
    317-348``): each vertex's features divided by their L1 norm
    (``CCN_1D.h:440-448``), channels C_l = max(ceil(C_{l-1} * decay), 16)
    (``:217``), head widths by the same rule (``:352-353``), and
    nChanels >= 16 (``:30, 37``)."""
    if nChanels < CCN_1D_MIN_CHANNELS:
        raise ValueError(
            f"CCN_1D requires nChanels >= {CCN_1D_MIN_CHANNELS} "
            f"(CCN_1D.h:37), got {nChanels}")
    if not 0.0 < nChanels_decay <= 1.0:
        raise ValueError("CCN_1D requires 0 < nChanels_decay <= 1 "
                         "(CCN_1D.h:38-39)")

    def decay(n):
        return max(int(math.ceil(n * nChanels_decay)), CCN_1D_MIN_CHANNELS)

    schedule = [nChanels]
    for _ in range(nLevels):
        schedule.append(decay(schedule[-1]))
    h1 = decay(2 * sum(schedule))
    return SMPPairGraphs(1, max_nVertices_1, max_nVertices_2,
                         max_receptive_field, nLevels, nChanels, nFeatures_1,
                         nFeatures_2, channel_schedule=tuple(schedule),
                         head_dims=(h1, decay(h1)),
                         l1_normalize_features=True, seed=seed,
                         device=device)


class GCNKernel(PairGraphModel):
    """``GCN_1D_Kernel.h``: one GCN tower shared by both graphs, the top
    level's features concatenated and read by W [2 nHiddens]; the squared
    loss (graph-kernel regression), Momentum.  Registration order
    ``GCN_1D_Kernel.h:120-128``: per level W1 (and W2 from level 1), then
    W."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                 max_Radius, order=1, momentum_param=0.9, seed=0,
                 device=None):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.cfg = GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens,
                             nDepth, max_Radius, order=order)
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        tower = init_gcn_params(generator, self.cfg, device)
        tower.pop("W")
        tree = {"tower": tower,
                "W": uniform_init((2 * nHiddens,), generator, torch.float32,
                                  device)}
        order_list = []
        for l in range(nLevels + 1):
            order_list.append(f"tower/levels/{l}/W1")
            if l > 0:
                order_list.append(f"tower/levels/{l}/W2")
        self._register(tree, order_list + ["W"])

    def _prepare_1(self, graph):
        return prep.prepare_graph(graph, self.cfg.nLevels,
                                  self.cfg.max_nVertices, 1, self.cfg.nDepth)

    _prepare_2 = _prepare_1

    def _forward(self, params, batch, case_mask=None, training=False,
                 level_fn=None):
        # gcn_forward reads a head W; the tower's top feature is all that is
        # used here, so the slot is zeros (pairgraphs.py:383-388).
        tower = dict(params["tower"],
                     W=params["W"].new_zeros((self.cfg.nHiddens,)))
        _, top1 = gcn_forward(tower, batch["g1"], self.cfg)
        _, top2 = gcn_forward(tower, batch["g2"], self.cfg)
        return torch.cat([top1, top2], dim=-1) @ params["W"]


def _gcn_kernel(order, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                max_Radius, momentum_param, seed, device) -> GCNKernel:
    return GCNKernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                     max_Radius, order, momentum_param, seed, device)


def GCN_1D_Kernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                  max_Radius, momentum_param=0.9, seed=0,
                  device=None) -> GCNKernel:
    """``GCN_1D_Kernel.h``."""
    return _gcn_kernel(1, nLevels, max_nVertices, nFeatures, nHiddens,
                       nDepth, max_Radius, momentum_param, seed, device)


def GCN_2D_Kernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                  max_Radius, momentum_param=0.9, seed=0,
                  device=None) -> GCNKernel:
    """``GCN_2D_Kernel.h``: RisiLayer2D; the radius is capped, as in the
    JAX package."""
    return _gcn_kernel(2, nLevels, max_nVertices, nFeatures, nHiddens,
                       nDepth, max_Radius, momentum_param, seed, device)


def GCN_3D_Kernel(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                  max_Radius, momentum_param=0.9, seed=0,
                  device=None) -> GCNKernel:
    """``GCN_3D_Kernel.h``: RisiLayer3D and KMax."""
    return _gcn_kernel(3, nLevels, max_nVertices, nFeatures, nHiddens,
                       nDepth, max_Radius, momentum_param, seed, device)
