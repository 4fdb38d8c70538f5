"""The physics family (counterpart of ``graphflow_tpu/models/physics.py``):
raw features, an optional Coulomb adjacency, and a head over the graph
features of every level.

Reference ``SMP_omega_physics.h``, ``SMP_beta_physics.h``,
``SMP_gamma_physics.h``.  They differ from their parents in three ways:

  * raw vertex features only: no WL histograms and no WL vertex ranking, so
    receptive fields keep insertion order;
  * an optional Coulomb reduced adjacency: with ``use_coulomb`` each
    receptive-field block copies ``coulomb[v1][v2]`` as it is, the diagonal
    included; without it the usual 0/1 block with a unit diagonal
    (``SMP_omega_physics.h:436-461``).  A negative entry meets the adj>0
    guard in the 18-case bank and no guard in the 4-case one, which takes
    no adjacency at all;
  * the head: ``hidden = LeakyReLU(W1 @ concat(level features 0..L))``,
    ``predict = <hidden, W2>`` with nHidden = nTotal // 2
    (``SMP_omega_physics.h:211-239, 585-592``), where the parents take one
    inner product with the top level's feature.

Every tower halves its channels per level, C_l = max(C_{l-1} // 2, 1)
(``SMP_omega_physics.h:142-144``), so its levels run the kernels at
C != Cout, down to one channel.  Adam, the squared loss.  The first-order
``SMP_theta_physics`` needs the first-order tower (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.models.smp2d import (SMP2DConfig, init_smp2d_params,
                                              smp2d_level_features)
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.optim.utils import uniform_init


def halving_schedule(nChanels: int, nLevels: int):
    """(C_0, ..., C_L) with C_l = max(C_{l-1} // 2, 1)."""
    schedule = [nChanels]
    for _ in range(nLevels):
        schedule.append(max(schedule[-1] // 2, 1))
    return tuple(schedule)


class SMPPhysics(GraphModel):
    """The model class the physics constructors share, for a second-order
    tower.

    Parameters are registered as the JAX tree ``{"tower": {"H", "levels"},
    "W1", "W2"}`` flattened to paths, in the reference's order
    (``SMP_omega_physics.h:254-263``): ``tower/H``, ``tower/levels/l/K``,
    ``tower/levels/l/b``, ``W1``, ``W2``.  The order fixes Adam's
    per-element schedule and the text checkpoint.  All parameters are
    float32, as the JAX constructor makes them."""

    def __init__(self, order: int, max_nVertices: int, max_receptive_field,
                 nLevels: int, nChanels: int, nFeatures: int,
                 use_coulomb: bool = False, contraction: int = 18,
                 seed: int = 0, device=None):
        super().__init__(optimizer="adam")
        if order != 2:
            raise NotImplementedError(
                "the first-order physics tower (SMP_theta_physics) needs "
                "models/smp1d.py: ROADMAP queue 1, item 5")
        self.order = order
        schedule = halving_schedule(nChanels, nLevels)
        self.cfg = SMP2DConfig(
            max_nVertices=max_nVertices,
            max_receptive_field=max_receptive_field, nLevels=nLevels,
            nChanels=nChanels, nFeatures=nFeatures, nDepth=0,
            has_WL_ordering=False, use_coulomb=use_coulomb,
            use_wl_features=False, contraction=contraction,
            channel_schedule=schedule)

        # nTotal = the per-level channel counts summed; nHidden = nTotal // 2
        # (SMP_omega_physics.h:211-233).
        nTotal = sum(schedule)
        nHidden = nTotal // 2
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        tower = init_smp2d_params(generator, self.cfg, device)
        fresh = {"tower/H": tower["H"],
                 **{f"tower/levels/{l}/{k}": lv[k]
                    for l, lv in enumerate(tower["levels"])
                    for k in ("K", "b")},
                 "W1": uniform_init((nHidden, nTotal), generator,
                                    torch.float32, device),
                 "W2": uniform_init((nHidden,), generator, torch.float32,
                                    device)}
        self.param_order = (["tower/H"]
                            + [f"tower/levels/{l}/{k}"
                               for l in range(nLevels) for k in ("K", "b")]
                            + ["W1", "W2"])
        for path in self.param_order:
            self.register_parameter(path, nn.Parameter(fresh[path]))
        self._finish_init()

    @property
    def params(self):
        """The parameters as the JAX tree."""
        d = self.param_dict()
        levels = [{"K": d[f"tower/levels/{l}/K"],
                   "b": d[f"tower/levels/{l}/b"]}
                  for l in range(self.cfg.nLevels)]
        return {"tower": {"H": d["tower/H"], "levels": levels},
                "W1": d["W1"], "W2": d["W2"]}

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        """Host arrays in float32 whatever the parameters' dtype, as the JAX
        package prepares them (``physics.py:98-102`` passes no dtype);
        ``_stack`` casts them to the parameters' dtype on the device."""
        return prep.prepare_graph(
            graph, self.cfg.nLevels, self.cfg.max_nVertices,
            self.cfg.max_receptive_field, 0, has_WL_ordering=False,
            use_coulomb=self.cfg.use_coulomb, use_wl_features=False,
            dtype=np.float32)

    def _forward(self, params, batch, level_fn=None, training=False):
        feats = smp2d_level_features(params["tower"], batch, self.cfg,
                                     level_fn=level_fn, training=training)
        gf = torch.cat(feats, dim=-1)                         # [B, nTotal]
        hidden = leaky_relu(gf @ params["W1"].T)
        return hidden @ params["W2"], gf

    def _loss(self, params, batch, level_fn=None):
        pred, _ = self._forward(params, batch, level_fn=level_fn,
                                training=True)
        return squared_loss(pred, batch["target"])


def SMP_omega_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, use_coulomb=False, seed=0,
                      device=None) -> SMPPhysics:
    """``SMP_omega_physics.h:31-61``: the 18-case tower with a
    receptive-field cap."""
    return SMPPhysics(2, max_nVertices, max_receptive_field, nLevels,
                      nChanels, nFeatures, use_coulomb=use_coulomb,
                      contraction=18, seed=seed, device=device)


def SMP_beta_physics(max_nVertices, nLevels, nChanels, nFeatures,
                     use_coulomb=False, seed=0, device=None) -> SMPPhysics:
    """``SMP_beta_physics.h:31-58``: omega_physics without the cap."""
    return SMPPhysics(2, max_nVertices, None, nLevels, nChanels, nFeatures,
                      use_coulomb=use_coulomb, contraction=18, seed=seed,
                      device=device)


def SMP_gamma_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, use_coulomb=False, seed=0,
                      device=None) -> SMPPhysics:
    """``SMP_gamma_physics.h:31-60``: the 4-case tower."""
    return SMPPhysics(2, max_nVertices, max_receptive_field, nLevels,
                      nChanels, nFeatures, use_coulomb=use_coulomb,
                      contraction=4, seed=seed, device=device)


def SMP_theta_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, seed=0, device=None) -> SMPPhysics:
    """``SMP_theta_physics.h:31-56``: the first-order tower, not ported
    yet: raises ``NotImplementedError`` (ROADMAP queue 1, item 5)."""
    return SMPPhysics(1, max_nVertices, max_receptive_field, nLevels,
                      nChanels, nFeatures, seed=seed, device=device)
