"""Second-order Steerable Message Passing, SMP_omega (counterpart of
``graphflow_tpu/models/smp2d.py``).

Math per level (reference ``SMP_omega.h:607-692``):
  level 0:  F_v = LeakyReLU(H @ wl_feat_v)            as a 1x1xC tensor
  level l:  for each w in phi_l(v): gather X f_w X^T  (permutation alignment)
            T = stack of gathered tensors; Y = RisiContraction_18(T, radj)
            Z = reshape(Y) @ K_l + b_l;  F = LeakyReLU(Z), then masked
  head:     vertex = LeakyReLU(sum_{p1,p2} F);  graph = sum_v vertex
            predict = <graph, W>

Where JAX vmaps the level over the batch, the port flattens B graphs of V
padded vertices into B*V vertex rows and offsets ``nbr`` by b*V, so one
call of the level (one kernel launch on CUDA) covers the batch.

The level has one route per dtype.  float32 (and float64, on the CPU for
parity tests) runs :func:`risi18_level`, the fused level (K1, K2 on
CUDA).  bfloat16 runs :func:`risi18_bank_level`: the take-gather
materialises T, then :func:`risi18_bank` (K4, K5 on CUDA), the bias and
LeakyReLU in bfloat16, as the JAX package's bank route does
(``graphflow_tpu/models/smp2d.py:297-308``).  On the TPU the JAX package
sends bfloat16 at P a multiple of 16 through its fused level instead; that
split follows the TPU's 16-row bfloat16 tile and is not ported.

The port covers inference and training (the squared loss of the
regression head, Adam, ``BatchLearn``) with contraction 18.  Other
contractions, ``case_mask``, ``channel_schedule``, ``nClasses`` and the
physics variants' raw features are ROADMAP queue 1, item 3b.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                               risi18_bank_reference)
from graphflow_tpu_torch.ops.risi_level import risi18_level
from graphflow_tpu_torch.optim.utils import uniform_init
from graphflow_tpu_torch.utils.convert import to_numpy

_REST_OF_SMP2D = "ROADMAP queue 1, item 3b (the rest of smp2d)"


@dataclasses.dataclass
class SMP2DConfig:
    max_nVertices: int
    max_receptive_field: Optional[int]
    nLevels: int
    nChanels: int
    nFeatures: int
    nDepth: int
    has_WL_ordering: bool = True
    use_coulomb: bool = False
    contraction: int = 18
    nClasses: Optional[int] = None
    dtype: str = "float32"
    channel_schedule: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.contraction != 18:
            raise NotImplementedError(
                f"contraction {self.contraction} is {_REST_OF_SMP2D}")
        if self.channel_schedule is not None:
            raise NotImplementedError(f"channel_schedule is {_REST_OF_SMP2D}")
        if self.nClasses:
            raise NotImplementedError(
                f"classification heads (nClasses) are {_REST_OF_SMP2D}")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise NotImplementedError(
                f"dtype {self.dtype} is not ported; the port takes "
                f"float32, float64 and bfloat16")

    @property
    def feat_dim(self) -> int:
        return self.nFeatures * (self.nDepth + 1)

    @property
    def P(self) -> int:
        return (self.max_receptive_field
                if self.max_receptive_field is not None else self.max_nVertices)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def host_dtype(self) -> np.dtype:
        """The dtype of the host arrays of ``prepare_graph``.  NumPy has no
        bfloat16, so a bfloat16 model prepares in float32 and
        ``stack_graphs`` casts on the device.  That is exact for the fields
        SMP_omega reads (0/1 masks and adjacency, WL histograms of small
        integers); a Coulomb or distance value may differ from the JAX
        package's by one bfloat16 step, rounded twice (float64 -> float32
        -> bfloat16) where the JAX package rounds once."""
        return np.dtype("float32" if self.dtype == "bfloat16"
                        else self.dtype)


def init_smp2d_params(generator: torch.Generator, cfg: SMP2DConfig,
                      device=None):
    """Fresh parameters as the JAX tree, drawn in the reference's
    registration order (``SMP_omega.h:289-295``): H, per level (K, b), W.
    Each draw is float64 from ``generator``, rounded to the model's dtype
    (bfloat16 included); weights shared with the JAX package come through
    ``utils/convert.py`` instead."""
    C, dt = cfg.nChanels, cfg.torch_dtype

    def draw(shape):
        return uniform_init(shape, generator, dt, device)

    H = draw((C, cfg.feat_dim))
    levels = [{"K": draw((18 * C, C)), "b": draw((C,))}
              for _ in range(cfg.nLevels)]
    return {"H": H, "levels": levels, "W": draw((C,))}


def _gather_neighbor_tensors_take(state_pad, nbr, pos):
    """The flat-take gather and alignment X f X^T (counterpart of
    ``smp2d.py:_gather_neighbor_tensors_take``).

    state_pad [N, P+1, P+1, C] (the state zero-padded by one position on
    both spatial axes), nbr [N, P] in [0, N], pos [N, P, P] in [0, P]
    -> T [N, P, P, P, C], T[v,i,p1,p2] = state_pad[nbr[v,i], pos[v,i,p1],
    pos[v,i,p2]].  Neighbour id and row position fold into one row index
    over the [(N+1)(P+1), (P+1)C] view; the appended zero vertex row makes
    the sentinel N read zeros, where ``jnp.take`` would clamp and torch
    would raise (CPU) or read out of range (CUDA).  The rows are taken with
    ``index_select``, whose adjoint is ``index_add_``, a scatter-add like
    ``jnp.take``'s; the adjoint of indexing ``src[rows]`` sorts the indices
    first, and took twice as long per bfloat16 step on an H100.
    """
    N, Q, _, C = state_pad.shape
    P = nbr.shape[1]
    src = torch.cat([state_pad.reshape(N * Q, Q * C),
                     state_pad.new_zeros((Q, Q * C))], dim=0)
    rows = nbr.long()[:, :, None] * Q + pos.long()                # [N, P, P]
    Ar = src.index_select(0, rows.reshape(-1)).reshape(N, P, P, Q, C)
    col = pos.long()[:, :, None, :, None].expand(N, P, P, P, C)
    return torch.gather(Ar, 3, col)


def _bank_level(bank, state, nbr, pos, radj, K, b, negslope=0.01):
    """The bank route of one level (``graphflow_tpu/models/smp2d.py:
    297-308``): pad the state, take-gather T [N,P,P,P,C], the bank with the
    float32 adjacency, then the bias and LeakyReLU in the state's dtype.
    -> [N, P*P, Cout]."""
    N, P, _, _ = state.shape
    state_pad = torch.nn.functional.pad(state, (0, 0, 0, 1, 0, 1))
    T = _gather_neighbor_tensors_take(state_pad, nbr, pos)
    Z = bank(T, radj.float(), K).reshape(N, P * P, K.shape[1]) + b
    return leaky_relu(Z, negslope)


def risi18_bank_level(state, nbr, pos, radj, K, b, negslope=0.01):
    """The level through :func:`risi18_bank` (K4 and K5 on CUDA); the
    bfloat16 route.  Arguments as :func:`risi18_level`."""
    return _bank_level(risi18_bank, state, nbr, pos, radj, K, b, negslope)


def risi18_bank_level_reference(state, nbr, pos, radj, K, b, negslope=0.01):
    """:func:`risi18_bank_level` through the plain bank, on any device."""
    return _bank_level(risi18_bank_reference, state, nbr, pos, radj, K, b,
                       negslope)


def smp2d_states(params, g, cfg: SMP2DConfig, case_mask=None,
                 level_fn=None):
    """Per-level vertex states [B, V, P, P, C], levels 0..nLevels, of a
    stacked batch ``g``.  ``level_fn`` is the level step; by default
    :func:`risi18_bank_level` for bfloat16 and :func:`risi18_level`
    otherwise, and a plain version may be given for comparison.
    Inference and training share this loop (the JAX package's
    ``training`` flag only picks TPU kernels): the wrapper's autograd (K2
    or K5 on CUDA) gives the gradients.
    """
    if level_fn is None:
        level_fn = (risi18_bank_level if cfg.dtype == "bfloat16"
                    else risi18_level)
    if case_mask is not None:
        raise NotImplementedError(f"case_mask is {_REST_OF_SMP2D}")
    B, V = g["vmask"].shape
    P, C = cfg.P, cfg.nChanels

    # Level 0 (SMP_omega.h:616-627): 1x1xC vertex tensors.
    F0 = leaky_relu(g["wl_feat"] @ params["H"].T)                  # [B, V, C]
    state = F0.new_zeros((B, V, P, P, C))
    state[:, :, 0, 0, :] = F0 * g["vmask"][..., None]
    states = [state]

    # Vertex v of graph k is row k*V + v; ids >= V are absent and map to
    # the sentinel row B*V.
    offset = (torch.arange(B, dtype=torch.int32, device=state.device)
              * V)[:, None, None]
    for l in range(cfg.nLevels):
        K, b = params["levels"][l]["K"], params["levels"][l]["b"]
        nbr = g["nbr"][:, l]
        nbr = torch.where(nbr < V, nbr + offset,
                          torch.full_like(nbr, B * V)).reshape(B * V, P)
        pos = g["pos"][:, l].reshape(B * V, P, P).contiguous()
        radj = g["radj"][:, l].reshape(B * V, P, P).contiguous()
        Z = level_fn(state.reshape(B * V, P, P, C), nbr, pos, radj, K, b)
        state = (Z.reshape(B, V, P, P, K.shape[1])
                 * g["smask"][:, l + 1, :, :, :, None])
        states.append(state)
    return states


def _graph_feature(state, vmask):
    """Shrink -> LeakyReLU -> masked vertex sum (SMP_omega.h:674-686)."""
    vertex = leaky_relu(state.sum(dim=(-3, -2)))                   # [B, V, C]
    return (vertex * vmask[..., None]).sum(dim=-2)                 # [B, C]


def smp2d_forward(params, g, cfg: SMP2DConfig, level_fn=None):
    """Forward over a stacked batch -> (prediction [B], graph_feat [B, C])."""
    states = smp2d_states(params, g, cfg, level_fn=level_fn)
    graph_feat = _graph_feature(states[-1], g["vmask"])
    return graph_feat @ params["W"], graph_feat


class SMP2D(GraphModel):
    """Config-driven second-order SMP model with the reference API.

    Parameters are registered under the JAX package's paths (``"H"``,
    ``"levels/0/K"``, ...) in the reference's order, so
    ``named_parameters()`` and ``state_dict()`` list them as the text
    checkpoint stores them."""

    def __init__(self, cfg: SMP2DConfig, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.param_order = (["H"]
                            + [f"levels/{l}/{k}" for l in range(cfg.nLevels)
                               for k in ("K", "b")]
                            + ["W"])
        p = init_smp2d_params(torch.Generator().manual_seed(seed), cfg,
                              device)
        fresh = {"H": p["H"], "W": p["W"],
                 **{f"levels/{l}/{k}": lv[k]
                    for l, lv in enumerate(p["levels"]) for k in ("K", "b")}}
        for path in self.param_order:
            self.register_parameter(path, nn.Parameter(fresh[path]))
        self._finish_init()

    @property
    def params(self):
        """The parameters as the JAX tree {"H", "levels": [{"K", "b"}], "W"}."""
        d = self.param_dict()
        return {"H": d["H"], "W": d["W"],
                "levels": [{"K": d[f"levels/{l}/K"], "b": d[f"levels/{l}/b"]}
                           for l in range(self.cfg.nLevels)]}

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        return prep.prepare_graph(
            graph, self.cfg.nLevels, self.cfg.max_nVertices,
            self.cfg.max_receptive_field, self.cfg.nDepth,
            has_WL_ordering=self.cfg.has_WL_ordering,
            use_coulomb=self.cfg.use_coulomb,
            dtype=self.cfg.host_dtype)

    def _forward(self, params, batch):
        return smp2d_forward(params, batch, self.cfg)

    def _loss(self, params, batch):
        """Squared loss of the batch, summed over graphs
        (``graphflow_tpu/models/smp2d.py:398-402``)."""
        if self.cfg.nClasses:
            raise NotImplementedError(
                f"classification heads (nClasses) are {_REST_OF_SMP2D}")
        pred, _ = smp2d_forward(params, batch, self.cfg)
        return squared_loss(pred, batch["target"])


def SMP_omega(max_nVertices, max_receptive_field, nLevels, nChanels,
              nFeatures, nDepth, has_WL_ordering=True, use_coulomb=False,
              seed=0, device=None) -> SMP2D:
    """``SMP_omega.h:31-113``: contraction 18 + receptive-field cap."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, has_WL_ordering=has_WL_ordering,
        use_coulomb=use_coulomb), seed, device)


@torch.no_grad()
def smp2d_inspect(model: SMP2D, graph: DenseGraph) -> dict:
    """Activation dump (the reference's ``ForDebugging()``,
    ``SMP_2D.h:762-795``): per-level states, vertex features and the graph
    feature as NumPy arrays restricted to real vertices."""
    g = model._stack([graph])
    states = smp2d_states(model.params, g, model.cfg)
    n = graph.nVertices
    vertex = leaky_relu(states[-1].sum(dim=(-3, -2)))
    return {
        "states": [to_numpy(s[0, :n]) for s in states],
        "vertex_features": to_numpy(vertex[0, :n]),
        "graph_feature": to_numpy(_graph_feature(states[-1], g["vmask"])[0]),
    }
