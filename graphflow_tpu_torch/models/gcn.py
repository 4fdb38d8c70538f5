"""The GCN family (counterpart of ``graphflow_tpu/models/gcn.py``).

  GCN_1D / GCN_2D / GCN_3D   (``GCN_1D.h`` etc.) WL features, per level
      hidden = Softmax(W1 feat + W2 agg(neighbours)) over the vertices within
      min(l, max_Radius) hops (GCN_2D: l, uncapped), aggregated to first,
      second or third order (RisiLayer1D/2D/3D; 3D then keeps the nHiddens
      largest entries, KMax), a linear head, Momentum
  GCN_*_Distance             (``GCN_1D_Distance.h:98-161``) a second channel
      fed by each vertex's sorted distance column; heads concatenated
  GCN_MW                     (``GCN_MW.h:209-221``) Kipf-Welling:
      hidden_l = LeakyReLU(norm_adj hidden_{l-1} W_l), a SumRows head
  NeuralFingerprint          (``NeuralFingerprint.h:58-106``) Duvenaud's
      fingerprints: raw features at every level, the open 1-hop sum

Every Softmax trains with the reference's diagonal-only backward
(``ops/activations.py:softmax``).  Where the JAX package vmaps one graph,
the port runs the batch [B, V, H] at once: the aggregations are batched
products with the [B, V, V] neighbourhood masks, or, on GCN_MW's and
NeuralFingerprint's ELL route, ELLPACK sums over the batch's rows laid end
to end (``ops/sparse.py:ell_spmm``).  No TPU kernel runs on these paths in
the JAX package, and none runs here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.ops.activations import leaky_relu, softmax
from graphflow_tpu_torch.ops.losses import squared_loss
from graphflow_tpu_torch.ops.sparse import ell_spmm
from graphflow_tpu_torch.optim.utils import uniform_init
from graphflow_tpu_torch.utils.convert import to_numpy

# GCN_MW and NeuralFingerprint take the ELL route from this many vertices
# under aggregation="auto" (``graphflow_tpu/models/gcn.py:304-306, 391-392``).
ELL_MIN_VERTICES = 1024


@dataclasses.dataclass
class GCNConfig:
    nLevels: int
    max_nVertices: int
    nFeatures: int
    nHiddens: int
    nDepth: int
    max_Radius: int
    order: int = 1                    # 1 | 2 | 3 (RisiLayer order)
    momentum_param: float = 0.9
    use_distance_channel: bool = False
    # GCN_2D's neighbour rule is sp(v, u) <= l with no max_Radius cap
    # (``GCN_2D.h:230``), unlike every other member of the family.
    uncapped_radius: bool = False
    optimizer: str = "momentum"
    dtype: str = "float32"

    def __post_init__(self):
        if self.order not in (1, 2, 3):
            raise ValueError(f"order {self.order}: 1, 2 or 3")

    @property
    def feat_dim(self) -> int:
        return self.nFeatures * (self.nDepth + 1)

    def param_order(self):
        """Channel-blocked, as the reference's save_model and load_model
        write it: every vertex-channel weight, then every distance-channel
        weight, then W (``GCN_1D_Distance.h`` save/load;
        ``graphflow_tpu/models/gcn.py:196-211``)."""
        order = []
        for channel in (("levels", "dlevels") if self.use_distance_channel
                        else ("levels",)):
            for l in range(self.nLevels + 1):
                order.append(f"{channel}/{l}/W1")
                if l > 0:
                    order.append(f"{channel}/{l}/W2")
        return order + ["W"]


def init_gcn_params(generator: torch.Generator, cfg: GCNConfig,
                    device=None):
    """Fresh parameters as the JAX tree {"levels": [...], ("dlevels": [...]),
    "W"} at the JAX package's scales (``graphflow_tpu/models/gcn.py:64-90``);
    W1 reads the WL features, or the distance column (max_nVertices wide)
    in the distance channel."""
    dt, H = getattr(torch, cfg.dtype), cfg.nHiddens

    def draw(shape):
        return uniform_init(shape, generator, dt, device)

    def channel(width):
        return [dict({"W1": draw((H, width))},
                     **({"W2": draw((H, H))} if l > 0 else {}))
                for l in range(cfg.nLevels + 1)]

    params = {"levels": channel(cfg.feat_dim)}
    if cfg.use_distance_channel:
        params["dlevels"] = channel(cfg.max_nVertices)
        params["W"] = draw((2 * H,))
    else:
        params["W"] = draw((H,))
    return params


def _aggregate(M, hidden, order: int, nHiddens: int):
    """The masked RisiLayer-{1,2,3}D over each vertex's neighbours, M
    [B, V, V] 0/1, hidden [B, V, H] (``graphflow_tpu/models/gcn.py:93-118``).
    """
    if order == 1:
        return M @ hidden                                        # RisiLayer1D
    if order == 2:
        # Y_v = SUM_u M_vu x_u (Stot_v - s_u), RisiLayer2D.h in closed form.
        s = hidden.sum(dim=-1, keepdim=True)                     # [B, V, 1]
        return (M @ s) * (M @ hidden) - M @ (s * hidden)
    # RisiLayer3D.h: inclusion-exclusion over ordered distinct triples,
    # then KMax to nHiddens (GCN_3D.h:84), keeping the ascending order.
    u1 = M @ hidden                                              # [B, V, H]
    u2 = torch.einsum("bvu,bui,buj->bvij", M, hidden, hidden)
    u3 = torch.einsum("bvu,bui,buj,buk->bvijk", M, hidden, hidden, hidden)
    uuu = torch.einsum("bvi,bvj,bvk->bvijk", u1, u1, u1)
    c12 = torch.einsum("bvij,bvk->bvijk", u2, u1)
    c13 = torch.einsum("bvik,bvj->bvijk", u2, u1)
    c23 = torch.einsum("bvi,bvjk->bvijk", u1, u2)
    Y = uuu - c12 - c13 - c23 + 2.0 * u3                          # [B,V,H,H,H]
    flat = Y.reshape(*Y.shape[:2], -1)
    return torch.sort(flat, dim=-1).values[..., -nHiddens:]


def _channel_forward(levels, feat, M_of, vmask, order, nHiddens,
                     collect=None):
    """One GCN channel: (the top level's hidden summed over vertices [B, H],
    that hidden [B, V, H]); ``collect`` gets each level's hidden."""
    mask = vmask[..., None]
    hidden = softmax(feat @ levels[0]["W1"].T) * mask
    if collect is not None:
        collect.append(hidden)
    for l in range(1, len(levels)):
        part1 = feat @ levels[l]["W1"].T
        agg = _aggregate(M_of(l), hidden, order, nHiddens)
        hidden = softmax(part1 + agg @ levels[l]["W2"].T) * mask
        if collect is not None:
            collect.append(hidden)
    return hidden.sum(dim=1), hidden


def _masks(g, cfg: GCNConfig):
    """M_of(l): [B, V, V], 1 where sp(v, u) <= radius(l) between real
    vertices."""
    vmask = g["vmask"]
    outer = vmask[:, :, None] * vmask[:, None, :]

    def M_of(l):
        radius = l if cfg.uncapped_radius else min(l, cfg.max_Radius)
        return (g["sp"] <= radius).to(vmask.dtype) * outer

    return M_of


def gcn_states(params, g, cfg: GCNConfig):
    """(per-level hiddens of the vertex channel, each [B, V, H]; the final
    feature [B, H]): the reference's ``level[l]->hidden[v]``
    (``graphflow_tpu/models/gcn.py:141-155``)."""
    states = []
    final, _ = _channel_forward(params["levels"], g["wl_feat"],
                                _masks(g, cfg), g["vmask"], cfg.order,
                                cfg.nHiddens, collect=states)
    return states, final


def gcn_forward(params, g, cfg: GCNConfig):
    """-> (prediction [B], graph feature [B, H] or [B, 2H])."""
    vmask, M_of = g["vmask"], _masks(g, cfg)
    final, _ = _channel_forward(params["levels"], g["wl_feat"], M_of, vmask,
                                cfg.order, cfg.nHiddens)
    if cfg.use_distance_channel:
        # The ascending-sorted distance column d(:, v) of each vertex, zero
        # in padding slots, through the same RisiLayer order
        # (GCN_2D_Distance.h:141).
        outer = vmask[:, :, None] * vmask[:, None, :]
        column = torch.sort(g["dist"].transpose(1, 2) * outer, dim=-1).values
        final_d, _ = _channel_forward(params["dlevels"], column, M_of, vmask,
                                      cfg.order, cfg.nHiddens)
        final = torch.cat([final, final_d], dim=-1)
    return final @ params["W"], final


class _Model(GraphModel):
    """The squared loss of the prediction."""

    def _loss(self, params, batch):
        pred, _ = self._forward(params, batch)
        return squared_loss(pred, batch["target"])


class GCN(_Model):
    """GCN_{1,2,3}D (+ _Distance) with the reference API."""

    def __init__(self, cfg: GCNConfig, seed: int = 0, device=None):
        super().__init__(optimizer=cfg.optimizer,
                         **({"gamma": cfg.momentum_param}
                            if cfg.optimizer == "momentum" else {}))
        self.cfg = cfg
        self._register(init_gcn_params(torch.Generator().manual_seed(seed),
                                       cfg, resolve_device(device)),
                       cfg.param_order())

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        return prep.prepare_graph(
            graph, self.cfg.nLevels, self.cfg.max_nVertices, 1,
            self.cfg.nDepth, dtype=np.dtype(self.cfg.dtype))

    def _forward(self, params, batch):
        return gcn_forward(params, batch, self.cfg)


def _gcn(order, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
         max_Radius, momentum_param, seed, device, **more) -> GCN:
    return GCN(GCNConfig(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                         max_Radius, order=order,
                         momentum_param=momentum_param, **more), seed, device)


def GCN_1D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth, max_Radius,
           momentum_param=0.9, seed=0, device=None) -> GCN:
    """``GCN_1D.h:30-41``."""
    return _gcn(1, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                max_Radius, momentum_param, seed, device)


def GCN_2D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth, max_Radius,
           momentum_param=0.9, seed=0, device=None) -> GCN:
    """``GCN_2D.h``: RisiLayer2D; its neighbour radius is l, not
    min(l, max_Radius) (``GCN_2D.h:230``)."""
    return _gcn(2, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                max_Radius, momentum_param, seed, device,
                uncapped_radius=True)


def GCN_3D(nLevels, max_nVertices, nFeatures, nHiddens, nDepth, max_Radius,
           momentum_param=0.9, seed=0, device=None) -> GCN:
    """``GCN_3D.h``: RisiLayer3D and KMax."""
    return _gcn(3, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                max_Radius, momentum_param, seed, device)


def GCN_1D_Distance(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                    max_Radius, momentum_param=0.9, seed=0,
                    device=None) -> GCN:
    """``GCN_1D_Distance.h``: the sorted-distance channel beside."""
    return _gcn(1, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                max_Radius, momentum_param, seed, device,
                use_distance_channel=True)


def GCN_2D_Distance(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                    max_Radius, momentum_param=0.9, seed=0,
                    device=None) -> GCN:
    """``GCN_2D_Distance.h`` (the radius capped)."""
    return _gcn(2, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                max_Radius, momentum_param, seed, device,
                use_distance_channel=True)


def GCN_3D_Distance(nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                    max_Radius, momentum_param=0.9, seed=0,
                    device=None) -> GCN:
    """``GCN_3D_Distance.h``."""
    return _gcn(3, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                max_Radius, momentum_param, seed, device,
                use_distance_channel=True)


def _route(aggregation: str, max_nVertices: int, ell_ok: bool = True) -> str:
    if aggregation == "auto":
        return ("ell" if max_nVertices >= ELL_MIN_VERTICES and ell_ok
                else "dense")
    if aggregation not in ("dense", "ell"):
        raise ValueError(f"aggregation {aggregation!r}: 'dense', 'ell' or "
                         f"'auto'")
    return aggregation


def _ell(g, key: str, h):
    """ell_spmm over a batch: each graph's ELL rows [B, V, D] (sentinel V)
    offset into the batch's rows laid end to end, the sentinel clamped to
    the graph's own last row first, as the JAX package's per-graph call
    does."""
    B, V, H = h.shape
    nbr = torch.clamp(g[f"ell_nbr{key}"].long(), max=V - 1)
    nbr = nbr + (torch.arange(B, device=h.device) * V)[:, None, None]
    out = ell_spmm(nbr.reshape(B * V, -1), g[f"ell_w{key}"].reshape(B * V, -1),
                   h.reshape(B * V, H))
    return out.reshape(B, V, H)


@dataclasses.dataclass
class GCNMWConfig:
    """GCN_MW's sizes, held by the model as ``cfg`` as in the JAX package
    (``graphflow_tpu/models/gcn.py:281-288``)."""
    nLevels: int
    max_nVertices: int
    nFeatures: int
    nHiddens: int
    nDepth: int
    momentum_param: float = 0.9
    dtype: str = "float32"


class GCN_MW(_Model):
    """``GCN_MW.h``: hidden_l = LeakyReLU(norm_adj hidden_{l-1} W_l).

    ``aggregation``: "dense" (the masked [V, V] product), "ell" (the
    ELLPACK sum, O(V D H), over graphs that :func:`prep.prepare_graph_sparse`
    prepares; needs nDepth == 0, since that prep computes no WL features) or
    "auto" (ell from 1024 vertices when nDepth == 0).  Parameters are
    float32, as in the JAX package."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens, nDepth,
                 momentum_param=0.9, seed=0, aggregation="auto",
                 device=None):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.aggregation = _route(aggregation, max_nVertices, nDepth == 0)
        if self.aggregation == "ell" and nDepth != 0:
            raise ValueError("ELL aggregation needs nDepth == 0")
        self.cfg = GCNMWConfig(nLevels, max_nVertices, nFeatures, nHiddens,
                               nDepth, momentum_param)
        gen, dev = torch.Generator().manual_seed(seed), resolve_device(device)
        feat_dim = nFeatures * (nDepth + 1)
        tree = {"levels": [{"W": uniform_init(
            (feat_dim if l == 0 else nHiddens, nHiddens), gen, torch.float32,
            dev)} for l in range(nLevels + 1)],
            "W": uniform_init((nHiddens,), gen, torch.float32, dev)}
        self._register(tree, [f"levels/{l}/W" for l in range(nLevels + 1)]
                       + ["W"])

    def _prepare(self, graph):
        cfg = self.cfg
        if self.aggregation == "ell":
            return prep.prepare_graph_sparse(graph, cfg.max_nVertices)
        return prep.prepare_graph(graph, cfg.nLevels, cfg.max_nVertices, 1,
                                  cfg.nDepth)

    def _forward(self, params, g):
        hidden = g["wl_feat"]
        for lev in params["levels"]:
            if "ell_nbr" in g:
                hidden = _ell(g, "", hidden @ lev["W"])
            else:
                hidden = g["norm_adj"] @ hidden @ lev["W"]
            hidden = leaky_relu(hidden) * g["vmask"][..., None]
        final = hidden.sum(dim=1)                 # SumRows head (GCN_MW.h)
        return final @ params["W"], final


def nf_states(params, g, nLevels: int):
    """NeuralFingerprint's per-level hiddens [B, V, H] and final feature
    [B, H] (``graphflow_tpu/models/gcn.py:359-380``)."""
    feat, vmask = g["raw_feat"], g["vmask"]
    mask = vmask[..., None]
    sparse = "ell_nbr_a" in g
    if not sparse:
        M = g["adj"] * vmask[:, :, None] * vmask[:, None, :]    # open 1-hop
    hidden = softmax(feat @ params["levels"][0]["W1"].T) * mask
    states = [hidden]
    for l in range(1, nLevels + 1):
        lev = params["levels"][l]
        agg = _ell(g, "_a", hidden) if sparse else M @ hidden
        hidden = softmax(feat @ lev["W1"].T + agg @ lev["W2"].T) * mask
        states.append(hidden)
    return states, hidden.sum(dim=1)


class NeuralFingerprint(_Model):
    """``NeuralFingerprint.h``: raw features at every level, the open 1-hop
    sum, Softmax units, Momentum; float32 parameters.  ``aggregation`` as
    GCN_MW's ("auto": ell from 1024 vertices)."""

    def __init__(self, nLevels, max_nVertices, nFeatures, nHiddens,
                 momentum_param=0.9, seed=0, aggregation="auto",
                 device=None):
        super().__init__(optimizer="momentum", gamma=momentum_param)
        self.aggregation = _route(aggregation, max_nVertices)
        self.nLevels, self.max_nVertices = nLevels, max_nVertices
        gen, dev = torch.Generator().manual_seed(seed), resolve_device(device)
        levels = []
        for l in range(nLevels + 1):
            lev = {"W1": uniform_init((nHiddens, nFeatures), gen,
                                      torch.float32, dev)}
            if l > 0:
                lev["W2"] = uniform_init((nHiddens, nHiddens), gen,
                                         torch.float32, dev)
            levels.append(lev)
        tree = {"levels": levels,
                "W": uniform_init((nHiddens,), gen, torch.float32, dev)}
        order = [f"levels/{l}/{k}" for l in range(nLevels + 1)
                 for k in (("W1", "W2") if l > 0 else ("W1",))]
        self._register(tree, order + ["W"])

    def _prepare(self, graph):
        if self.aggregation == "ell":
            return prep.prepare_graph_sparse(graph, self.max_nVertices)
        return prep.prepare_graph(graph, self.nLevels, self.max_nVertices, 1,
                                  0, use_wl_features=False)

    def _forward(self, params, g):
        _, final = nf_states(params, g, self.nLevels)
        return final @ params["W"], final


@torch.no_grad()
def gcn_inspect(model: GCN, graph: DenseGraph) -> dict:
    """Activation dump (``graphflow_tpu/models/gcn.py:431-444``): per-level
    hiddens restricted to real vertices and the final feature, as NumPy."""
    states, final = gcn_states(model.params, model._stack([graph]),
                               model.cfg)
    n = graph.nVertices
    return {"states": [to_numpy(s[0, :n]) for s in states],
            "final_feature": to_numpy(final[0])}
