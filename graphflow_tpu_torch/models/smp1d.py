"""First-order Steerable Message Passing (counterpart of
``graphflow_tpu/models/smp1d.py``): a vertex's state is a |phi| x C matrix.

  SMP_theta            (``SMP_theta.h``)  [l1*sum ; l2*1@sum] @ K (2C->C),
                                          receptive-field cap, Adam
  SMP_1D               (``SMP_1D.h``)     steerable filter (l1 I + l2 1),
                                          Momentum
  SMP_1D_ver2, ver3    channel-growing concat of the two branches (ver3
                                          mixes each with K_eye / K_one)
  Unrestricted_SMP_1D  (``Unrestricted_SMP_1D.h:98-103``) full learned
                                          W[size]; ver2 two of them
  *_classification     the log-loss head

Math per level (``SMP_theta.h:570-615``, ``SMP_1D.h:480-512``):
  level 0:  f_v = LeakyReLU(H @ wl_feat_v)              (1 x C matrix)
  level l:  sum_v = SUM_{w : sp(v,w) <= 1} X[v][w] @ f_w   (s x C)
            theta:        f = LeakyReLU([l1[s]*sum ; l2[s]*(1 @ sum)] K + b[s])
            steerable:    f = LeakyReLU((l1[s] I + l2[s] 1) @ sum + b[s])
            unrestricted: f = LeakyReLU(W[s] @ sum + b[s])
  head:     vertex = LeakyReLU(column sums); graph = SUM_v vertex;
            <graph, W>, or class scores W @ graph

lambda1, lambda2 and b are per receptive-field size: [V+1]-indexed arrays
gathered by |phi_l(v)| (``SMP_theta.h:166-187``).  With
``faithful_lambda_grads`` their gradients are the reference's shared-node
ones (``ops/activations.py:persize_gather_refgrad``).

Where the JAX package vmaps one graph, the port runs the batch [B, V, P, C]
at once.  The 1-hop sum moves each state into vertex-id space (a scatter
of rows, G [B, V, V, C]), takes one batched product with the closed
adjacency, and gathers back into each receptive field's order; the JAX
package does the same with one-hot products.  With ``sparse_max_degree``
it is one ELLPACK product over the prepared ``fo_idx`` rows
(``ops/sparse.py:ell_spmm``).  No TPU kernel runs on this path in the JAX
package, and none runs here: every step is a torch op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.ops.activations import (leaky_relu,
                                                 persize_gather_refgrad)
from graphflow_tpu_torch.ops.losses import log_loss, squared_loss
from graphflow_tpu_torch.ops.sparse import ell_spmm
from graphflow_tpu_torch.optim.utils import uniform_init
from graphflow_tpu_torch.utils.convert import to_numpy

_FILTERS = ("theta", "steerable", "concat", "concat_kk", "unrestricted",
            "unrestricted2")
# lambda -> W_eye [-> W_flat -> W]: the shared-node chain's depth
# (SMP_1D.h:495-505 against SMP_theta.h:597-601).
_LAMBDA_DEPTH = {"theta": 1, "steerable": 3, "concat": 1, "concat_kk": 1}


@dataclasses.dataclass
class SMP1DConfig:
    max_nVertices: int
    max_receptive_field: Optional[int]
    nLevels: int
    nChanels: int
    nFeatures: int
    nDepth: int
    # "theta"         [l1*sum ; l2*1@sum] @ K (2C->C), constant channels
    # "steerable"     (l1 I + l2 1) @ sum, constant channels
    # "concat"        [l1*sum ; l2*1@sum], channels double per level
    #                 (``SMP_1D_ver2.h:131-166``)
    # "concat_kk"     [(l1*sum) @ K_eye ; (l2*1@sum) @ K_one], channels
    #                 double (``SMP_1D_ver3.h:142-175, 542-549``)
    # "unrestricted"  W[size] @ sum, constant channels
    # "unrestricted2" [W1[s] @ sum ; W2[s] @ sum], channels double
    #                 (``Unrestricted_SMP_1D_ver2.h:102-137``)
    filter: str = "theta"
    has_WL_ordering: bool = True
    use_wl_features: bool = True
    # CCN_1D divides each vertex's raw features by their L1 norm before H
    # (``CCN_1D.h:440-448``); no other first-order model does.
    l1_normalize_features: bool = False
    # The channel-doubling variants pass alpha = 0 to every tower LeakyReLU
    # (``SMP_1D_ver2.h:491,534``); the head's vertex LeakyReLU keeps 0.01.
    tower_alpha: float = 0.01
    # The largest closed vertex degree of the graphs: the 1-hop sum then
    # runs as one ELLPACK product over ``PreparedGraph.fo_idx``, O(V P D C),
    # instead of the id-space products, O(V^2 (P + C)).  The same sums.
    sparse_max_degree: Optional[int] = None
    # The reference's shared-node lambda gradients (True) or the true ones.
    faithful_lambda_grads: bool = True
    nClasses: Optional[int] = None
    optimizer: str = "adam"
    dtype: str = "float32"
    # Per-level channel counts, length nLevels + 1 (the physics tower
    # halves them); None: the filter's own schedule.
    channel_schedule: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.filter not in _FILTERS:
            raise ValueError(f"filter {self.filter!r}: one of {_FILTERS}")
        if (self.channel_schedule is not None
                and len(self.channel_schedule) != self.nLevels + 1):
            raise ValueError(
                f"channel_schedule {self.channel_schedule} needs "
                f"nLevels + 1 = {self.nLevels + 1} entries")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise NotImplementedError(
                f"dtype {self.dtype} is not ported; the port takes "
                f"float32, float64 and bfloat16")

    @property
    def feat_dim(self) -> int:
        return (self.nFeatures * (self.nDepth + 1)
                if self.use_wl_features else self.nFeatures)

    @property
    def P(self) -> int:
        return (self.max_receptive_field
                if self.max_receptive_field is not None else self.max_nVertices)

    def channels_at(self, l: int) -> int:
        """The level-l state's channels: the schedule's, else doubling per
        level for the concat filters (``SMP_1D_ver2.h:131``), else
        nChanels."""
        if self.channel_schedule is not None:
            return self.channel_schedule[l]
        if self.filter in ("concat", "concat_kk", "unrestricted2"):
            return self.nChanels * (2 ** l)
        return self.nChanels

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def host_dtype(self) -> np.dtype:
        """The host arrays' dtype: float32 for a bfloat16 model (NumPy has
        none; ``stack_graphs`` casts on the device), else the model's."""
        return np.dtype("float32" if self.dtype == "bfloat16"
                        else self.dtype)

    def level_keys(self):
        """The parameters of one level in registration order."""
        if self.filter == "unrestricted":
            return ("Wf", "b")
        if self.filter == "unrestricted2":
            return ("Wf1", "Wf2", "b")
        return (("lambda1", "lambda2", "b")
                + {"theta": ("K",),
                   "concat_kk": ("K_eye", "K_one")}.get(self.filter, ()))


def init_smp1d_params(generator: torch.Generator, cfg: SMP1DConfig,
                      device=None):
    """Fresh parameters as the JAX tree {"H", "levels": [...], "W"}, drawn
    in registration order at the JAX package's scales
    (``graphflow_tpu/models/smp1d.py:114-153``): per-size arrays have
    max_nVertices + 1 rows; the full filters Wf [V+1, P, P] scale by P,
    the lambdas by 1, b [V+1, C] by C.  Weights shared with the JAX package
    come through ``utils/convert.py``."""
    dt, at = cfg.torch_dtype, cfg.channels_at
    V1, P = cfg.max_nVertices + 1, cfg.P

    def draw(shape, fan=None):
        return uniform_init(shape, generator, dt, device, fan=fan)

    H = draw((at(0), cfg.feat_dim))
    levels = []
    for l in range(cfg.nLevels):
        C_prev, C = at(l), at(l + 1)
        shapes = {"Wf": ((V1, P, P), P), "Wf1": ((V1, P, P), P),
                  "Wf2": ((V1, P, P), P), "lambda1": ((V1,), 1),
                  "lambda2": ((V1,), 1), "b": ((V1, C), C),
                  "K": ((2 * C_prev, C), None),
                  "K_eye": ((C_prev, C_prev), None),
                  "K_one": ((C_prev, C_prev), None)}
        levels.append({k: draw(*shapes[k]) for k in cfg.level_keys()})
    CL = at(cfg.nLevels)
    W = draw((cfg.nClasses, CL) if cfg.nClasses else (CL,))
    return {"H": H, "levels": levels, "W": W}


def _neighbor_sum(f_prev, vid_prev, adj1, vid_cur):
    """sum_v[p] = SUM_{w in the closed 1-hop of v} f_w[q] where
    phi_{l-1}(w)[q] = phi_l(v)[p], for a batch.

    f_prev [B, V, P, C] (rows beyond |phi| zero), vid_prev [B, V, P] and
    vid_cur [B, V, P] the vertex ids of phi_{l-1}(w)[q] and phi_l(v)[p]
    (sentinel V), adj1 [B, V, V] the closed 1-hop adjacency."""
    B, V, P, C = f_prev.shape
    # Rows into vertex-id space: G[b, w, u] = f_w[q] where phi(w)[q] = u;
    # a receptive field holds each vertex once, and sentinels land in the
    # extra column V, which is dropped.
    idx = vid_prev.long()[..., None].expand(B, V, P, C)
    G = f_prev.new_zeros((B, V, V + 1, C)).scatter_add(2, idx, f_prev)
    M = torch.bmm(adj1, G[:, :, :V].reshape(B, V, V * C)).reshape(B, V, V, C)
    # Back into each phi_l(v)'s order; sentinels read the zero column V.
    M = torch.cat([M, M.new_zeros((B, V, 1, C))], dim=2)
    return torch.gather(M, 2, vid_cur.long()[..., None].expand(B, V, P, C))


def _neighbor_sum_sparse(f_prev, fo_idx):
    """The ELLPACK form of :func:`_neighbor_sum` over ``fo_idx`` [B, V, P,
    D]: out[v, p] = SUM_d rows[idx[v, p, d]] of each graph's flat [(w q), C]
    view, the sentinel V*P clamped to the graph's last row with weight 0
    (``graphflow_tpu/models/smp1d.py:183-192``, one graph at a time there;
    the graphs' rows are laid end to end here)."""
    B, V, P, C = f_prev.shape
    idx = fo_idx.reshape(B, V * P, -1).long()
    w = (idx < V * P).to(f_prev.dtype)
    offset = (torch.arange(B, device=idx.device) * (V * P))[:, None, None]
    flat = torch.clamp(idx, max=V * P - 1) + offset
    out = ell_spmm(flat.reshape(B * V * P, -1), w.reshape(B * V * P, -1),
                   f_prev.reshape(B * V * P, C))
    return out.reshape(B, V, P, C)


def smp1d_states(params, g, cfg: SMP1DConfig):
    """Per-level matrix states [B, V, P, C_l], levels 0..nLevels, of a
    stacked batch ``g`` (``graphflow_tpu/models/smp1d.py:195-296``)."""
    B, V = g["vmask"].shape
    P = cfg.P
    vmask = g["vmask"]

    feat = g["wl_feat"]
    if cfg.l1_normalize_features:
        # CCN_1D.h:440-448; the all-zero padding rows stay zero.
        norm = feat.abs().sum(dim=-1, keepdim=True)
        feat = feat / torch.where(norm > 0, norm, torch.ones_like(norm))
    F0 = leaky_relu(feat @ params["H"].T, cfg.tower_alpha)        # [B, V, C]
    state = F0.new_zeros((B, V, P, cfg.channels_at(0)))
    state[:, :, 0, :] = F0 * vmask[..., None]
    states = [state]
    vid_prev = torch.full((B, V, P), V, dtype=torch.int64,
                          device=state.device)
    vid_prev[:, :, 0] = torch.arange(V, device=state.device)   # phi_0(v) = [v]

    eye = torch.eye(V, dtype=g["adj"].dtype, device=state.device)
    adj1 = torch.clamp(g["adj"] + eye, max=1.0)
    adj1 = (adj1 * vmask[:, :, None] * vmask[:, None, :]).to(state.dtype)
    sparse = cfg.sparse_max_degree is not None and "fo_idx" in g

    for l in range(cfg.nLevels):
        lev = params["levels"][l]
        rm = g["smask"][:, l + 1, :, :, 0]                        # [B, V, P]
        vid_cur = torch.where(rm > 0, g["nbr"][:, l].long(),
                              torch.full_like(vid_prev, V))
        if sparse:
            sum_v = _neighbor_sum_sparse(state, g["fo_idx"][:, l])
        else:
            sum_v = _neighbor_sum(state, vid_prev, adj1, vid_cur)
        sum_v = sum_v * rm[..., None]

        s = g["sizes"][:, l + 1].long()                           # [B, V]
        b = lev["b"][s]                                           # [B, V, C]
        if "lambda1" in lev:
            if cfg.faithful_lambda_grads:
                depth = _LAMBDA_DEPTH[cfg.filter]
                l1 = persize_gather_refgrad(lev["lambda1"], s, depth)
                l2 = persize_gather_refgrad(lev["lambda2"], s, depth)
            else:
                l1, l2 = lev["lambda1"][s], lev["lambda2"][s]
            l1, l2 = l1[..., None, None], l2[..., None, None]
        colsum = sum_v.sum(dim=2)                                 # [B, V, C]
        ones_sum = rm[..., None] * colsum[:, :, None, :]          # 1_s @ sum

        if cfg.filter == "theta":
            z = torch.cat([l1 * sum_v, l2 * ones_sum], dim=-1) @ lev["K"]
        elif cfg.filter == "steerable":
            z = l1 * sum_v + l2 * ones_sum
        elif cfg.filter == "concat":
            z = torch.cat([l1 * sum_v, l2 * ones_sum], dim=-1)
        elif cfg.filter == "concat_kk":
            z = torch.cat([(l1 * sum_v) @ lev["K_eye"],
                           (l2 * ones_sum) @ lev["K_one"]], dim=-1)
        else:
            m = rm[..., :, None] * rm[..., None, :]               # [B,V,P,P]
            if cfg.filter == "unrestricted":
                z = torch.einsum("bvpq,bvqc->bvpc", lev["Wf"][s] * m, sum_v)
            else:
                z = torch.cat(
                    [torch.einsum("bvpq,bvqc->bvpc", lev[k][s] * m, sum_v)
                     for k in ("Wf1", "Wf2")], dim=-1)
        state = (leaky_relu(z + b[:, :, None, :], cfg.tower_alpha)
                 * rm[..., None])
        states.append(state)
        vid_prev = vid_cur
    return states


def _graph_feature(state, vmask):
    """Column sums -> LeakyReLU -> masked vertex sum -> [B, C]."""
    vertex = leaky_relu(state.sum(dim=2))                         # [B, V, C]
    return (vertex * vmask[..., None]).sum(dim=1)


def smp1d_level_features(params, g, cfg: SMP1DConfig):
    """Per-level graph features of a stacked batch (the physics and
    pairgraph towers): a list of [B, C_l], levels 0..nLevels."""
    return [_graph_feature(s, g["vmask"])
            for s in smp1d_states(params, g, cfg)]


def smp1d_forward(params, g, cfg: SMP1DConfig):
    """-> (prediction [B], or class scores [B, nClasses]; graph_feat
    [B, C_L])."""
    graph_feat = _graph_feature(smp1d_states(params, g, cfg)[-1],
                                g["vmask"])
    if cfg.nClasses:
        return graph_feat @ params["W"].T, graph_feat
    return graph_feat @ params["W"], graph_feat


class SMP1D(GraphModel):
    """Config-driven first-order SMP model with the reference API.

    Parameters are registered under the JAX package's paths (``"H"``,
    ``"levels/0/lambda1"``, ...) in its order: H, per level the filter's
    keys (:meth:`SMP1DConfig.level_keys`), W."""

    # What smp1d_states and smp1d_forward read.
    batch_fields = ("wl_feat", "vmask", "sizes", "nbr", "smask", "adj",
                    "fo_idx")

    def __init__(self, cfg: SMP1DConfig, seed: int = 0, device=None):
        super().__init__(optimizer=cfg.optimizer)
        self.cfg = cfg
        self._register(
            init_smp1d_params(torch.Generator().manual_seed(seed), cfg,
                              resolve_device(device)),
            ["H"] + [f"levels/{l}/{k}" for l in range(cfg.nLevels)
                     for k in cfg.level_keys()] + ["W"])

    def _prepare(self, graph: DenseGraph,
                 pad_nVertices: Optional[int] = None) -> prep.PreparedGraph:
        """Host arrays of one graph, padded to ``pad_nVertices`` (a size
        bucket) or max_nVertices; with ``sparse_max_degree`` the NumPy
        path also builds ``fo_idx``."""
        return prep.prepare_graph(
            graph, self.cfg.nLevels, pad_nVertices or self.cfg.max_nVertices,
            self.cfg.max_receptive_field, self.cfg.nDepth,
            has_WL_ordering=self.cfg.has_WL_ordering,
            use_wl_features=self.cfg.use_wl_features,
            dtype=self.cfg.host_dtype,
            fo_degree=self.cfg.sparse_max_degree)

    def _forward(self, params, batch):
        return smp1d_forward(params, batch, self.cfg)

    def _loss(self, params, batch):
        """The batch loss, summed over graphs: the log loss of the class
        scores against the targets as integer labels, or the squared
        loss."""
        out, _ = smp1d_forward(params, batch, self.cfg)
        if self.cfg.nClasses:
            return log_loss(out, batch["target"])
        return squared_loss(out, batch["target"])


def _smp1d(filter, optimizer, max_nVertices, max_receptive_field, nLevels,
           nChanels, nFeatures, nDepth, seed, device, **more) -> SMP1D:
    return SMP1D(SMP1DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, filter=filter, optimizer=optimizer, **more),
        seed, device)


def SMP_theta(max_nVertices, max_receptive_field, nLevels, nChanels,
              nFeatures, nDepth, seed=0, device=None) -> SMP1D:
    """``SMP_theta.h``: the concat-K filter, a receptive-field cap, Adam."""
    return _smp1d("theta", "adam", max_nVertices, max_receptive_field,
                  nLevels, nChanels, nFeatures, nDepth, seed, device)


def SMP_1D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
           momentum_param=0.9, seed=0, device=None) -> SMP1D:
    """``SMP_1D.h``: the steerable filter, uncapped fields, Momentum."""
    return _smp1d("steerable", "momentum", max_nVertices, None, nLevels,
                  nChanels, nFeatures, nDepth, seed, device)


def SMP_1D_classification(max_nVertices, nLevels, nChanels, nFeatures,
                          nDepth, nClasses, seed=0, device=None) -> SMP1D:
    """``SMP_1D_classification.h``: SMP_1D with a log-loss head."""
    return _smp1d("steerable", "momentum", max_nVertices, None, nLevels,
                  nChanels, nFeatures, nDepth, seed, device,
                  nClasses=nClasses)


def Unrestricted_SMP_1D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                        seed=0, device=None) -> SMP1D:
    """``Unrestricted_SMP_1D.h:98-103``: full learned W[size] filters."""
    return _smp1d("unrestricted", "momentum", max_nVertices, None, nLevels,
                  nChanels, nFeatures, nDepth, seed, device)


def SMP_1D_ver2(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0, device=None) -> SMP1D:
    """``SMP_1D_ver2.h:131-166``: the two steerable branches concatenated
    (C_l = 2 C_{l-1}), uncapped, Momentum, ReLU towers."""
    return _smp1d("concat", "momentum", max_nVertices, None, nLevels,
                  nChanels, nFeatures, nDepth, seed, device, tower_alpha=0.0)


def SMP_1D_ver3(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0, device=None) -> SMP1D:
    """``SMP_1D_ver3.h:142-175, 542-549``: ver2 with per-level K_eye and
    K_one channel mixers on the branches; ReLU towers."""
    return _smp1d("concat_kk", "momentum", max_nVertices, None, nLevels,
                  nChanels, nFeatures, nDepth, seed, device, tower_alpha=0.0)


def SMP_1D_ver3_classification(max_nVertices, nLevels, nChanels, nFeatures,
                               nDepth, nClasses, seed=0,
                               device=None) -> SMP1D:
    """``SMP_1D_ver3_classification.h``: ver3 with a log-loss head."""
    return _smp1d("concat_kk", "momentum", max_nVertices, None, nLevels,
                  nChanels, nFeatures, nDepth, seed, device, tower_alpha=0.0,
                  nClasses=nClasses)


def Unrestricted_SMP_1D_ver2(max_nVertices, nLevels, nChanels, nFeatures,
                             nDepth, seed=0, device=None) -> SMP1D:
    """``Unrestricted_SMP_1D_ver2.h:102-137``: two full W[size] filters,
    outputs concatenated (channels double per level); ReLU towers."""
    return _smp1d("unrestricted2", "momentum", max_nVertices, None, nLevels,
                  nChanels, nFeatures, nDepth, seed, device, tower_alpha=0.0)


def SMP_theta_physics(max_nVertices, max_receptive_field, nLevels, nChanels,
                      nFeatures, seed=0, device=None):
    """``SMP_theta_physics.h``: raw features, no WL ranking, the physics
    head over every level's feature (``models/physics.py``)."""
    from graphflow_tpu_torch.models.physics import SMP_theta_physics as ctor
    return ctor(max_nVertices, max_receptive_field, nLevels, nChanels,
                nFeatures, seed=seed, device=device)


@torch.no_grad()
def smp1d_inspect(model: SMP1D, graph: DenseGraph) -> dict:
    """Activation dump (``graphflow_tpu/models/smp1d.py:449-467``):
    per-level states, vertex features and the graph feature as NumPy
    arrays restricted to real vertices."""
    g = model._stack([graph])
    states = smp1d_states(model.params, g, model.cfg)
    n = graph.nVertices
    vertex = leaky_relu(states[-1].sum(dim=2))
    return {
        "states": [to_numpy(s[0, :n]) for s in states],
        "vertex_features": to_numpy(vertex[0, :n]),
        "graph_feature": to_numpy(_graph_feature(states[-1],
                                                 g["vmask"])[0]),
    }
